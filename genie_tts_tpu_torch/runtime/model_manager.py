"""Character/model manager: LRU-cached weights + the shared HuBERT model.

The port of ``genie_tts_tpu/runtime/model_manager.py``: model-dir
validation and ``config.json`` hyperparameter overrides (what a version
adds, such as V2ProPlus's prompt encoder and its ``gin_channels=1024``,
is its synthesizer object's: ``runtime/synthesizers.py``), int8 decode weights at
load (``RuntimeConfig.t2s_int8``), an LRU of loaded characters with reload
after eviction (an evicted character is dropped, and with it its weights;
the captured graphs are its configuration's and stay for the next
character of it: ``runtime/graphs.py``; ``on_evict`` is told, so the API
lets go of what it holds for it), and the lazy shared models: HuBERT, and RoBERTa with the
Chinese BERT-feature hook it installs into the G2P dispatcher. Both are
kept per device, so a second character on the same card loads neither
again.
"""
from __future__ import annotations

import functools
import logging
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..config import (HubertConfig, RobertaConfig, RuntimeConfig, T2SConfig, config_from,
                      hubert_dir, indexed_device, resolve_device, resolve_dtype, roberta_dir)
from ..convert.io import load_character_config, load_params
from ..utils.lru import LRUCache
from .engine import CharacterModel
from .synthesizers import synthesizer

logger = logging.getLogger(__name__)

REQUIRED_FILES = ("t2s.safetensors", "vits.safetensors", "config.json")


def check_model_dir(model_dir) -> Dict:
    """Validate a character checkpoint directory; returns its config."""
    path = Path(model_dir)
    if not path.is_dir():
        raise FileNotFoundError(
            f"Model directory '{model_dir}' does not exist or is not a directory.")
    missing = [f for f in REQUIRED_FILES if not (path / f).is_file()]
    if missing:
        raise FileNotFoundError(
            f"\n[genie-tts-tpu-torch] Invalid model directory: '{path}'\n"
            f"Missing files: {', '.join(missing)}\n"
            f"A valid character checkpoint contains:\n"
            f"  - t2s.safetensors   (text-to-semantic GPT weights)\n"
            f"  - vits.safetensors  (SoVITS synthesizer weights)\n"
            f"  - config.json       (version/language metadata)\n"
            f"  - prompt_encoder.safetensors  (V2ProPlus only)\n"
            f"A V4 character's vits.safetensors holds its whole synthesizer (the DiT\n"
            f"and the 48 kHz vocoder too) and its config.json a \"v4\" section.")
    cfg = load_character_config(path / "config.json")
    synthesizer(cfg.get("version", "v2")).check_files(path)
    return cfg


class ModelManager:
    def __init__(self, runtime_cfg: Optional[RuntimeConfig] = None):
        self.cfg = runtime_cfg or RuntimeConfig()
        self._lock = threading.RLock()
        self._cache: LRUCache[str, CharacterModel] = LRUCache(
            self.cfg.max_cached_characters, on_evict=self._evicted)
        # called with a character's name when the LRU evicts it: what it
        # lets go of would keep the character (its weights and states) alive
        self.on_evict: Optional[Callable[[str], None]] = None
        # name -> (model_dir, language, device, dtype) for reload after evict
        self._registry: Dict[str, Tuple] = {}
        self._hubert: Dict[torch.device, Tuple[Dict, HubertConfig]] = {}
        # device -> (params, cfg, tokenizer)
        self._roberta: Dict[torch.device, Tuple[Dict, RobertaConfig, object]] = {}

    # -- characters -------------------------------------------------------

    def _evicted(self, name: str, _model: CharacterModel) -> None:
        logger.info("evicted character '%s'", name)
        if self.on_evict is not None:
            self.on_evict(name)

    def load_character(self, name: str, model_dir: str, language: str,
                       compute_dtype=None, device=None) -> CharacterModel:
        """``device``: cuda unless named; ``compute_dtype``: dtype of the
        non-sensitive weights (default the runtime config's, bf16)."""
        dev = resolve_device(device)
        dtype = resolve_dtype(compute_dtype, self.cfg)
        cfg = check_model_dir(model_dir)
        version = cfg.get("version", "v2")
        path = Path(model_dir)
        t2s_params = load_params(path / "t2s.safetensors", dtype, dev)
        if self.cfg.t2s_int8:
            from ..models.t2s import quantize_params

            t2s_params = quantize_params(t2s_params)
        with self._lock:
            model = CharacterModel(
                name=name, language=language, version=version,
                t2s_params=t2s_params, t2s_cfg=config_from(T2SConfig, cfg.get("t2s")),
                device=dev, **synthesizer(version).load(path, cfg, version, dtype, dev))
            self._cache.put(name, model)
            self._registry[name] = (str(model_dir), language, dev, dtype)
            logger.info("loaded character '%s' (%s, %s) on %s", name, version,
                        language, dev)
            return model

    def register(self, model: CharacterModel) -> None:
        """Insert an already-built model (tests, random characters)."""
        with self._lock:
            self._cache.put(model.name, model)

    def get(self, name: str) -> Optional[CharacterModel]:
        with self._lock:
            model = self._cache.get(name)
            if model is not None:
                return model
            if name in self._registry:  # evicted: reload
                model_dir, language, dev, dtype = self._registry[name]
                logger.info("reloading evicted character '%s'", name)
                return self.load_character(name, model_dir, language, dtype, dev)
            return None

    def holds(self, model: CharacterModel) -> bool:
        """Whether ``model`` is the loaded character of its name (not one
        evicted, unloaded or replaced since)."""
        return self._cache.get(model.name) is model

    def remove_character(self, name: str) -> None:
        with self._lock:
            self._cache.pop(name)
            self._registry.pop(name, None)

    # -- shared models ----------------------------------------------------

    def load_hubert(self, device) -> Optional[Tuple[Dict, HubertConfig]]:
        """Lazy global HuBERT on ``device`` (None when the checkpoint is
        missing). A ``config.json`` beside ``hubert.safetensors`` may
        override HubertConfig fields, as a character's does."""
        dev = indexed_device(resolve_device(device))
        with self._lock:
            if dev in self._hubert:
                return self._hubert[dev]
            path = hubert_dir() / "hubert.safetensors"
            if not path.is_file():
                logger.warning("HuBERT checkpoint not found at %s; reference-"
                               "audio SSL features unavailable", path)
                return None
            cfg_path = path.with_name("config.json")
            overrides = load_character_config(cfg_path) if cfg_path.is_file() else None
            self._hubert[dev] = (load_params(path, resolve_dtype(None, self.cfg), dev),
                                 config_from(HubertConfig, overrides))
            return self._hubert[dev]

    def set_hubert(self, params: Dict, cfg: HubertConfig) -> None:
        """Inject HuBERT weights (tests / preloaded); they serve the
        device their leaves are on."""
        dev = indexed_device(params["fp_proj"]["w"].device)
        with self._lock:
            self._hubert[dev] = (params, cfg)

    def load_roberta(self, device) -> Optional[Tuple[Dict, RobertaConfig, object]]:
        """Lazy global RoBERTa + tokenizer on ``device`` for Chinese BERT
        features. Loading it installs the per-phoneme feature hook into
        the G2P dispatcher. Returns (params, cfg, tokenizer), or None when
        ``roberta.safetensors`` or ``tokenizer.json`` is missing: Chinese
        BERT features are then zero. A ``config.json`` beside them may
        override RobertaConfig fields, as HuBERT's does."""
        dev = indexed_device(resolve_device(device))
        with self._lock:
            if dev in self._roberta:
                return self._roberta[dev]
            root = roberta_dir()
            ckpt = root / "roberta.safetensors"
            tok_path = root / "tokenizer.json"
            if not (ckpt.is_file() and tok_path.is_file()):
                logger.warning(
                    "RoBERTa assets not found at %s; Chinese BERT features "
                    "will be zero (pronunciation unaffected, prosody degrades)",
                    root)
                return None
            from ..frontend.wordpiece import WordPieceTokenizer

            cfg_path = root / "config.json"
            overrides = load_character_config(cfg_path) if cfg_path.is_file() else None
            self._roberta[dev] = (
                load_params(ckpt, resolve_dtype(None, self.cfg), dev),
                config_from(RobertaConfig, overrides), WordPieceTokenizer.from_file(tok_path))
            self._install_bert_hook(dev)
            return self._roberta[dev]

    def set_roberta(self, params: Dict, cfg: RobertaConfig, tokenizer) -> None:
        """Inject RoBERTa weights (on their device) + a tokenizer with
        ``encode(text) -> .ids, .attention_mask`` (tests / preloaded)."""
        dev = indexed_device(params["word_embed"].device)
        with self._lock:
            self._roberta[dev] = (params, cfg, tokenizer)
            self._install_bert_hook(dev)

    def _install_bert_hook(self, dev: torch.device) -> None:
        """Point the dispatcher's BERT hook at the RoBERTa on ``dev``. The
        hook reads only the weights and its arguments, so server threads
        may call it at once."""
        from ..frontend.dispatcher import set_bert_feature_fn
        from ..models import roberta as roberta_model
        from ..ops.layers import unstack

        params, cfg, tokenizer = self._roberta[dev]
        unstack(params["layers"])      # per-layer views made here, not in a call
        buckets = self.cfg.phoneme_buckets

        @torch.inference_mode()
        def bert_fn(norm_text: str, word2ph) -> np.ndarray:
            enc = tokenizer.encode(norm_text)
            reps = np.asarray(word2ph, np.int64)
            if len(enc.ids) - 2 != len(reps):
                # tokenizer/char mismatch (rare unicode): zero features
                return np.zeros((int(reps.sum()), cfg.embed_dim), np.float32)
            return roberta_model.bucketed_features(
                params, cfg, np.asarray(enc.ids), np.asarray(enc.attention_mask), reps,
                buckets).cpu().numpy()

        set_bert_feature_fn(bert_fn)

    def roberta_warmup_units(self, device) -> list:
        """Thunks capturing the BERT hook's feature program at every token
        bucket of its ladder, for the RoBERTa on ``device`` (none when no
        RoBERTa is loaded there). Its graphs are the device's, shared by
        every Chinese character: a later sweep finds them captured."""
        from ..models import roberta as roberta_model

        with self._lock:
            loaded = self._roberta.get(indexed_device(resolve_device(device)))
        if loaded is None:
            return []
        params, cfg, _ = loaded
        return [functools.partial(roberta_model.prepare_features, params, cfg, T)
                for T in self.cfg.phoneme_buckets]


model_manager = ModelManager()
