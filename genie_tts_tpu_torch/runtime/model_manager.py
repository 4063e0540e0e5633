"""Character/model manager: LRU-cached weights + the shared HuBERT model.

The port of ``genie_tts_tpu/runtime/model_manager.py`` for V2 characters:
model-dir validation, ``config.json`` hyperparameter overrides, int8
decode weights at load (``RuntimeConfig.t2s_int8``), an LRU of loaded
characters with reload after eviction, and a lazy global HuBERT.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from ..config import (HubertConfig, RuntimeConfig, SoVITSConfig, T2SConfig,
                      hubert_dir, resolve_device, resolve_dtype)
from ..convert.io import load_character_config, load_params
from ..utils.lru import LRUCache
from .engine import CharacterModel

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
            f"  - config.json       (version/language metadata)")
    cfg = load_character_config(path / "config.json")
    if cfg.get("version", "v2") != "v2":
        raise NotImplementedError(
            f"version {cfg.get('version')!r} is not ported yet (ROADMAP.md, "
            f"Queue 1 item 10: V2ProPlus); the port loads V2 characters")
    return cfg


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def _cfg(cls, overrides, **defaults):
    """``cls`` with the fields of ``overrides`` that it has (config.json may
    override model hyperparameters; tuple fields arrive as lists)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = dict(defaults)
    for k, v in (overrides or {}).items():
        if k in fields:
            kw[k] = _deep_tuple(v)
    return cls(**kw)


class ModelManager:
    def __init__(self, runtime_cfg: Optional[RuntimeConfig] = None):
        self.cfg = runtime_cfg or RuntimeConfig()
        self._lock = threading.RLock()
        self._cache: LRUCache[str, CharacterModel] = LRUCache(
            self.cfg.max_cached_characters,
            on_evict=lambda name, _: logger.info("evicted character '%s'", name))
        # name -> (model_dir, language, device, dtype) for reload after evict
        self._registry: Dict[str, Tuple] = {}
        self._hubert: Dict[torch.device, Tuple[Dict, HubertConfig]] = {}

    # -- characters -------------------------------------------------------

    def load_character(self, name: str, model_dir: str, language: str,
                       compute_dtype=None, device=None) -> CharacterModel:
        """``device``: cuda unless named; ``compute_dtype``: dtype of the
        non-sensitive weights (default the runtime config's, bf16)."""
        dev = resolve_device(device)
        dtype = resolve_dtype(compute_dtype, self.cfg)
        cfg = check_model_dir(model_dir)
        path = Path(model_dir)
        t2s_params = load_params(path / "t2s.safetensors", dtype, dev)
        if self.cfg.t2s_int8:
            from ..models.t2s import quantize_params

            t2s_params = quantize_params(t2s_params)
        with self._lock:
            model = CharacterModel(
                name=name, language=language, version="v2",
                t2s_params=t2s_params,
                sovits_params=load_params(path / "vits.safetensors", dtype, dev),
                t2s_cfg=_cfg(T2SConfig, cfg.get("t2s")),
                sovits_cfg=_cfg(SoVITSConfig, cfg.get("sovits"), version="v2",
                                gin_channels=512),
                device=dev)
            self._cache.put(name, model)
            self._registry[name] = (str(model_dir), language, dev, dtype)
            logger.info("loaded character '%s' (v2, %s) on %s", name, language, dev)
            return model

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

    def remove_character(self, name: str) -> None:
        with self._lock:
            self._cache.pop(name)
            self._registry.pop(name, None)

    # -- shared models ----------------------------------------------------

    def load_hubert(self, device) -> Optional[Tuple[Dict, HubertConfig]]:
        """Lazy global HuBERT on ``device`` (None when the checkpoint is
        missing). A ``config.json`` beside ``hubert.safetensors`` may
        override HubertConfig fields, as a character's does."""
        dev = resolve_device(device)
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
                                 _cfg(HubertConfig, overrides))
            return self._hubert[dev]


model_manager = ModelManager()
