"""The system under test: the port (``genie_tts_tpu_torch``) built for one
configuration, on the benchmark's weights and reference clip.

Set-up does what a server does before traffic, through the port's own
functions: the weights are handed over as a converted checkpoint's trees
(the decoder's matmuls quantized by the port, ``t2s.quantize_params``,
as ``load_character`` does), HuBERT and RoBERTa installed with
``model_manager.set_hubert`` / ``set_roberta``, and the reference clip (a
WAV under ``TMPDIR``) run through the port's reference path
(``reference_audio_cache.get_features``). The configuration's family
(``families/<family>.py``) names the models, gives the character's
synthesizer and the reference path's speaker-verification function, and
reads the speaker conditioning set-up derived."""
from __future__ import annotations

import tempfile
import wave
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from . import spec, weights

LANGUAGE = {"ja": "Japanese", "zh": "Chinese"}
SPECIAL_TOKENS = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}


def scratch_dir() -> Path:
    d = Path(tempfile.gettempdir()) / "perfbench"
    d.mkdir(parents=True, exist_ok=True)
    return d


def clip_rate(cfg: Dict) -> int:
    """The sample rate of the reference clip: the SoVITS input's."""
    return int(cfg["sovits"].get("sample_rate", 32000))


def reference_clip(cfg: Dict, seed: int) -> np.ndarray:
    """The configuration's reference recording for ``seed``: int16 at
    :func:`clip_rate`, a voiced signal (harmonics of a wandering pitch
    under a syllable-rate envelope) with a little noise."""
    sr = clip_rate(cfg)
    n = int(round(float(cfg["reference_clip"]["seconds"]) * sr))
    rng = np.random.default_rng(int(seed) % (2 ** 63))
    t = np.arange(n) / sr
    f0 = 110.0 + 60.0 * rng.random() + 20.0 * np.sin(2 * np.pi * (0.5 + rng.random()) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    x = sum((0.6 ** k) * np.sin(k * phase + rng.random() * 6.28) for k in range(1, 9))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (3.0 + 2.0 * rng.random()) * t) ** 2
    x = x * env + 0.02 * rng.standard_normal(n)
    x = 0.3 * x / np.abs(x).max()
    return np.round(x * 32767).astype(np.int16)


def write_wav(path: Path, pcm: np.ndarray, sr: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.astype("<i2").tobytes())


def tokenizer_json(cfg: Dict, texts) -> Path:
    """A BERT-layout ``tokenizer.json`` whose vocabulary holds every
    character of ``texts`` as normalized for Chinese G2P (ids spread over
    the table), under ``TMPDIR``."""
    import json

    from ..reference.frontend import phones
    from ..reference.frontend.wordpiece import bert_layout

    V = int(cfg["roberta"].get("vocab_size", 21128))
    chars = sorted({c for s in texts for c in phones.chinese(s)[1]})
    vocab = dict(SPECIAL_TOKENS)
    for i, c in enumerate(chars):
        vocab[c] = 670 + i * (V - 700) // max(len(chars), 1)
    path = scratch_dir() / f"tokenizer-{cfg['name']}.json"
    path.write_text(json.dumps(bert_layout(vocab)), encoding="utf-8")
    return path


def run_units(units) -> str:
    """Run warmup thunks one after another, as ``TTSEngine._run_compile_units``
    does; returns their seconds summed by the function each calls."""
    import time

    spent: Dict[str, list] = {}
    for u in units:
        t = time.perf_counter()
        u()
        name = getattr(getattr(u, "func", u), "__name__", "unit")
        if name == "prepare" and len(getattr(u, "args", ())) > 2:
            name = f"sovits.{u.args[2]}"
        e = spent.setdefault(name, [0, 0.0])
        e[0] += 1
        e[1] += time.perf_counter() - t
    return ", ".join(f"{k} {n} in {s:.2f} s" for k, (n, s) in spent.items())


class System:
    """The port for configuration ``cfg`` on ``device``; ``timing`` turns on
    the engine's synchronizing stage marks (traced runs only)."""

    def __init__(self, cfg: Dict, seed: int, device, texts, timing: bool = False,
                 mark=lambda what: None):
        from genie_tts_tpu_torch.config import (HubertConfig, RobertaConfig, RuntimeConfig,
                                                T2SConfig)
        from genie_tts_tpu_torch.models import hubert, t2s
        from genie_tts_tpu_torch.runtime.engine import CharacterModel, TTSEngine
        from genie_tts_tpu_torch.runtime.model_manager import model_manager
        from genie_tts_tpu_torch.runtime.reference_audio import ReferenceAudioCache

        self.cfg = cfg
        self.device = torch.device(device)
        self.language = LANGUAGE[cfg["language"]]
        dev = self.device
        self.family = family = spec.family(cfg["family"])
        trees = {m: weights.make(m, cfg, seed, dev) for m in family.models(cfg)}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mark("weights")
        rcfg = RuntimeConfig(**cfg.get("runtime", {}))
        t2s_params = trees["t2s"]
        if rcfg.t2s_int8:
            t2s_params = t2s.quantize_params(t2s_params)
        self.char = CharacterModel(
            name=cfg["name"], language=self.language, t2s_params=t2s_params,
            t2s_cfg=T2SConfig(**cfg["t2s"]), device=dev, **family.character(cfg, trees))
        self.engine = TTSEngine(rcfg, timing=timing)
        hcfg = HubertConfig(**cfg["hubert"])
        model_manager.set_hubert(trees["hubert"], hcfg)
        if cfg.get("roberta"):
            from genie_tts_tpu_torch.frontend.wordpiece import WordPieceTokenizer

            tok = WordPieceTokenizer.from_file(tokenizer_json(cfg, texts))
            model_manager.set_roberta(trees["roberta"], RobertaConfig(**cfg["roberta"]), tok)
        self.model_manager = model_manager
        mark("the port's models installed")
        hparams = trees["hubert"]

        @torch.inference_mode()
        def hubert_fn(audio_16k):
            audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=dev)[None]
            return hubert.apply(hparams, audio, hcfg)[0].float().cpu().numpy()

        self.kept = {}          # what the family's SV function gave
        sv_fn = family.sv_fn(trees, dev, self.kept)
        self.clip = reference_clip(cfg, seed)
        path = scratch_dir() / f"reference-{cfg['name']}.wav"
        write_wav(path, self.clip, clip_rate(cfg))
        cache = ReferenceAudioCache(rcfg)
        self.ref = cache.get_features(
            self.engine, self.char, str(path), cfg["reference_clip"]["text"],
            self.language, hubert_fn=hubert_fn, sv_fn=sv_fn)
        # HuBERT's features of the clip, as the port's reference path made them
        self.ssl = np.asarray(cache.get_clip(str(path), cfg["reference_clip"]["text"],
                                             self.language).ssl_content, np.float32)
        self.batcher = None
        mark("reference features")

    def derived(self) -> Dict[str, np.ndarray]:
        """What set-up derived from the reference clip, for the check: the
        prompt tokens, HuBERT's features, and what the family reads (the
        speaker conditioning)."""
        return {"prompts": np.asarray(self.ref.prompt_tokens), "ssl": self.ssl,
                **self.family.derived(self.ref, self.kept)}

    # -- the entries the traffic drives ------------------------------------

    def phones(self, text: str):
        from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert

        return get_phones_and_bert(text, self.language)

    def slot_batcher(self):
        """The character's slot machine, as ``api.get_slot_batcher`` makes
        it (serving emits PCM16), its programs captured first through the
        port's unit list (``slot_warmup_units``)."""
        from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher, slot_warmup_units

        if self.batcher is None:
            units = [u for u in slot_warmup_units(self.engine, self.char)
                     if self._reached(u)]
            self.units_log = run_units(units)
            self.batcher = SlotBatcher(self.engine, self.char, pcm16=True)
        return self.batcher

    def _reached(self, unit) -> bool:
        """Whether the cell's requests reach a unit of the slot machine's
        list: they never sample with top-p, and take BERT features exactly
        when the configuration has RoBERTa (join variant (bert, top_p);
        segment (width, ctx window, ring window, top_p))."""
        name = getattr(getattr(unit, "func", None), "__name__", "")
        args = getattr(unit, "args", ())
        if name == "capture" and len(args) == 1 and isinstance(args[0], tuple):
            bert, top_p = args[0]
            return not top_p and bert == bool(self.cfg.get("roberta"))
        if name == "segment" and len(args) == 4:
            return not args[3]
        return True

    def capture_roberta(self) -> str:
        return run_units(self.model_manager.roberta_warmup_units(self.device))

    def graph_stats(self) -> Dict[str, int]:
        """Misses and captures summed over the configuration's graph caches
        and RoBERTa's (``runtime/graphs.py``)."""
        from genie_tts_tpu_torch.runtime import graphs

        caches = list(self.engine.graph_caches(self.char))
        if self.cfg.get("roberta"):
            loaded = self.model_manager._roberta.get(self.device) or next(
                iter(self.model_manager._roberta.values()), None)
            if loaded is not None:
                caches.append(graphs.cache_for(loaded[0]))
        out: Dict[str, int] = {}
        for c in caches:
            for k in ("misses", "captures", "hits"):
                out[k] = out.get(k, 0) + int(c.stats.get(k, 0))
        return out

    def close(self, keep_graphs: bool = False) -> None:
        """Stop the slot machine and drop the program's state; the
        configuration's graphs too unless ``keep_graphs`` (a later System
        of the configuration then binds its weights into them, as a
        second character of a served configuration does)."""
        from genie_tts_tpu_torch.runtime import graphs

        if self.batcher is not None:
            self.batcher.retire()
            self.batcher.join(60.0)
            self.batcher = None
        self.model_manager._hubert.clear()
        self.model_manager._roberta.clear()
        self.char = self.engine = self.ref = None
        if not keep_graphs:
            graphs.clear_caches()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
