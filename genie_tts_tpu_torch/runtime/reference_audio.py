"""Reference-audio feature cache for voice cloning.

The port of ``genie_tts_tpu/runtime/reference_audio.py``: load a clip at
32 kHz (mono mix, +0.3 s silence appended, 3-10 s duration warning),
resample to 16 kHz, run HuBERT for ``ssl_content`` and phonemize the
transcript, cached per (path, text). Character-dependent features (VQ
prompt tokens from the character's codebook, and the speaker conditioning
of its version, ``synth.reference``: the V2 style embedding, or
V2ProPlus's prompt-encoder embeddings from the clip's SV embedding, or
V4's style embedding with its CFM prompt) are cached per (path, character).
"""
from __future__ import annotations

import logging
import threading
from typing import Optional, Tuple

import numpy as np

from ..config import RuntimeConfig
from ..frontend.dispatcher import get_phones_and_bert
from ..ops.audio import resample_poly
from ..utils.lru import LRUCache
from ..utils.wavio import read_audio
from .engine import CharacterModel, ReferenceFeatures, TTSEngine

logger = logging.getLogger(__name__)

APPEND_SILENCE_S = 0.3
MIN_REF_S, MAX_REF_S = 3.0, 10.0


class ReferenceClip:
    """Character-independent features of one reference recording."""

    def __init__(self, audio_path: str, text: str, language: str,
                 hubert_fn=None):
        self.audio_path = audio_path
        self.text = text
        self.language = language

        audio, sr = read_audio(audio_path)
        dur = len(audio) / sr
        if not (MIN_REF_S <= dur <= MAX_REF_S):
            logger.warning(
                "Reference audio is %.1f s; recommended range is %.0f-%.0f s "
                "for stable cloning.", dur, MIN_REF_S, MAX_REF_S)
        audio_32k = resample_poly(audio, sr, 32000)
        silence = np.zeros(int(APPEND_SILENCE_S * 32000), np.float32)
        self.audio_32k = np.concatenate([audio_32k, silence])
        self.clip_samples = len(audio_32k)       # before the silence
        self.audio_16k = resample_poly(self.audio_32k, 32000, 16000)

        self.phones, self.bert = get_phones_and_bert(text, language)

        # HuBERT SSL features [T50, 768]; None when HuBERT isn't available
        self.ssl_content: Optional[np.ndarray] = None
        if hubert_fn is not None:
            self.ssl_content = np.asarray(hubert_fn(self.audio_16k))


class ReferenceAudioCache:
    def __init__(self, runtime_cfg: Optional[RuntimeConfig] = None):
        cfg = runtime_cfg or RuntimeConfig()
        self._clips: LRUCache[str, ReferenceClip] = LRUCache(
            cfg.max_cached_reference_audio)
        self._features: LRUCache[Tuple[str, str], ReferenceFeatures] = LRUCache(
            cfg.max_cached_reference_audio * 2)
        self._lock = threading.RLock()

    def get_clip(self, audio_path: str, text: str, language: str,
                 hubert_fn=None) -> ReferenceClip:
        with self._lock:
            clip = self._clips.get(audio_path)
            if clip is not None and clip.text == text:
                return clip
            clip = ReferenceClip(audio_path, text, language, hubert_fn=hubert_fn)
            self._clips.put(audio_path, clip)
            # invalidate derived features of the old clip
            for key, _ in list(self._features.items()):
                if key[0] == audio_path:
                    self._features.pop(key)
            return clip

    def get_features(self, engine: TTSEngine, char: CharacterModel,
                     audio_path: str, text: str, language: str,
                     hubert_fn=None, sv_fn=None) -> ReferenceFeatures:
        """``sv_fn(audio_16k) -> [20480]`` gives the speaker-verification
        embedding of a character whose version clones from one
        (``synth.needs_sv``: V2ProPlus; ``models/sv.py::get_sv_fn``)."""
        with self._lock:
            key = (audio_path, char.name)
            feats = self._features.get(key)
            if feats is not None:
                return feats
            clip = self.get_clip(audio_path, text, language, hubert_fn=hubert_fn)
            if clip.ssl_content is None:
                raise RuntimeError(
                    "HuBERT model unavailable: cannot extract reference-audio "
                    "SSL features. Put hubert.safetensors under "
                    "GENIE_DATA_DIR/chinese-hubert-base (or GENIE_HUBERT_DIR).")
            prompt_tokens = engine.compute_prompt_tokens(char, clip.ssl_content)
            synth = char.synth
            sv_emb = (np.asarray(sv_fn(clip.audio_16k), np.float32)
                      if synth.needs_sv and sv_fn is not None else None)
            feats = ReferenceFeatures(
                phones=np.asarray(clip.phones, np.int32),
                bert=np.asarray(clip.bert, np.float32),
                prompt_tokens=prompt_tokens,
                **synth.reference(char, clip.audio_32k, clip.clip_samples, prompt_tokens,
                                  clip.phones, sv_emb))
            self._features.put(key, feats)
            return feats

    def clear(self) -> None:
        with self._lock:
            self._clips.clear()
            self._features.clear()


reference_audio_cache = ReferenceAudioCache()
