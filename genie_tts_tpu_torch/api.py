"""Public Python API of the port: load_character, set_reference_audio, tts.

The solo, synchronous subset of ``genie_tts_tpu/api.py``. Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
device named they raise. Streaming sessions, playback, batching, slots and
the server are later slices (ROADMAP.md).
"""
from __future__ import annotations

import logging
import os
from os import PathLike
from typing import Dict, Optional, Union

import numpy as np
import torch

from .config import RuntimeConfig, resolve_device
from .frontend.dispatcher import get_phones_and_bert
from .frontend.language import MONOLINGUAL, normalize_language, require_supported
from .frontend.splitter import split_text
from .ops.sampling import SamplingConfig
from .runtime.engine import TTSEngine
from .runtime.model_manager import model_manager
from .runtime.reference_audio import reference_audio_cache
from .utils.wavio import write_wav

logger = logging.getLogger(__name__)

SUPPORTED_AUDIO_EXTS = {".wav", ".flac", ".ogg", ".aiff", ".aif"}
SAMPLE_RATE = 32000

engine = TTSEngine(RuntimeConfig())

# character -> reference-audio config
_reference_audios: Dict[str, dict] = {}
_hubert_fns: Dict[torch.device, object] = {}


def _hubert_fn(device):
    """HuBERT forward on ``device``, or None when weights are unavailable."""
    dev = resolve_device(device)
    if dev in _hubert_fns:
        return _hubert_fns[dev]
    loaded = model_manager.load_hubert(dev)
    if loaded is None:
        return None
    from .models import hubert as hubert_model

    params, hcfg = loaded

    @torch.inference_mode()
    def fn(audio_16k: np.ndarray) -> np.ndarray:
        audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=dev)[None]
        return hubert_model.apply(params, audio, hcfg)[0].float().cpu().numpy()

    _hubert_fns[dev] = fn
    return fn


# ---------------------------------------------------------------------------
# Character management
# ---------------------------------------------------------------------------

def load_character(character_name: str, model_dir: Union[str, PathLike],
                   language: str, device=None, dtype=None) -> None:
    """Load a character checkpoint directory (t2s/vits safetensors) onto
    ``device`` (cuda unless named) in ``dtype`` (default bf16)."""
    language = require_supported(language)
    model_manager.load_character(character_name, os.fspath(model_dir), language,
                                 compute_dtype=dtype, device=device)


def unload_character(character_name: str) -> None:
    model_manager.remove_character(character_name)


def set_reference_audio(character_name: str, audio_path: Union[str, PathLike],
                        audio_text: str, language: Optional[str] = None,
                        device=None) -> bool:
    """Register the voice-cloning reference clip for a character and run
    its HuBERT features on the character's device (or ``device``).

    Returns False (after logging) for unsupported formats."""
    audio_path = os.fspath(audio_path)
    ext = os.path.splitext(audio_path)[1].lower()
    if ext not in SUPPORTED_AUDIO_EXTS:
        logger.error("Audio format '%s' not supported (supported: %s)",
                     ext, sorted(SUPPORTED_AUDIO_EXTS))
        return False
    model = model_manager.get(character_name)
    if language is None:
        if model is None:
            raise ValueError("No language specified and character not loaded")
        language = model.language
    language = normalize_language(language)
    if language not in MONOLINGUAL:
        raise ValueError(f"Unknown language: {language}")
    if device is None and model is not None:
        device = model.device
    _reference_audios[character_name] = {
        "audio_path": audio_path, "audio_text": audio_text, "language": language,
    }
    reference_audio_cache.get_clip(audio_path, audio_text, language,
                                   hubert_fn=_hubert_fn(device))
    return True


# ---------------------------------------------------------------------------
# Synthesis
# ---------------------------------------------------------------------------

def _make_synth_fn(character_name: str, sampling: Optional[SamplingConfig] = None):
    char = model_manager.get(character_name)
    if char is None:
        raise ValueError(f"Character '{character_name}' is not loaded")
    ref_cfg = _reference_audios[character_name]
    feats = reference_audio_cache.get_features(
        engine, char, ref_cfg["audio_path"], ref_cfg["audio_text"],
        ref_cfg["language"], hubert_fn=_hubert_fn(char.device))

    def synth(sentence: str) -> Optional[np.ndarray]:
        # a leading 。 guards against the model swallowing the first phrase
        phones, bert = get_phones_and_bert("。" + sentence, char.language)
        if len(phones) == 0:
            return None
        return engine.synthesize_utterance(char, feats, phones, bert,
                                           sampling=sampling)

    return synth


def tts(character_name: str, text: str, play: bool = False,
        split_sentence: bool = True, save_path: Union[str, PathLike, None] = None,
        sampling: Optional[SamplingConfig] = None) -> Optional[np.ndarray]:
    """Synthesize ``text`` sentence by sentence on the character's device.

    Returns the 32 kHz float32 waveform of all sentences, and writes it as
    one wav when ``save_path`` is given."""
    if play:
        raise NotImplementedError(
            "playback is not ported yet (ROADMAP.md, Queue 1 item 7: Streaming)")
    if character_name not in _reference_audios:
        logger.error("Call set_reference_audio first to set the reference audio.")
        return None
    synth = _make_synth_fn(character_name, sampling)
    pieces = [a for s in (split_text(text) if split_sentence else [text])
              if (a := synth(s)) is not None]
    audio = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
    if save_path:
        save_path = os.fspath(save_path)
        parent = os.path.dirname(save_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        write_wav(save_path, audio, SAMPLE_RATE)
        logger.info("saved %s", save_path)
    return audio
