"""Public Python API of the port: load_character, set_reference_audio, tts.

The solo, synchronous subset of ``genie_tts_tpu/api.py``, and its
in-flight slot serving route (``_make_synth_fn(use_batcher=True)``, one
``runtime/slot_batcher.py`` scheduler per character). Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; with no GPU and no
device named they raise. Streaming sessions, playback, the window batcher
and the server are later slices (ROADMAP.md).
"""
from __future__ import annotations

import logging
import os
import threading
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
    # popped under the lock: a concurrent first request in get_slot_batcher
    # must not re-insert a batcher for the character being unloaded
    with _slot_batchers_lock:
        sb = _slot_batchers.pop(character_name, None)
    if sb is not None:
        sb.stop()


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

_slot_batchers: dict = {}
_slot_batchers_lock = threading.Lock()


def get_slot_batcher(char):
    """Lazy per-character SlotBatcher (in-flight continuous batching).

    Locked: two concurrent first requests must not each build a batcher
    (the loser would leak a scheduler thread and a slot KV cache)."""
    with _slot_batchers_lock:
        sb = _slot_batchers.get(char.name)
        if sb is None:
            from .runtime.slot_batcher import SlotBatcher

            # serving emits PCM16, made on the device
            sb = SlotBatcher(engine, char, pcm16=True)
            _slot_batchers[char.name] = sb
        return sb


def _make_synth_fn(character_name: str, sampling: Optional[SamplingConfig] = None,
                   use_batcher: bool = False):
    """The synthesis function of one character: sentence -> waveform.

    ``use_batcher`` (the serving route): a sentence that fits the slot
    machine's buckets joins the character's slot batcher and comes back
    as int16 PCM, decoding in flight beside concurrent requests (with
    ``RuntimeConfig.serve_slots``). Until the window batcher is ported
    (ROADMAP.md, Queue 1 item 8), a sentence that does not fit is
    synthesized solo, as float32. Without ``use_batcher`` every sentence
    is synthesized solo."""
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
        if use_batcher and engine.cfg.serve_slots:
            # per-request sampling joins too: it is per-row slot state
            sb = get_slot_batcher(char)
            if sb.fits(feats, phones):
                return sb.synthesize(feats, phones, bert, sampling=sampling)
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
