"""Speaker-verification embedding: the V2ProPlus cloning surface.

The port of ``genie_tts_tpu/models/sv.py``: a 16 kHz waveform -> Kaldi
fbank (``ops/audio.py::kaldi_fbank``) -> ERes2NetV2
(``models/eres2net.py``) -> a 20480-d embedding, which the prompt encoder
takes. The model is read from ``config.sv_model_path()``
(``GENIE_SV_MODEL``, else ``GENIE_DATA_DIR/speaker_encoder.safetensors``)
with the port's own reader; a function may be injected instead
(:func:`set_sv_fn`, for tests and plugins).
"""
from __future__ import annotations

import logging
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..config import resolve_device, sv_model_path

logger = logging.getLogger(__name__)

SV_EMB_DIM = 20480

SvFn = Callable[[np.ndarray], np.ndarray]

_custom_fn: Optional[SvFn] = None
_loaded_fns: Dict[torch.device, SvFn] = {}
_load_lock = threading.Lock()


def set_sv_fn(fn: Optional[SvFn]) -> None:
    """Inject a speaker-verification embedding function (tests, plugins);
    None restores the model read from disk."""
    global _custom_fn
    _custom_fn = fn


def make_sv_fn(params, device) -> SvFn:
    """audio_16k -> [20480] fp32 from an ERes2NetV2 param tree on
    ``device``. Features and activations are fp32 whatever the weights'
    dtype (each conv casts its weights to fp32)."""
    from ..ops.audio import kaldi_fbank
    from . import eres2net

    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(audio_16k: np.ndarray) -> np.ndarray:
        audio = torch.as_tensor(np.asarray(audio_16k, np.float32), device=dev)[None]
        return eres2net.apply(params, kaldi_fbank(audio))[0].cpu().numpy()

    return fn


def get_sv_fn(device=None) -> Optional[SvFn]:
    """The audio_16k -> [20480] function on ``device`` (cuda unless
    named), or None with a warning when the model file is missing."""
    if _custom_fn is not None:
        return _custom_fn
    dev = resolve_device(device)
    path = sv_model_path()
    with _load_lock:
        if dev in _loaded_fns:
            return _loaded_fns[dev]
        if path.is_file():
            from ..convert.io import load_params

            # the compute dtype, as the JAX package loads it: bf16 weights
            # computed in fp32
            _loaded_fns[dev] = make_sv_fn(load_params(path, torch.bfloat16, dev), dev)
            return _loaded_fns[dev]
    logger.warning("SV model unavailable (%s); V2ProPlus cloning disabled", path)
    return None
