"""genie-tts-tpu-torch: the PyTorch/CUDA port of genie-tts-tpu.

GPT-SoVITS voice-cloning TTS for an NVIDIA H100 (PyTorch, with
hand-written CUDA kernels for the decode step). It imports nothing of the
JAX package ``genie_tts_tpu``, which stays the reference it is tested
against. Entry points run on ``cuda`` unless ``device="cpu"`` is passed.
"""
from .api import (
    load_character,
    set_reference_audio,
    tts,
    unload_character,
)

__version__ = "0.1.0"

__all__ = [
    "load_character",
    "unload_character",
    "set_reference_audio",
    "tts",
]
