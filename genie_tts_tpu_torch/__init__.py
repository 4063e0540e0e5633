"""genie-tts-tpu-torch: the PyTorch/CUDA port of genie-tts-tpu.

GPT-SoVITS voice-cloning TTS for an NVIDIA H100 (PyTorch, with
hand-written CUDA kernels for the decode step). It imports nothing of the
JAX package ``genie_tts_tpu``, which stays the reference it is tested
against. Entry points run on ``cuda`` unless ``device="cpu"`` is passed.
"""
from .api import (
    clear_reference_audio_cache,
    convert_model,
    convert_to_onnx,
    load_character,
    set_reference_audio,
    start_server,
    stop,
    tts,
    tts_async,
    unload_character,
    wait_for_playback_done,
)

__version__ = "0.1.0"

__all__ = [
    "load_character",
    "unload_character",
    "set_reference_audio",
    "tts",
    "tts_async",
    "stop",
    "wait_for_playback_done",
    "clear_reference_audio_cache",
    "start_server",
    "convert_model",
    "convert_to_onnx",
]
