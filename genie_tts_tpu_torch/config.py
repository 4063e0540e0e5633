"""Configuration: model hyperparameters, the runtime fields the port reads,
and device selection.

Own copy of the dataclasses of ``genie_tts_tpu/config.py`` (the port
imports nothing of the JAX package). Field names and defaults are the
same, so a character's ``config.json`` overrides apply unchanged.
"""
from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Optional, Tuple, Union

import torch


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class T2SConfig:
    """Text-to-semantic GPT decoder (AR transformer)."""
    phoneme_vocab: int = 732
    semantic_vocab: int = 1025        # 1024 codes + EOS (id 1024)
    embed_dim: int = 512
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 2048
    bert_dim: int = 1024
    ssl_dim: int = 768
    eos_id: int = 1024
    max_decode_steps: int = 500

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


@dataclasses.dataclass(frozen=True)
class SoVITSConfig:
    """VITS/SoVITS synthesizer (text encoder + MRTE, RVQ, flow, HiFi-GAN)."""
    spec_channels: int = 1025
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    mrte_channels: int = 512
    ssl_dim: int = 768
    vq_codes: int = 1024
    vq_dim: int = 768
    gin_channels: int = 512
    flow_layers: int = 4
    wn_layers: int = 4
    wn_kernel: int = 5
    upsample_rates: Tuple[int, ...] = (10, 8, 2, 2, 2)   # hop 640 @ 32 kHz
    upsample_kernels: Tuple[int, ...] = (16, 16, 8, 2, 2)
    upsample_initial: int = 512
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    sample_rate: int = 32000
    hop_length: int = 640
    n_fft: int = 2048
    win_length: int = 2048
    semantic_frame_rate: int = 25
    version: str = "v2"
    sv_dim: int = 20480


@dataclasses.dataclass(frozen=True)
class HubertConfig:
    """chinese-hubert-base SSL feature extractor."""
    conv_dims: Tuple[int, ...] = (512,) * 7
    conv_strides: Tuple[int, ...] = (5, 2, 2, 2, 2, 2, 2)
    conv_kernels: Tuple[int, ...] = (10, 3, 3, 3, 3, 2, 2)
    embed_dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    ffn_dim: int = 3072
    conv_pos_kernel: int = 128
    conv_pos_groups: int = 16
    sample_rate: int = 16000


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false", "off")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The runtime knobs of the solo synthesis path and of in-flight slot
    serving (``runtime/slot_batcher.py``)."""
    compute_dtype: str = "bfloat16"
    phoneme_buckets: Tuple[int, ...] = (32, 64, 128, 256)
    prompt_buckets: Tuple[int, ...] = (128, 256, 512)
    frame_buckets: Tuple[int, ...] = (64, 128, 192, 256, 512)
    # static decode-cap ladder: sizes the token buffer, the Gumbel table
    # and the KV cache of one utterance
    step_caps: Tuple[int, ...] = (64, 128, 256, 512)
    # batch ladder the pooled slot finisher pads its vocode batch to
    batch_buckets: Tuple[int, ...] = (1, 2, 4, 8)
    # In-flight (slot) serving: a persistent slot_batch-slot decode machine
    # advances slot_steps tokens per dispatch (a "segment"); requests join
    # free slots between segments. Packed phonemes <= slot_phoneme_bucket,
    # prompts <= slot_prompt_bucket, a decode ring of slot_ring tokens
    # (rounded up to a slot_steps multiple, and at most max_decode_steps).
    slot_batch: int = 8
    slot_steps: int = 32
    slot_ring: int = 512
    slot_phoneme_bucket: int = 192
    slot_prompt_bucket: int = 192
    # finished rows pool for one batched vocode: flush at
    # slot_finisher_batch rows, after slot_finisher_wait_segs segments, or
    # at once when the machine idles or starves
    slot_finisher_batch: int = 4
    slot_finisher_wait_segs: int = 2
    # int8 KV cache for the slot machine (models/slots.py kv_int8): the big
    # caches hold int8 codes + per-column fp32 scales, and the big-cache
    # attention runs through ops/int8_decode.py. GENIE_SLOT_KV_INT8=1 opts
    # in; off by default, as in the JAX package.
    slot_kv_int8: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "GENIE_SLOT_KV_INT8", "0").lower() in ("1", "true", "on"))
    # serving requests (api._make_synth_fn(use_batcher=True)) that fit the
    # slot buckets join the slot machine; GENIE_SLOT_SERVING=0 serves them
    # solo
    serve_slots: bool = dataclasses.field(
        default_factory=lambda: _env_flag("GENIE_SLOT_SERVING", "1"))
    # weight-only int8 T2S decoder matmuls, applied at character load
    # (models/t2s.py::quantize_params); GENIE_T2S_INT8=0 keeps the
    # compute-dtype weights
    t2s_int8: bool = dataclasses.field(
        default_factory=lambda: _env_flag("GENIE_T2S_INT8", "1"))
    # chunked HiFi-GAN: latent frames per chunk and the halo on each side
    # (the generator's receptive field is ~14 frames)
    vocode_chunk: int = 256
    vocode_halo: int = 24
    # decode caps up to this many codes vocode the whole cap in one pass
    # right after decode (the "fused" branch); larger caps first read the
    # emitted length and vocode a frame bucket of it (the "staged" branch)
    solo_fused_max_codes: int = dataclasses.field(
        default_factory=lambda: _env_int("GENIE_SOLO_FUSED", 256))
    max_cached_characters: int = dataclasses.field(
        default_factory=lambda: _env_int("Max_Cached_Character_Models", 3))
    max_cached_reference_audio: int = dataclasses.field(
        default_factory=lambda: _env_int("Max_Cached_Reference_Audio", 10))


# ---------------------------------------------------------------------------
# Paths (GenieData layout)
# ---------------------------------------------------------------------------

HUBERT_DIR_ENV = "GENIE_HUBERT_DIR"


def genie_data_dir() -> Path:
    return Path(os.environ.get("GENIE_DATA_DIR", "./GenieData"))


def hubert_dir() -> Path:
    if HUBERT_DIR_ENV in os.environ:
        return Path(os.environ[HUBERT_DIR_ENV])
    return genie_data_dir() / "chinese-hubert-base"


# ---------------------------------------------------------------------------
# Device and dtype
# ---------------------------------------------------------------------------

def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no device is named and there is no GPU, so a run
    never carries on silently on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda")
    return torch.device(device)


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  cfg: Optional[RuntimeConfig] = None) -> torch.dtype:
    """Compute dtype: an explicit torch dtype or name, else the runtime
    config's ``compute_dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype or (cfg or RuntimeConfig()).compute_dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
