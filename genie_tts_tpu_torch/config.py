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
class V4Config:
    """GPT-SoVITS V4's mel side (``SynthesizerTrnV3``, ``version="v4"``):
    the mel-rate bridge and WaveNet after V2's text encoder, the DiT under
    conditional flow matching, the prompted chunk loop, the prompt mel and
    the 48 kHz HiFi-GAN (``models/sovits_v4.py``). The text side is the
    character's ``SoVITSConfig``."""
    fea_channels: int = 512           # bridge, WaveNet (wns1) and DiT text width
    wn_layers: int = 8
    wn_kernel: int = 5
    frames_per_code: int = 4          # 25 Hz codes -> 100 Hz mel frames
    dit_dim: int = 1024
    dit_depth: int = 22
    dit_heads: int = 16
    dit_head_dim: int = 64
    dit_ff_mult: int = 2
    mel_dim: int = 100
    text_conv_layers: int = 4
    text_conv_mult: int = 2
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    freq_embed_dim: int = 256
    sample_steps: int = 32            # Euler steps (inference_cfg_rate 0)
    T_ref: int = 500                  # most prompt frames a chunk keeps
    T_chunk: int = 1000               # prompt + new frames of one chunk
    # the prompt mel: the 32 kHz clip, Slaney filterbank, log, normalised
    mel_n_fft: int = 1280
    mel_hop: int = 320
    mel_win: int = 1280
    mel_fmin: float = 0.0
    mel_fmax: float = 16000.0
    mel_sample_rate: int = 32000
    # the vocoder: 100 mel bands at 100 frames/s -> 48 kHz (480 samples a frame)
    upsample_rates: Tuple[int, ...] = (10, 6, 2, 2, 2)
    upsample_kernels: Tuple[int, ...] = (20, 12, 4, 4, 4)
    upsample_initial: int = 512
    resblock_kernels: Tuple[int, ...] = (3, 7, 11)
    resblock_dilations: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    sample_rate: int = 48000

    @property
    def hop_length(self) -> int:
        """Output samples a mel frame."""
        n = 1
        for u in self.upsample_rates:
            n *= u
        return n

    @property
    def samples_per_code(self) -> int:
        return self.frames_per_code * self.hop_length


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


@dataclasses.dataclass(frozen=True)
class RobertaConfig:
    """chinese-roberta-wwm-ext-large for per-phoneme BERT features."""
    vocab_size: int = 21128
    embed_dim: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    ffn_dim: int = 4096
    max_position: int = 512
    type_vocab: int = 2
    feature_layer: int = -3           # third-to-last hidden state


def _env_flag(name: str, default: str) -> bool:
    return os.environ.get(name, default).lower() not in ("0", "false", "off")


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """The runtime knobs of the solo synthesis path, of in-flight slot
    serving (``runtime/slot_batcher.py``), of streaming (``runtime/
    stream.py``, the fused stream head, slot-joined streams) and of the
    window batcher (``runtime/batcher.py``)."""
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
    # streaming: the fused stream head's FIRST chunk is smaller so first
    # audio lands sooner (its vocode window is first + halo frames)
    stream_first_chunk: int = 48
    # slot streaming: a streaming row's first piece is this many latent
    # frames, vocoded speculatively behind the row's first segment when
    # the claimed tokens (first_piece/2 + lookahead) fit in it; 0 waits
    # for a full vocode_chunk
    slot_first_piece: int = 16
    # segment width while a streaming row owes its first piece (must
    # divide the ring; 0 keeps slot_steps always)
    slot_join_steps: int = 16
    # segmented streaming (runtime/stream.py): decode in stream_seg_steps
    # segments on a solo slot machine, audio windows from the prefix of
    # decoded codes; GENIE_STREAM_SEGMENTED=0 keeps the exact fused head
    stream_segmented: bool = dataclasses.field(
        default_factory=lambda: _env_flag("GENIE_STREAM_SEGMENTED", "1"))
    stream_seg_steps: int = 16
    # emitted frames trail the decode frontier by this many codes
    stream_lookahead: int = 8
    stream_chunk: int = 64            # follow-up window stride
    # every slot row pumps windows during decode (GENIE_SLOT_WINDOWS=1);
    # off by default: only streaming rows pump
    slot_stream_finisher: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "GENIE_SLOT_WINDOWS", "0").lower() in ("1", "true", "on"))
    # serving (HTTP /tts): sentences go through the slot machine or the
    # window batcher; GENIE_SERVE_BATCHING=0 synthesizes each solo
    serve_batching: bool = dataclasses.field(
        default_factory=lambda: _env_flag("GENIE_SERVE_BATCHING", "1"))
    batch_max: int = dataclasses.field(
        default_factory=lambda: _env_int("GENIE_BATCH_MAX", 8))
    batch_window_ms: float = dataclasses.field(
        default_factory=lambda: float(
            os.environ.get("GENIE_BATCH_WINDOW_MS", 8.0)))
    max_cached_characters: int = dataclasses.field(
        default_factory=lambda: _env_int("Max_Cached_Character_Models", 3))
    max_cached_reference_audio: int = dataclasses.field(
        default_factory=lambda: _env_int("Max_Cached_Reference_Audio", 10))


def _deep_tuple(v):
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def config_from(cls, overrides, **defaults):
    """``cls`` with the fields of ``overrides`` that it has (a character's
    or a shared model's ``config.json`` may override hyperparameters;
    tuple fields arrive as lists)."""
    fields = {f.name for f in dataclasses.fields(cls)}
    kw = dict(defaults)
    for k, v in (overrides or {}).items():
        if k in fields:
            kw[k] = _deep_tuple(v)
    return cls(**kw)


# ---------------------------------------------------------------------------
# Paths (GenieData layout)
# ---------------------------------------------------------------------------

HUBERT_DIR_ENV = "GENIE_HUBERT_DIR"
ROBERTA_DIR_ENV = "GENIE_ROBERTA_DIR"
SV_MODEL_ENV = "GENIE_SV_MODEL"
CHINESE_G2P_ENV = "GENIE_CHINESE_G2P_DIR"
ENGLISH_G2P_ENV = "GENIE_ENGLISH_G2P_DIR"


def genie_data_dir() -> Path:
    return Path(os.environ.get("GENIE_DATA_DIR", "./GenieData"))


def asset_path(name: str, env_override: Optional[str] = None) -> Path:
    if env_override and env_override in os.environ:
        return Path(os.environ[env_override])
    return genie_data_dir() / name


def hubert_dir() -> Path:
    return asset_path("chinese-hubert-base", HUBERT_DIR_ENV)


def roberta_dir() -> Path:
    """``roberta.safetensors`` and its ``tokenizer.json``."""
    return asset_path("RoBERTa", ROBERTA_DIR_ENV)


def chinese_g2p_dir() -> Path:
    return asset_path("G2P/Chinese", CHINESE_G2P_ENV)


def english_g2p_dir() -> Path:
    return asset_path("G2P/English", ENGLISH_G2P_ENV)


def sv_model_path() -> Path:
    """The ERes2NetV2 speaker-verification checkpoint (V2ProPlus)."""
    return asset_path("speaker_encoder.safetensors", SV_MODEL_ENV)


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


def indexed_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` with its card's index: a bare ``cuda`` and the tensors on
    it (``cuda:0``) name one card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype, None],
                  cfg: Optional[RuntimeConfig] = None) -> torch.dtype:
    """Compute dtype: an explicit torch dtype or name, else the runtime
    config's ``compute_dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype or (cfg or RuntimeConfig()).compute_dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
