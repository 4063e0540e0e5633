"""Operations of GPT-SoVITS V4's work, from the configuration's shapes and
the lengths the traffic reaches (the same whatever implements it).

Counts are of multiply-adds times two. The decoder, RoBERTa and V2's
text side are ``work/gpt_sovits.py``'s. V4's own: ``decode_encp``'s
bridge and WaveNet at 100 frames/s; the DiT of each Euler step over a
chunk of T frames (its prompt included), whose attention is full over
the chunk (T^2), with its text embedding once a chunk; the 48 kHz
HiFi-GAN over 4 frames a code. The peaks are one H100 SXM's (NVIDIA's
data sheet, dense): 989 TFLOP/s in bfloat16."""
from __future__ import annotations

from typing import Dict

from perfbench.harness import spec

_v2 = spec.work("gpt_sovits")
PEAK_BF16_FLOPS = _v2.PEAK_BF16_FLOPS
HBM_BYTES_PER_S = _v2.HBM_BYTES_PER_S
t2s_flops = _v2.t2s_flops
roberta_flops = _v2.roberta_flops


def _v4(cfg: Dict) -> Dict:
    return cfg["v4"]


def dit_frame_macs(cfg: Dict) -> int:
    """Multiply-adds of one DiT forward per frame, apart from attention's
    T^2 part: the input projection, the convolutional position embedding,
    each block's q, k, v, out and feed-forward, the output projection."""
    v = _v4(cfg)
    D, M, C = v["dit_dim"], v["mel_dim"], v["fea_channels"]
    inner = v["dit_heads"] * v["dit_head_dim"]
    conv_pos = 2 * v["conv_pos_kernel"] * (D // v["conv_pos_groups"]) * D
    block = 4 * D * inner + 2 * D * v["dit_ff_mult"] * D
    return (2 * M + C) * D + conv_pos + v["dit_depth"] * block + D * M


def dit_attention_macs(cfg: Dict) -> int:
    """Multiply-adds per frame^2 of one forward: QK^T and PV in every block."""
    v = _v4(cfg)
    return v["dit_depth"] * 2 * v["dit_heads"] * v["dit_head_dim"]


def dit_forward_macs(cfg: Dict) -> int:
    """Multiply-adds of one forward that do not scale with frames: the
    adaLN modulations of every block and of the output, the time embedding."""
    v = _v4(cfg)
    D = v["dit_dim"]
    return v["dit_depth"] * 6 * D * D + 2 * D * D + v["freq_embed_dim"] * D + D * D


def text_frame_macs(cfg: Dict) -> int:
    """The text embedding's ConvNeXt-V2 blocks per frame (once a chunk)."""
    v = _v4(cfg)
    C = v["fea_channels"]
    return v["text_conv_layers"] * (7 * C + 2 * C * C * v["text_conv_mult"])


def dit_flops(cfg: Dict, forwards: float, frames: float, frames_sq: float) -> float:
    """The DiT's work over ``forwards`` forwards of ``frames`` frames in all
    (Σ steps x T) and ``frames_sq`` (Σ steps x T^2): the counters
    ``cfm_forwards``, ``cfm_frames`` and ``cfm_frames_sq``."""
    steps = _v4(cfg)["sample_steps"]
    return 2.0 * (dit_frame_macs(cfg) * frames + dit_attention_macs(cfg) * frames_sq
                  + dit_forward_macs(cfg) * forwards + text_frame_macs(cfg) * frames / steps)


def prompt_frames(cfg: Dict) -> int:
    """P, a chunk's prompt frames: the clip's mel frames, at most T_ref
    (the prompt codes' frames are more here: 4 x tokens of the clip with
    its appended silence)."""
    v = _v4(cfg)
    mel = int(float(cfg["reference_clip"]["seconds"]) * v["mel_sample_rate"]) // v["mel_hop"]
    return min(mel, v["T_ref"])


def chunk_frames(cfg: Dict, codes: int):
    """T of each chunk of a request of ``codes`` codes (prompt + slice)."""
    v = _v4(cfg)
    P = prompt_frames(cfg)
    F = v["frames_per_code"] * codes
    step = v["T_chunk"] - P
    return [P + min(step, F - s) for s in range(0, F, step)]


def cfm_flops(cfg: Dict, codes: int) -> float:
    steps = _v4(cfg)["sample_steps"]
    T = chunk_frames(cfg, codes)
    return dit_flops(cfg, steps * len(T), steps * sum(T), steps * sum(t * t for t in T))


def encp_flops(cfg: Dict, codes: int, text: int) -> float:
    """V2's text side (no flow), the bridge, and ``wns1`` at 4 frames a code."""
    v, s = _v4(cfg), cfg["sovits"]
    text_side = _v2.latent_flops(dict(cfg, sovits=dict(s, flow_layers=0)), codes, text)
    C, k, L = v["fea_channels"], v["wn_kernel"], v["wn_layers"]
    T4 = v["frames_per_code"] * codes
    wn = L * (k * C * 2 * C + C * 2 * C)
    return text_side + 2.0 * (2 * codes * int(s["hidden_channels"]) * C
                              + T4 * (C * C + wn + C * C))


def vocoder_flops(cfg: Dict, codes: int) -> float:
    v = _v4(cfg)
    dec = {"upsample_initial": v["upsample_initial"], "inter_channels": v["mel_dim"],
           "upsample_rates": v["upsample_rates"], "upsample_kernels": v["upsample_kernels"],
           "resblock_kernels": v["resblock_kernels"],
           "resblock_dilations": v["resblock_dilations"]}
    return _v2.hifigan_flops({"sovits": dec}, v["frames_per_code"] * codes)


def request_flops(cfg: Dict, ctx: int, codes: int, text: int, tokens: int = 0) -> float:
    """One request: decoder, ``decode_encp``, the CFM's chunks (prompt
    frames included), the 48 kHz vocoder, and RoBERTa over its tokens."""
    f = t2s_flops(cfg, ctx, codes) + encp_flops(cfg, codes, text) + cfm_flops(cfg, codes) \
        + vocoder_flops(cfg, codes)
    if cfg.get("roberta") and tokens:
        f += roberta_flops(cfg, tokens)
    return f
