"""chinese-hubert-base SSL feature extractor.

The port of ``genie_tts_tpu/models/hubert.py``: 16 kHz reference audio ->
``ssl_content`` [B, T, 768] for the T2S prompt tokens. A 7-layer conv
waveform frontend (stride 320, GroupNorm on the first layer, exact GELU),
feature projection (LN + 512->768), a grouped convolutional position
embedding (k128, 16 groups; the even kernel leaves one extra frame, which
is trimmed), then post-norm transformer layers.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..config import HubertConfig
from ..ops.layers import attention, conv1d, conv1d_ncw, layer_norm, linear, unstack

Params = Dict


def _group_norm(p, x):
    """Per-channel norm over time ([B, C, T]; groups == channels)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + 1e-5) * p["scale"][None, :, None] \
        + p["bias"][None, :, None]
    return y.to(x.dtype)


def feature_extractor(params, audio: torch.Tensor, cfg: HubertConfig) -> torch.Tensor:
    """[B, S] waveform -> [B, S//320, 512] conv features."""
    x = audio[:, None, :]                                 # NCW
    for i, s in enumerate(cfg.conv_strides):
        p = params["conv_layers"][i]
        x = conv1d_ncw(p, x, stride=s)
        if i == 0:
            x = _group_norm(p["norm"], x)
        x = F.gelu(x)
    return x.transpose(1, 2)


def encoder_layer(lp, x, cfg: HubertConfig):
    """Post-norm transformer layer."""
    B, T, D = x.shape
    H = cfg.num_heads

    def heads(t):
        return t.reshape(B, T, H, D // H).transpose(1, 2)

    att = attention(heads(linear(lp["q"], x)), heads(linear(lp["k"], x)),
                    heads(linear(lp["v"], x)))
    att = att.transpose(1, 2).reshape(B, T, D)
    x = layer_norm(lp["norm1"], x + linear(lp["out"], att))
    ff = linear(lp["ffn2"], F.gelu(linear(lp["ffn1"], x)))
    return layer_norm(lp["norm2"], x + ff)


def apply(params: Params, audio: torch.Tensor, cfg: HubertConfig) -> torch.Tensor:
    """16 kHz waveform [B, S] -> SSL features [B, S//320, 768]."""
    x = feature_extractor(params, audio, cfg)
    x = layer_norm(params["fp_norm"], x)
    x = linear(params["fp_proj"], x)
    pos = conv1d(params["pos_conv"], x, padding=cfg.conv_pos_kernel // 2,
                 groups=cfg.conv_pos_groups)
    pos = F.gelu(pos[:, : x.shape[1]])
    x = layer_norm(params["enc_norm"], x + pos)
    for lp in unstack(params["layers"]):
        x = encoder_layer(lp, x, cfg)
    return x


def init_params(generator: torch.Generator, cfg: HubertConfig,
                dtype=torch.bfloat16) -> Params:
    """Random HuBERT weights on ``generator``'s device."""
    dev = generator.device
    D, Fd, L = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers
    C = cfg.conv_dims[0]

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def dense(i, o):
        return {"w": randn(L, i, o, std=i ** -0.5),
                "b": torch.zeros((L, o), dtype=dtype, device=dev)}

    def ln(n, lead=()):
        return {"scale": torch.ones(lead + (n,), device=dev),
                "bias": torch.zeros(lead + (n,), device=dev)}

    conv_layers = []
    in_c = 1
    for i, k_w in enumerate(cfg.conv_kernels):
        p = {"w": randn(k_w, in_c, C, std=(in_c * k_w) ** -0.5)}
        if i == 0:
            p["norm"] = ln(C)
        conv_layers.append(p)
        in_c = C
    G = cfg.conv_pos_groups
    return {
        "conv_layers": conv_layers,
        "fp_norm": ln(C),
        "fp_proj": {"w": randn(C, D, std=C ** -0.5),
                    "b": torch.zeros((D,), dtype=dtype, device=dev)},
        "pos_conv": {"w": randn(cfg.conv_pos_kernel, D // G, D, std=0.02),
                     "b": torch.zeros((D,), dtype=dtype, device=dev)},
        "enc_norm": ln(D),
        "layers": {"q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
                   "out": dense(D, D), "norm1": ln(D, (L,)),
                   "ffn1": dense(D, Fd), "ffn2": dense(Fd, D),
                   "norm2": ln(D, (L,))},
    }
