"""chinese-hubert-base (HuBERT base) SSL features in plain PyTorch.

The published architecture: seven 1-D convolutions over the 16 kHz
waveform (stride 320 in all, the first followed by a per-channel norm
over time), exact GELU, LayerNorm and a 512 -> 768 projection, a grouped
convolutional position embedding (width 128, 16 groups, its extra frame
dropped), LayerNorm, then twelve post-LN transformer layers. Weights in
the converted tree's layout: a conv's ``w`` as [width, in/groups, out],
a dense ``w`` as [in, out], layers stacked on a leading axis."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

STRIDES = (5, 2, 2, 2, 2, 2, 2)


def _ln(x, p, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), eps)


def _conv(w, x, act=torch.float32, **kw):
    return F.conv1d(x.to(act), w.float().permute(2, 1, 0).to(act), **kw).float()


def features(p: Dict, audio: torch.Tensor, num_heads: int = 12,
             act=torch.float32) -> torch.Tensor:
    """[S] float waveform at 16 kHz -> [T, 768] float32; ``act`` is the
    dtype of the convolutions and matmuls (the control's bfloat16)."""
    x = audio.float()[None, None]
    for i, s in enumerate(STRIDES):
        cp = p["conv_layers"][i]
        x = _conv(cp["w"], x, act, stride=s)
        if i == 0:
            m = x.mean(-1, keepdim=True)
            v = x.var(-1, unbiased=False, keepdim=True)
            x = (x - m) * torch.rsqrt(v + 1e-5) * cp["norm"]["scale"].float()[None, :, None] \
                + cp["norm"]["bias"].float()[None, :, None]
        x = F.gelu(x)
    x = x.transpose(1, 2)[0]                                   # [T, 512]
    x = _ln(x, p["fp_norm"])
    x = (x.to(act) @ p["fp_proj"]["w"].float().to(act)).float() + p["fp_proj"]["b"].float()
    w = p["pos_conv"]["w"]
    groups = x.shape[-1] // w.shape[1]
    pos = _conv(w, x.T[None], act, padding=w.shape[0] // 2, groups=groups)[0].T
    pos = pos + p["pos_conv"]["b"].float()
    x = _ln(x + F.gelu(pos[: x.shape[0]]), p["enc_norm"])
    T, D = x.shape
    H = num_heads
    L = p["layers"]["q"]["w"].shape[0]
    for l in range(L):
        lay = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in p["layers"].items()
               if not k.startswith("_")}

        def dense(name, t):
            return (t.to(act) @ lay[name]["w"].float().to(act)).float() + lay[name]["b"].float()

        q, k, v = (dense(n, x).reshape(T, H, D // H).transpose(0, 1) for n in "qkv")
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), -1) @ v
        x = _ln(x + dense("out", att.transpose(0, 1).reshape(T, D)), lay["norm1"])
        x = _ln(x + dense("ffn2", F.gelu(dense("ffn1", x))), lay["norm2"])
    return x
