"""ERes2NetV2 speaker-verification encoder (V2ProPlus cloning).

The port of ``genie_tts_tpu/models/eres2net.py``: an 80-mel Kaldi fbank
[B, T, 80] -> a 2-D CNN -> a 20480-d embedding (2048 channels x 10
frequency bins flattened channel-major, mean over time). The geometry is
the 3D-Speaker ERes2NetV2 recipe GPT-SoVITS V2ProPlus uses (m_channels
64, baseWidth 24, scale 4, expansion 4, blocks (3, 4, 6, 3)): Res2Net
bottlenecks with hierarchical 3x3 stages; layers 3-4 fuse their groups
with attentional feature fusion (AFF), as does the layer3 -> layer4 skip.
BatchNorms are folded into the convs at conversion time.

The param tree is the JAX package's (HWIO kernels ``[kh, kw, in, out]``,
biases ``[out]``), so one file serves both packages. Here the network
runs in NCHW (frequency as H, time as W) through ``F.conv2d``; each
kernel's OIHW layout is made once per dtype at first use and kept beside
it under ``_wt``. Every conv casts its weights to the activation's dtype,
so a tree loaded in bf16 computes in fp32 on fp32 features, as the JAX
package's does.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict

M_CHANNELS = 64
BASE_WIDTH = 24
SCALE = 4
EXPANSION = 4
NUM_BLOCKS = (3, 4, 6, 3)
EMB_DIM = 20480  # (m*8*expansion) * (80/8) = 2048 * 10


def _weight(p, dtype: torch.dtype) -> torch.Tensor:
    """HWIO -> OIHW in ``dtype``, kept under ``p['_wt']``."""
    wt = p.get("_wt")
    if wt is None or wt.dtype != dtype:
        wt = p["w"].to(dtype).permute(3, 2, 0, 1).contiguous()
        p["_wt"] = wt
    return wt


def conv2d(p, x: torch.Tensor, stride: int = 1, padding: int = 1) -> torch.Tensor:
    """x [B, C_in, H, W] -> [B, C_out, H', W'] (+ the folded bias)."""
    b = p.get("b")
    return F.conv2d(x, _weight(p, x.dtype), None if b is None else b.to(x.dtype),
                    stride=stride, padding=padding)


def conv1x1(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    return conv2d(p, x, stride=stride, padding=0)


def aff(p, x: torch.Tensor, ds_y: torch.Tensor) -> torch.Tensor:
    """Attentional feature fusion: a gate from the concatenation blends
    ``x`` and ``ds_y``."""
    h = F.silu(conv1x1(p["att1"], torch.cat([x, ds_y], dim=1)))
    gate = 1.0 + torch.tanh(conv1x1(p["att2"], h))
    return x * gate + ds_y * (2.0 - gate)


def _res2_stage(p, x: torch.Tensor, use_aff: bool) -> torch.Tensor:
    """Hierarchical Res2Net 3x3 stage over ``SCALE`` channel groups."""
    groups = torch.split(x, x.shape[1] // SCALE, dim=1)
    outs: List[torch.Tensor] = []
    sp = groups[0]
    for i in range(SCALE):
        if i > 0:
            sp = aff(p["fuse"][i - 1], sp, groups[i]) if use_aff else sp + groups[i]
        sp = F.relu(conv2d(p["convs"][i], sp, padding=1))
        outs.append(sp)
    return torch.cat(outs, dim=1)


def res2_block(p, x: torch.Tensor, stride: int, use_aff: bool) -> torch.Tensor:
    out = F.relu(conv1x1(p["conv1"], x, stride=stride))
    out = conv1x1(p["conv3"], _res2_stage(p, out, use_aff))
    sc = conv1x1(p["shortcut"], x, stride=stride) if "shortcut" in p else x
    return F.relu(out + sc)


def apply(params: Params, fbank: torch.Tensor) -> torch.Tensor:
    """[B, T, 80] Kaldi fbank -> [B, 20480] embedding."""
    x = fbank.transpose(1, 2)[:, None]                   # [B, 1, 80, T]
    x = F.relu(conv2d(params["conv1"], x, padding=1))
    strides = (1, 2, 2, 2)
    for li, (blocks, stride) in enumerate(zip(NUM_BLOCKS, strides)):
        for bi in range(blocks):
            x = res2_block(params[f"layer{li + 1}"][bi], x,
                           stride if bi == 0 else 1, li >= 2)
        if li == 2:
            out3 = x
    out3_ds = conv2d(params["layer3_ds"], out3, stride=2, padding=1)
    fused = aff(params["fuse34"], x, out3_ds)            # [B, 2048, 10, T/8]
    B, C, Fq, T = fused.shape
    return fused.reshape(B, C * Fq, T).mean(dim=-1)      # channel-major, then freq


# ---------------------------------------------------------------------------
# Torch checkpoint conversion (3D-Speaker ERes2NetV2 naming, BN folding),
# host-side numpy, as in the JAX package
# ---------------------------------------------------------------------------

def _fold_bn(w, bn_prefix, sd, eps: float = 1e-5):
    """Fold BatchNorm into the preceding conv: (w', b') with the torch conv
    layout [out, in, kh, kw] kept."""
    gamma = np.asarray(sd[f"{bn_prefix}.weight"], np.float64)
    beta = np.asarray(sd[f"{bn_prefix}.bias"], np.float64)
    mean = np.asarray(sd[f"{bn_prefix}.running_mean"], np.float64)
    var = np.asarray(sd[f"{bn_prefix}.running_var"], np.float64)
    scale = gamma / np.sqrt(var + eps)
    w = np.asarray(w, np.float64) * scale[:, None, None, None]
    b = beta - mean * scale
    return w.astype(np.float32), b.astype(np.float32)


def _conv_bn(sd, conv_key, bn_key):
    """Folded conv+BN -> {'w': [kh,kw,in,out], 'b': [out]}."""
    w, b = _fold_bn(sd[f"{conv_key}.weight"], bn_key, sd)
    if f"{conv_key}.bias" in sd:
        # a conv bias flows through the BN: scale * (conv + bias - mean) + beta
        gamma = np.asarray(sd[f"{bn_key}.weight"], np.float64)
        var = np.asarray(sd[f"{bn_key}.running_var"], np.float64)
        b = (b + np.asarray(sd[f"{conv_key}.bias"], np.float64)
             * (gamma / np.sqrt(var + 1e-5))).astype(np.float32)
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}


def _aff_from(sd, prefix):
    """AFF local_att Sequential(conv, BN, SiLU, conv, BN) -> {att1, att2}."""
    return {"att1": _conv_bn(sd, f"{prefix}.local_att.0", f"{prefix}.local_att.1"),
            "att2": _conv_bn(sd, f"{prefix}.local_att.3", f"{prefix}.local_att.4")}


def convert_from_torch(sd) -> Params:
    """3D-Speaker ERes2NetV2 state dict -> param tree (numpy leaves).

    Keys per block ``layer{L}.{i}``: conv1/bn1, convs.{j}/bns.{j} (j <
    SCALE), conv3/bn3, optional shortcut.0/shortcut.1, and in layers 3-4
    fuse_models.{j}.local_att.{0,1,3,4}; top level conv1/bn1, layer3_ds,
    fuse_mode34. Raises KeyError naming what is missing."""
    sd = {k: np.asarray(v) for k, v in sd.items() if hasattr(v, "shape")}
    params: Params = {"conv1": _conv_bn(sd, "conv1", "bn1")}
    for li, blocks in enumerate(NUM_BLOCKS):
        layer = []
        for bi in range(blocks):
            pre = f"layer{li + 1}.{bi}"
            n_convs = len([k for k in sd if k.startswith(f"{pre}.convs.")
                           and k.endswith(".weight")])
            if n_convs != SCALE:
                raise KeyError(
                    f"{pre}: expected {SCALE} res2 convs, found {n_convs}; the "
                    "checkpoint is not a baseWidth=24/scale=4 ERes2NetV2")
            block = {
                "conv1": _conv_bn(sd, f"{pre}.conv1", f"{pre}.bn1"),
                "convs": [_conv_bn(sd, f"{pre}.convs.{j}", f"{pre}.bns.{j}")
                          for j in range(SCALE)],
                "conv3": _conv_bn(sd, f"{pre}.conv3", f"{pre}.bn3"),
            }
            if f"{pre}.shortcut.0.weight" in sd:
                block["shortcut"] = _conv_bn(sd, f"{pre}.shortcut.0", f"{pre}.shortcut.1")
            if f"{pre}.fuse_models.0.local_att.0.weight" in sd:
                block["fuse"] = [_aff_from(sd, f"{pre}.fuse_models.{j}")
                                 for j in range(SCALE - 1)]
            layer.append(block)
        params[f"layer{li + 1}"] = layer
    ds = {"w": np.transpose(sd["layer3_ds.weight"], (2, 3, 1, 0))}
    if "layer3_ds.bias" in sd:
        ds["b"] = sd["layer3_ds.bias"].astype(np.float32)
    params["layer3_ds"] = ds
    params["fuse34"] = _aff_from(sd, "fuse_mode34")
    return params


# ---------------------------------------------------------------------------
# Random init (tests and the chip smoke run; real weights are converted)
# ---------------------------------------------------------------------------

# the scale of each residual branch's last conv in random weights, as a
# share of the fan-in scale (see init_params)
BRANCH_SCALE = 0.3


def init_params(generator: torch.Generator, dtype=torch.bfloat16) -> Params:
    """Random ERes2NetV2 weights on ``generator``'s device, in the JAX
    package's tree (HWIO kernels, zero biases), every kernel at the
    fan-in scale except ``conv3``, the last of each residual branch, which
    starts at ``BRANCH_SCALE`` of it. At the full scale (the JAX package's
    init) the residual sums grow block by block, and the AFF blocks of
    layers 3-4 amplify fp32 rounding about 1e5-fold (a 5 s clip's
    embedding in fp32 is 1.7e-2 from fp64, relative L2), so no two fp32
    implementations agree on such weights; at 0.3 it is 1e-7, as for the
    batch-normed weights of a trained checkpoint."""
    dev = generator.device

    def conv(kh, kw, cin, cout, gain=1.0):
        w = torch.randn((kh, kw, cin, cout), generator=generator, device=dev)
        return {"w": (w * gain * (kh * kw * cin) ** -0.5).to(dtype),
                "b": torch.zeros((cout,), dtype=dtype, device=dev)}

    def block(in_c, planes, stride, use_aff):
        width = int(math.floor(planes * BASE_WIDTH / 64.0))
        p = {"conv1": conv(1, 1, in_c, width * SCALE),
             "convs": [conv(3, 3, width, width) for _ in range(SCALE)],
             "conv3": conv(1, 1, width * SCALE, planes * EXPANSION, BRANCH_SCALE)}
        if use_aff:
            inter = max(width // 4, 4)
            p["fuse"] = [{"att1": conv(1, 1, 2 * width, inter),
                          "att2": conv(1, 1, inter, width)} for _ in range(SCALE - 1)]
        if stride != 1 or in_c != planes * EXPANSION:
            p["shortcut"] = conv(1, 1, in_c, planes * EXPANSION)
        return p

    params: Params = {"conv1": conv(3, 3, 1, M_CHANNELS)}
    in_c = M_CHANNELS
    for li, (blocks, stride) in enumerate(zip(NUM_BLOCKS, (1, 2, 2, 2))):
        planes = M_CHANNELS * (2 ** li)
        layer = []
        for bi in range(blocks):
            layer.append(block(in_c, planes, stride if bi == 0 else 1, li >= 2))
            in_c = planes * EXPANSION
        params[f"layer{li + 1}"] = layer
    c4, c3 = M_CHANNELS * 8 * EXPANSION, M_CHANNELS * 4 * EXPANSION
    params["layer3_ds"] = conv(3, 3, c3, c4)
    params["fuse34"] = {"att1": conv(1, 1, 2 * c4, c4 // 4),
                        "att2": conv(1, 1, c4 // 4, c4)}
    return params
