"""Shared neural-net building blocks (plain functions over param trees).

Conventions, the same as ``genie_tts_tpu/ops/layers.py``:

* params are nested dicts of tensors;
* linear weights are stored ``[in, out]`` (``x @ w + b``);
* conv1d weights are stored ``[width, in/groups, out]``; the layout
  ``F.conv1d`` takes (``[out, in/groups, width]``) is made once per weight
  and dtype, at its first use, and kept beside it under the key ``_wt``;
* activations are ``[B, T, C]`` at the public functions (the ``_ncw``
  forms take ``[B, C, T]``);
* mixed-dtype products compute in the promoted dtype and return the
  activation's dtype, as ``jnp.dot(..., preferred_element_type=x.dtype)``
  does; LayerNorm statistics and softmax run in fp32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two (as jnp.dot promotes),
    cast to ``out_dtype`` (default: the promoted dtype)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    y = x.to(dt) @ w.to(dt)
    return y if out_dtype is None else y.to(out_dtype)


def unstack(tree) -> list:
    """Per-layer views of a tree whose leaves are stacked ``[L, ...]``.

    Made once and kept under ``tree['_layers']``, so what a layer caches
    beside its weights (``_wt``) outlives the call."""
    cached = tree.get("_layers")
    if cached is None:
        def index(node, l):
            if isinstance(node, dict):
                return {k: index(v, l) for k, v in node.items()
                        if not k.startswith("_")}
            if isinstance(node, (list, tuple)):
                return [index(v, l) for v in node]
            return node[l]

        leaf = tree
        while not isinstance(leaf, torch.Tensor):
            leaf = next(v for k, v in leaf.items() if not k.startswith("_")) \
                if isinstance(leaf, dict) else leaf[0]
        cached = [index(tree, l) for l in range(leaf.shape[0])]
        tree["_layers"] = cached
    return cached


def linear(params, x: torch.Tensor) -> torch.Tensor:
    """Dense layer; supports weight-only int8 quantization.

    Quantized params carry ``w`` int8 [in, out] + ``scale`` [out]
    (symmetric per-output-channel): ``(x @ w.to(x.dtype)) * scale + b``.
    """
    w = params["w"]
    if w.dtype == torch.int8:
        y = x @ w.to(x.dtype)
        y = y * params["scale"].to(x.dtype)
    else:
        y = matmul(x, w, x.dtype)
    if "b" in params:
        y = y + params["b"]
    return y


def layer_norm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    out = normed * params["scale"] + params["bias"]
    return out.to(x.dtype)


def _conv_weight(params, dtype: torch.dtype) -> torch.Tensor:
    """[width, in/groups, out] -> [out, in/groups, width] in ``dtype``,
    made once and kept under ``params['_wt']``."""
    wt = params.get("_wt")
    if wt is None or wt.dtype != dtype:
        wt = params["w"].to(dtype).permute(2, 1, 0).contiguous()
        params["_wt"] = wt
    return wt


def _conv_transpose_weight(params, dtype: torch.dtype) -> torch.Tensor:
    """[width, in, out] -> [in, out, width], the ``F.conv_transpose1d``
    layout, made once and kept under ``params['_wtt']``."""
    wt = params.get("_wtt")
    if wt is None or wt.dtype != dtype:
        wt = params["w"].to(dtype).permute(1, 2, 0).contiguous()
        params["_wtt"] = wt
    return wt


def conv1d_ncw(params, x: torch.Tensor, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1D conv in channel-major layout: [B, C_in, T] -> [B, C_out, T']."""
    y = F.conv1d(x, _conv_weight(params, x.dtype), stride=stride,
                 padding=padding, dilation=dilation, groups=groups)
    if "b" in params:
        y = y + params["b"][None, :, None]
    return y


def conv1d(params, x: torch.Tensor, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1) -> torch.Tensor:
    """1D convolution. ``x``: [B, T, C_in] -> [B, T', C_out]."""
    y = F.conv1d(x.transpose(1, 2), _conv_weight(params, x.dtype),
                 stride=stride, padding=padding, dilation=dilation,
                 groups=groups).transpose(1, 2)
    if "b" in params:
        y = y + params["b"]
    return y


def conv_transpose1d_ncw(params, x: torch.Tensor, stride: int,
                         padding: int = 0) -> torch.Tensor:
    """Transposed 1D conv (torch ConvTranspose1d semantics), NCW.

    ``x``: [B, C_in, T] -> [B, C_out, (T-1)*stride + width - 2*padding].
    The JAX package runs this as a conv over the lhs-dilated input with
    the kernel flipped along its width; ``F.conv_transpose1d`` is the
    transposed conv itself, so the stored kernel goes in unflipped.
    """
    y = F.conv_transpose1d(x, _conv_transpose_weight(params, x.dtype),
                           stride=stride, padding=padding)
    if "b" in params:
        y = y + params["b"][None, :, None]
    return y


def conv_transpose1d(params, x: torch.Tensor, stride: int,
                     padding: int = 0) -> torch.Tensor:
    """Transposed 1D conv. ``x``: [B, T, C_in] -> [B, T', C_out]."""
    return conv_transpose1d_ncw(params, x.transpose(1, 2), stride,
                                padding).transpose(1, 2)


def sine_position_table(max_len: int, dim: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Sinusoidal position table [max_len, dim], positions 1..max_len.

    GPT-SoVITS's SinePositionalEmbedding builds positions with
    cumsum(ones), i.e. 1-based: row i is the embedding of position i+1.
    """
    pos = torch.arange(1, max_len + 1, dtype=torch.float32,
                       device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention, softmax in fp32.

    q: [B, H, Tq, D], k/v: [B, H, Tk, D]; mask: broadcastable to
    [B, H, Tq, Tk], True = attend.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, -1e10))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.to(q.dtype))
