"""One whole B=1 T2S decode step over all layers: CUDA kernel + plain version.

The port of ``genie_tts_tpu/ops/fused_decode.py::fused_decode_step`` (the
Pallas TPU kernel ``_layer_kernel``). The kernel is ``csrc/fused_decode.cu``,
one cooperative launch per decode step; its source note says what bounds
it on the H100 and what its design does about that. ``models/t2s.py::
generate`` runs every B=1 decode step through it.

Weights are packed once per ``generate`` call by :func:`pack_decode_params`
(views of the stacked layer weights; small vectors in fp32). They are
bf16/fp32, or int8 codes with a per-output-channel fp32 scale (the default
``t2s_int8`` decode weights): the kernel reads the int8 bytes and computes
``(x . w_int8) * scale + b`` in fp32, the int8 path of ``ops/layers.py::
linear``.

:func:`fused_decode_step` launches the kernel for CUDA tensors (and raises
on what the kernel does not take) and runs :func:`fused_decode_step_plain`
for CPU tensors. ``fused_decode_step.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from . import _build
from .layers import layer_norm

_WTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_CTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MATS = (("qkv", "qkv"), ("out", "out"), ("1", "ffn1"), ("2", "ffn2"))


def pack_decode_params(t2s_params) -> Dict[str, torch.Tensor]:
    """T2S layer params -> the kernel's stacked layout.

    ``w*`` [L, in, out] (the stored weights: int8 codes, or floats in the
    compute dtype), ``s*`` [L, 1, out] fp32 scales for int8 weights,
    ``b*`` [L, 1, out] fp32 biases, norms ``n1s``, ``n1b``, ``n2s``,
    ``n2b`` [L, 1, D] fp32."""
    lp = t2s_params["layers"]
    out = {}
    for name, key in _MATS:
        p = lp[key]
        w = p["w"]
        out["w" + name] = w.contiguous()
        out["b" + name] = p["b"].float()[:, None, :].contiguous()
        if w.dtype == torch.int8:
            out["s" + name] = p["scale"].float()[:, None, :].contiguous()
    for n, key in (("1", "norm1"), ("2", "norm2")):
        out[f"n{n}s"] = lp[key]["scale"].float()[:, None, :].contiguous()
        out[f"n{n}b"] = lp[key]["bias"].float()[:, None, :].contiguous()
    return out


def _product(x: torch.Tensor, stacked, name: str, layer: int,
             cdt: torch.dtype) -> torch.Tensor:
    """x [1, in] fp32 -> [1, out] fp32: x rounded to the compute dtype,
    fp32 accumulation, then the int8 scale and the bias."""
    w = stacked["w" + name][layer]
    y = x.to(cdt).float() @ w.float()
    if ("s" + name) in stacked:
        y = y * stacked["s" + name][layer]
    return y + stacked["b" + name][layer]


def fused_decode_step_plain(stacked, h: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: int, mask: torch.Tensor,
                            *, num_heads: int):
    """The kernel's function in plain PyTorch (same signature and effect)."""
    L, S, D = k_cache.shape
    H, Dh = num_heads, D // num_heads
    cdt = k_cache.dtype
    scale = 1.0 / math.sqrt(Dh)
    madd = (mask.float() - 1.0) * 1e10
    h = h.float().reshape(1, D)
    for l in range(L):
        qkv = _product(h, stacked, "qkv", l, cdt)[0]
        # in-place cache update at the row-uniform write position
        k_cache[l, pos] = qkv[D:2 * D].to(cdt)
        v_cache[l, pos] = qkv[2 * D:].to(cdt)
        q = qkv[:D].to(cdt).float().view(H, Dh)
        keys = k_cache[l].float().view(S, H, Dh)
        vals = v_cache[l].float().view(S, H, Dh)
        scores = torch.einsum("hd,shd->hs", q, keys) * scale + madd
        probs = torch.softmax(scores, dim=-1).to(cdt).float()
        att = torch.einsum("hs,shd->hd", probs, vals).reshape(1, D)
        h = layer_norm({"scale": stacked["n1s"][l], "bias": stacked["n1b"][l]},
                       h + _product(att, stacked, "out", l, cdt))
        ff = torch.relu(_product(h, stacked, "1", l, cdt))
        h = layer_norm({"scale": stacked["n2s"][l], "bias": stacked["n2b"][l]},
                       h + _product(ff, stacked, "2", l, cdt))
    return h, k_cache, v_cache


_fn = None


def _kernel():
    """The C entry point of csrc/fused_decode.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load_library("fused_decode").fused_decode_step
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


def _launch(stacked, h, k_cache, v_cache, pos, mask, num_heads):
    L, S, D = k_cache.shape
    dev = k_cache.device
    F = stacked["w1"].shape[-1]
    wdt, cdt = stacked["wqkv"].dtype, k_cache.dtype
    if wdt not in _WTYPES or cdt not in _CTYPES or wdt not in (torch.int8, cdt):
        raise TypeError(f"fused_decode_step kernel takes float32/bfloat16 "
                        f"caches with int8 weights or weights of the cache "
                        f"dtype, got {wdt} weights and {cdt} caches")
    # shared-memory sizes and 16-byte vector loads (csrc/fused_decode.cu)
    tile = 32 // stacked["wqkv"].element_size()
    Dh = D // num_heads
    if (D > 1024 or F > 4096 or S > 4096 or Dh > 64 or D % num_heads
            or D % tile or F % tile or (Dh * k_cache.element_size()) % 16):
        raise ValueError(f"fused_decode_step kernel takes D <= 1024, F <= 4096, "
                         f"S <= 4096, Dh <= 64, D and F multiples of {tile} and "
                         f"16-byte head rows; got D={D}, F={F}, S={S}, Dh={Dh}")
    shapes = {"wqkv": (L, D, 3 * D), "wout": (L, D, D), "w1": (L, D, F),
              "w2": (L, F, D), "bqkv": (L, 1, 3 * D), "bout": (L, 1, D),
              "b1": (L, 1, F), "b2": (L, 1, D), "n1s": (L, 1, D),
              "n1b": (L, 1, D), "n2s": (L, 1, D), "n2b": (L, 1, D)}
    if wdt == torch.int8:
        shapes.update({"sqkv": (L, 1, 3 * D), "sout": (L, 1, D),
                       "s1": (L, 1, F), "s2": (L, 1, D)})
    for name, shape in shapes.items():
        t = stacked[name]
        want = wdt if name.startswith("w") else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed {name} must be a contiguous, 16-byte "
                             f"aligned {want} tensor of shape {shape} on {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != cdt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{cdt} tensor")
    h = h.reshape(1, D)
    mask = mask.reshape(S)
    if h.dtype != torch.float32 or mask.dtype != torch.float32 \
            or h.device != dev or mask.device != dev:
        raise TypeError(f"h and mask must be float32 tensors on {dev}")
    if not 0 <= int(pos) < S:
        raise ValueError(f"pos {pos} outside the cache of {S} rows")
    h = h.contiguous()
    mask = mask.contiguous()
    h_out = torch.empty((1, D), dtype=torch.float32, device=dev)
    scratch = torch.empty(6 * D + F, dtype=torch.float32, device=dev)
    s = stacked.get
    ptrs = [stacked["wqkv"], stacked["wout"], stacked["w1"], stacked["w2"],
            s("sqkv"), s("sout"), s("s1"), s("s2"),
            stacked["bqkv"], stacked["bout"], stacked["b1"], stacked["b2"],
            stacked["n1s"], stacked["n1b"], stacked["n2s"], stacked["n2b"],
            k_cache, v_cache, mask, h, h_out, scratch]
    arr = (ctypes.c_ulonglong * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    dims = (ctypes.c_int * 6)(L, S, D, num_heads, F, int(pos))
    with torch.cuda.device(dev):        # the kernel sizes its grid for it
        err = _kernel()(ctypes.addressof(arr), ctypes.addressof(dims),
                        1.0 / math.sqrt(D // num_heads), 1e-5, _WTYPES[wdt],
                        _CTYPES[cdt], torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decode_step")
    fused_decode_step.launches += 1
    return h_out, k_cache, v_cache


def fused_decode_step(stacked, h: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos: int, mask: torch.Tensor,
                      *, num_heads: int):
    """One decode step over all layers.

    stacked: see :func:`pack_decode_params`. h: [1, D] fp32 hidden (token +
    position embedding). k_cache / v_cache: [L, S, D] in the compute dtype
    (heads merged into D). pos: write position; mask: [S] fp32 (1 =
    attend). Returns (h_out [1, D] fp32, k_cache, v_cache); row ``pos`` of
    every layer's caches is written in place."""
    if k_cache.is_cuda:
        return _launch(stacked, h, k_cache, v_cache, pos, mask, num_heads)
    return fused_decode_step_plain(stacked, h, k_cache, v_cache, pos, mask,
                                   num_heads=num_heads)


fused_decode_step.launches = 0
