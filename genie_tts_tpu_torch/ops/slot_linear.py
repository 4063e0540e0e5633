"""One int8 linear of the slot machine's decode layer with its epilogue:
CUDA kernel + plain version.

It replaces no Pallas kernel: the JAX package runs the slot decode layer's
dense path (``models/t2s.py::_layer_decode_buffered``) as XLA ops. The
kernel is ``csrc/slot_linear.cu``: one launch computes ``x @ w * scale +
b`` over the int8 codes ``w`` [in, out] read in place, and then one tail:
none (the qkv projection, whose row ``ops/slot_attention.py`` reads as it
is), ReLU (ffn1), or the residual add and the post-LN LayerNorm (the
output projection and ffn2), with fp32 sums and statistics and one
rounding to the activation dtype. What bounds it on the H100 is its fixed
cost: the weight bytes (0.26-1.05 MB at the T2S widths) take 0.08-0.31 us
at 3.35 TB/s. Its design: a cluster of 16 blocks splits K over 128 warps
that issue all their 16-byte weight loads before using any, dequantize in
registers into tensor-core products with the slots as the mma's N, and
push their partials into the owning block's shared memory (byte-counted on
its mbarrier, no cluster barrier), summed there in a fixed order; the
LayerNorm's row statistics are one more such exchange. A launch starts
while the previous one runs (programmatic dependent launch) and loads its
weights before it waits for that one's output.

:func:`slot_linear` launches the kernel for CUDA tensors (and raises on
what the kernel does not take) and runs :func:`slot_linear_plain`, the
composition of ``ops/layers.py`` the layer ran before, for CPU tensors.
``slot_linear.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .layers import layer_norm, linear

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_NORM_WIDTHS = (128, 256, 512, 1024)
_EPS = 1e-5


def slot_linear_plain(params, x: torch.Tensor, *, relu: bool = False, res=None,
                      norm=None) -> torch.Tensor:
    """``linear(params, x)``, then ``relu`` or, with ``norm``, the post-LN
    ``layer_norm(norm, res + y)``: the decode layer's composition, op for
    op."""
    y = linear(params, x)
    if relu:
        return torch.relu(y)
    if norm is not None:
        return layer_norm(norm, res + y)
    return y


def takes(params) -> bool:
    """The slot decode layer's route: whether it runs the linear ``params``
    through :func:`slot_linear` (int8 codes) rather than the composition."""
    return params["w"].dtype == torch.int8


def launches_kernel(params) -> bool:
    """Whether the route launches the kernel for ``params``: it takes them
    and their codes lie on the card (the rows with them, or it raises)."""
    return takes(params) and params["w"].is_cuda


_fn = None


def _kernel():
    """The C entry point of csrc/slot_linear.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load_library("slot_linear").slot_linear
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 4
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _vector(name, t, n, dt, dev):
    if t.dtype != dt or t.device != dev or tuple(t.shape) != (n,) or not t.is_contiguous():
        raise TypeError(f"{name} must be a contiguous {dt} [{n}] on {dev}")
    return t.data_ptr()


def _launch(params, x, relu, res, norm):
    w = params["w"]
    dev, dt = x.device, x.dtype
    if dt not in _DTYPES:
        raise TypeError(f"slot_linear kernel takes float32 or bfloat16 rows, got {dt}")
    if w.dtype != torch.int8 or w.dim() != 2 or w.device != dev or not w.is_contiguous():
        raise TypeError(f"slot_linear kernel takes contiguous int8 [in, out] codes on {dev}")
    K, N = w.shape
    if x.shape[-1] != K or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"x must be contiguous rows of {K} on a 16-byte boundary, "
                         f"got {tuple(x.shape)} (strides {x.stride()})")
    if K % 16 or N % 128 or w.data_ptr() % 16:
        raise ValueError(f"slot_linear kernel takes in % 16 == 0 and out % 128 == 0 on a "
                         f"16-byte boundary, got [{K}, {N}]")
    if relu and norm is not None:
        raise ValueError("slot_linear takes one tail: relu or norm")
    scale = _vector("scale", params["scale"], N, torch.float32, dev)
    bias = _vector("b", params["b"], N, dt, dev)
    out_shape = tuple(x.shape[:-1]) + (N,)
    # the columns of a cluster: the whole row for the LayerNorm, else tiles
    nt = 512 if N % 512 == 0 else 256 if N % 256 == 0 else 128
    res_p = g_p = beta_p = None
    tail = int(relu)
    if norm is not None:
        tail, nt = 2, N
        if N not in _NORM_WIDTHS:
            raise ValueError(f"the LayerNorm tail takes out in {_NORM_WIDTHS}, got {N}")
        if res is None or res.dtype != dt or res.device != dev \
                or tuple(res.shape) != out_shape or not res.is_contiguous():
            raise TypeError(f"res must be a contiguous {dt} {list(out_shape)} on {dev}")
        res_p = res.data_ptr()
        g_p = _vector("norm scale", norm["scale"], N, torch.float32, dev)
        beta_p = _vector("norm bias", norm["bias"], N, torch.float32, dev)
    out = torch.empty(out_shape, dtype=dt, device=dev)
    with torch.cuda.device(dev):        # the kernel opts in to its cluster per device
        err = _kernel()(
            x.data_ptr(), K, w.data_ptr(), scale, bias, res_p, N, g_p, beta_p, out.data_ptr(),
            N, x.numel() // K, K, N, nt, tail, _EPS, _DTYPES[dt],
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slot_linear")
    _build.count_launch(slot_linear)
    return out


def slot_linear(params, x: torch.Tensor, *, relu: bool = False, res=None,
                norm=None) -> torch.Tensor:
    """One int8 linear of the slot decode layer (``params``: ``w`` int8
    [in, out], ``scale`` fp32 [out], ``b`` [out] in x's dtype) over the rows
    of ``x`` [..., in], with ``relu``, or with ``norm`` (a LayerNorm's fp32
    ``scale`` and ``bias``) over ``res + y`` (``res`` [..., out]); neither:
    the bare linear. Returns [..., out] in x's dtype."""
    if x.is_cuda:
        return _launch(params, x, relu, res, norm)
    return slot_linear_plain(params, x, relu=relu, res=res, norm=norm)


slot_linear.launches = 0
