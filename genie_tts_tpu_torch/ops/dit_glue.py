"""The V4 DiT block's glue between its GEMMs and its attention: two CUDA
kernels and their plain versions.

They replace no Pallas kernel: the JAX package has no V4. The kernels are
``csrc/dit_glue.cu``:

* :func:`dit_adanorm` — a gated residual and the adaLN-modulated
  LayerNorm after it, in one launch: ``h' = h + g * y`` (``h + y`` without
  a gate), then ``LayerNorm(h') * (1 + scale) + shift`` (no affine of its
  own, eps 1e-6), with mean and variance in fp32 over the rounded ``h'`` and ``1 + scale`` rounded to the dtype first: the
  rounding points of ``torch.addcmul`` and ``F.layer_norm`` (weight ``1 +
  scale``, bias ``shift``), which :func:`dit_adanorm_plain` runs. What
  bounds it on the H100 is bytes: ``h`` and ``y`` read, ``h'`` and ``n``
  written (8 KB a row of d1024 in bf16).
* :func:`dit_rope` — x-transformers' rotary (interleaved pairs, in fp32,
  each product and the sum rounded to fp32, then once to the dtype) on the
  first ``cos.shape[-1]`` channels of every row of ``q`` and of ``k``, in
  place, in one launch; :func:`dit_rope_plain` is the composition it
  replaces. What bounds it is a launch's fixed cost (128 bytes a row).

The wrappers launch the kernel for CUDA tensors (and raise on what it does
not take) and run the plain version for CPU tensors. Each counts its
kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-6
# a row is held in registers by one warp: at most 8 chunks of 16 bytes a lane
_MAX_ROW_BYTES = 8 * 32 * 16


def dit_adanorm_plain(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                      y: torch.Tensor,
                      g: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', LayerNorm(h') * (1 + scale) + shift)`` with ``h' = h + g * y``
    (``torch.addcmul``), ``h + y`` without ``g``: the DiT's composition, op
    for op."""
    h = h + y if g is None else torch.addcmul(h, g, y)
    n = F.layer_norm(h, (h.shape[-1],), (1 + scale).reshape(-1), shift.reshape(-1), eps=EPS)
    return h, n


def dit_rope_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> None:
    """x-transformers' ``apply_rotary_pos_emb`` on the first ``rot``
    channels of ``q`` and of ``k`` [R, T, C] (interleaved pairs, in
    float32), in place; ``cos``, ``sin`` [T, rot] float32."""
    rot = cos.shape[-1]
    for x in (q, k):
        xr = x[..., :rot].float()
        pairs = xr.unflatten(-1, (rot // 2, 2))
        half = torch.stack([-pairs[..., 1], pairs[..., 0]], dim=-1).flatten(-2)
        x[..., :rot] = xr * cos + half * sin


def engages(w: torch.Tensor) -> bool:
    """Whether a DiT whose weights are like ``w`` runs the two kernels: on
    the card, in a dtype they take."""
    return w.is_cuda and w.dtype in _DTYPES


_fns = {}


def _kernel(name):
    """The C entry point ``name`` of csrc/dit_glue.cu (built on first use)."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load_library("dit_glue"), name)
        fn.restype = ctypes.c_int
        if name == "dit_adanorm":
            fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong, ctypes.c_int,
                                                    ctypes.c_float, ctypes.c_int,
                                                    ctypes.c_void_p])
        else:
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                           + [ctypes.c_void_p])
        _fns[name] = fn
    return _fns[name]


def _rows(name, t, shape, dt, dev):
    if t.dtype != dt or t.device != dev or tuple(t.shape) != shape or not t.is_contiguous() \
            or t.data_ptr() % 16:
        raise TypeError(f"{name} must be a contiguous {dt} {list(shape)} on {dev} on a "
                        f"16-byte boundary, got {t.dtype} {list(t.shape)} on {t.device} "
                        f"(strides {t.stride()})")
    return t.data_ptr()


def _vector(name, t, D, dt, dev):
    """A [D] vector, or a [1, D] row (an ``ada`` chunk read in place)."""
    if t.dtype != dt or t.device != dev or t.numel() != D or t.shape[-1] != D \
            or t.stride(-1) != 1 or t.data_ptr() % 16:
        raise TypeError(f"{name} must be {D} contiguous {dt} values on {dev} on a 16-byte "
                        f"boundary, got {t.dtype} {list(t.shape)} on {t.device} "
                        f"(strides {t.stride()})")
    return t.data_ptr()


def adanorm_args(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 y: torch.Tensor, g: Optional[torch.Tensor] = None) -> tuple:
    """What the kernel takes, checked: (pointers of h, y, g, scale and
    shift, rows, D, dtype code); raises on anything else."""
    dev, dt = h.device, h.dtype
    if dt not in _DTYPES:
        raise TypeError(f"dit_adanorm kernel takes float32 or bfloat16 rows, got {dt}")
    D = h.shape[-1]
    if not D or (D * h.element_size()) % 16 or D * h.element_size() > _MAX_ROW_BYTES:
        raise ValueError(f"dit_adanorm kernel takes rows of a multiple of 16 bytes up to "
                         f"{_MAX_ROW_BYTES}, got {D} x {dt}")
    shape = tuple(h.shape)
    return (_rows("h", h, shape, dt, dev), _rows("y", y, shape, dt, dev),
            None if g is None else _vector("g", g, D, dt, dev),
            _vector("scale", scale, D, dt, dev), _vector("shift", shift, D, dt, dev),
            h.numel() // D, D, _DTYPES[dt])


def dit_adanorm(h: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                y: torch.Tensor,
                g: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h', n)`` of :func:`dit_adanorm_plain` for ``h`` and ``y``
    [..., D] and ``scale``, ``shift`` (and ``g``) of D values ([D] or a
    [1, D] row)."""
    if not h.is_cuda:
        return dit_adanorm_plain(h, scale, shift, y, g)
    h_p, y_p, g_p, s_p, b_p, rows, D, code = adanorm_args(h, scale, shift, y, g)
    h_out, n = torch.empty_like(h), torch.empty_like(h)
    if rows:
        err = _kernel("dit_adanorm")(
            h_p, y_p, g_p, s_p, b_p, h_out.data_ptr(), n.data_ptr(),
            rows, D, EPS, code, torch.cuda.current_stream(h.device).cuda_stream)
        _build.check(err, "dit_adanorm")
        _build.count_launch(dit_adanorm)
    return h_out, n


def rope_args(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> tuple:
    """What the kernel takes, checked: (pointers of q, k, cos and sin,
    rows, frames, C, rot, dtype code); raises on anything else."""
    dev, dt = q.device, q.dtype
    if dt not in _DTYPES:
        raise TypeError(f"dit_rope kernel takes float32 or bfloat16 rows, got {dt}")
    if q.dim() != 3:
        raise ValueError(f"dit_rope takes q and k [R, T, C], got {list(q.shape)}")
    R, T, C = q.shape
    rot = cos.shape[-1]
    if rot % 2 or rot < 2 or rot > C or C % 2:
        raise ValueError(f"dit_rope takes an even rotary width up to an even C, got {rot} of {C}")
    return (_rows("q", q, (R, T, C), dt, dev), _rows("k", k, (R, T, C), dt, dev),
            _rows("cos", cos, (T, rot), torch.float32, dev),
            _rows("sin", sin, (T, rot), torch.float32, dev), R * T, T, C, rot, _DTYPES[dt])


def dit_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> None:
    """:func:`dit_rope_plain` on ``q`` and ``k`` [R, T, C] (one dtype,
    contiguous), in place; ``cos``, ``sin`` [T, rot] float32, ``rot`` even
    and at most C."""
    if not q.is_cuda:
        dit_rope_plain(q, k, cos, sin)
        return
    args = rope_args(q, k, cos, sin)
    if q.numel():
        err = _kernel("dit_rope")(*args, torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(err, "dit_rope")
        _build.count_launch(dit_rope)


dit_adanorm.launches = 0
dit_rope.launches = 0
