"""Decode attention of the slot machine's step over exact KV caches: CUDA
kernel + plain version.

It replaces no Pallas kernel: the JAX package runs this route (the exact,
non-int8 slot cache of ``models/slots.py``) as XLA ops, a gather of read
windows and a masked softmax. The kernel is ``csrc/slot_attention.cu``:
one launch a layer a step computes the attention of
``models/t2s.py::_layer_decode_buffered`` over [the visible columns of the
big cache | the segment's write buffer before this step | the step's own
column] and writes the step's own K/V column into the buffer. What bounds
it on the H100 is the bytes of the visible columns, read in place in the
cache's own dtype (bf16 or fp32), with visibility recomputed from four
segment-frozen scalars as ``ops/int8_decode.py`` does, so there is no
gather, no fp32 copy and no mask tensor. Its design: visible 16-column
chunks split over a cluster of 4 blocks per (slot, head), V staged into
shared memory by asynchronous copies while K is read and scored, and one
exchange of (max, sum) in the cluster before the probabilities are
rounded as the plain version rounds them.

:func:`slot_attention` launches the kernel for CUDA tensors (and raises on
what the kernel does not take) and runs :func:`slot_attention_plain` for
CPU tensors. ``slot_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .int8_decode import visibility

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_S = 2048


def slot_attention_plain(q, k_new, v_new, k_big, v_big, k_buf, v_buf, col: int, x_len,
                         p_len, keys_written, ring_head, *, sx: int, sp: int,
                         ring: int) -> torch.Tensor:
    """q, k_new, v_new [B,H,Dh] (any strides); k_big/v_big [B,H,Dh,S], the
    first ring copy, S = sx+sp+ring; k_buf/v_buf [B,H,Dh,W], the segment's
    write buffer, whose columns before ``col`` are visible; x_len, p_len,
    keys_written [B] and ring_head (an int or a one-element int tensor)
    segment-frozen. Returns the attention [B,1,H*Dh] in q's dtype (merged
    heads) and writes k_new/v_new into buffer column ``col``.

    fp32 scores, one softmax over [visible big columns | buffer | self],
    probabilities rounded to q's dtype, an fp32 sum stored in q's dtype."""
    B, H, Dh, S = k_big.shape
    dt = q.dtype
    scale = 1.0 / math.sqrt(Dh)
    qf = q.float()
    valid = visibility(S, x_len, p_len, keys_written, ring_head, sx=sx, sp=sp,
                       ring=ring)[:, None, :]
    s_big = torch.einsum("bhd,bhds->bhs", qf, k_big.to(dt).float()) * scale
    s_big = torch.where(valid, s_big, torch.full_like(s_big, -1e30))
    kb, vb = k_buf[..., :col], v_buf[..., :col]
    s_buf = torch.einsum("bhd,bhdw->bhw", qf, kb.to(dt).float()) * scale
    s_self = (qf * k_new.to(dt).float()).sum(-1, keepdim=True) * scale
    p = torch.softmax(torch.cat([s_big, s_buf, s_self], dim=-1), dim=-1).to(dt).float()
    o = (torch.einsum("bhs,bhds->bhd", p[..., :S], v_big.to(dt).float())
         + torch.einsum("bhw,bhdw->bhd", p[..., S:S + col], vb.to(dt).float())
         + p[..., S + col:] * v_new.to(dt).float())
    k_buf[..., col] = k_new
    v_buf[..., col] = v_new
    return o.to(dt).reshape(B, 1, H * Dh)


_fn = None


def _kernel():
    """The C entry point of csrc/slot_attention.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load_library("slot_attention").slot_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                       + [ctypes.c_longlong] + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
                       + [ctypes.c_int] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2
                       + [ctypes.c_void_p])
        _fn = fn
    return _fn


def _launch(q, k_new, v_new, k_big, v_big, k_buf, v_buf, col, x_len, p_len, keys_written,
            ring_head, sx, sp, ring):
    B, H, Dh, S = k_big.shape
    dev, dt = q.device, q.dtype
    if isinstance(ring_head, torch.Tensor):
        if (ring_head.dtype != torch.int32 or ring_head.numel() != 1
                or ring_head.device != dev):
            raise TypeError(f"ring_head must be one int32 on {dev} (or an int)")
    else:       # a host head: copied to the device (not capturable)
        ring_head = torch.tensor([int(ring_head)], dtype=torch.int32, device=dev)
    ring_head = ring_head.contiguous()
    if S != sx + sp + ring or S > _MAX_S or Dh not in (32, 64):
        raise ValueError(f"slot_attention kernel takes S == sx+sp+ring <= {_MAX_S} and "
                         f"Dh in (32, 64), got S={S} (sx={sx}, sp={sp}, ring={ring}), "
                         f"Dh={Dh}")
    if dt not in _DTYPES:
        raise TypeError(f"slot_attention kernel takes float32 or bfloat16, got {dt}")
    qld = q.stride(0)
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        if t.dtype != dt or t.device != dev or tuple(t.shape) != (B, H, Dh):
            raise TypeError(f"{name} must be {dt} [{B},{H},{Dh}] on {dev}")
        if t.stride() != (qld, Dh, 1):
            raise ValueError(f"{name} must be rows of one pitch with dense heads "
                             f"(strides {t.stride()}, q's {q.stride()})")
    ld = k_big.stride(2)
    for name, t in (("k_big", k_big), ("v_big", v_big)):
        if t.dtype != dt or t.device != dev:
            raise TypeError(f"{name} must be {dt} on {dev}")
        if t.stride() != (H * Dh * ld, Dh * ld, ld, 1):
            raise ValueError(f"{name} rows must be dense with one pitch "
                             f"(strides {t.stride()})")
    W = k_buf.shape[-1]
    for name, t in (("k_buf", k_buf), ("v_buf", v_buf)):
        if (t.dtype != dt or t.device != dev or tuple(t.shape) != (B, H, Dh, W)
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous {dt} [{B},{H},{Dh},{W}] on {dev}")
    if not 0 <= col < W:
        raise ValueError(f"buffer column {col} outside [0, {W})")
    for name, t in (("x_len", x_len), ("p_len", p_len), ("keys_written", keys_written)):
        if (t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != (B,)
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous int32 [{B}] tensor on {dev}")
    vec = int((ld * k_big.element_size()) % 16 == 0 and k_big.data_ptr() % 16 == 0
              and v_big.data_ptr() % 16 == 0)
    out = torch.empty((B, 1, H * Dh), dtype=dt, device=dev)
    err = _kernel()(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), qld, k_big.data_ptr(),
        v_big.data_ptr(), ld, k_buf.data_ptr(), v_buf.data_ptr(), W, col, x_len.data_ptr(),
        p_len.data_ptr(), keys_written.data_ptr(), ring_head.data_ptr(), sx + sp, ring,
        out.data_ptr(), B, H, Dh, 1.0 / math.sqrt(Dh), _DTYPES[dt], vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "slot_attention")
    _build.count_launch(slot_attention)
    return out


def slot_attention(q, k_new, v_new, k_big, v_big, k_buf, v_buf, col: int, x_len, p_len,
                   keys_written, ring_head, *, sx: int, sp: int, ring: int) -> torch.Tensor:
    """The attention of one slot decode step over exact caches (see the
    plain version for shapes); writes the step's K/V into buffer column
    ``col``. ``ring_head`` and ``keys_written`` are the segment-frozen
    head (one int32 on the card, as the slot state keeps it) and counts."""
    if q.is_cuda:
        return _launch(q, k_new, v_new, k_big, v_big, k_buf, v_buf, col, x_len, p_len,
                       keys_written, ring_head, sx, sp, ring)
    return slot_attention_plain(q, k_new, v_new, k_big, v_big, k_buf, v_buf, col, x_len,
                                p_len, keys_written, ring_head, sx=sx, sp=sp, ring=ring)


slot_attention.launches = 0
