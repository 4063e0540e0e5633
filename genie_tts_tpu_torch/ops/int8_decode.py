"""Decode attention over the int8 slot KV cache: CUDA kernel + plain version.

The port of ``genie_tts_tpu/ops/int8_decode.py::int8_big_attention`` (the
Pallas TPU kernel ``_kernel``). It returns the flash partials (o, m, l) of
one decode step's attention over the slot machine's big cache, whose
columns are int8 codes with per-column fp32 scales; the visibility of each
column is recomputed from four scalars, never passed as a mask. The kernel
is ``csrc/int8_decode.cu``; its source note says what bounds it on the
H100 (the visible columns' bytes) and what its design does about that
(one block per (slot, head), 16-byte coalesced loads of the kv-major
codes, 16-column chunks with no visible column skipped). It is the
big-cache attention of ``models/t2s.py::_layer_decode_buffered`` on the
int8 slot route (``models/slots.py::decode_segment``).

:func:`int8_big_attention` launches the kernel for CUDA tensors (and
raises on what the kernel does not take) and runs
:func:`int8_big_attention_plain` for CPU tensors.
``int8_big_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_QDTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_S = 2048


def visibility(S: int, x_len: torch.Tensor, p_len: torch.Tensor,
               keys_written: torch.Tensor, ring_head: int, *, sx: int, sp: int,
               ring: int) -> torch.Tensor:
    """[B, S] bool: the compacted context ``[0, x_len+p_len)`` and the last
    ``keys_written`` ring writes before ``ring_head`` (floor modulo, as
    ``jnp.mod``)."""
    pos = torch.arange(S, device=x_len.device)[None, :]
    rpos = pos - (sx + sp)
    age = torch.remainder(ring_head - 1 - rpos, ring)
    return ((pos < (x_len + p_len)[:, None])
            | ((rpos >= 0) & (age < keys_written[:, None])))


def int8_big_attention_plain(q, kq, ks, vq, vs, x_len, p_len, keys_written,
                             ring_head, *, sx: int, sp: int, ring: int):
    """The JAX package's ``xla_big_attention``: q [B,H,Dh]; kq/vq int8
    [B,H,Dh,S]; ks/vs fp32 [B,H,S]; x_len/p_len/keys_written [B]. Returns
    fp32 (o [B,H,Dh] unnormalized, m [B,H], l [B,H]); a row with nothing
    visible gets m = -1e30, l = 0, o = 0."""
    B, H, Dh, S = kq.shape
    valid = visibility(S, x_len, p_len, keys_written, ring_head, sx=sx, sp=sp,
                       ring=ring)[:, None, :]
    kf = kq.float() * ks[:, :, None, :]
    vf = vq.float() * vs[:, :, None, :]
    scores = torch.einsum("bhd,bhds->bhs", q.float(), kf) * (1.0 / math.sqrt(Dh))
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1)
    p = torch.where(valid, torch.exp(scores - m[..., None]), torch.zeros_like(scores))
    return torch.einsum("bhs,bhds->bhd", p, vf), m, p.sum(dim=-1)


_fn = None


def _kernel():
    """The C entry point of csrc/int8_decode.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load_library("int8_decode").int8_big_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 3
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _fn = fn
    return _fn


def _launch(q, kq, ks, vq, vs, x_len, p_len, keys_written, ring_head, sx, sp, ring):
    B, H, Dh, S = kq.shape
    dev = q.device
    if isinstance(ring_head, torch.Tensor):
        raise TypeError("ring_head must be a Python int (reading a device "
                        "tensor would wait for the device)")
    if S != sx + sp + ring or S > _MAX_S or Dh not in (32, 64):
        raise ValueError(f"int8_big_attention kernel takes S == sx+sp+ring <= "
                         f"{_MAX_S} and Dh in (32, 64), got S={S} (sx={sx}, "
                         f"sp={sp}, ring={ring}), Dh={Dh}")
    if q.dtype not in _QDTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if tuple(q.shape) != (B, H, Dh) or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [{B},{H},{Dh}] tensor")
    ld = kq.stride(2)
    for name, t in (("kq", kq), ("vq", vq)):
        if t.dtype != torch.int8 or t.device != dev or tuple(t.shape) != (B, H, Dh, S):
            raise TypeError(f"{name} must be int8 [{B},{H},{Dh},{S}] on {dev}")
        if t.stride() != (H * Dh * ld, Dh * ld, ld, 1):
            raise ValueError(f"{name} rows must be dense with one pitch "
                             f"(strides {t.stride()})")
    lds = ks.stride(1)
    for name, t in (("ks", ks), ("vs", vs)):
        if t.dtype != torch.float32 or t.device != dev or tuple(t.shape) != (B, H, S):
            raise TypeError(f"{name} must be float32 [{B},{H},{S}] on {dev}")
        if t.stride() != (H * lds, lds, 1):
            raise ValueError(f"{name} rows must be dense with one pitch "
                             f"(strides {t.stride()})")
    for name, t in (("x_len", x_len), ("p_len", p_len), ("keys_written", keys_written)):
        if (t.dtype != torch.int32 or t.device != dev or tuple(t.shape) != (B,)
                or not t.is_contiguous()):
            raise TypeError(f"{name} must be a contiguous int32 [{B}] tensor on {dev}")
    vec = int(ld % 16 == 0 and kq.data_ptr() % 16 == 0 and vq.data_ptr() % 16 == 0)
    o = torch.empty((B, H, Dh), dtype=torch.float32, device=dev)
    m = torch.empty((B, H), dtype=torch.float32, device=dev)
    l = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = _kernel()(
        q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
        x_len.data_ptr(), p_len.data_ptr(), keys_written.data_ptr(),
        o.data_ptr(), m.data_ptr(), l.data_ptr(), B, H, Dh, S, ld, lds,
        int(ring_head), sx + sp, ring, 1.0 / math.sqrt(Dh), _QDTYPES[q.dtype], vec,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "int8_big_attention")
    int8_big_attention.launches += 1
    return o, m, l


def int8_big_attention(q, kq, ks, vq, vs, x_len, p_len, keys_written, ring_head,
                       *, sx: int, sp: int, ring: int):
    """Flash partials over the int8 big cache (see the plain version for
    shapes). ``ring_head`` is the segment-frozen write head, an int on the
    kernel route; ``keys_written`` must be the segment-frozen count too,
    never a per-step counter."""
    if q.is_cuda:
        return _launch(q, kq, ks, vq, vs, x_len, p_len, keys_written, ring_head,
                       sx, sp, ring)
    return int8_big_attention_plain(q, kq, ks, vq, vs, x_len, p_len, keys_written,
                                    ring_head, sx=sx, sp=sp, ring=ring)


int8_big_attention.launches = 0
