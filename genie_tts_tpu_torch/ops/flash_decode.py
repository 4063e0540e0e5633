"""Single-token KV-cache decode attention: CUDA kernel + plain version.

The port of ``genie_tts_tpu/ops/flash_decode.py::flash_decode_attention``
(the Pallas TPU kernel ``_decode_attn_kernel``). The kernel is
``csrc/flash_decode.cu``; its source note says what bounds it on the H100
and what its design does about that. It is the decode attention of
``models/t2s.py::_layer_decode``, the B > 1 route of ``generate``.

:func:`flash_decode_attention` launches the kernel for CUDA tensors (and
raises on what the kernel does not take) and runs
:func:`flash_decode_attention_plain` for CPU tensors.
``flash_decode_attention.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 kv_mask: torch.Tensor) -> torch.Tensor:
    """q [B,H,Dh], caches [B,H,S,Dh], kv_mask [B,S] bool -> [B,H,Dh].

    The reference's ``xla_decode_attention``: fp32 scores, -1e30 fill,
    fp32 softmax rounded to V's dtype, fp32 sum cast to q's dtype. A row
    with no visible key gets the mean of V."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bhd,bhsd->bhs", q.float(), k_cache.float()) * scale
    scores = torch.where(kv_mask[:, None, :], scores,
                         torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    return torch.einsum("bhs,bhsd->bhd", p.float(), v_cache.float()).to(q.dtype)


_fn = None


def _kernel():
    """The C entry point of csrc/flash_decode.cu (built on first use)."""
    global _fn
    if _fn is None:
        fn = _build.load_library("flash_decode").flash_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        _fn = fn
    return _fn


def _launch(q, k_cache, v_cache, kv_mask):
    B, H, S, Dh = k_cache.shape
    dt = q.dtype
    if S > 4096 or Dh > 128:
        raise ValueError(f"flash_decode_attention kernel takes S <= 4096 and "
                         f"Dh <= 128 (scores live in shared memory), got "
                         f"S={S}, Dh={Dh}")
    if dt not in _DTYPES:
        raise TypeError(f"flash_decode_attention kernel takes float32 or "
                        f"bfloat16, got {dt}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != dt or t.device != q.device:
            raise TypeError(f"{name} must be {dt} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(q.shape) != (B, H, Dh) or not q.is_contiguous():
        raise ValueError(f"q must be a contiguous [{B},{H},{Dh}] tensor")
    if (kv_mask.dtype != torch.bool or tuple(kv_mask.shape) != (B, S)
            or not kv_mask.is_contiguous() or kv_mask.device != q.device):
        raise ValueError(f"kv_mask must be a contiguous bool [{B},{S}] "
                         f"tensor on {q.device}")
    out = torch.empty_like(q)
    err = _kernel()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             kv_mask.data_ptr(), out.data_ptr(), B, H, S, Dh,
             1.0 / math.sqrt(Dh), _DTYPES[dt],
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_decode_attention")
    flash_decode_attention.launches += 1
    return out


def flash_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor,
                           kv_mask: torch.Tensor) -> torch.Tensor:
    """q [B,H,Dh], caches [B,H,S,Dh], kv_mask [B,S] bool -> [B,H,Dh]."""
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, kv_mask)
    return flash_decode_attention_plain(q, k_cache, v_cache, kv_mask)


flash_decode_attention.launches = 0
