"""Tensor parallelism for the T2S decoder layer (Megatron-style).

The JAX package gets these collectives from GSPMD; here they are explicit,
each as a ``torch.autograd.Function`` whose backward is the collective the
gradient needs:

* ``copy_to_tp``: identity forward, all-reduce backward. It stands at the
  input of each column-parallel product (qkv, ffn1): every rank sees the
  whole activation but back-propagates only through its own columns, so
  the activation's gradient is the sum over ranks.
* ``reduce_from_tp``: all-reduce forward, identity backward. It sums the
  partial outputs of each row-parallel product (out, ffn2).

With both in place the gradients of the replicated leaves (embeddings,
norms, ``bert_proj``, ``predict``, the alphas, the row-parallel biases)
are the unsharded gradients, equal on every tp rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.t2s import _merge_heads, _split_heads
from ..ops.layers import attention, layer_norm, linear, matmul


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(x, group)


def layer_prefill(lp, h: torch.Tensor, mask: torch.Tensor, num_heads: int,
                  group):
    """``models/t2s.py::_layer_prefill`` on this rank's shards of one layer
    (qkv and ffn1 column-parallel over its ``num_heads / tp`` heads and
    ``ffn_dim / tp`` columns; out and ffn2 row-parallel, their biases added
    once after the sum). Returns (hidden, (k, v)) with the local heads'
    k/v."""
    heads = num_heads // dist.get_world_size(group)
    q, k, v = linear(lp["qkv"], copy_to_tp(h, group)).chunk(3, dim=-1)
    q, k, v = (_split_heads(t, heads) for t in (q, k, v))
    att = attention(q, k, v, mask)
    o = reduce_from_tp(matmul(_merge_heads(att), lp["out"]["w"], h.dtype), group)
    h = layer_norm(lp["norm1"], h + (o + lp["out"]["b"]))
    f = torch.relu(linear(lp["ffn1"], copy_to_tp(h, group)))
    ff = reduce_from_tp(matmul(f, lp["ffn2"]["w"], h.dtype), group)
    h = layer_norm(lp["norm2"], h + (ff + lp["ffn2"]["b"]))
    return h, (k, v)
