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

Serving runs the same layer math in one process over a list of shards
(``parallel/mesh.py::shard_serving_params``), one per device of a replica's
tp column: :func:`layer_prefill_shards`, :func:`layer_decode_shards` and
:func:`layer_decode_buffered_shards`. The activation is copied to each
shard's device, each shard computes its heads and ffn columns, and the
row-parallel partial sums are copied to the first shard's device and
added there in rank order, so results do not depend on timing. Each
shard's work is queued in :func:`shard_work`: inside a CUDA-graph capture
(``runtime/graphs.py``) on a capture stream of its tp rank's own, forked
from the lead card's stream where the work begins and joined back where
the partial sums are added, so one graph per dp row records every shard.
A tp set's graphs read its configuration's bank (``runtime/graphs.py``),
a copy of the set made shard by shard on the shards' devices, so a
second character of the configuration binds them: its shards are copied
into the bank's, each on its card.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from ..models import t2s
from ..models.t2s import _merge_heads, _split_heads
from ..ops.flash_decode import flash_decode_attention
from ..ops.layers import attention, layer_norm, linear, matmul
from ..runtime import graphs


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


# ---------------------------------------------------------------------------
# One process over a list of shards (serving)
# ---------------------------------------------------------------------------

def on_device(dev: torch.device):
    """Make ``dev`` the current card while a shard's work is queued (a
    kernel launches on the current card's stream); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


@contextlib.contextmanager
def shard_work(rank: int, dev: torch.device):
    """Queue tp rank ``rank``'s work on its device ``dev``. In a capture
    (and its warm-up run) it runs on the rank's capture stream
    (``graphs.shard_stream``), which first waits for the current stream
    (the lead card's) and which that stream waits for on exit: the fork
    and the join of the shard's work. Otherwise ``dev`` is made current
    (:func:`on_device`) and the work runs on its current stream."""
    s = graphs.shard_stream(rank, dev)
    if s is None:
        with on_device(dev):
            yield
        return
    lead = torch.cuda.current_stream()
    s.wait_stream(lead)
    with torch.cuda.stream(s):
        yield
    lead.wait_stream(s)


def _row_partial(p, x: torch.Tensor) -> torch.Tensor:
    """A row-parallel shard's partial product, without the bias (added once
    after the sum). Int8 weights carry a per-output-channel scale that every
    shard holds whole, so the scaled partials sum to the unsharded product."""
    return linear({k: v for k, v in p.items() if k != "b"}, x)


def _reduce(parts) -> torch.Tensor:
    """The sum of the shards' partials (each copied to the lead device by
    its shard), added in rank order."""
    out = parts[0]
    for x in parts[1:]:
        out = out + x
    return out


def _megatron_layer(lps, h: torch.Tensor, num_heads: int, attend):
    """One post-LN decoder layer over tp shards ``lps`` (a layer's tree per
    shard). ``attend(i, q, k, v)`` -> (attention output [B, H/tp, T, Dh],
    what the caller keeps of shard ``i``'s k/v), on shard ``i``'s device,
    in its :func:`shard_work`. Returns (hidden on h's device, [kept per
    shard])."""
    lead = h.device
    heads = num_heads // len(lps)
    parts, kept = [], []
    for i, lp in enumerate(lps):
        dev = lp["qkv"]["w"].device
        with shard_work(i, dev):
            q, k, v = linear(lp["qkv"], h.to(dev)).chunk(3, dim=-1)
            att, kv = attend(i, *(_split_heads(t, heads) for t in (q, k, v)))
            parts.append(_row_partial(lp["out"], _merge_heads(att)).to(lead))
            kept.append(kv)
    lp0 = lps[0]
    h = layer_norm(lp0["norm1"], h + (_reduce(parts) + lp0["out"]["b"]))
    parts = []
    for i, lp in enumerate(lps):
        dev = lp["qkv"]["w"].device
        with shard_work(i, dev):
            parts.append(_row_partial(lp["ffn2"], torch.relu(linear(lp["ffn1"], h.to(dev))))
                         .to(lead))
    h = layer_norm(lp0["norm2"], h + (_reduce(parts) + lp0["ffn2"]["b"]))
    return h, kept


def layer_prefill_shards(lps, h: torch.Tensor, masks, num_heads: int):
    """``models/t2s.py::_layer_prefill`` over tp shards: ``masks`` holds the
    prefill mask on each shard's device. Returns (hidden, [(k, v)] per
    shard, each [B, H/tp, T, Dh] on its device)."""
    def attend(i, q, k, v):
        return attention(q, k, v, masks[i]), (k, v)

    return _megatron_layer(lps, h, num_heads, attend)


def layer_decode_shards(lps, h: torch.Tensor, k_caches, v_caches, pos,
                        kv_masks, num_heads: int) -> torch.Tensor:
    """``models/t2s.py::_layer_decode`` over tp shards: shard ``i`` writes
    its heads' K/V row at ``pos`` (an int, or an int tensor [1]) into
    ``k_caches[i]`` / ``v_caches[i]`` ([B, H/tp, S, Dh] on its device) in
    place and attends through the flash-decode kernel over its ``H/tp``
    heads, with ``kv_masks[i]``."""
    def attend(i, q, k, v):
        row = t2s.row_index(pos, k_caches[i].device)
        k_caches[i].index_copy_(2, row, k.to(k_caches[i].dtype))
        v_caches[i].index_copy_(2, row, v.to(v_caches[i].dtype))
        att = flash_decode_attention(q[:, :, 0].contiguous(), k_caches[i],
                                     v_caches[i], kv_masks[i])
        return att[:, :, None], None

    return _megatron_layer(lps, h, num_heads, attend)[0]


def layer_decode_buffered_shards(lps, h: torch.Tensor, reads, num_heads: int) -> torch.Tensor:
    """``models/t2s.py::_layer_decode_buffered`` over tp shards: ``reads[i]``
    holds shard ``i``'s keyword arguments of
    ``t2s.buffered_attention`` (its big caches and scales of ``H/tp``
    heads, its write buffer and the step's column in it, the masks and the
    kernels' segment context on its device), so the attention runs per
    shard, and each shard writes its new K/V column into its write buffer
    ([B, H/tp, Dh, W]) in its own work. Returns the hidden state."""
    def attend(i, q, k, v):
        return t2s.buffered_attention(q, k[:, :, 0], v[:, :, 0], **reads[i]), None

    return _megatron_layer(lps, h, num_heads, attend)[0]
