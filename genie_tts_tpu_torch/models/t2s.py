"""Text-to-semantic (T2S) autoregressive GPT decoder.

The port of ``genie_tts_tpu/models/t2s.py``: phoneme + BERT embedding,
HuBERT -> VQ prompt extraction, a prefill over the packed
``[text | prompt]`` sequence, then the AR decode loop with a
pre-allocated KV cache.

Static-shape layout per batch row (cache length S):

    [ 0 .............. Sx )   text block (right-padded, len x_len[b])
    [ Sx ......... Sx+Sp )    semantic prompt block (right-padded, len p_len[b])
    [ Sx+Sp ............ )    decoded tokens, step t lives at Sx+Sp+t

Decode routes of :func:`generate`: B = 1 runs each step as ONE launch of
the fused all-layer kernel (``ops/fused_decode.py``) over ``[L, S, D]``
caches; B > 1 runs the per-layer :func:`_layer_decode` with the
flash-decode attention kernel (``ops/flash_decode.py``) over
``[B, H, S, Dh]`` caches. Both write each step's K/V row into the cache in
place (the JAX package's write-buffered ``generate`` exists only for the
TPU's tiling; it computes the same tokens). The decode runs in blocks of
steps over static buffers (:func:`_decode_block`), which the card replays
as captured CUDA graphs: the counterpart of the JAX package's one
compiled ``lax.while_loop``. The slot machine
(``models/slots.py``) decodes through :func:`_layer_decode_buffered`,
whose read-only big cache may hold int8 codes (``ops/int8_decode.py``);
on the card its exact caches are read by ``ops/slot_attention.py`` and its
int8 linears run through ``ops/slot_linear.py``.

A tp-sharded parameter set (``parallel/mesh.py::shard_serving_params``:
the layers split over a replica's devices, under ``layer_shards``) takes
the per-layer route at every B, each shard over its ``H/tp`` heads with
a cache of its own on its device (``parallel/tp.py``), in graphs of its
own cache as the whole set's are; the fused kernel holds all the layers
whole, so it serves whole parameters only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import T2SConfig
from ..ops.flash_decode import flash_decode_attention
from ..ops.fused_decode import fused_decode_step
from ..ops.fused_decode import prepare as prepare_fused
from ..ops.fused_decode import step_buffers as fused_step_buffers
from ..ops.int8_decode import int8_big_attention
from ..ops.slot_attention import slot_attention
from ..ops.slot_linear import slot_linear, slot_linear_plain, takes as slot_linear_takes
from ..ops.layers import (attention, layer_norm, linear, sine_position_table,
                          unstack)
from ..ops.sampling import (SamplingConfig, SamplingRows, gumbel_noise_,
                            sample_token_rows)
from ..runtime import graphs

Params = Dict

# decode steps between the host's reads of the finished flags in
# ``generate`` (each read synchronizes the host with the device)
DONE_READ_EVERY = 16


# ---------------------------------------------------------------------------
# Initialization (random weights for tests and the chip smoke run; real
# weights come from converted checkpoints)
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: T2SConfig,
                dtype=torch.bfloat16) -> Params:
    """Random T2S weights on ``generator``'s device.

    Biases and LayerNorm scales/biases are random too, and differ from
    layer to layer, as a trained checkpoint's do, so whatever reads them
    (the fused decode kernel's per-layer offsets) is exercised."""
    dev = generator.device
    d, f, v = cfg.embed_dim, cfg.ffn_dim, cfg.semantic_vocab
    L = cfg.num_layers

    def randn(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dt)

    def dense(i, o, lead=()):
        return {"w": randn(*lead, i, o, std=i ** -0.5),
                "b": randn(*lead, o, std=0.1)}

    def ln():
        return {"scale": 1.0 + randn(L, d, std=0.1, dt=torch.float32),
                "bias": randn(L, d, std=0.1, dt=torch.float32)}

    return {
        "text_embed": randn(cfg.phoneme_vocab, d, std=0.02),
        "bert_proj": dense(cfg.bert_dim, d),
        "text_pos_alpha": torch.ones((), device=dev),
        "audio_embed": randn(v, d, std=0.02),
        "audio_pos_alpha": torch.ones((), device=dev),
        "layers": {
            "qkv": dense(d, 3 * d, (L,)),
            "out": dense(d, d, (L,)),
            "ffn1": dense(d, f, (L,)),
            "ffn2": dense(f, d, (L,)),
            "norm1": ln(),
            "norm2": ln(),
        },
        "predict": {"w": randn(d, v, std=d ** -0.5)},
        "ssl_proj": {"w": randn(2, cfg.ssl_dim, cfg.ssl_dim, std=0.03),
                     "b": randn(cfg.ssl_dim, std=0.1)},
        "codebook": randn(1024, cfg.ssl_dim, dt=torch.float32),
    }


def _quantize_dense(p: Params) -> Params:
    """Symmetric per-output-channel int8 weight quantization.

    w [..., in, out] -> int8 w + fp32 scale [..., out]; bias untouched."""
    w = p["w"].float()
    s = torch.clamp(w.abs().amax(dim=-2) / 127.0, min=1e-8)
    wq = torch.round(w / s[..., None, :]).to(torch.int8)
    out = {"w": wq, "scale": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_params(params: Params) -> Params:
    """Weight-only int8 quantization of the per-layer matmuls (embeddings,
    norms, the predict head and the encoder-side tensors stay as they
    are)."""
    layers = {k: v for k, v in params["layers"].items() if not k.startswith("_")}
    for k in ("qkv", "out", "ffn1", "ffn2"):
        layers[k] = _quantize_dense(layers[k])
    out = dict(params)
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Encoder: text embedding + prompt token extraction
# ---------------------------------------------------------------------------

def embed_text(params: Params, phoneme_ids: torch.Tensor,
               bert: torch.Tensor) -> torch.Tensor:
    """[B,Tx] ids + [B,Tx,1024] bert -> positioned text states [B,Tx,D]."""
    x = params["text_embed"][phoneme_ids]
    x = x + linear(params["bert_proj"], bert.to(x.dtype))
    pe = sine_position_table(x.shape[1], x.shape[2], device=x.device)
    return x + (params["text_pos_alpha"] * pe).to(x.dtype)[None]


def extract_prompt_tokens(params: Params, ssl_content: torch.Tensor) -> torch.Tensor:
    """HuBERT features [B,Ts,768] -> semantic prompt ids [B,Ts//2].

    Conv(768,768,k2,s2) projection then the nearest codebook row, all in
    fp32 (the assignment must be exact)."""
    w = params["ssl_proj"]["w"].float()                      # [2, C, C]
    B, T, C = ssl_content.shape
    T2 = T // 2
    x = ssl_content.float()[:, :2 * T2].reshape(B, T2, 2 * C)
    x = x @ w.reshape(2 * C, C) + params["ssl_proj"]["b"].float()
    cb = params["codebook"].float()                          # [1024, C]
    dots = torch.einsum("btc,kc->btk", x, cb)
    c2 = (cb * cb).sum(-1)
    return torch.argmin(c2[None, None, :] - 2.0 * dots, dim=-1)


# ---------------------------------------------------------------------------
# Transformer core
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _layer_prefill(lp: Params, h: torch.Tensor, mask: torch.Tensor,
                   num_heads: int):
    """Post-LN transformer layer over the prefill sequence.
    Returns (hidden, (k, v)) with k/v [B, H, T, Dh]."""
    q, k, v = linear(lp["qkv"], h).chunk(3, dim=-1)
    q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
    att = attention(q, k, v, mask)
    h = layer_norm(lp["norm1"], h + linear(lp["out"], _merge_heads(att)))
    ff = linear(lp["ffn2"], torch.relu(linear(lp["ffn1"], h)))
    h = layer_norm(lp["norm2"], h + ff)
    return h, (k, v)


def row_index(pos, device) -> torch.Tensor:
    """A write row as an int64 index [1] on ``device``: ``pos`` is an int
    or a one-element int tensor (the decode's device step counter)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).to(device=device, dtype=torch.int64)
    return torch.tensor([int(pos)], device=device)


def _layer_decode(lp: Params, h: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos, kv_mask: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """One-token decode layer (the batched route). h: [B,1,D]; caches
    [B,H,S,Dh]; ``pos`` is the row-uniform write position (static text and
    prompt buckets + step): an int, or an int tensor [1] in device memory.
    The new K/V row is written into the caches IN PLACE; attention runs
    through the flash-decode kernel."""
    q, k_new, v_new = linear(lp["qkv"], h).chunk(3, dim=-1)
    q = _split_heads(q, num_heads)[:, :, 0]                  # [B,H,Dh]
    row = row_index(pos, k_cache.device)
    k_cache.index_copy_(2, row, _split_heads(k_new, num_heads).to(k_cache.dtype))
    v_cache.index_copy_(2, row, _split_heads(v_new, num_heads).to(v_cache.dtype))
    att = flash_decode_attention(q.contiguous(), k_cache, v_cache, kv_mask)
    h = layer_norm(lp["norm1"], h + linear(lp["out"], _merge_heads(att[:, :, None])))
    ff = linear(lp["ffn2"], torch.relu(linear(lp["ffn1"], h)))
    return layer_norm(lp["norm2"], h + ff)


def _layer_decode_buffered(lp: Params, h: torch.Tensor, k_big, v_big,
                           k_buf: torch.Tensor, v_buf: torch.Tensor,
                           buf_mask: torch.Tensor, kv_mask, num_heads: int,
                           k_scale=None, v_scale=None, kv_kernel_ctx=None, col=None):
    """One-token decode layer against a read-only big cache + write buffer
    (the slot machine's route, ``models/slots.py::decode_segment``).

    h [B,1,D]; big caches kv-major [B,H,Dh,S] with kv_mask [B,S]; the
    segment's own columns in k_buf/v_buf [B,H,Dh,W] with buf_mask [W].
    Attention is one softmax over [big | buffer | self]. Returns (h, k_new [B,H,Dh], v_new [B,H,Dh]);
    with ``col`` the new columns are also written into buffer column
    ``col`` (:func:`buffered_attention`).

    ``k_scale``/``v_scale`` [B,H,S]: per-column fp32 scales when the big
    caches hold int8 codes. ``kv_kernel_ctx`` = (x_len, p_len,
    keys_written, ring_head, sx, sp, ring), all segment-frozen: the
    big-cache attention then recomputes visibility from these over the
    first ring copy (``kv_mask`` unused): through ``ops/int8_decode.py``
    for int8 codes (flash partials, merged with the exact buffer and self
    columns in one log-sum-exp step), through ``ops/slot_attention.py``
    for exact caches (the whole attention, ``buf_mask`` unused).

    Int8 linear weights take each linear with its tail through
    ``ops/slot_linear.py`` (one kernel launch each on the card, the same
    composition on the CPU); other weights run the composition here."""
    dense = slot_linear if slot_linear_takes(lp["qkv"]) else slot_linear_plain
    q, k_new, v_new = dense(lp["qkv"], h).chunk(3, dim=-1)
    q = _split_heads(q, num_heads)                           # [B,H,1,Dh]
    k_new = _split_heads(k_new, num_heads)[:, :, 0]          # [B,H,Dh]
    v_new = _split_heads(v_new, num_heads)[:, :, 0]
    att = buffered_attention(q, k_new, v_new, k_big, v_big, k_buf, v_buf, buf_mask,
                             kv_mask, k_scale=k_scale, v_scale=v_scale,
                             kv_kernel_ctx=kv_kernel_ctx, col=col)
    h = dense(lp["out"], _merge_heads(att), res=h, norm=lp["norm1"])
    ff = dense(lp["ffn1"], h, relu=True)
    h = dense(lp["ffn2"], ff, res=h, norm=lp["norm2"])
    return h, k_new, v_new


def buffered_attention(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                       k_big, v_big, k_buf: torch.Tensor, v_buf: torch.Tensor,
                       buf_mask: torch.Tensor, kv_mask, k_scale=None, v_scale=None,
                       kv_kernel_ctx=None, col=None) -> torch.Tensor:
    """The attention of :func:`_layer_decode_buffered`: q [B,H,1,Dh], the
    step's own k_new/v_new [B,H,Dh], the rest as there. Returns [B,H,1,Dh]
    in q's dtype. ``col`` (an int): the step's buffer column, into which
    k_new/v_new are written (after the read; its ``buf_mask`` entry is
    False); the exact-cache kernel route takes it in place of ``buf_mask``.
    Heads are independent, so a tp shard calls it on its own heads
    (``parallel/tp.py::layer_decode_buffered_shards``)."""
    if k_scale is None and kv_kernel_ctx is not None:
        x_len, p_len, keys_written, ring_head, sx, sp, ring = kv_kernel_ctx
        out = slot_attention(q[:, :, 0], k_new, v_new, k_big, v_big, k_buf, v_buf, col,
                             x_len, p_len, keys_written, ring_head, sx=sx, sp=sp, ring=ring)
        return out.view(q.shape[0], 1, q.shape[1], q.shape[-1]).transpose(1, 2)
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q[:, :, 0].float()                                  # [B,H,Dh]
    W = k_buf.shape[-1]
    if k_scale is not None and kv_kernel_ctx is not None:
        x_len, p_len, keys_written, ring_head, sx, sp, ring = kv_kernel_ctx
        o1, m1, l1 = int8_big_attention(
            q[:, :, 0].contiguous(), k_big, k_scale, v_big, v_scale,
            x_len, p_len, keys_written, ring_head, sx=sx, sp=sp, ring=ring)
        s_buf = torch.einsum("bhd,bhdw->bhw", qf, k_buf.float()) * scale
        s_buf = s_buf.masked_fill(~buf_mask[None, None, :], -1e10)
        s_self = (qf * k_new.float()).sum(-1, keepdim=True) * scale   # [B,H,1]
        s_rest = torch.cat([s_buf, s_self], dim=-1)                   # [B,H,W+1]
        m_tot = torch.maximum(m1, s_rest.amax(dim=-1))
        a1 = torch.exp(m1 - m_tot)
        p_rest = torch.exp(s_rest - m_tot[..., None])
        l_tot = l1 * a1 + p_rest.sum(dim=-1)
        att_f = (o1 * a1[..., None]
                 + torch.einsum("bhw,bhdw->bhd", p_rest[..., :W].to(dt).float(),
                                v_buf.float())
                 + p_rest[..., W:] * v_new.float())
        att = (att_f / l_tot[..., None]).to(dt)[:, :, None]
    else:
        # one softmax over [big | buffer | self]; int8 codes dequantize V
        # in q's dtype and fold the K scale into the scores
        vb = v_big if v_scale is None else v_big.to(dt) * v_scale[:, :, None, :].to(dt)
        s_big = torch.einsum("bhd,bhds->bhs", qf, k_big.to(dt).float()) * scale
        if k_scale is not None:
            s_big = s_big * k_scale
        s_big = s_big.masked_fill(~kv_mask[:, None, :], -1e10)
        s_buf = torch.einsum("bhd,bhdw->bhw", qf, k_buf.float()) * scale
        s_buf = s_buf.masked_fill(~buf_mask[None, None, :], -1e10)
        s_self = (qf * k_new.float()).sum(-1, keepdim=True) * scale
        probs = torch.softmax(torch.cat([s_big, s_buf, s_self], dim=-1),
                              dim=-1).to(dt).float()
        S = s_big.shape[-1]
        att = (torch.einsum("bhs,bhds->bhd", probs[..., :S], vb.float()).to(dt)
               + torch.einsum("bhw,bhdw->bhd", probs[..., S:S + W],
                              v_buf.float()).to(dt)
               + (probs[..., S + W:] * v_new.float()).to(dt))[:, :, None]
    if col is not None:
        k_buf[..., col] = k_new
        v_buf[..., col] = v_new
    return att


# ---------------------------------------------------------------------------
# Generate: prefill + AR decode
# ---------------------------------------------------------------------------

class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_steps] semantic tokens (incl. final EOS/0)
    counts: torch.Tensor   # [B] number of emitted tokens
    steps: int             # loop counter at exit (decode launches + 1)


def _prefill_mask(Sx: int, Sp: int, x_len: torch.Tensor,
                  p_len: torch.Tensor) -> torch.Tensor:
    """[B, S_pre, S_pre] bool attention mask for the packed prefill sequence."""
    S = Sx + Sp
    dev = x_len.device
    qi = torch.arange(S, device=dev)[None, :, None]
    kj = torch.arange(S, device=dev)[None, None, :]
    x_len = x_len[:, None, None]
    p_len = p_len[:, None, None]
    k_is_text = kj < x_len
    k_is_prompt = (kj >= Sx) & (kj < Sx + p_len)
    q_is_text = qi < Sx
    # text query: attends text block only; audio query: text + causal prompt
    causal = kj <= qi
    return torch.where(q_is_text, k_is_text, k_is_text | (k_is_prompt & causal))


def layer_shards(params: Params):
    """The per-device layer trees of a tp-sharded parameter set
    (``parallel/mesh.py::shard_serving_params``), or None for a whole one."""
    return params.get("layer_shards")


def shard_devices(params: Params) -> list:
    """The devices of a parameter set's tp shards, in rank order (one
    device for a whole set)."""
    shards = layer_shards(params)
    if shards is None:
        return [params["audio_embed"].device]
    return [s["qkv"]["w"].device for s in shards]


def on_shard(sharded: bool, rank: int, dev):
    """``parallel/tp.py::shard_work`` of tp rank ``rank`` on ``dev`` for
    the work of a tp-sharded set or state, nothing for a whole one."""
    if not sharded:
        return contextlib.nullcontext()
    from ..parallel.tp import shard_work

    return shard_work(rank, dev)


def prefill(params: Params, cfg: T2SConfig, x: torch.Tensor, x_len: torch.Tensor,
            prompts: torch.Tensor, p_len: torch.Tensor, cache_len: int, caches=None
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the packed sequence through all layers and build the KV cache.

    Returns (logits_first [B, V] fp32, (k_cache, v_cache) each
    [L, B, H, cache_len, Dh], zero past the prefill). For a tp-sharded
    parameter set (:func:`layer_shards`) the caches are tuples with one
    ``[L, B, H/tp, cache_len, Dh]`` cache per shard, on its device.
    ``caches``: (k, v) of those layouts, or the fused kernel's
    ``[L, cache_len, D]`` (B = 1), written in place instead of new ones
    (a decode graph's own)."""
    B, Sx, D = x.shape
    Sp = prompts.shape[1]
    H, L, Dh = cfg.num_heads, cfg.num_layers, cfg.head_dim
    T = Sx + Sp
    y_emb = params["audio_embed"][prompts]
    pe = sine_position_table(Sp, D, device=x.device)
    y = y_emb + (params["audio_pos_alpha"] * pe).to(y_emb.dtype)[None]
    h = torch.cat([x, y], dim=1)                              # [B, S_pre, D]
    mask = _prefill_mask(Sx, Sp, x_len, p_len)[:, None]       # [B,1,S,S]
    shards = layer_shards(params)
    devs = shard_devices(params)
    if caches is None:
        k_cache, v_cache = [], []
        for i, d in enumerate(devs):
            with on_shard(shards is not None, i, d):
                k_cache.append(torch.zeros((L, B, H // len(devs), cache_len, Dh),
                                           dtype=h.dtype, device=d))
                v_cache.append(torch.zeros_like(k_cache[-1]))
        k_cache, v_cache = tuple(k_cache), tuple(v_cache)
    else:
        k_cache, v_cache = (c if isinstance(c, tuple) else (c,) for c in caches)
        for i, (kc, vc) in enumerate(zip(k_cache, v_cache)):
            # nothing of an earlier call stays
            with on_shard(shards is not None, i, devs[i]):
                for c in (kc, vc):
                    c.narrow(-2, T, c.shape[-2] - T).zero_()

    def write(cache, l, kv):
        if cache.dim() == 3:                 # [L, S, D]: [1, H, T, Dh] -> [T, D]
            cache[l, :T] = kv[0].transpose(0, 1).reshape(T, D)
        else:
            cache[l, :, :, :T] = kv

    if shards is None:
        for l, lp in enumerate(unstack(params["layers"])):
            h, (k, v) = _layer_prefill(lp, h, mask, H)
            write(k_cache[0], l, k)
            write(v_cache[0], l, v)
    else:
        from ..parallel.tp import layer_prefill_shards

        masks = []
        for i, d in enumerate(devs):
            with on_shard(shards is not None, i, d):
                masks.append(mask.to(d))
        for l, lps in enumerate(zip(*(unstack(s) for s in shards))):
            h, kv = layer_prefill_shards(lps, h, masks, H)
            for i, (k, v) in enumerate(kv):
                with on_shard(shards is not None, i, devs[i]):
                    write(k_cache[i], l, k)
                    write(v_cache[i], l, v)
    last_idx = Sx + p_len - 1                                 # [B]
    h_last = h[torch.arange(B, device=h.device), last_idx]   # [B, D]
    logits = h_last.float() @ params["predict"]["w"].float()
    if shards is None:
        k_cache, v_cache = k_cache[0], v_cache[0]
    return logits, (k_cache, v_cache)


@dataclasses.dataclass
class DecodeBuffers:
    """The static buffers of one decode geometry: what the prefill
    program (:func:`_prefill_block`) and the decode program
    (:func:`_decode_block`) read and write, every value that changes
    from step to step included, so a captured CUDA graph of either
    replays with nothing from the host (``runtime/graphs.py``). The
    per-call inputs are copied in by :func:`generate` (the Gumbel table
    drawn in place); ``pe``, ``kv_positions`` and ``forbid_eos`` are
    constants of the geometry."""
    k_cache: object          # fused: [L,S,D]; per-layer: [L,B,H,S,Dh] (tp: a tuple per shard)
    v_cache: object
    phones: torch.Tensor     # [B, Sx] int64 text ids
    bert: torch.Tensor       # [B, Sx, bert_dim] fp32 BERT features
    x: torch.Tensor          # [B, Sx, D] embedded text (the embedded-input route)
    prompts: torch.Tensor    # [B, Sp] int64 semantic prompt ids
    tokens: torch.Tensor     # [B, max_steps] int64
    hist: torch.Tensor       # [B, V] int64 repetition-penalty histogram
    counts: torch.Tensor     # [B] int64
    done: torch.Tensor       # [B] bool
    step: torch.Tensor       # [] int64: the next decode step
    pos: torch.Tensor        # [1] int32: the step's write row (the fused kernel reads it)
    noise: torch.Tensor      # [max_steps, B, V] fp32 Gumbel table
    x_len: torch.Tensor      # [B] int64
    p_len: torch.Tensor      # [B] int64
    static_mask: torch.Tensor  # [B, S] bool: valid text and prompt columns
    min_steps: torch.Tensor  # [] int64
    ms_dyn: torch.Tensor     # [] int64 per-call cap
    top_k: torch.Tensor      # [B] per-row sampling parameters
    top_p: torch.Tensor
    temperature: torch.Tensor
    repetition_penalty: torch.Tensor
    pe: torch.Tensor         # [S, D] fp32 position table
    kv_positions: torch.Tensor  # [1, S]
    forbid_eos: torch.Tensor    # [1, V] bool
    # the fused kernel's output row and scratch, this graph's own (B = 1
    # on the card; None elsewhere)
    h_out: Optional[torch.Tensor] = None
    scratch: Optional[torch.Tensor] = None


def _decode_buffers(cfg: T2SConfig, B: int, Sx: int, Sp: int, cache_len: int,
                    max_steps: int, packed, dtype: torch.dtype, device,
                    devices=None) -> DecodeBuffers:
    """Zeroed buffers of a geometry (lengths 1, so a capture's warm-up run
    sees a row with something to attend to); ``packed``: the fused
    kernel's packing (B = 1), else None. ``devices``: a tp-sharded set's
    devices, a cache of ``H/tp`` heads on each."""
    L, H, Dh, D, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.embed_dim, cfg.semantic_vocab
    S = cache_len

    def z(*shape, dt=torch.int64):
        return torch.zeros(shape, dtype=dt, device=device)

    if devices is not None and len(devices) > 1:
        shape = (L, B, H // len(devices), S, Dh)
        caches = tuple(tuple(torch.zeros(shape, dtype=dtype, device=d) for d in devices)
                       for _ in range(2))
    else:
        shape = (L, S, D) if packed is not None else (L, B, H, S, Dh)
        caches = (z(*shape, dt=dtype), z(*shape, dt=dtype))
    forbid = z(1, V, dt=torch.bool)
    forbid[0, cfg.eos_id] = True
    ones = torch.ones((B,), dtype=torch.int64, device=device)
    h_out, scratch = (None, None) if packed is None else fused_step_buffers(
        packed, S, H, device)
    return DecodeBuffers(
        k_cache=caches[0], v_cache=caches[1], phones=z(B, Sx),
        bert=z(B, Sx, cfg.bert_dim, dt=torch.float32), x=z(B, Sx, D, dt=dtype),
        prompts=z(B, Sp), tokens=z(B, max_steps), hist=z(B, V),
        counts=ones.clone(), done=z(B, dt=torch.bool), step=ones[0].clone(),
        pos=z(1, dt=torch.int32), noise=z(max_steps, B, V, dt=torch.float32),
        x_len=ones.clone(), p_len=ones.clone(), static_mask=z(B, S, dt=torch.bool),
        min_steps=z(), ms_dyn=torch.full((), max_steps, dtype=torch.int64, device=device),
        top_k=z(B), top_p=torch.ones((B,), device=device),
        temperature=torch.ones((B,), device=device),
        repetition_penalty=torch.ones((B,), device=device),
        pe=sine_position_table(S, D, device=device),
        kv_positions=torch.arange(S, device=device)[None, :], forbid_eos=forbid,
        h_out=h_out, scratch=scratch)


def _prefill_block(params: Params, cfg: T2SConfig, b: DecodeBuffers, *, Sx: int, Sp: int,
                   embed: bool, any_top_p: bool) -> None:
    """The first program of a decode: the text embedded (``embed``: from
    ``b.phones`` and ``b.bert``; else ``b.x`` as given), the prefill
    written into the graph's own caches, the repetition histogram seeded
    with the valid prompt tokens, the first token drawn (EOS forbidden)
    with the first row of the Gumbel table, and the decode state set to
    step 1. Reads nothing back to the host, so a CUDA graph captures it
    (a variant of the decode graph, on its buffers)."""
    x = embed_text(params, b.phones, b.bert) if embed else b.x
    logits0, _ = prefill(params, cfg, x, b.x_len, b.prompts, b.p_len,
                         b.static_mask.shape[1], caches=(b.k_cache, b.v_cache))
    kv = b.kv_positions
    b.static_mask.copy_((kv < b.x_len[:, None])
                        | ((kv >= Sx) & (kv < Sx + b.p_len[:, None])))
    b.hist.zero_()
    b.hist.scatter_add_(1, b.prompts, (kv[:, :Sp] < b.p_len[:, None]).long())
    rows = SamplingRows(b.top_k, b.top_p, b.temperature, b.repetition_penalty)
    tok0 = sample_token_rows(None, logits0, b.hist, rows, forbid=b.forbid_eos,
                             noise=b.noise[0], any_top_p=any_top_p)
    b.hist.scatter_add_(1, tok0[:, None], torch.ones_like(tok0)[:, None])
    b.tokens.zero_()
    b.tokens[:, 0] = tok0
    b.counts.fill_(1)
    b.done.zero_()
    b.step.fill_(1)


def _decode_block(params: Params, cfg: T2SConfig, b: DecodeBuffers, *, n_steps: int,
                  Sx: int, Sp: int, any_top_p: bool, packed=None) -> None:
    """``n_steps`` decode steps over the buffers ``b``, driven by the
    device step counter ``b.step``: the program a CUDA graph captures.

    A step whose counter has reached the per-call cap changes nothing
    and leaves the counter as it is, so a block may run past the cap (the
    host reads ``done`` and the counter once per block). Finished rows
    keep their tokens and counts. Routes: ``packed`` (B = 1) runs the
    fused all-layer kernel; otherwise the per-layer route with the flash
    kernel, over tp shards when the caches are tuples."""
    H, V, eos = cfg.num_heads, cfg.semantic_vocab, cfg.eos_id
    B, ms = b.tokens.shape
    S = b.static_mask.shape[1]
    audio_embed, alpha = params["audio_embed"], params["audio_pos_alpha"]
    predict_w = params["predict"]["w"].float()
    rows = SamplingRows(b.top_k, b.top_p, b.temperature, b.repetition_penalty)
    shards = layer_shards(params)
    if packed is None and shards is None:
        layers = unstack(params["layers"])
    elif shards is not None:
        from ..parallel.tp import layer_decode_shards

        shard_layers = list(zip(*(unstack(sh) for sh in shards)))
        devs = shard_devices(params)
    front = Sx + Sp
    for _ in range(n_steps):
        step = b.step
        live = step < b.ms_dyn                  # a step past the cap changes nothing
        prev = (step - 1).clamp(0, ms - 1).reshape(1, 1).expand(B, 1)
        cur_tok = b.tokens.gather(1, prev)[:, 0]
        emb = audio_embed[cur_tok]                              # [B, D]
        pos_emb = b.pe[b.p_len + step - 1]                      # [B, D]
        h = emb + (alpha * pos_emb).to(emb.dtype)
        # keys visible: valid text, valid prompt, decoded tokens so far
        kv_mask = b.static_mask | ((b.kv_positions >= front)
                                   & (b.kv_positions <= front + step - 1))
        # the row-uniform write position (its last row once past the cap)
        b.pos.copy_((front + step - 1).clamp(max=S - 1).reshape(1))
        if packed is not None:
            h_last, _, _ = fused_decode_step(packed, h.float(), b.k_cache, b.v_cache,
                                             b.pos, kv_mask[0].float(), num_heads=H,
                                             h_out=b.h_out, scratch=b.scratch)
        else:
            row = b.pos.long()                  # the per-layer routes' cache index
            hb = h[:, None]
            if shards is None:
                for l, lp in enumerate(layers):
                    hb = _layer_decode(lp, hb, b.k_cache[l], b.v_cache[l], row, kv_mask, H)
            else:
                masks = []
                for i, d in enumerate(devs):
                    with on_shard(shards is not None, i, d):
                        masks.append(kv_mask.to(d))
                for l, lps in enumerate(shard_layers):
                    hb = layer_decode_shards(lps, hb, [k[l] for k in b.k_cache],
                                             [v[l] for v in b.v_cache], row, masks, H)
            h_last = hb[:, 0]
        logits = h_last.float() @ predict_w                     # [B, V]

        # below min_steps EOS is masked out of sampling entirely
        forbid = b.forbid_eos & (step < b.min_steps)
        noise = b.noise.index_select(0, step.clamp(max=ms - 1).reshape(1))[0]
        nxt = sample_token_rows(None, logits, b.hist, rows, forbid=forbid, noise=noise,
                                any_top_p=any_top_p)
        argmax_eos = torch.argmax(logits, dim=-1) == eos
        now_done = (argmax_eos | (nxt == eos)) & (step >= b.min_steps)
        active = ~b.done & live
        nxt = torch.where(active, nxt, torch.full_like(nxt, eos))  # freeze finished rows
        write = step.clamp(max=ms - 1).reshape(1, 1).expand(B, 1)
        b.tokens.scatter_(1, write, torch.where(active[:, None], nxt[:, None],
                                                b.tokens.gather(1, write)))
        b.hist.scatter_add_(1, nxt[:, None], active[:, None].long())
        b.counts.copy_(torch.where(active, step + 1, b.counts))
        b.done.copy_(b.done | ((now_done | (step + 1 >= b.ms_dyn)) & live))
        b.step.add_(live.long())


# the variants of a decode graph: a block of DONE_READ_EVERY steps, and
# the single step that the last block of a decode repeats up to its cap
DECODE_BLOCKS = (DONE_READ_EVERY, 1)


def _generate_key(B, Sx, Sp, cache_len, max_steps, dtype, tp=1):
    """The static geometry a decode graph of :func:`generate` is keyed on:
    the route ("fused" for B = 1 on whole parameters, "flash" for B > 1,
    "tp" with the tp degree appended for a tp-sharded set). Its programs
    are variants of one graph on one set of buffers (``Graph.run``):
    ("prefill", embed flag, top-p flag) and (block length in
    :data:`DECODE_BLOCKS`, top-p flag)."""
    if tp > 1:
        return ("generate", "tp", B, Sx, Sp, cache_len, max_steps, dtype, tp)
    return ("generate", "fused" if B == 1 else "flash", B, Sx, Sp, cache_len,
            max_steps, dtype)


def decode_graph(params: Params, cfg: T2SConfig, B: int, Sx: int, Sp: int,
                 cache_len: int, max_steps: int, dtype):
    """The graph of :func:`generate` at this geometry, from the
    configuration's cache (its buffers made on a miss), and the fused
    kernel's packing for B = 1 on whole parameters (``params["_packed"]``,
    made once per set by ``graphs.cache_for``; prepared for ``cache_len``
    before any capture). ``params``: the bank of a bound set
    (``GraphCache.bind``), whose programs every character's replays
    share, or for an eager run the set itself. A tp-sharded set's buffers
    hold a cache per shard on its device (:func:`shard_devices`), the rest
    on the lead device."""
    cache = graphs.cache_for(params)
    dev = params["audio_embed"].device
    devs = shard_devices(params)
    packed = None
    if B == 1 and len(devs) == 1:
        packed = params["_packed"]
        prepare_fused(packed, cache_len, cfg.num_heads, dev)
    g = cache.graph(_generate_key(B, Sx, Sp, cache_len, max_steps, dtype, tp=len(devs)),
                    lambda: _decode_buffers(cfg, B, Sx, Sp, cache_len, max_steps,
                                            packed, dtype, dev, devices=devs))
    return g, packed


def generate_programs(params: Params, cfg: T2SConfig, Sx: int, Sp: int, packed):
    """Every program of a decode graph, by variant: the prefill (with the
    embedding, as :func:`generate_e2e` runs it) and the decode blocks,
    each with and without top-p (what the warmup sweep captures)."""
    progs = {}
    for top_p in (False, True):
        progs[("prefill", True, top_p)] = functools.partial(
            _prefill_block, params, cfg, Sx=Sx, Sp=Sp, embed=True, any_top_p=top_p)
        for n in DECODE_BLOCKS:
            progs[(n, top_p)] = functools.partial(
                _decode_block, params, cfg, n_steps=n, Sx=Sx, Sp=Sp, any_top_p=top_p,
                packed=packed)
    return progs


def generate(params: Params, cfg: T2SConfig, scfg: SamplingConfig,
             generator: Optional[torch.Generator], x, x_len: torch.Tensor,
             prompts: torch.Tensor, p_len: torch.Tensor,
             max_steps: int, cache_len: int, min_steps: int = 0,
             max_steps_dyn: Optional[int] = None,
             noise: Optional[torch.Tensor] = None, eager: bool = False) -> GenerateResult:
    """Prefill + sample + full AR decode.

    ``x``: the embedded text [B, Sx, D], or (phone ids [B, Sx], BERT
    features [B, Sx, bert_dim]) for the prefill program to embed (the
    route of :func:`generate_e2e`). ``min_steps``: EOS may not fire
    before this many tokens. ``max_steps``: the static cap that sizes the
    token buffer and the Gumbel table ``noise`` [max_steps, B, V] (drawn
    in place from ``generator`` when not given); ``max_steps_dyn``: an
    optional per-call cap <= max_steps.

    Everything runs over the static buffers of the geometry's graph in
    the configuration's cache (``runtime/graphs.py``), on its bank with
    ``params`` bound, held from the inputs' copy in to the outputs' copy
    out: the prefill program (:func:`_prefill_block`:
    embedding, prefill into the graph's caches, histogram, first token)
    once, then the decode in blocks of ``DONE_READ_EVERY`` steps of
    :func:`_decode_block` (the last one, where the per-call cap is
    nearer, as that many single steps). On the card each is a replay of
    a captured CUDA graph (a variant per program and top-p flag, so
    every cap replays the same ones); the host reads ``done`` and the
    step counter once per block. ``eager`` runs the same programs on the
    same buffers without a graph, on ``params`` itself.

    Routes: B = 1 on whole parameters runs the fused all-layer kernel; B >
    1 the per-layer route with the flash kernel; a tp-sharded parameter
    set (every B) the per-layer route over its shards' ``H/tp`` heads
    (``parallel/tp.py::layer_decode_shards``), each shard's cache on its
    device, in the same graphs (key route "tp"). Logits, sampling and the
    token history stay on the device of ``x``.
    """
    ms_dyn = max_steps if max_steps_dyn is None else min(int(max_steps_dyn), max_steps)
    embed = isinstance(x, (tuple, list))
    B, Sx = x[0].shape if embed else x.shape[:2]
    Sp = prompts.shape[1]
    dtype = params["audio_embed"].dtype
    any_top_p = scfg.top_p < 1.0
    with graphs.cache_for(params).bind(params, eager) as params:
        g, packed = decode_graph(params, cfg, B, Sx, Sp, cache_len, max_steps, dtype)
        with g.lock:
            b = g.static
            if embed:
                b.phones.copy_(x[0])
                b.bert.copy_(x[1])
            else:
                b.x.copy_(x)
            b.prompts.copy_(prompts)
            b.x_len.copy_(x_len)
            b.p_len.copy_(p_len)
            if noise is None:
                gumbel_noise_(b.noise, generator)
            else:
                b.noise.copy_(noise)
            b.min_steps.fill_(int(min_steps))
            b.ms_dyn.fill_(ms_dyn)
            b.top_k.fill_(scfg.top_k)
            b.top_p.fill_(scfg.top_p)
            b.temperature.fill_(scfg.temperature)
            b.repetition_penalty.fill_(scfg.repetition_penalty)
            g.run(functools.partial(_prefill_block, params, cfg, Sx=Sx, Sp=Sp, embed=embed,
                                    any_top_p=any_top_p),
                  variant=("prefill", embed, any_top_p), eager=eager)
            step = 1
            while step < ms_dyn:
                # a block of DONE_READ_EVERY steps, or as many single steps as
                # are left before the cap (no step past it runs)
                n = min(DONE_READ_EVERY, ms_dyn - step)
                for w in [n] if n == DONE_READ_EVERY else [1] * n:
                    g.run(functools.partial(_decode_block, params, cfg, n_steps=w, Sx=Sx,
                                            Sp=Sp, any_top_p=any_top_p, packed=packed),
                          variant=(w, any_top_p), eager=eager)
                # the host reads `done` and the step counter once per block
                all_done, step = torch.stack([b.done.all().long(), b.step]).tolist()
                if all_done:
                    break
            tokens, counts = b.tokens.clone(), b.counts.clone()
    return GenerateResult(tokens=tokens, counts=counts, steps=int(step))


def finalize_tokens_device(tokens: torch.Tensor, counts: torch.Tensor,
                           eos_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [B, max_steps] zero-padded, codes_len [B]): the final emitted
    token becomes semantic code 0 (a reference quirk), then the codes end
    at the first remaining token >= EOS."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :]
    in_range = pos < counts[:, None]
    tokens = torch.where(pos == counts[:, None] - 1, torch.zeros_like(tokens), tokens)
    bad = (tokens >= eos_id) & in_range
    first_bad = torch.where(bad, pos, torch.full_like(pos, S)).amin(dim=1)
    codes_len = torch.minimum(counts, first_bad)
    codes = torch.where(pos < codes_len[:, None], tokens, torch.zeros_like(tokens))
    return codes, codes_len


def generate_e2e(params: Params, cfg: T2SConfig, scfg: SamplingConfig,
                 generator: Optional[torch.Generator], phones: torch.Tensor,
                 bert: Optional[torch.Tensor], x_len: torch.Tensor,
                 prompts: torch.Tensor, p_len: torch.Tensor, max_steps: int,
                 cache_len: int, min_steps: int = 0,
                 max_steps_dyn: Optional[int] = None,
                 stats: Optional[dict] = None,
                 noise: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed + prefill + AR decode + EOS finalize.

    Returns (codes [B, max_steps], codes_len [B]). ``stats``: optional
    dict that receives ``decode_steps`` (loop iterations run; the codes
    are at most that many plus one) and ``cache_len``. ``noise``: as
    :func:`generate`'s. The embedding runs inside generate's prefill
    program."""
    if bert is None:
        bert = torch.zeros(phones.shape + (cfg.bert_dim,), device=phones.device)
    res = generate(params, cfg, scfg, generator, (phones, bert), x_len, prompts, p_len,
                   max_steps=max_steps, cache_len=cache_len,
                   min_steps=min_steps, max_steps_dyn=max_steps_dyn, noise=noise)
    if stats is not None:
        stats["decode_steps"] = res.steps - 1
        stats["cache_len"] = cache_len
    return finalize_tokens_device(res.tokens, res.counts, cfg.eos_id)


# ---------------------------------------------------------------------------
# Training (teacher-forced): fine-tuning, and the dp x tp sharded train
# step of parallel/train.py
# ---------------------------------------------------------------------------

def forward_train(params: Params, cfg: T2SConfig, phones: torch.Tensor,
                  bert: torch.Tensor, x_len: torch.Tensor,
                  semantic: torch.Tensor, sem_len: torch.Tensor,
                  layer=_layer_prefill) -> torch.Tensor:
    """Teacher-forced logits over the audio block: [B, Sy, V] fp32.

    Position t predicts semantic[t + 1]; the GPT-SoVITS T2S training
    objective (next-token CE over audio positions, EOS appended).
    ``layer``: the decoder layer, ``(lp, h, mask, num_heads) -> (h, kv)``;
    the tensor-parallel step passes its own over local shards
    (``parallel/tp.py``). The per-layer views are made anew on each call,
    so autograd reaches the stacked ``[L, ...]`` leaves."""
    x = embed_text(params, phones, bert)
    B, Sx, D = x.shape
    Sy = semantic.shape[1]
    y_emb = params["audio_embed"][semantic]
    pe = sine_position_table(Sy, D, device=x.device)
    y = y_emb + (params["audio_pos_alpha"] * pe).to(y_emb.dtype)[None]
    h = torch.cat([x, y], dim=1)
    mask = _prefill_mask(Sx, Sy, x_len, sem_len)[:, None]
    layers = {k: v for k, v in params["layers"].items() if not k.startswith("_")}
    for lp in unstack(layers):
        h, _ = layer(lp, h, mask, cfg.num_heads)
    return h[:, Sx:].float() @ params["predict"]["w"].float()


def masked_nll(logits: torch.Tensor, semantic: torch.Tensor,
               sem_len: torch.Tensor, eos_id: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the next-token NLL over valid positions, the count of valid
    positions): targets are ``semantic`` shifted left, EOS at
    ``sem_len - 1``; positions from ``sem_len`` on are padding."""
    B, Sy, _ = logits.shape
    targets = torch.cat([semantic[:, 1:], torch.zeros_like(semantic[:, :1])], dim=1)
    pos = torch.arange(Sy, device=logits.device)[None, :]
    targets = torch.where(pos == sem_len[:, None] - 1,
                          torch.full_like(targets, eos_id), targets)
    valid = (pos < sem_len[:, None]).float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets[..., None].long())[..., 0]
    return (nll * valid).sum(), valid.sum()


def train_loss(params: Params, cfg: T2SConfig, batch) -> torch.Tensor:
    """Masked next-token cross-entropy, a 0-d fp32 tensor. batch keys:
    phones, bert, x_len, semantic, sem_len. The mean is over the valid
    positions of the whole batch."""
    logits = forward_train(params, cfg, batch["phones"], batch["bert"],
                           batch["x_len"], batch["semantic"], batch["sem_len"])
    total, count = masked_nll(logits, batch["semantic"], batch["sem_len"],
                              cfg.eos_id)
    return total / count.clamp(min=1.0)


def finalize_semantic_tokens(tokens, counts, eos_id: int = 1024):
    """Host-side post-processing matching the reference quirks: the final
    emitted token becomes semantic code 0, then anything >= ``eos_id``
    that remains ends the codes. Returns a list of 1-D numpy arrays."""
    tokens = np.asarray(tokens)
    counts = np.asarray(counts)
    out = []
    for row, cnt in zip(tokens, counts):
        seq = row[: int(cnt)].copy()
        if len(seq):
            seq[-1] = 0
        bad = np.nonzero(seq >= eos_id)[0]
        if len(bad):
            seq = seq[: bad[0]]
        out.append(seq)
    return out
