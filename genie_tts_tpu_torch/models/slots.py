"""In-flight (slot-based) continuous batching for the T2S decoder.

The port of ``genie_tts_tpu/models/slots.py``. The decoder runs as a
persistent B-slot machine: one decode loop advances every occupied slot W
steps per dispatch (a "segment"), and the host inserts a new request into
a free slot between segments, so a request joins within one segment.

* every shape is static: B slots, phoneme/prompt buckets, a decode RING of
  ``ring_len`` key/value columns per slot;
* per-row join times are handled by MASKS: a slot's visible ring columns
  are the last ``keys_written[b]`` writes before the row-uniform head;
* within a segment each step's K/V columns collect in a small buffer
  (``t2s._layer_decode_buffered``), and one merge per segment writes them
  at ``ring_head`` (every slot writes every step; finished and empty slots
  write garbage that their masks hide).

Ring invariant: a slot decodes at most ``ring_len`` tokens, and ring
column j is rewritten every ``ring_len`` steps, so no visible column is
ever clobbered. ``ring_len`` is a multiple of W, so a merge never wraps.

The state keeps the JAX package's shapes and layout leaf for leaf. The
port updates the big caches (and int8 scales) in place, at insert and at
each merge; every other leaf is replaced, never written in place, so a
tensor read from one segment's state (``done``, ``counts``) keeps that
segment's values while later segments run. ``ring_head`` is a Python int
(it is row-uniform and advances by W per segment), so no segment reads a
device value on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import T2SConfig
from ..ops.layers import sine_position_table, unstack
from ..ops.sampling import SamplingRows, gumbel_noise, sample_token_rows
from . import t2s

@dataclasses.dataclass
class SlotState:
    """Decode state for B slots.

    Caches [L,B,H,Dh,S] kv-major with S = Sx+Sp+2*ring_len:

    * ``[0, Sx+Sp)``: the request's COMPACTED prefill context (text then
      prompt columns gathered to the front: valid columns are exactly
      ``[0, x_len+p_len)``);
    * ``[Sx+Sp, Sx+Sp+ring)``: the decode ring in ring-index order;
    * ``[Sx+Sp+ring, Sx+Sp+2*ring)``: a second copy of the ring, written
      at ``head+ring`` by the same merge, so the last ``ring_len`` writes
      form one contiguous window ending at ``head+ring``.
    """
    k_cache: torch.Tensor             # [L,B,H,Dh,S]
    v_cache: torch.Tensor
    # int8 KV mode: the caches hold int8 codes and these the per-column
    # fp32 scales [L,B,H,S]; None in the exact mode
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    cur_tok: torch.Tensor             # [B] int32 last sampled token per row
    keys_written: torch.Tensor        # [B] int32 ring columns this row has written
    counts: torch.Tensor              # [B] int32 tokens emitted (frozen once done)
    done: torch.Tensor                # [B] bool row finished (EOS or cap)
    active: torch.Tensor              # [B] bool slot occupied
    hist: torch.Tensor                # [B,V] int32 repetition-penalty histogram
    x_len: torch.Tensor               # [B] int32
    p_len: torch.Tensor               # [B] int32
    min_steps: torch.Tensor           # [B] int32
    max_steps: torch.Tensor           # [B] int32 per-row decode cap (<= ring_len)
    samp_top_k: torch.Tensor          # [B] int32 per-row sampling parameters
    samp_top_p: torch.Tensor          # [B] float32
    samp_temp: torch.Tensor           # [B] float32
    samp_rep: torch.Tensor            # [B] float32
    ring_head: int                    # next write column in [0, ring_len)
    # host copy of samp_top_p: whether the top-p branch must run
    top_p_host: np.ndarray

    @property
    def sampling_rows(self) -> SamplingRows:
        return SamplingRows(top_k=self.samp_top_k, top_p=self.samp_top_p,
                            temperature=self.samp_temp,
                            repetition_penalty=self.samp_rep)


def quantize_kv_columns(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-column symmetric int8 quantization of K/V columns.

    x [..., Dh, S] -> (int8 codes [..., Dh, S], fp32 scale [..., S]); the
    scale is the column's max |x| over Dh divided by 127, computed in fp32
    and rounded half to even, as the JAX package does."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-2), min=1e-6) / 127.0
    return torch.round(xf / s[..., None, :]).to(torch.int8), s


def init_slots(cfg: T2SConfig, n_slots: int, sx: int, sp: int, ring_len: int,
               dtype=torch.bfloat16, kv_int8: bool = False,
               device="cpu") -> SlotState:
    L, H, Dh, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.semantic_vocab
    S = sx + sp + 2 * ring_len        # doubled ring: see SlotState
    B = n_slots
    i32 = torch.int32

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    def full(value, dt):
        return torch.full((B,), value, dtype=dt, device=device)

    cache_dtype = torch.int8 if kv_int8 else dtype
    return SlotState(
        k_cache=z((L, B, H, Dh, S), cache_dtype),
        v_cache=z((L, B, H, Dh, S), cache_dtype),
        k_scale=z((L, B, H, S), torch.float32) if kv_int8 else None,
        v_scale=z((L, B, H, S), torch.float32) if kv_int8 else None,
        cur_tok=z((B,), i32), keys_written=z((B,), i32), counts=z((B,), i32),
        done=full(True, torch.bool), active=z((B,), torch.bool),
        hist=z((B, V), i32), x_len=z((B,), i32), p_len=z((B,), i32),
        min_steps=z((B,), i32), max_steps=full(ring_len, i32),
        samp_top_k=z((B,), i32), samp_top_p=full(1.0, torch.float32),
        samp_temp=full(1.0, torch.float32), samp_rep=full(1.0, torch.float32),
        ring_head=0, top_p_host=np.ones(B, np.float32))


def prefill_join(params: t2s.Params, cfg: T2SConfig,
                 phones: torch.Tensor,          # [1, Sx] packed [ref_text | text]
                 bert: Optional[torch.Tensor],  # [1, Sx, bert_dim] or None
                 x_len: torch.Tensor,           # [1]
                 prompts: torch.Tensor,         # [1, Sp]
                 p_len: torch.Tensor,           # [1]
                 samp: SamplingRows,            # per-row values, shape [1]
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 any_top_p: Optional[bool] = None):
    """One request's prefill at the slot geometry.

    Returns (ctx_k [L,1,H,Dh,Sx+Sp], ctx_v, tok0 [1] int32, hist [1,V]
    int32) for :func:`insert_slot`. The first token forbids EOS, as
    ``t2s.generate``'s does; its Gumbel noise is ``noise`` [1,V], or drawn
    from ``generator``. ``any_top_p``: whether ``samp.top_p < 1`` (read
    from ``samp`` when not given). The context columns come back COMPACTED: the valid
    text columns ``[0, x_len)`` then the prompt columns ``[Sx, Sx+p_len)``
    gathered to the front (decode attention sees the same key set; only
    the column order changes)."""
    Sx, Sp = phones.shape[1], prompts.shape[1]
    V = cfg.semantic_vocab
    dev = phones.device
    if bert is None:
        bert = torch.zeros(phones.shape + (cfg.bert_dim,), device=dev)
    x = t2s.embed_text(params, phones, bert)
    logits0, (k_ctx, v_ctx) = t2s.prefill(params, cfg, x, x_len, prompts, p_len,
                                          cache_len=Sx + Sp)
    # kv-major [L,1,H,Dh,Sx+Sp]; position j reads source column j (text) or
    # Sx + j - x_len (prompt); columns past x_len+p_len are garbage behind
    # the decode mask
    pos = torch.arange(Sx + Sp, device=dev)
    src = torch.where(pos < x_len[0], pos,
                      torch.clamp(Sx + pos - x_len[0], max=Sx + Sp - 1))
    k_ctx = k_ctx.transpose(-1, -2).index_select(-1, src)
    v_ctx = v_ctx.transpose(-1, -2).index_select(-1, src)
    hist = torch.zeros((1, V), dtype=torch.int32, device=dev)
    prompt_valid = torch.arange(Sp, device=dev)[None, :] < p_len[:, None]
    hist.scatter_add_(1, prompts.long(), prompt_valid.int())
    forbid_eos = torch.zeros((V,), dtype=torch.bool, device=dev)
    forbid_eos[cfg.eos_id] = True
    tok0 = sample_token_rows(generator, logits0, hist, samp, forbid=forbid_eos,
                             noise=noise, any_top_p=any_top_p)
    hist = hist + F.one_hot(tok0, V).int()
    return k_ctx, v_ctx, tok0.int(), hist


def _scalar(v):
    """A [] / [1] value as a Python number or a 0-d tensor (no host read)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(())
    return np.asarray(v).reshape(-1)[0].item()


def _set1(vec: torch.Tensor, b: int, value) -> torch.Tensor:
    out = vec.clone()
    out[b] = _scalar(value)
    return out


def insert_slot(state: SlotState, slot: int, ctx_k: torch.Tensor,
                ctx_v: torch.Tensor, tok0: torch.Tensor, hist: torch.Tensor,
                x_len, p_len, min_steps, max_steps,
                samp: SamplingRows) -> SlotState:
    """Claim slot ``slot`` for a prefilled request. The context columns go
    into the big caches in place (quantized per column in int8 mode);
    every other leaf is replaced. Scalars may be Python numbers, numpy
    values or device tensors of shape [] or [1]."""
    b = int(slot)
    C = ctx_k.shape[-1]
    if state.k_scale is not None:
        ctx_k, ks = quantize_kv_columns(ctx_k)
        ctx_v, vs = quantize_kv_columns(ctx_v)
        state.k_scale[:, b:b + 1, :, :C] = ks
        state.v_scale[:, b:b + 1, :, :C] = vs
    state.k_cache[:, b:b + 1, ..., :C] = ctx_k.to(state.k_cache.dtype)
    state.v_cache[:, b:b + 1, ..., :C] = ctx_v.to(state.v_cache.dtype)
    hist_all = state.hist.clone()
    hist_all[b:b + 1] = hist
    top_p = samp.top_p
    top_p_host = state.top_p_host.copy()
    top_p_host[b] = float(top_p.reshape(-1)[0]) if isinstance(top_p, torch.Tensor) \
        else _scalar(top_p)
    return dataclasses.replace(
        state, cur_tok=_set1(state.cur_tok, b, tok0),
        keys_written=_set1(state.keys_written, b, 0),
        counts=_set1(state.counts, b, 1),
        done=_set1(state.done, b, False), active=_set1(state.active, b, True),
        hist=hist_all, x_len=_set1(state.x_len, b, x_len),
        p_len=_set1(state.p_len, b, p_len),
        min_steps=_set1(state.min_steps, b, min_steps),
        max_steps=_set1(state.max_steps, b, max_steps),
        samp_top_k=_set1(state.samp_top_k, b, samp.top_k),
        samp_top_p=_set1(state.samp_top_p, b, samp.top_p),
        samp_temp=_set1(state.samp_temp, b, samp.temperature),
        samp_rep=_set1(state.samp_rep, b, samp.repetition_penalty),
        top_p_host=top_p_host)


def release_slot(state: SlotState, slot: int) -> SlotState:
    """Free a harvested slot (its cache columns are garbage behind masks)."""
    return dataclasses.replace(state, active=_set1(state.active, slot, False),
                               done=_set1(state.done, slot, True))


def decode_segment(params: t2s.Params, state: SlotState, cfg: T2SConfig,
                   seg_steps: int, sx: int, sp: int, ring_len: int,
                   kv_kernel: bool = False, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[SlotState, torch.Tensor]:
    """Advance every occupied slot ``seg_steps`` decode steps.

    Returns (state', seg_tokens [B, W] int32): the tokens sampled this
    segment per row (done and empty rows repeat EOS). The loop always runs
    its W steps and reads nothing back to the host. ``noise`` [W,B,V] is
    the Gumbel noise of the W steps, drawn from ``generator`` when not
    given. Each step's K/V columns collect in a [L,B,H,Dh,W] buffer in the
    compute dtype; one merge writes them to the ring at the row-uniform
    head, twice (at ``head`` and ``head+ring``), quantized per column in
    int8 mode.

    Two read routes for the big cache: ``kv_kernel`` with int8 caches
    reads the first ring copy ``[0, Sx+Sp+ring)`` through the
    ``int8_big_attention`` kernel, which recomputes visibility from the
    segment-frozen ``x_len``/``p_len``/``keys_written``/``ring_head``;
    otherwise the full read: the context ``[0, Sx+Sp)`` and the ring window
    ``[Sx+Sp+head, Sx+Sp+head+ring)`` of the doubled ring, with masks.
    """
    assert ring_len % seg_steps == 0, "segment must not wrap the ring"
    W = seg_steps
    L, B, H, Dh, S = state.k_cache.shape
    dev = state.k_cache.device
    int8_kv = state.k_scale is not None
    buf_dtype = params["audio_embed"].dtype if int8_kv else state.k_cache.dtype
    V, eos = cfg.semantic_vocab, cfg.eos_id
    Sx, Sp = sx, sp
    use_kernel = int8_kv and kv_kernel
    pe_full = sine_position_table(Sx + Sp + ring_len, cfg.embed_dim, device=dev)
    if noise is None:
        noise = gumbel_noise((W, B, V), generator, dev)
    noise = torch.as_tensor(noise, device=dev)
    forbid_eos = torch.zeros((V,), dtype=torch.bool, device=dev)
    forbid_eos[eos] = True
    head0 = int(state.ring_head)

    if use_kernel:
        S1 = Sx + Sp + ring_len
        regions = [(state.k_cache[..., :S1], state.v_cache[..., :S1],
                    state.k_scale[..., :S1], state.v_scale[..., :S1])]
        kv_mask = None
        ctx = (state.x_len, state.p_len, state.keys_written, head0, Sx, Sp, ring_len)
    else:
        w0 = Sx + Sp + head0          # the last ring_len writes end at head+ring
        cut = (slice(0, Sx + Sp), slice(w0, w0 + ring_len))

        def scales(t):
            return (None, None) if t is None else tuple(t[..., c] for c in cut)

        regions = list(zip(*(tuple(state.k_cache[..., c] for c in cut),
                             tuple(state.v_cache[..., c] for c in cut),
                             scales(state.k_scale), scales(state.v_scale))))
        ctx_len = state.x_len + state.p_len
        win_age = ring_len - 1 - torch.arange(ring_len, device=dev)[None, :]
        kv_mask = (torch.arange(Sx + Sp, device=dev)[None, :] < ctx_len[:, None],
                   win_age < state.keys_written[:, None])
        ctx = None
    # per-layer views of each region: (k, v, k_scale, v_scale) per layer
    per_layer = [[tuple(None if t is None else t[l] for t in reg) for reg in regions]
                 for l in range(L)]
    layers = unstack(params["layers"])

    k_buf = torch.zeros((L, B, H, Dh, W), dtype=buf_dtype, device=dev)
    v_buf = torch.zeros_like(k_buf)
    buf_masks = torch.arange(W, device=dev)[None, :] < torch.arange(W, device=dev)[:, None]
    seg_tokens = torch.full((B, W), eos, dtype=torch.int32, device=dev)
    rows = state.sampling_rows
    any_top_p = bool((state.top_p_host < 1.0).any())
    predict_w = params["predict"]["w"].float()
    audio_embed, alpha = params["audio_embed"], params["audio_pos_alpha"]
    cur_tok, keys_written, counts = state.cur_tok, state.keys_written, state.counts
    done, hist = state.done, state.hist

    for i in range(W):
        emb = audio_embed[cur_tok.long()]                         # [B, D]
        pos_emb = pe_full[(state.p_len + keys_written).long()]
        h = (emb + (alpha * pos_emb).to(emb.dtype))[:, None]
        for l, lp in enumerate(layers):
            if use_kernel:
                (kb, vb, ks, vs), = per_layer[l]
            else:
                kb, vb, ks, vs = (tuple(r[j] for r in per_layer[l]) for j in range(4))
                if not int8_kv:
                    ks = vs = None
            h, k_new, v_new = t2s._layer_decode_buffered(
                lp, h, kb, vb, k_buf[l], v_buf[l], buf_masks[i], kv_mask, H,
                k_scale=ks, v_scale=vs, kv_kernel_ctx=ctx)
            k_buf[l, ..., i] = k_new
            v_buf[l, ..., i] = v_new
        logits = h[:, 0].float() @ predict_w
        # per-row EOS gate: below min_steps EOS is masked out of sampling
        row_step = keys_written + 1
        forbid = forbid_eos[None, :] & (row_step < state.min_steps)[:, None]
        nxt = sample_token_rows(None, logits, hist, rows, forbid=forbid,
                                noise=noise[i], any_top_p=any_top_p)
        argmax_eos = torch.argmax(logits, dim=-1) == eos
        now_done = (argmax_eos | (nxt == eos)) & (row_step >= state.min_steps)
        # t2s.generate's bookkeeping: a row samples while row_step <
        # max_steps and is done once row_step+1 reaches it
        alive = state.active & ~done & (row_step < state.max_steps)
        nxt = torch.where(alive, nxt, torch.full_like(nxt, eos)).int()
        seg_tokens[:, i] = nxt
        hist = hist + F.one_hot(nxt.long(), V).int() * alive[:, None].int()
        keys_written = keys_written + alive.int()
        counts = torch.where(alive, counts + 1, counts)
        done = done | now_done | (row_step + 1 >= state.max_steps)
        cur_tok = nxt

    # merge the segment's W columns at the ring head, twice
    base = Sx + Sp + head0
    if int8_kv:
        k_buf, ks = quantize_kv_columns(k_buf)
        v_buf, vs = quantize_kv_columns(v_buf)
        for at in (base, base + ring_len):
            state.k_scale[..., at:at + W] = ks
            state.v_scale[..., at:at + W] = vs
    for at in (base, base + ring_len):
        state.k_cache[..., at:at + W] = k_buf.to(state.k_cache.dtype)
        state.v_cache[..., at:at + W] = v_buf.to(state.v_cache.dtype)
    state = dataclasses.replace(
        state, cur_tok=cur_tok, keys_written=keys_written, counts=counts,
        done=done, hist=hist, ring_head=(head0 + W) % ring_len)
    return state, seg_tokens
