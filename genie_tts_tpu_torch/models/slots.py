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

Under tp (a parameter set from ``parallel/mesh.py::shard_serving_params``)
the big caches are per shard, ``H/tp`` heads each on its shard's device;
the small state stays on the first shard's device, and the prefill, the
windowed read or the ``int8_big_attention`` kernel, the quantization and
the merges run per shard (``parallel/tp.py::layer_decode_buffered_shards``).
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
    # tp > 1: (k_cache, v_cache, k_scale, v_scale) of shards 1..tp-1, each
    # of H/tp heads on its device; the four fields above are shard 0's
    tp_caches: tuple = ()

    @property
    def cache_shards(self) -> list:
        """(k_cache, v_cache, k_scale, v_scale) of every tp shard, in rank
        order (one for a state that is not sharded)."""
        return [(self.k_cache, self.v_cache, self.k_scale, self.v_scale),
                *self.tp_caches]

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
               device="cpu", tp_devices=None) -> SlotState:
    """An empty B-slot state on ``device``. ``tp_devices``: the devices of
    a tp-sharded parameter set's shards (``t2s.shard_devices``); with more
    than one, each gets big caches of ``H/tp`` heads and the small state
    stays on ``device``, which must be the first."""
    L, H, Dh, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.semantic_vocab
    S = sx + sp + 2 * ring_len        # doubled ring: see SlotState
    B = n_slots
    i32 = torch.int32
    tp_devices = list(tp_devices or [device])
    Hs = H // len(tp_devices)

    def z(shape, dt, dev=device):
        return torch.zeros(shape, dtype=dt, device=dev)

    def full(value, dt):
        return torch.full((B,), value, dtype=dt, device=device)

    cache_dtype = torch.int8 if kv_int8 else dtype
    caches = [(z((L, B, Hs, Dh, S), cache_dtype, d), z((L, B, Hs, Dh, S), cache_dtype, d),
               z((L, B, Hs, S), torch.float32, d) if kv_int8 else None,
               z((L, B, Hs, S), torch.float32, d) if kv_int8 else None)
              for d in tp_devices]
    return SlotState(
        k_cache=caches[0][0], v_cache=caches[0][1],
        k_scale=caches[0][2], v_scale=caches[0][3], tp_caches=tuple(caches[1:]),
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
    int32) for :func:`insert_slot` (for a tp-sharded ``params``, ctx_k and
    ctx_v are tuples with each shard's ``H/tp`` heads on its device). The first token forbids EOS, as
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

    def compact(c):
        return c.transpose(-1, -2).index_select(-1, src.to(c.device))

    if isinstance(k_ctx, tuple):
        k_ctx, v_ctx = tuple(map(compact, k_ctx)), tuple(map(compact, v_ctx))
    else:
        k_ctx, v_ctx = compact(k_ctx), compact(v_ctx)
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
    into the big caches in place (quantized per column in int8 mode), per
    tp shard when ``ctx_k``/``ctx_v`` are tuples of shards; every other
    leaf is replaced. Scalars may be Python numbers, numpy values or
    device tensors of shape [] or [1]."""
    b = int(slot)
    if not isinstance(ctx_k, tuple):
        ctx_k, ctx_v = (ctx_k,), (ctx_v,)
    for ck, cv, (kc, vc, ks_c, vs_c) in zip(ctx_k, ctx_v, state.cache_shards,
                                           strict=True):
        C = ck.shape[-1]
        if ks_c is not None:
            ck, ks = quantize_kv_columns(ck)
            cv, vs = quantize_kv_columns(cv)
            ks_c[:, b:b + 1, :, :C] = ks
            vs_c[:, b:b + 1, :, :C] = vs
        kc[:, b:b + 1, ..., :C] = ck.to(kc.dtype)
        vc[:, b:b + 1, ..., :C] = cv.to(vc.dtype)
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
                   generator: Optional[torch.Generator] = None,
                   ctx_win: Optional[int] = None, ring_win: Optional[int] = None
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
    segment-frozen ``x_len``/``p_len``/``keys_written``/``ring_head``, and
    ignores the windows; otherwise the windowed read: the first ``ctx_win``
    context columns and the last ``ring_win`` ring writes, a window that
    ends at ``Sx+Sp+head+ring`` in the doubled ring (window column j holds
    the write of age ``ring_win-1-j``), with masks. The caller guarantees
    that every active row fits (``x_len+p_len <= ctx_win``,
    ``keys_written <= ring_win``); None (the default) reads the whole
    context or ring.

    A tp-sharded ``params`` (with a state from ``init_slots(...,
    tp_devices=t2s.shard_devices(params))``) runs each layer over its
    shards: each reads and merges its own caches of ``H/tp`` heads, on the
    kernel route with one ``int8_big_attention`` launch per shard.
    """
    assert ring_len % seg_steps == 0, "segment must not wrap the ring"
    W = seg_steps
    caches = state.cache_shards
    devs = [c[0].device for c in caches]
    L, B, _, Dh, S = state.k_cache.shape
    H = cfg.num_heads
    dev = devs[0]
    int8_kv = state.k_scale is not None
    buf_dtype = params["audio_embed"].dtype if int8_kv else state.k_cache.dtype
    V, eos = cfg.semantic_vocab, cfg.eos_id
    Sx, Sp = sx, sp
    ctx_win = min(ctx_win or Sx + Sp, Sx + Sp)
    ring_win = min(ring_win or ring_len, ring_len)
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
        cut = (slice(0, S1),)
        kv_mask = None
    else:
        w1 = Sx + Sp + ring_len + head0    # the ring writes end at head+ring
        cut = (slice(0, ctx_win), slice(w1 - ring_win, w1))
        ctx_len = state.x_len + state.p_len
        win_age = ring_win - 1 - torch.arange(ring_win, device=dev)[None, :]
        kv_mask = (torch.arange(ctx_win, device=dev)[None, :] < ctx_len[:, None],
                   win_age < state.keys_written[:, None])
    buf_masks = torch.arange(W, device=dev)[None, :] < torch.arange(W, device=dev)[:, None]

    # per shard, the keyword arguments of t2s.buffered_attention for each
    # layer (buffer column and its mask filled in per step): the big-cache
    # regions (one region on the kernel route, which recomputes visibility
    # from the segment-frozen lengths; the context and ring windows with
    # masks otherwise) and the segment's write buffer [L,B,H/tp,Dh,W]
    def regions(t):
        return None if t is None else tuple(t[..., c] for c in cut)

    reads, bufs, step_masks = [], [], []
    for (kc, vc, ksc, vsc), d in zip(caches, devs):
        k_buf = torch.zeros(kc.shape[:3] + (Dh, W), dtype=buf_dtype, device=d)
        bufs.append((k_buf, torch.zeros_like(k_buf)))
        step_masks.append(buf_masks.to(d))
        if use_kernel:
            ctx = tuple(t.to(d) for t in (state.x_len, state.p_len, state.keys_written)) + (
                head0, Sx, Sp, ring_len)
            mask_d = None
        else:
            ctx = None
            mask_d = tuple(m.to(d) for m in kv_mask)
        rk, rv, rks, rvs = (regions(t) for t in (kc, vc, ksc, vsc))
        per_layer = []
        for l in range(L):
            kb, vb = tuple(r[l] for r in rk), tuple(r[l] for r in rv)
            ks = vs = None
            if int8_kv:
                ks, vs = tuple(r[l] for r in rks), tuple(r[l] for r in rvs)
            if use_kernel:
                kb, vb, ks, vs = kb[0], vb[0], ks[0], vs[0]
            per_layer.append(dict(k_big=kb, v_big=vb, kv_mask=mask_d, k_scale=ks,
                                  v_scale=vs, kv_kernel_ctx=ctx))
        reads.append(per_layer)
    shards = t2s.layer_shards(params)
    if shards is None:
        layers = unstack(params["layers"])
    else:
        from ..parallel.tp import layer_decode_buffered_shards

        layers = list(zip(*(unstack(sh) for sh in shards)))

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
            step = [dict(reads[j][l], k_buf=kb[l], v_buf=vb[l], buf_mask=bm[i])
                    for j, ((kb, vb), bm) in enumerate(zip(bufs, step_masks))]
            if shards is None:
                h, k_new, v_new = t2s._layer_decode_buffered(lp, h, num_heads=H, **step[0])
                new = [(k_new, v_new)]
            else:
                h, new = layer_decode_buffered_shards(lp, h, step, H)
            for (kb, vb), (k_new, v_new) in zip(bufs, new):
                kb[l, ..., i] = k_new
                vb[l, ..., i] = v_new
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

    # merge the segment's W columns at the ring head, twice, per shard
    base = Sx + Sp + head0
    for (kc, vc, ksc, vsc), (k_buf, v_buf) in zip(caches, bufs):
        if int8_kv:
            k_buf, ks = quantize_kv_columns(k_buf)
            v_buf, vs = quantize_kv_columns(v_buf)
            for at in (base, base + ring_len):
                ksc[..., at:at + W] = ks
                vsc[..., at:at + W] = vs
        for at in (base, base + ring_len):
            kc[..., at:at + W] = k_buf.to(kc.dtype)
            vc[..., at:at + W] = v_buf.to(vc.dtype)
    state = dataclasses.replace(
        state, cur_tok=cur_tok, keys_written=keys_written, counts=counts,
        done=done, hist=hist, ring_head=(head0 + W) % ring_len)
    return state, seg_tokens
