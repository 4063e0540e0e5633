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

The state keeps the JAX package's shapes and layout leaf for leaf, the
ring head included: an int32 on the device, as in the reference, advanced
by the segment itself. Every leaf is updated IN PLACE (at insert,
release and each segment), so a segment is a program over static buffers
that a CUDA graph captures once per geometry (``runtime/graphs.py``): the
attention reads the head from device memory, and the merge writes at it.
A caller that reads ``done`` or ``counts`` of one segment after the next
one was dispatched copies them first (the schedulers enqueue one copy
right behind each segment). The graphs of a geometry are the
configuration's (they read its bank: ``runtime/graphs.py``) and replay on
its RESIDENT state (:class:`StateHome`), which holds one owner's state at
a time: a state made ``persistent`` (a slot batcher's or a segmented
stream's, ``TTSEngine.take_slot_state``) stays resident until another
owner takes its place, and is copied back then (so one machine pays no
copy); any other state is copied in and back around each use. Its leaves
are the resident buffers while it is resident; a caller that reads them
while other owners may run reads them in :func:`holding`.

A request joins through three more programs, the JAX package's jitted
join (``runtime/slot_batcher.py:90-131`` there): :func:`prefill_join`
(prefill, compaction, first token; a graph per (Sx, Sp) with a variant
per BERT flag and top-p flag), :func:`insert_slot` and
:func:`release_slot` (graphs on the state, the slot index and the row's
values read from device memory, so one graph serves every slot).

Under tp (a parameter set from ``parallel/mesh.py::shard_serving_params``)
the big caches are per shard, ``H/tp`` heads each on its shard's device;
the small state stays on the first shard's device, and the prefill, the
attention, the quantization and the merges run per shard
(``parallel/tp.py::layer_decode_buffered_shards``), each in its shard's
work (``t2s.on_shard``: a capture stream of its tp rank's own while
captured), in graphs of the set's cache as a whole set's are. Copies into and out of a graph's buffers on another card than the
lead are ordered with the lead card's stream
(``runtime/graphs.py::on_device_stream``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import T2SConfig
from ..ops.int8_decode import visibility
from ..ops.layers import sine_position_table, unstack
from ..ops.sampling import SamplingRows, gumbel_noise, gumbel_noise_, sample_token_rows
from ..runtime import graphs
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
      form one contiguous window ending at ``head+ring`` (the JAX
      package's windowed read reads it; the port's attention reads the
      first copy, and keeps the JAX layout leaf for leaf).
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
    ring_head: torch.Tensor           # [] int32 next write column in [0, ring_len)
    # host copy of samp_top_p: whether the top-p branch must run
    top_p_host: np.ndarray
    # tp > 1: (k_cache, v_cache, k_scale, v_scale) of shards 1..tp-1, each
    # of H/tp heads on its device; the four fields above are shard 0's
    tp_caches: tuple = ()
    # the buffers of the segment graphs that capture it (lives as long as
    # its slot machine); see the module note
    persistent: bool = False

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
        ring_head=z((), i32), top_p_host=np.ones(B, np.float32))


def reset_slots(state: SlotState, ring_len: int) -> SlotState:
    """Empty every slot of ``state`` in place: the values of
    :func:`init_slots`."""
    for shard in state.cache_shards:
        with graphs.on_device_stream(shard[0].device):
            for t in shard:
                if t is not None:
                    t.zero_()
    for t in (state.cur_tok, state.keys_written, state.counts, state.active, state.hist,
              state.x_len, state.p_len, state.min_steps, state.samp_top_k,
              state.ring_head):
        t.zero_()
    state.done.fill_(True)
    state.max_steps.fill_(ring_len)
    for t in (state.samp_top_p, state.samp_temp, state.samp_rep):
        t.fill_(1.0)
    state.top_p_host[:] = 1.0
    return state


def _tensor_fields(state: SlotState) -> list:
    return [f.name for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)]


def _clone_shard(shard: tuple) -> tuple:
    with graphs.on_device_stream(shard[0].device):
        return tuple(None if t is None else t.clone() for t in shard)


def clone_state(state: SlotState) -> SlotState:
    """A copy of a state in buffers of its own (a tp-sharded one's caches
    on their shards' devices)."""
    return dataclasses.replace(
        state, **{n: getattr(state, n).clone() for n in _tensor_fields(state)},
        tp_caches=tuple(_clone_shard(c) for c in state.tp_caches),
        top_p_host=state.top_p_host.copy(), persistent=False)


def copy_state(dst: SlotState, src: SlotState, host: bool = True) -> None:
    """Every leaf of ``src`` into ``dst``'s buffers (every tp shard's
    caches too; ``host``: the host mirror too)."""
    for n in _tensor_fields(dst):
        getattr(dst, n).copy_(getattr(src, n))
    for d_shard, s_shard in zip(dst.tp_caches, src.tp_caches, strict=True):
        with graphs.on_device_stream(d_shard[0].device):
            for d, s_ in zip(d_shard, s_shard):
                if d is not None:
                    d.copy_(s_)
    if host:
        dst.top_p_host[:] = src.top_p_host


def _point(state: SlotState, src: SlotState) -> None:
    """Make ``state``'s leaves ``src``'s tensors (its host mirror stays)."""
    for n in _tensor_fields(src):
        setattr(state, n, getattr(src, n))
    state.tp_caches = src.tp_caches


class StateHome:
    """The RESIDENT slot state of one configuration and slot geometry: the
    buffers its segment, insert and release graphs replay on, holding one
    owner's state at a time (``graphs.Residency``). A persistent state (a
    slot machine's or a segmented stream's) is copied in when it is not
    resident and its leaves then ARE the resident buffers, until another
    owner takes its place: its contents are copied back and its leaves are
    its own again. So copies cost nothing while one owner runs. Any other
    state is copied in and back around each use."""

    def __init__(self, template: SlotState):
        self.state = clone_state(template)
        self.residency = graphs.Residency(template.hist.device, self._load, self._save)

    def _load(self, state: SlotState) -> None:
        if state.persistent:
            state._own = dataclasses.replace(state)      # its buffers while it is here
            copy_state(self.state, state._own, host=False)
            _point(state, self.state)
        else:
            copy_state(self.state, state, host=False)

    def _save(self, state: SlotState) -> None:
        if state.persistent:
            copy_state(state._own, self.state, host=False)
            _point(state, state._own)
            del state._own
        else:
            copy_state(state, self.state, host=False)


def _geometry_key(state: SlotState) -> tuple:
    """A slot state's static geometry (its shard devices included)."""
    return (tuple(state.k_cache.shape), state.k_cache.dtype, state.k_scale is not None,
            tuple(c[0].device for c in state.cache_shards))


def _home(params: t2s.Params, state: SlotState) -> StateHome:
    return graphs.cache_for(params).shared(("slot_state",) + _geometry_key(state),
                                           lambda: StateHome(state))


@contextlib.contextmanager
def holding(params: Optional[t2s.Params], state: SlotState):
    """Hold ``state`` resident in its geometry's :class:`StateHome` in the
    cache of ``params`` while the block lasts, and yield the state to
    read and run programs on: a persistent ``state`` itself (its leaves
    are the resident buffers now), else the resident buffers with
    ``state``'s host mirror (copied back to ``state`` when the block
    ends). ``state`` itself without ``params``. A caller that reads a
    state's leaves while other owners may run reads them here."""
    if params is None:
        yield state
        return
    home = _home(params, state)
    with home.residency.hold(state, transient=not state.persistent):
        yield (state if state.persistent
               else dataclasses.replace(home.state, top_p_host=state.top_p_host))


@dataclasses.dataclass
class JoinBuffers:
    """The static buffers of the join program (:func:`_join`): one
    request's inputs (packed phones, BERT features, lengths, prompts, its
    sampling values and the first draw's Gumbel noise) and outputs (the
    compacted context columns per tp shard, the first token and the
    repetition histogram)."""
    phones: torch.Tensor      # [1, Sx] int64
    bert: torch.Tensor        # [1, Sx, bert_dim] fp32
    x_len: torch.Tensor       # [1] int64
    prompts: torch.Tensor     # [1, Sp] int64
    p_len: torch.Tensor       # [1] int64
    samp: SamplingRows        # [1] each: top_k int32, the others fp32
    noise: torch.Tensor       # [1, V] fp32
    ctx_k: tuple              # per shard [L, 1, H/tp, Dh, Sx+Sp]
    ctx_v: tuple
    tok0: torch.Tensor        # [1] int32
    hist: torch.Tensor        # [1, V] int32


def _join_buffers(params: t2s.Params, cfg: T2SConfig, sx: int, sp: int) -> JoinBuffers:
    dev = params["audio_embed"].device
    ctx_dtype = torch.promote_types(params["text_embed"].dtype, params["audio_embed"].dtype)
    L, H, Dh, V = cfg.num_layers, cfg.num_heads, cfg.head_dim, cfg.semantic_vocab
    devs = t2s.shard_devices(params)

    def z(*shape, dt=torch.int64, d=dev):
        return torch.zeros(shape, dtype=dt, device=d)

    ctx = [tuple(z(L, 1, H // len(devs), Dh, sx + sp, dt=ctx_dtype, d=d) for d in devs)
           for _ in range(2)]
    f32 = torch.float32
    return JoinBuffers(
        phones=z(1, sx), bert=z(1, sx, cfg.bert_dim, dt=f32), x_len=z(1) + 1,
        prompts=z(1, sp), p_len=z(1) + 1,
        samp=SamplingRows(z(1, dt=torch.int32), z(1, dt=f32) + 1, z(1, dt=f32) + 1,
                          z(1, dt=f32) + 1),
        noise=z(1, V, dt=f32), ctx_k=ctx[0], ctx_v=ctx[1], tok0=z(1, dt=torch.int32),
        hist=z(1, V, dt=torch.int32))


def _join(params: t2s.Params, cfg: T2SConfig, b: JoinBuffers, *, with_bert: bool,
          any_top_p: bool) -> None:
    """The program of :func:`prefill_join` over ``b``: the prefill, the
    context columns compacted on the device (``x_len`` is read there), the
    histogram of the valid prompt tokens and the first token (EOS
    forbidden). Reads nothing back to the host. ``with_bert`` False: the
    BERT features are zero (the buffer is zeroed here)."""
    Sx, Sp = b.phones.shape[1], b.prompts.shape[1]
    V = cfg.semantic_vocab
    dev = b.phones.device
    if not with_bert:
        b.bert.zero_()
    x = t2s.embed_text(params, b.phones, b.bert)
    logits0, (k_ctx, v_ctx) = t2s.prefill(params, cfg, x, b.x_len, b.prompts, b.p_len,
                                          cache_len=Sx + Sp)
    # kv-major [L,1,H,Dh,Sx+Sp]; position j reads source column j (text) or
    # Sx + j - x_len (prompt); columns past x_len+p_len are garbage behind
    # the decode mask
    pos = torch.arange(Sx + Sp, device=dev)
    src = torch.where(pos < b.x_len[0], pos,
                      torch.clamp(Sx + pos - b.x_len[0], max=Sx + Sp - 1))
    if not isinstance(k_ctx, tuple):
        k_ctx, v_ctx = (k_ctx,), (v_ctx,)
    sharded = len(k_ctx) > 1
    for i, (ok, ov, ck, cv) in enumerate(zip(b.ctx_k, b.ctx_v, k_ctx, v_ctx, strict=True)):
        with t2s.on_shard(sharded, i, ck.device):
            at = src.to(ck.device)
            for out, c in ((ok, ck), (ov, cv)):
                out.copy_(c.transpose(-1, -2).index_select(-1, at))
    b.hist.zero_()
    prompt_valid = torch.arange(Sp, device=dev)[None, :] < b.p_len[:, None]
    b.hist.scatter_add_(1, b.prompts, prompt_valid.int())
    forbid_eos = torch.arange(V, device=dev) == cfg.eos_id     # no host scalar: capturable
    tok0 = sample_token_rows(None, logits0, b.hist, b.samp, forbid=forbid_eos,
                             noise=b.noise, any_top_p=any_top_p)
    b.hist.scatter_add_(1, tok0[:, None], torch.ones_like(b.hist[:, :1]))
    b.tok0.copy_(tok0)


def join_graph(params: t2s.Params, cfg: T2SConfig, sx: int, sp: int):
    """The join program's graph at (Sx, Sp) in the configuration's cache
    (its buffers made on a miss: a tp-sharded set's context columns per
    shard on its device, key ``("join", "tp", Sx, Sp, dtype)``), and its
    programs by variant ``(BERT features given, top-p)`` over ``params``:
    the bank of a bound set (``GraphCache.bind``), or for an eager run the
    set itself."""
    route = ("tp",) if t2s.layer_shards(params) is not None else ()
    g = graphs.cache_for(params).graph(
        ("join",) + route + (sx, sp, params["audio_embed"].dtype),
        lambda: _join_buffers(params, cfg, sx, sp))
    return g, {(bert, top_p): functools.partial(_join, params, cfg, with_bert=bert,
                                                any_top_p=top_p)
               for bert in (False, True) for top_p in (False, True)}


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
    in place from ``generator``. ``any_top_p``: whether ``samp.top_p < 1`` (read
    from ``samp`` when not given). The context columns come back COMPACTED: the valid
    text columns ``[0, x_len)`` then the prompt columns ``[Sx, Sx+p_len)``
    gathered to the front (decode attention sees the same key set; only
    the column order changes).

    The JAX package's ``_prefill_jit``: the program :func:`_join` over the
    static buffers of :func:`join_graph` (on the card a replay of the CUDA
    graph of its variant) with ``params`` bound, held from the inputs'
    copy in to the outputs' copies out."""
    Sx, Sp = phones.shape[1], prompts.shape[1]
    if any_top_p is None:
        any_top_p = bool((torch.as_tensor(samp.top_p) < 1.0).any())
    variant = (bert is not None, bool(any_top_p))
    with graphs.cache_for(params).bind(params) as params:
        g, progs = join_graph(params, cfg, Sx, Sp)
        with g.lock:
            b = g.static
            b.phones.copy_(phones)
            if bert is not None:
                b.bert.copy_(bert)
            b.x_len.copy_(x_len)
            b.prompts.copy_(prompts)
            b.p_len.copy_(p_len)
            for buf, value in zip(b.samp, samp):
                buf.copy_(torch.as_tensor(value).reshape(1))
            if noise is None:
                gumbel_noise_(b.noise, generator)
            else:
                b.noise.copy_(noise)
            g.run(progs[variant], variant)
            ctx_k, ctx_v = [], []
            for ck, cv in zip(b.ctx_k, b.ctx_v):
                with graphs.on_device_stream(ck.device):
                    ctx_k.append(ck.clone())
                    ctx_v.append(cv.clone())
            ctx_k, ctx_v = tuple(ctx_k), tuple(ctx_v)
            tok0, hist = b.tok0.clone(), b.hist.clone()
    if len(ctx_k) == 1:
        ctx_k, ctx_v = ctx_k[0], ctx_v[0]
    return ctx_k, ctx_v, tok0, hist


# the insert program's row: int32 [slot, x_len, p_len, min_steps,
# max_steps, top_k, tok0], then the float32 bits of [top_p, temperature,
# repetition_penalty]
_ROW_INTS, _ROW_FLOATS = 7, 3


@dataclasses.dataclass
class InsertBuffers:
    """The static buffers of the insert program (:func:`_insert`): the
    state it writes, the request's context columns per tp shard, its
    histogram [1,V] int32 and its row (``_ROW_INTS`` + ``_ROW_FLOATS``
    int32: the slot index and the row's scalars)."""
    state: SlotState
    ctx_k: tuple
    ctx_v: tuple
    hist: torch.Tensor
    row: torch.Tensor


def _insert(bufs: InsertBuffers) -> None:
    """The program of :func:`insert_slot`: the slot index and the row's
    values read from device memory, the context columns written (and
    quantized per column in int8 mode) into every shard's caches."""
    st, row = bufs.state, bufs.row
    at = row[:1].long()
    f = row[_ROW_INTS:].view(torch.float32)
    sharded = bool(st.tp_caches)
    for r, (ck, cv, (kc, vc, ks_c, vs_c)) in enumerate(zip(bufs.ctx_k, bufs.ctx_v,
                                                          st.cache_shards, strict=True)):
        with t2s.on_shard(sharded, r, kc.device):
            C = ck.shape[-1]
            i = at.to(kc.device)
            if ks_c is not None:
                ck, ks = quantize_kv_columns(ck)
                cv, vs = quantize_kv_columns(cv)
                ks_c.narrow(-1, 0, C).index_copy_(1, i, ks)
                vs_c.narrow(-1, 0, C).index_copy_(1, i, vs)
            kc.narrow(-1, 0, C).index_copy_(1, i, ck.to(kc.dtype))
            vc.narrow(-1, 0, C).index_copy_(1, i, cv.to(vc.dtype))
    st.hist.index_copy_(0, at, bufs.hist)
    for vec, value in ((st.x_len, row[1:2]), (st.p_len, row[2:3]), (st.min_steps, row[3:4]),
                       (st.max_steps, row[4:5]), (st.samp_top_k, row[5:6]),
                       (st.cur_tok, row[6:7]), (st.samp_top_p, f[0:1]),
                       (st.samp_temp, f[1:2]), (st.samp_rep, f[2:3])):
        vec.index_copy_(0, at, value.to(vec.dtype))
    st.keys_written.index_fill_(0, at, 0)
    st.counts.index_fill_(0, at, 1)
    st.done.index_fill_(0, at, False)
    st.active.index_fill_(0, at, True)


def _insert_buffers(state: SlotState, ctx_k: tuple, ctx_v: tuple) -> InsertBuffers:
    dev = state.hist.device
    return InsertBuffers(state, ctx_k, ctx_v,
                         torch.zeros((1, state.hist.shape[1]), dtype=torch.int32, device=dev),
                         torch.zeros(_ROW_INTS + _ROW_FLOATS, dtype=torch.int32, device=dev))


def insert_graph(params: t2s.Params, state: SlotState, ctx_k: tuple, ctx_v: tuple):
    """The insert program's graph for the geometry of ``state`` and context
    columns of this shape and dtype, in the configuration's cache, on the
    geometry's resident state (:class:`StateHome`; one graph serves every
    slot: the slot index is a buffer). Without ``params`` the buffers of
    one call, on ``state``."""
    if params is None:          # no cache: the program runs on the state itself
        return graphs.Graph(None, None, _insert_buffers(state, ctx_k, ctx_v))
    key = ("insert", ctx_k[0].shape[-1], ctx_k[0].dtype) + _geometry_key(state)
    return graphs.cache_for(params).graph(key, lambda: _insert_buffers(
        _home(params, state).state, tuple(map(torch.zeros_like, ctx_k)),
        tuple(map(torch.zeros_like, ctx_v))))


def _fill_row(row: torch.Tensor, ints, floats) -> None:
    """Write the insert row: host values in one copy to the device, then
    device tensors (shape [] or [1]) copied on the device, not read."""
    host = np.zeros(_ROW_INTS + _ROW_FLOATS, np.int32)
    on_dev = []
    for j, v in enumerate(ints + floats):
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            on_dev.append((j, v))
        elif j < _ROW_INTS:
            host[j] = int(np.asarray(v).reshape(-1)[0])
        else:
            host[j] = np.float32(np.asarray(v).reshape(-1)[0]).view(np.int32)
    row.copy_(torch.from_numpy(host))
    for j, v in on_dev:
        dst = row[j:j + 1] if j < _ROW_INTS else row[j:j + 1].view(torch.float32)
        dst.copy_(v.reshape(1))


def insert_slot(state: SlotState, slot: int, ctx_k: torch.Tensor,
                ctx_v: torch.Tensor, tok0: torch.Tensor, hist: torch.Tensor,
                x_len, p_len, min_steps, max_steps,
                samp: SamplingRows, params: Optional[t2s.Params] = None) -> SlotState:
    """Claim slot ``slot`` for a prefilled request, in place: the context
    columns go into the big caches (quantized per column in int8 mode),
    per tp shard when ``ctx_k``/``ctx_v`` are tuples of shards, and the
    row's leaves are set. Scalars may be Python numbers, numpy values or
    device tensors of shape [] or [1]. Returns ``state``.

    The JAX package's ``_insert_jit``: the program :func:`_insert` over
    the buffers of :func:`insert_graph` in the cache of ``params`` (the
    serving paths pass their T2S set; on the card a replay), on the
    resident state holding ``state`` (:func:`holding`); without ``params``
    it runs on the state itself. The host mirror ``top_p_host`` is
    written here."""
    b = int(slot)
    if not isinstance(ctx_k, tuple):
        ctx_k, ctx_v = (ctx_k,), (ctx_v,)
    top_p = samp.top_p
    state.top_p_host[b] = (float(top_p.reshape(-1)[0]) if isinstance(top_p, torch.Tensor)
                           else np.asarray(top_p).reshape(-1)[0].item())
    with holding(params, state):
        g = insert_graph(params, state, ctx_k, ctx_v)
        with g.lock:
            bufs = g.static
            for dst, src in zip(bufs.ctx_k + bufs.ctx_v, ctx_k + ctx_v, strict=True):
                if dst is not src:
                    with graphs.on_device_stream(dst.device):
                        dst.copy_(src)
            bufs.hist.copy_(hist)
            _fill_row(bufs.row, (b, x_len, p_len, min_steps, max_steps, samp.top_k, tok0),
                      (samp.top_p, samp.temperature, samp.repetition_penalty))
            g.run(_insert)
    return state


@dataclasses.dataclass
class ReleaseBuffers:
    """The static buffers of the release program: the resident state's
    ``active`` and ``done`` flags and the slot [1] int64."""
    active: torch.Tensor
    done: torch.Tensor
    slot: torch.Tensor


def _release(bufs: ReleaseBuffers) -> None:
    bufs.active.index_fill_(0, bufs.slot, False)
    bufs.done.index_fill_(0, bufs.slot, True)


def release_slot(state: SlotState, slot: int,
                 params: Optional[t2s.Params] = None) -> SlotState:
    """Free a harvested slot in place (its cache columns are garbage
    behind masks). Returns ``state``. The JAX package's ``_release_jit``:
    a program over the state's two flags with the slot index in device
    memory, a graph in the cache of ``params`` on the resident state, as
    :func:`insert_slot`'s is."""
    dev = state.active.device
    with holding(params, state):
        if params is None:          # no cache: the program runs on the state itself
            g = graphs.Graph(None, None, ReleaseBuffers(
                state.active, state.done, torch.zeros(1, dtype=torch.int64, device=dev)))
        else:
            home = _home(params, state).state
            g = graphs.cache_for(params).graph(
                ("release",) + _geometry_key(state),
                lambda: ReleaseBuffers(home.active, home.done,
                                       torch.zeros(1, dtype=torch.int64, device=dev)))
        with g.lock:
            g.static.slot.fill_(int(slot))
            g.run(_release)
    return state


@dataclasses.dataclass
class SegmentBuffers:
    """The static buffers of a segment graph: the state it advances, the
    Gumbel noise of its W steps [W,B,V] and its tokens [B,W] int32."""
    state: SlotState
    noise: torch.Tensor
    seg_tok: torch.Tensor


def _segment_key(state: SlotState, W: int, sx: int, sp: int, ring_len: int,
                 use_kernel: bool, any_top_p: bool):
    """The static geometry a segment graph is keyed on (it replays on the
    resident state of that geometry, whichever state it holds)."""
    B = state.k_cache.shape[1]
    return ("segment", B, sx, sp, ring_len, W, use_kernel, bool(any_top_p),
            state.k_scale is not None, state.k_cache.dtype)


def decode_segment(params: t2s.Params, state: SlotState, cfg: T2SConfig,
                   seg_steps: int, sx: int, sp: int, ring_len: int,
                   kv_kernel: bool = False, noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   eager: bool = False) -> Tuple[SlotState, torch.Tensor]:
    """Advance every occupied slot ``seg_steps`` decode steps.

    Returns (state, seg_tokens [B, W] int32): ``state`` updated in place,
    and the tokens sampled this segment per row (done and empty rows
    repeat EOS), a tensor of the caller's. The loop always runs its W
    steps and reads nothing back to the host. ``noise`` [W,B,V] is the
    Gumbel noise of the W steps, drawn from ``generator`` when not given.
    Each step's K/V columns collect in a [L,B,H,Dh,W] buffer in the
    compute dtype; one merge writes them to the ring at the row-uniform
    head, twice (at ``head`` and ``head+ring``), quantized per column in
    int8 mode.

    The attention reads the first ring copy ``[0, Sx+Sp+ring)`` of the big
    cache in place, its visible columns recomputed from the segment-frozen
    ``x_len``/``p_len``/``keys_written``/``ring_head``: exact caches through
    ``slot_attention`` (``ops/slot_attention.py``: one launch a layer for
    the whole attention and the buffer column's write; its plain version
    on CPU tensors); int8 caches through ``int8_big_attention``
    (``ops/int8_decode.py``) with ``kv_kernel``, else through the dequantized
    read masked by ``int8_decode.visibility``.

    The segment runs as :func:`_segment` over static buffers: the graph of
    its geometry in the configuration's cache (``runtime/graphs.py``; on
    the card a replay of a captured CUDA graph) with ``params`` bound, on
    the resident state of the geometry holding ``state`` (:func:`holding`:
    a persistent state stays there until another owner takes its place,
    any other is copied in and back). ``eager`` runs it on the same
    buffers without a graph, on ``params`` itself. A caller that reads a
    persistent state's leaves after the segment reads them in
    :func:`holding`. A tp-sharded ``params`` (with a
    state from ``init_slots(..., tp_devices=t2s.shard_devices(params))``)
    runs each layer over its shards, in the same graphs: each reads and
    merges its own caches of ``H/tp`` heads, on the kernel routes with one
    launch a layer per shard.
    """
    assert ring_len % seg_steps == 0, "segment must not wrap the ring"
    W = seg_steps
    B = state.k_cache.shape[1]
    dev = state.k_cache.device
    Sx, Sp = sx, sp
    use_kernel = state.k_scale is None or bool(kv_kernel)
    any_top_p = bool((state.top_p_host < 1.0).any())
    if noise is None:
        noise = gumbel_noise((W, B, cfg.semantic_vocab), generator, dev)
    noise = torch.as_tensor(noise, device=dev)
    key = _segment_key(state, W, Sx, Sp, ring_len, use_kernel, any_top_p)
    cache = graphs.cache_for(params)
    # the state first, then the bank, then the graph's lock (everywhere)
    with holding(params, state), cache.bind(params, eager) as p:
        g = cache.graph(key, lambda: SegmentBuffers(
            _home(params, state).state, torch.zeros_like(noise),
            torch.zeros((B, W), dtype=torch.int32, device=dev)))
        with g.lock:
            b = g.static
            b.noise.copy_(noise)
            g.run(functools.partial(_segment, p, cfg, W=W, sx=Sx, sp=Sp, ring_len=ring_len,
                                    use_kernel=use_kernel, any_top_p=any_top_p),
                  eager=eager)
            seg_tok = b.seg_tok.clone()
    return state, seg_tok


def _segment(params: t2s.Params, cfg: T2SConfig, bufs: SegmentBuffers, *, W: int,
             sx: int, sp: int, ring_len: int, use_kernel: bool,
             any_top_p: bool) -> None:
    """The program of :func:`decode_segment` over ``bufs``: every value
    that changes from segment to segment is read from the state's device
    leaves (the ring head included) and written back in place."""
    state = bufs.state
    caches = state.cache_shards
    devs = [c[0].device for c in caches]
    L, B, _, Dh, S = state.k_cache.shape
    H = cfg.num_heads
    dev = devs[0]
    int8_kv = state.k_scale is not None
    buf_dtype = params["audio_embed"].dtype if int8_kv else state.k_cache.dtype
    V, eos = cfg.semantic_vocab, cfg.eos_id
    Sx, Sp = sx, sp
    pe_full = sine_position_table(Sx + Sp + ring_len, cfg.embed_dim, device=dev)
    noise = bufs.noise
    forbid_eos = torch.arange(V, device=dev) == eos      # no host scalar: capturable
    # segment-frozen: the head and the ring keys each row had at its start
    head0 = state.ring_head.clone()
    kw0 = state.keys_written.clone()

    S_read = Sx + Sp + ring_len
    buf_masks = torch.arange(W, device=dev)[None, :] < torch.arange(W, device=dev)[:, None]

    # per shard, the keyword arguments of t2s.buffered_attention for each
    # layer (buffer column and its mask filled in per step): the first ring
    # copy of the big caches [L,B,H/tp,Dh,S_read], the segment-frozen
    # lengths the kernels recompute visibility from (the visibility mask
    # on the int8 masked read) and the segment's write buffer
    # [L,B,H/tp,Dh,W]
    shards = t2s.layer_shards(params)
    sharded = shards is not None
    reads, bufs_kv, step_masks = [], [], []
    for j, ((kc, vc, ksc, vsc), d) in enumerate(zip(caches, devs)):
        with t2s.on_shard(sharded, j, d):
            k_buf = torch.zeros(kc.shape[:3] + (Dh, W), dtype=buf_dtype, device=d)
            bufs_kv.append((k_buf, torch.zeros_like(k_buf)))
            step_masks.append(buf_masks.to(d))
            frozen = tuple(t.to(d) for t in (state.x_len, state.p_len, kw0, head0))
            ctx = frozen + (Sx, Sp, ring_len) if use_kernel else None
            mask_d = None if use_kernel else visibility(S_read, *frozen, sx=Sx, sp=Sp,
                                                        ring=ring_len)
        per_layer = []
        for l in range(L):
            ks = vs = None
            if int8_kv:
                ks, vs = ksc[l, ..., :S_read], vsc[l, ..., :S_read]
            per_layer.append(dict(k_big=kc[l, ..., :S_read], v_big=vc[l, ..., :S_read],
                                  kv_mask=mask_d, k_scale=ks, v_scale=vs,
                                  kv_kernel_ctx=ctx))
        reads.append(per_layer)
    if shards is None:
        layers = unstack(params["layers"])
    else:
        from ..parallel.tp import layer_decode_buffered_shards

        layers = list(zip(*(unstack(sh) for sh in shards)))

    seg_tokens = bufs.seg_tok
    rows = state.sampling_rows
    predict_w = params["predict"]["w"].float()
    audio_embed, alpha = params["audio_embed"], params["audio_pos_alpha"]
    cur_tok, keys_written, counts = state.cur_tok, state.keys_written, state.counts
    done, hist = state.done, state.hist

    for i in range(W):
        emb = audio_embed[cur_tok.long()]                         # [B, D]
        pos_emb = pe_full[(state.p_len + keys_written).long()]
        h = (emb + (alpha * pos_emb).to(emb.dtype))[:, None]
        for l, lp in enumerate(layers):
            step = [dict(reads[j][l], k_buf=kb[l], v_buf=vb[l], buf_mask=bm[i], col=i)
                    for j, ((kb, vb), bm) in enumerate(zip(bufs_kv, step_masks))]
            if shards is None:
                h = t2s._layer_decode_buffered(lp, h, num_heads=H, **step[0])[0]
            else:
                h = layer_decode_buffered_shards(lp, h, step, H)
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
        hist = hist.scatter_add(1, nxt.long()[:, None], alive[:, None].int())
        keys_written = keys_written + alive.int()
        counts = torch.where(alive, counts + 1, counts)
        done = done | now_done | (row_step + 1 >= state.max_steps)
        cur_tok = nxt

    # merge the segment's W columns at the ring head, twice, per shard
    base = Sx + Sp + head0.long()
    cols = torch.cat([base + torch.arange(W, device=dev),
                      base + ring_len + torch.arange(W, device=dev)])
    for j, ((kc, vc, ksc, vsc), (k_buf, v_buf), d) in enumerate(zip(caches, bufs_kv, devs)):
        with t2s.on_shard(sharded, j, d):
            at = cols.to(d)
            if int8_kv:
                k_buf, ks = quantize_kv_columns(k_buf)
                v_buf, vs = quantize_kv_columns(v_buf)
                ksc.index_copy_(3, at, torch.cat([ks, ks], dim=-1))
                vsc.index_copy_(3, at, torch.cat([vs, vs], dim=-1))
            kc.index_copy_(4, at, torch.cat([k_buf, k_buf], dim=-1).to(kc.dtype))
            vc.index_copy_(4, at, torch.cat([v_buf, v_buf], dim=-1).to(vc.dtype))
    for leaf, value in ((state.cur_tok, cur_tok), (state.keys_written, keys_written),
                        (state.counts, counts), (state.done, done), (state.hist, hist)):
        leaf.copy_(value)
    state.ring_head.copy_((head0 + W) % ring_len)
