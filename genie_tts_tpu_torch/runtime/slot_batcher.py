"""In-flight continuous batching scheduler (slot engine), with streaming.

The port of ``genie_tts_tpu/runtime/slot_batcher.py``. A persistent B-slot
decode machine (``models/slots.py``) lives on the character's device:
every dispatch advances all occupied slots a segment of ``slot_steps``
tokens, and new requests claim free slots between dispatches, so a
request joins within a segment; per-request ``min_steps``/``max_steps``
and sampling parameters are per-row values. Rows without a streaming
consumer pool when they finish for one batched vocode
(``engine.vocode_codes_*``).

Streaming (:meth:`SlotBatcher.synthesize_stream`): a streaming row pumps
WINDOWS during decode. While it owes its first piece the machine runs
shorter segments (``slot_join_steps``), and the first piece (``slot_first_
piece`` frames) is vocoded speculatively right behind the row's first
segment, from codes put together on the device out of that segment's
tokens; after it, one ``vocode_chunk`` window per half-chunk of decoded
steps, batched over the pumped rows; at completion only the remainder.
Pieces reach the consumer as their host copies land. Each pumped row
draws one flow-noise table at insert, so every window of it sees the same
noise. ``slot_stream_finisher`` makes every row pump.

One scheduler thread dispatches all device work. The loop is pipelined
one segment deep: segment k's tokens and flags go to pinned host memory
(one non-blocking copy and an event) before segment k+1 is dispatched.
Workers only wait for copies and trim: two for the pooled finisher, one
(in submission order) for window pieces and window completions.

One scheduler serves one character; ``api.get_slot_batcher`` keeps one
per loaded character, and retires (:meth:`SlotBatcher.retire`) that of a
character evicted or unloaded: it finishes what it holds, then exits.
On a serving mesh it runs on the character's replica 0; where that
replica's T2S is tp-sharded, so are its slot caches
(``models/slots.py``), and the scheduling is the same.

The machine owns its persistent slot state for as long as it lives
(``TTSEngine.take_slot_state``: the one a warmup sweep of its
configuration left, else a new one), updated in place; each segment is a
replay of the CUDA graph of its width, read windows and top-p flag, in
the configuration's cache (``runtime/graphs.py``: on its bank, with the
character bound, and on its resident state, holding this machine's:
``models/slots.py::holding``), and so is each join: the prefill program
(``slots.prefill_join``), the insert and, when the row is harvested, the
release (``slots.insert_slot`` / ``release_slot``, the slot index in
device memory), as the JAX package's ``_prefill_jit``, ``_insert_jit``
and ``_release_jit``; a streaming row's speculative codes are the graph
of :func:`spec_codes` (``_spec_codes_jit``), a tp-sharded character's
too. The host keeps a mirror of the ring head.
:func:`slot_warmup_units` captures every one of these programs the
scheduler can reach, on a state it then leaves for the configuration's
next slot machine, and the finisher's and window pump's SoVITS programs,
ahead of traffic (``TTSEngine.warmup(..., sweep=True)``).
"""
from __future__ import annotations

import collections
import concurrent.futures
import functools
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import slots as slots_mod
from ..models.t2s import finalize_semantic_tokens, layer_shards, shard_devices
from ..ops.sampling import SamplingConfig, SamplingRows, rows_from_config
from ..ops.slot_linear import launches_kernel
from ..utils.metrics import metrics
from .buckets import pad_to, pick_bucket
from . import graphs
from .engine import (CharacterModel, ReferenceFeatures, TTSEngine, finish_host_copy,
                     host_to_device, refuse_v4_stream, start_host_copy)
from .stream import noise_table

logger = logging.getLogger(__name__)


def seg_widths(cfg, ring: int) -> "tuple[int, ...]":
    """The segment widths the scheduler dispatches: slot_steps always, and
    the shorter slot_join_steps while a streaming row owes its first
    piece, kept only where it divides both slot_steps and the ring: the
    head then stays on the join width's grid, so a join-width segment
    always fits before the end of the ring."""
    widths = [cfg.slot_steps]
    j = cfg.slot_join_steps
    if j and j != cfg.slot_steps and ring % j == 0 and cfg.slot_steps % j == 0:
        widths.append(j)
    return tuple(widths)


def pump_windows(cfg) -> "tuple[int, int, int]":
    """(first, small, large): the window pump's vocode widths in latent
    frames: a first piece's (``slot_first_piece`` + both halos, unless
    that is not below the small one), half a chunk's and a chunk's, each
    with both halos."""
    chunk, halo = cfg.vocode_chunk, cfg.vocode_halo
    win, win_small = chunk + 2 * halo, chunk // 2 + 2 * halo
    first_piece = min(cfg.slot_first_piece, chunk)
    win_first = first_piece + 2 * halo if first_piece else 0
    if not win_first or win_first >= win_small:
        win_first = win_small
    return win_first, win_small, win


def slot_geometry(cfg, tcfg) -> "tuple[int, int, int, int, int]":
    """(n_slots, seg_steps, ring, phoneme_bucket, prompt_bucket): the
    static geometry of the slot machine."""
    W = cfg.slot_steps
    ring = -(-min(cfg.slot_ring, tcfg.max_decode_steps) // W) * W
    return (cfg.slot_batch, W, ring, cfg.slot_phoneme_bucket, cfg.slot_prompt_bucket)


def _slot_finisher_t_bucket(cfg) -> int:
    """The ONE text bucket the slot finisher pads to."""
    return pick_bucket(cfg.slot_phoneme_bucket, cfg.phoneme_buckets)


def _state_key(engine: TTSEngine, char: CharacterModel) -> tuple:
    B, _, ring, sx, sp = slot_geometry(engine.cfg, char.t2s_cfg)
    return (B, sx, sp, ring, char.t2s_params["audio_embed"].dtype, engine.cfg.slot_kv_int8)


def take_slot_state(engine: TTSEngine, char: CharacterModel) -> slots_mod.SlotState:
    """An empty slot machine state of the character's configuration at the
    engine's slot geometry, for the caller alone: a persistent one
    (``TTSEngine.take_slot_state``: resident in the buffers its graphs
    replay on while it runs, ``models/slots.py::holding``; a tp-sharded
    character's holds its caches per shard)."""
    cfg, tcfg = engine.cfg, char.t2s_cfg
    B, _, ring, sx, sp = slot_geometry(cfg, tcfg)
    params = char.t2s_params
    kw = dict(dtype=params["audio_embed"].dtype, kv_int8=cfg.slot_kv_int8,
              device=char.device, tp_devices=shard_devices(params))
    state = engine.take_slot_state(char, _state_key(engine, char),
                                   lambda: slots_mod.init_slots(tcfg, B, sx, sp, ring, **kw))
    with slots_mod.holding(params, state) as st:
        slots_mod.reset_slots(st, ring)
    return state


def join_warmup_units(char: CharacterModel, sx: int, sp: int) -> list:
    """Warmup thunks capturing the join program (``slots.prefill_join``)
    at (Sx, Sp): each variant, with and without BERT features and top-p,
    with the character's set bound."""
    params = char.t2s_params

    def capture(variant):
        with graphs.cache_for(params).bind(params) as p:
            g, progs = slots_mod.join_graph(p, char.t2s_cfg, sx, sp)
            with g.lock:
                g.prepare(progs[variant], variant)

    return [functools.partial(capture, (bert, top_p))
            for bert in (False, True) for top_p in (False, True)]


def warmup_join(char: CharacterModel, state: slots_mod.SlotState, sx: int, sp: int,
                max_steps: int, generator: torch.Generator) -> None:
    """A warmup row: a one-phoneme, one-prompt request joined into slot 0
    of ``state`` through the join graphs (the insert's captured at the
    geometry's first join)."""
    params, tcfg, dev = char.t2s_params, char.t2s_cfg, char.device
    samp = rows_from_config(SamplingConfig(), 1)
    ctx_k, ctx_v, tok0, hist = slots_mod.prefill_join(
        params, tcfg, phones=torch.zeros((1, sx), dtype=torch.int64, device=dev),
        bert=None, x_len=torch.ones((1,), dtype=torch.int64, device=dev),
        prompts=torch.zeros((1, sp), dtype=torch.int64, device=dev),
        p_len=torch.ones((1,), dtype=torch.int64, device=dev),
        samp=SamplingRows(*(host_to_device(a, dev) for a in samp)), generator=generator,
        any_top_p=False)
    slots_mod.insert_slot(state, 0, ctx_k, ctx_v, tok0, hist, 1, 1, 0, max_steps,
                          SamplingRows(*(a[0] for a in samp)), params=params)


def slot_warmup_units(engine: TTSEngine, char: CharacterModel) -> list:
    """Warmup thunks for every slot-serving program: captures of the join
    program's variants (:func:`join_warmup_units`), of every segment
    graph the scheduler can dispatch (each width of :func:`seg_widths` x
    the top-p flag)
    and of the insert and release programs, on a persistent slot state
    that it leaves for the configuration's next slot machine
    (``TTSEngine.offer_slot_state``), of the speculative first piece's
    codes at every row bucket and width (:func:`spec_codes`), and of the
    window pump's and the finisher's SoVITS programs
    (``engine.window_warmup_units`` / ``finisher_warmup_units``). Returns
    thunks for ``engine._run_compile_units``."""
    cfg, tcfg = engine.cfg, char.t2s_cfg
    B, W, ring, sx, sp = slot_geometry(cfg, tcfg)
    params = char.t2s_params
    dev = char.device
    units = join_warmup_units(char, sx, sp)

    def segment(w, top_p):
        # a row joined, decoded and released (the insert and release graphs
        # captured at the first unit)
        state = take_slot_state(engine, char)
        warmup_join(char, state, sx, sp, w, torch.Generator(device=dev).manual_seed(0))
        state.top_p_host[0] = 0.5 if top_p else 1.0
        slots_mod.decode_segment(params, state, tcfg, w, sx, sp, ring,
                                 kv_kernel=cfg.slot_kv_int8,
                                 generator=torch.Generator(device=dev).manual_seed(0))
        slots_mod.release_slot(state, 0, params=params)
        with slots_mod.holding(params, state) as st:
            slots_mod.reset_slots(st, ring)
        engine.offer_slot_state(char, _state_key(engine, char), state)

    for w in seg_widths(cfg, ring):
        for top_p in (False, True):
            units.append(functools.partial(segment, w, top_p))
    spec = spec_geometry(cfg) if char.version != "v4" else None   # V4 streams no pieces
    if spec is not None:
        count, fb = spec
        rows = sorted({max(pick_bucket(r, cfg.batch_buckets), r) for r in range(1, B + 1)})
        for r in rows:
            for w in seg_widths(cfg, ring):
                if w >= count - 1:     # _spec_first_pieces' own guard
                    units.append(functools.partial(
                        _prepare_spec, params, r, B, w, fb, count,
                        char.sovits_cfg.vq_codes))
    # window-pump programs: streaming rows pump per row even without the
    # machine-wide flag, so a server must have them warm
    units.extend(engine.window_warmup_units(char, wins=pump_windows(cfg),
                                            t_bucket=_slot_finisher_t_bucket(cfg)))
    if not cfg.slot_stream_finisher:
        units.extend(engine.finisher_warmup_units(
            char, t_buckets=(_slot_finisher_t_bucket(cfg),)))
    return units


def spec_geometry(cfg) -> "Optional[tuple[int, int]]":
    """(count, fb) of a speculative first piece: the codes it claims (its
    first piece's frames over two, plus the lookahead) and the frame
    bucket of its codes (the window of a first piece's width, in codes);
    None without first pieces (``slot_first_piece`` 0)."""
    first_piece = min(cfg.slot_first_piece, cfg.vocode_chunk)
    if not first_piece:
        return None
    count = first_piece // 2 + cfg.stream_lookahead
    need = first_piece + 2 * cfg.vocode_halo
    win = next(w for w in pump_windows(cfg) if need <= w)
    return count, pick_bucket(max(count, -(-win // 2)), cfg.frame_buckets)


@dataclass
class SpecBuffers:
    """The static buffers of the speculative codes program: the rows'
    first tokens [R] int64, the segment's tokens [B, W] int32, each row's
    slot [R] int64, and the codes [R, fb] int64."""
    tok0s: torch.Tensor
    seg_tok: torch.Tensor
    slots: torch.Tensor
    codes: torch.Tensor


def _spec_program(b: SpecBuffers, *, count: int, vq_codes: int) -> None:
    b.codes.zero_()
    b.codes[:, 0].copy_(b.tok0s)
    b.codes[:, 1:count].copy_(b.seg_tok.index_select(0, b.slots)[:, :count - 1])
    b.codes.clamp_(0, vq_codes - 1)


def _spec_buffers(R: int, B: int, W: int, fb: int, dev) -> SpecBuffers:
    def z(*shape, dt=torch.int64):
        return torch.zeros(shape, dtype=dt, device=dev)

    return SpecBuffers(z(R), z(B, W, dt=torch.int32), z(R), z(R, fb))


def spec_codes_graph(params, R: int, B: int, W: int, fb: int, count: int, vq_codes: int):
    """The speculative codes program's graph at (rows, B, W, fb, count)
    in the T2S set's cache (the JAX ``_spec_codes_jit``, keyed on the row
    bucket), and the program."""
    dev = params["audio_embed"].device
    g = graphs.cache_for(params).graph(("spec_codes", R, B, W, fb, count, vq_codes),
                                       lambda: _spec_buffers(R, B, W, fb, dev))
    return g, functools.partial(_spec_program, count=count, vq_codes=vq_codes)


def _prepare_spec(params, R, B, W, fb, count, vq_codes) -> None:
    g, prog = spec_codes_graph(params, R, B, W, fb, count, vq_codes)
    with g.lock:
        g.prepare(prog)


def spec_codes(tok0s, seg_tok: torch.Tensor, slots: torch.Tensor, *, fb: int,
               count: int, vq_codes: int, params=None) -> torch.Tensor:
    """[R, fb] codes for speculative first pieces, on the device: row r is
    ``tok0s[r]`` ([1] tensors) then the first ``count - 1`` tokens of row
    ``slots[r]`` of the segment ``seg_tok`` [B, W], which the host has not
    read; clipped to the codebook. The program over the buffers of
    :func:`spec_codes_graph` in the cache of ``params`` (the slot
    machine's T2S set; on the card a replay), else eagerly on buffers of
    this call. Returns the caller's copy."""
    R, (B, W) = len(tok0s), seg_tok.shape
    if params is None:
        g = graphs.Graph(None, None, _spec_buffers(R, B, W, fb, seg_tok.device))
        prog = functools.partial(_spec_program, count=count, vq_codes=vq_codes)
    else:
        g, prog = spec_codes_graph(params, R, B, W, fb, count, vq_codes)
    with g.lock:
        b = g.static
        for r, t in enumerate(tok0s):
            b.tok0s[r:r + 1].copy_(t.reshape(1))
        b.seg_tok.copy_(seg_tok)
        b.slots.copy_(slots)
        g.run(prog)
        return b.codes.clone()


def _phase(name: str, req: "_Request", t0: float, t1: float) -> None:
    """A request's phase from ``t0`` to ``t1`` (perf_counter): a sample of
    timer ``name`` and, while recording, a span on the requests track
    (``req``: the request's ``id``, shared by its phases)."""
    metrics.observe(name, t1 - t0)
    if metrics.recording:
        metrics.span_at(name, t0, t1, req=id(req))


def _stream_close(req: "_Request", err: Optional[BaseException] = None) -> None:
    """End a streaming consumer: an exception propagates, None ends."""
    if req.stream_q is not None:
        req.stream_q.put(err)


@dataclass
class _Request:
    ref: ReferenceFeatures
    phones: np.ndarray
    bert: np.ndarray
    min_steps: int
    max_steps: int
    sampling: Optional[SamplingConfig] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None
    tok0_dev: object = None       # [1] device tensor; reaches the host with a segment fetch
    tok0_np: Optional[int] = None
    seg_tokens: List[np.ndarray] = field(default_factory=list)
    harvested: bool = False
    cancelled: bool = False       # waiter gave up (timeout): drop, don't decode
    cfm_seed: Optional[int] = None    # V4: the seed of the request's CFM noise
    # window-pump state
    noise: object = None          # [N, C] flow-noise table, drawn at insert
    count_seen: int = 0           # tokens confirmed by the last fetched segment
    emitted: int = 0              # latent frames already dispatched to vocode
    pieces: dict = field(default_factory=dict)   # start frame -> piece
    final_codes: Optional[np.ndarray] = None
    # streaming consumer: pieces are pushed here as their copies land;
    # None ends the stream, an exception propagates
    stream_q: Optional[queue.Queue] = None
    # time-to-first-audio stamps (perf_counter), observed as ttfa_* timers;
    # t_submit and t_harvest (the row finished decoding) also bound the
    # slot_queue and slot_finish phases of every request
    t_submit: float = 0.0
    t_join: float = 0.0
    t_first_dispatch: float = 0.0
    t_harvest: float = 0.0


class SlotBatcher:
    """Persistent B-slot decode loop with between-segment joins.

    ``pcm16``: results and stream pieces are int16 PCM made on the device
    (half the host copy of float32); the serving path enables it.

    ``stats`` counts what the loop dispatched: ``segments``, ``steps``
    (decode steps), ``peak_occupancy``, ``streams`` (streaming requests
    that joined)."""

    def __init__(self, engine: TTSEngine, char: CharacterModel, pcm16: bool = False):
        self.engine = engine
        self.char = char
        self.pcm16 = pcm16
        self.cfg = engine.cfg
        tcfg = char.t2s_cfg
        (self.n_slots, self.W, self.ring, self.sx, self.sp) = slot_geometry(self.cfg, tcfg)
        widths = seg_widths(self.cfg, self.ring)
        j = self.cfg.slot_join_steps
        if 0 < j < self.W and j not in widths:
            # mixed widths off the join width's grid can leave the ring head
            # where neither fits before the end of the ring
            raise ValueError(
                f"slot_join_steps={j} must divide slot_steps={self.W} and the "
                f"{self.ring}-step ring (slot_ring={self.cfg.slot_ring}); use one "
                f"that divides both, or 0")
        self._t_buckets = (_slot_finisher_t_bucket(self.cfg),)
        # int8 KV caches read through the int8_big_attention kernel, exact
        # ones through slot_attention (on CPU tensors both wrappers run
        # their plain versions)
        self._decode_segs = {
            w: functools.partial(slots_mod.decode_segment, cfg=tcfg, seg_steps=w,
                                 sx=self.sx, sp=self.sp, ring_len=self.ring,
                                 kv_kernel=self.cfg.slot_kv_int8)
            for w in widths}
        # the default width's segment is an attribute so tests can inject
        # faults through it
        self._decode_seg = self._decode_segs[self.W]
        self.join_W = min(self._decode_segs)       # == W when join steps are off
        # 1 where the route sends every segment's attention through the
        # slot_attention kernel (exact caches on the card), read by the
        # slot_attn_kernel gauge; the launches replay inside CUDA graphs,
        # where no host counter sees them
        self.attn_kernel = int(not self.cfg.slot_kv_int8
                               and torch.device(char.device).type == "cuda")
        # 1 where the decode layer's int8 linears run through the
        # slot_linear kernel (whole int8 weights on the card; a tp-sharded
        # set keeps the composition), read by the slot_linear_kernel gauge
        params = char.t2s_params
        self.linear_kernel = int(layer_shards(params) is None
                                 and launches_kernel(params["layers"]["qkv"]))
        # the window pump: every row with slot_stream_finisher, else only
        # rows with a streaming consumer
        self.windows = self.cfg.slot_stream_finisher
        self.chunk = self.cfg.vocode_chunk
        self.halo = self.cfg.vocode_halo
        self.lookahead = self.cfg.stream_lookahead
        # the first piece must fit the large window
        self.first_piece = min(self.cfg.slot_first_piece, self.chunk)
        # a small window of its own for first pieces and short remainders
        self.win_first, self.win_small, self.win = pump_windows(self.cfg)
        self._spec = spec_geometry(self.cfg)     # (count, fb) of a first piece
        if char.version == "v4" and self.windows:
            refuse_v4_stream(char)
        self.stats = {"segments": 0, "steps": 0, "peak_occupancy": 0, "streams": 0}
        self._state = take_slot_state(engine, char)     # this machine's alone
        self._reset_state()
        self._slots: List[Optional[_Request]] = [None] * self.n_slots
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._defer_pump = False
        self._running = False
        self._retired = False       # exit once drained (retire)
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()       # start() runs under it in _submit
        self._vocoder = ThreadPoolExecutor(max_workers=2,
                                           thread_name_prefix="slot-vocode")
        # window pieces and window completions on ONE worker, in submission
        # order: a completion never reads a piece still in flight
        self._winworker = ThreadPoolExecutor(max_workers=1,
                                             thread_name_prefix="slot-windows")
        # finished rows awaiting the pooled finisher: [req, count, age_in_segments]
        self._finish_pending: List[list] = []
        # what the loop handed to the workers and :meth:`join` waits for
        self._work: "collections.deque" = collections.deque(maxlen=256)

    # -- public -----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            # a previous loop may still be finishing its last iteration
            if self._thread is not None and self._thread.is_alive():
                self._thread.join()
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="tts-slots")
            self._thread.start()

    def _submit(self, req: "_Request") -> None:
        """Make sure a loop runs, and queue ``req``: under the lock, so a
        retired loop cannot exit between the two."""
        with self._lock:
            self.start()
            self._q.put(req)

    def stop(self) -> None:
        """Signal shutdown. The loop thread fails every queued and
        in-flight request on its way out (no hung waiters)."""
        with self._lock:
            self._running = False

    def retire(self) -> None:
        """Let the machine go once it has drained: the loop finishes the
        requests queued and in its slots, then exits (failing none), and
        drops its hold on the character. A request submitted later starts
        the loop again, which exits when that one is done too."""
        with self._lock:
            self._retired = True

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait up to ``timeout`` seconds for a retired (or stopped) machine
        to come to rest: its loop ended, the vocode work it handed to its
        workers done and their threads stopped (the machine takes no more
        requests). Returns whether it did (a process that ends while that
        work runs inside torch on a daemon thread aborts at exit)."""
        deadline = None if timeout is None else time.monotonic() + timeout

        def left():
            return None if deadline is None else max(deadline - time.monotonic(), 0.0)

        thread = self._thread
        if thread is not None:
            thread.join(left())
            if thread.is_alive():
                return False
        if concurrent.futures.wait(list(self._work), left()).not_done:
            return False
        # the workers' threads too (they free a job's tensors after it ran)
        for pool in (self._vocoder, self._winworker):
            pool.shutdown(wait=True)
        return True

    def fits(self, ref: ReferenceFeatures, phones: np.ndarray) -> bool:
        """Whether a request fits the slot machine's static geometry."""
        return (len(ref.phones) + len(phones) <= self.sx
                and len(ref.prompt_tokens) <= self.sp)

    def synthesize(self, ref: ReferenceFeatures, phones: np.ndarray, bert: np.ndarray,
                   timeout: Optional[float] = None, min_steps: int = 0,
                   max_steps: Optional[int] = None,
                   sampling: Optional[SamplingConfig] = None,
                   cfm_seed: Optional[int] = None) -> np.ndarray:
        """Blocking submit; decodes in flight with concurrent requests.
        ``sampling`` is per request (rows with different configs share the
        machine). ``cfm_seed``: a V4 request's CFM noise seed (default: one
        of the engine's), so that its audio depends on it alone."""
        max_steps = min(max_steps or self.char.t2s_cfg.max_decode_steps, self.ring)
        if cfm_seed is None and self.char.version == "v4":
            cfm_seed = self.engine._next_seed()
        req = _Request(ref, np.asarray(phones, np.int32), bert,
                       min_steps=min(min_steps, max_steps), max_steps=max_steps,
                       sampling=sampling, t_submit=time.perf_counter(), cfm_seed=cfm_seed)
        self._submit(req)
        if not req.done.wait(timeout):
            # the scheduler drops it from the queue or releases its slot
            req.cancelled = True
            raise TimeoutError("slot-batched synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def synthesize_stream(self, ref: ReferenceFeatures, phones: np.ndarray,
                          bert: np.ndarray, timeout: Optional[float] = None,
                          min_steps: int = 0, max_steps: Optional[int] = None,
                          sampling: Optional[SamplingConfig] = None):
        """Streaming submit: yields PCM pieces as the window pump emits
        them, while the request decodes in flight beside others (the
        counterpart under load of the solo segmented stream). ``timeout``
        bounds the whole stream. A V4 character raises
        ``NotImplementedError``."""
        refuse_v4_stream(self.char)
        max_steps = min(max_steps or self.char.t2s_cfg.max_decode_steps, self.ring)
        if self.first_piece:
            # the speculative first piece claims this many tokens of the
            # row's first segment, which is sound only if EOS cannot land
            # in them (16 codes = 0.32 s of audio, below any real
            # utterance)
            min_steps = max(min_steps, min(self.first_piece // 2 + self.lookahead,
                                           max_steps))
        req = _Request(ref, np.asarray(phones, np.int32), bert,
                       min_steps=min(min_steps, max_steps), max_steps=max_steps,
                       sampling=sampling, stream_q=queue.Queue(),
                       t_submit=time.perf_counter())
        self._submit(req)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            budget = (None if deadline is None
                      else max(deadline - time.monotonic(), 0.001))
            try:
                item = req.stream_q.get(timeout=budget)
            except queue.Empty:
                req.cancelled = True
                raise TimeoutError("slot-batched stream timed out") from None
            if item is None:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    # -- scheduler --------------------------------------------------------

    def _occupied(self) -> bool:
        return any(r is not None for r in self._slots)

    def _stream_waiter_queued(self) -> bool:
        """A streaming request is waiting to join."""
        with self._q.mutex:
            return any(r.stream_q is not None and not r.cancelled for r in self._q.queue)

    def _drop_cancelled(self) -> None:
        """Free slots whose waiters timed out."""
        for b, req in enumerate(self._slots):
            if req is not None and req.cancelled and not req.harvested:
                req.harvested = True
                self._slots[b] = None
                self._state = slots_mod.release_slot(self._state, b,
                                                     params=self.char.t2s_params)

    def _fill_slots(self, block: bool) -> None:
        self._drop_cancelled()
        free = [i for i, r in enumerate(self._slots) if r is None]
        while free:
            try:
                if block:
                    with metrics.span("slot_wait"):
                        req = self._q.get(timeout=0.2)
                else:
                    req = self._q.get_nowait()
            except queue.Empty:
                return
            block = False
            if req.cancelled:
                continue
            b = free.pop(0)
            try:
                self._insert_request(b, req)
            except BaseException as e:  # noqa: BLE001 — bad request only
                req.error = e
                _stream_close(req, e)
                req.done.set()
                free.insert(0, b)

    def _insert_request(self, b: int, req: _Request) -> None:
        _phase("slot_queue", req, req.t_submit, time.perf_counter())
        ref, phones = req.ref, req.phones
        dev = self.char.device
        packed = np.concatenate([ref.phones, phones]).astype(np.int64)
        if len(packed) > self.sx or len(ref.prompt_tokens) > self.sp:
            raise ValueError(
                f"request exceeds slot buckets ({len(packed)} phonemes > "
                f"{self.sx} or {len(ref.prompt_tokens)} prompts > {self.sp})")
        if np.any(ref.bert) or np.any(req.bert):
            bert = host_to_device(pad_to(np.concatenate([ref.bert, req.bert])
                                         .astype(np.float32), self.sx, axis=0)[None], dev)
        else:
            bert = None                 # all-zero BERT built on the device
        samp = rows_from_config(req.sampling or SamplingConfig(), 1)
        with metrics.timer("slot_join"):
            ctx_k, ctx_v, tok0, hist = slots_mod.prefill_join(
                self.char.t2s_params, self.char.t2s_cfg,
                phones=host_to_device(pad_to(packed, self.sx)[None], dev), bert=bert,
                x_len=host_to_device(np.array([len(packed)]), dev),
                prompts=host_to_device(pad_to(np.asarray(ref.prompt_tokens, np.int64),
                                              self.sp)[None], dev),
                p_len=host_to_device(np.array([len(ref.prompt_tokens)]), dev),
                samp=SamplingRows(*(host_to_device(a, dev) for a in samp)),
                generator=self._gen, any_top_p=bool(samp.top_p[0] < 1.0))
            # ring invariant: a row never decodes more tokens than the ring holds
            mx = min(req.max_steps, self.ring)
            self._state = slots_mod.insert_slot(
                self._state, b, ctx_k, ctx_v, tok0, hist, len(packed),
                len(ref.prompt_tokens), min(req.min_steps, mx), mx,
                SamplingRows(*(a[0] for a in samp)), params=self.char.t2s_params)
        req.tok0_dev = tok0   # reaches the host with the next segment's fetch
        if self.windows or req.stream_q is not None:
            # one flow-noise table for every window of this request
            req.noise = noise_table(self.cfg, self.char.sovits_cfg, self._gen)
        self._slots[b] = req
        if req.stream_q is not None:
            self.stats["streams"] += 1
            req.t_join = time.perf_counter()
            metrics.observe("ttfa_queue_wait", req.t_join - req.t_submit)

    def _harvest(self, seg_tok: np.ndarray, done: np.ndarray, counts: np.ndarray,
                 occupants: List[Optional[_Request]]) -> None:
        """Collect one fetched segment. ``occupants`` is the slot list AT
        DISPATCH TIME: with the depth-1 pipeline a finished row can still
        appear (done) in the next segment, so completion is guarded by the
        request's harvested flag. Finished rows go to ``_finish_pending``."""
        for b, req in enumerate(occupants):
            if req is None or req.harvested:
                continue
            req.seg_tokens.append(seg_tok[b])
            req.count_seen = int(counts[b])
            if done[b]:
                req.harvested = True
                req.t_harvest = time.perf_counter()
                if self._slots[b] is req:
                    self._slots[b] = None
                with metrics.span("slot_release"):
                    self._state = slots_mod.release_slot(self._state, b,
                                                         params=self.char.t2s_params)
                self._finish_pending.append([req, int(counts[b]), 0])

    # -- window pump -------------------------------------------------------

    def _codes_so_far(self, req: _Request, count: int) -> np.ndarray:
        return np.concatenate([[req.tok0_np]] + req.seg_tokens)[:count]

    def _fetch_tok0(self, reqs) -> None:
        """First tokens that no segment fetch has brought yet (one read)."""
        missing = [r for r in reqs if r.tok0_np is None]
        if missing:
            vals = torch.cat([r.tok0_dev.reshape(-1) for r in missing]).cpu().tolist()
            for r, v in zip(missing, vals):
                r.tok0_np = int(v)

    def _win_for(self, jobs) -> int:
        """Smallest window covering every job's width + the halos."""
        need = max(width for *_x, width in jobs) + 2 * self.halo
        for w in (self.win_first, self.win_small, self.win):
            if need <= w:
                return w
        raise ValueError(
            f"no vocode window covers width+halo={need} frames (windows: "
            f"{self.win_first}, {self.win_small}, {self.win}); job widths must be "
            f"clamped to vocode_chunk={self.chunk}")

    def _dispatch_windows(self, jobs, codes_dev=None) -> None:
        """One batched latent + window vocode for ``jobs`` = [(req, codes,
        count, start, width_frames)], dispatched here on the scheduler
        thread; the piece fetch runs on the window worker. ``codes_dev``:
        device codes that replace the jobs' codes (the speculative first
        piece)."""
        rows = [(req.ref, req.phones, codes, count, req.noise, start, width)
                for req, codes, count, start, width in jobs]
        with metrics.timer("slot_window_vocode"):
            handle = self.engine.vocode_windows_dispatch(
                self.char, rows, win=self._win_for(jobs), pcm16=self.pcm16,
                t_buckets=self._t_buckets, codes_dev=codes_dev)
        metrics.gauge("slot_window_rows", len(jobs))
        now = time.perf_counter()
        for req, _, _, start, width in jobs:
            req.emitted = start + width
            if start == 0 and req.stream_q is not None and req.t_join:
                req.t_first_dispatch = now
                metrics.observe("ttfa_join_to_dispatch", now - req.t_join)
        meta = [(req, start) for req, _, _, start, _ in jobs]

        @torch.inference_mode()
        def fetch(meta=meta, handle=handle):
            try:
                for (req, start), piece in zip(meta,
                                               TTSEngine.vocode_windows_fetch(handle)):
                    req.pieces[start] = piece
                    if req.stream_q is not None and not req.cancelled:
                        if start == 0 and req.t_first_dispatch:
                            t = time.perf_counter()
                            metrics.observe("ttfa_dispatch_to_piece",
                                            t - req.t_first_dispatch)
                            metrics.observe("ttfa_total", t - req.t_submit)
                        req.stream_q.put(piece)
            except BaseException as e:  # noqa: BLE001 — surface to the waiters
                logger.exception("window fetch failed")
                for req, _ in meta:
                    req.error = e
                    _stream_close(req, e)
                    req.done.set()

        self._work.append(self._winworker.submit(fetch))

    def _spec_first_pieces(self, seg_tok: torch.Tensor, seg_w: int) -> None:
        """Speculative first pieces for streaming rows whose FIRST segment
        is the one just dispatched: the vocode is enqueued right behind that
        segment, with codes put together on the device from its tokens
        (:func:`spec_codes`), so the join -> first audio chain crosses one
        device round trip. Sound because such rows have min_steps >= the
        claimed count, so every claimed token is a real pre-EOS token."""
        if not self.first_piece:
            return
        count, fb = self._spec
        if count - 1 > seg_w:
            return                      # one segment cannot cover it
        jobs, slots = [], []
        for b, req in enumerate(self._slots):
            if (req is not None and req.stream_q is not None and not req.harvested
                    and not req.cancelled and req.emitted == 0 and req.count_seen == 0
                    and req.tok0_dev is not None and req.min_steps >= count):
                jobs.append((req, None, count, 0, self.first_piece))
                slots.append(b)
        if not jobs:
            return
        R = len(jobs)
        R_pad = max(pick_bucket(R, self.cfg.batch_buckets), R)
        tok0s = [req.tok0_dev for req, *_ in jobs] + [jobs[0][0].tok0_dev] * (R_pad - R)
        rows = host_to_device(np.asarray(slots + [slots[0]] * (R_pad - R), np.int64),
                              seg_tok.device)
        codes_dev = spec_codes(tok0s, seg_tok, rows, fb=fb, count=count,
                               vq_codes=self.char.sovits_cfg.vq_codes,
                               params=self.char.t2s_params)
        self._dispatch_windows(jobs, codes_dev=codes_dev)

    def _run_pump_flush(self) -> None:
        """One round of vocode dispatches: the pump on the chunk cadence (a
        half-chunk of decoded steps since the last pump), or every segment
        while a streaming row still owes its first piece (then only those
        rows); then the finisher flush (forced when the machine idles)."""
        on_cadence = self._steps_since_pump >= self.chunk // 2
        if on_cadence:
            self._steps_since_pump = 0
        if on_cadence or (self.first_piece and any(
                r.emitted == 0 and r.stream_q is not None for r in self._pump_rows())):
            self._pump_windows(first_only=not on_cadence)
        with metrics.timer("slot_flush_host"):
            self._flush_finishers_maybe(force=not self._occupied())

    def _pump_rows(self) -> list:
        """Rows the pump serves: every in-flight row with
        ``slot_stream_finisher``, else the rows with a streaming consumer."""
        return [r for r in self._slots
                if r is not None and not r.harvested and not r.cancelled
                and (self.windows or r.stream_q is not None)]

    def _pump_windows(self, first_only: bool = False) -> None:
        """Vocode one chunk for every pumped row whose decoded frontier
        (lookahead-guarded) is a full chunk past what it has emitted; a
        streaming row's FIRST piece is the small ``first_piece`` window
        instead. ``first_only`` serves only rows awaiting that piece."""
        jobs = []
        for req in self._pump_rows():
            frontier = 2 * max(req.count_seen - self.lookahead, 0)
            if self.first_piece and req.emitted == 0 and req.stream_q is not None:
                if frontier >= self.first_piece:
                    jobs.append((req, self.first_piece))
            elif not first_only and frontier - req.emitted >= self.chunk:
                jobs.append((req, self.chunk))
        if not jobs:
            return
        self._fetch_tok0([req for req, _ in jobs])
        self._dispatch_windows([
            (req, self._codes_so_far(req, req.count_seen), req.count_seen,
             req.emitted, width) for req, width in jobs])

    def _flush_finishers_windows(self, pend) -> None:
        """Completion of pumped rows: vocode only the REMAINDER of each
        (the pump already emitted up to its frontier), then assemble the
        pieces in order on the window worker."""
        reqs = [r for r, _, _ in pend]
        try:
            self._fetch_tok0(reqs)
            for req, count, _ in pend:
                req.final_codes = finalize_semantic_tokens(
                    self._codes_so_far(req, count)[None], np.array([count]),
                    self.char.t2s_cfg.eos_id)[0]
            while True:
                jobs = []
                for req in reqs:
                    total = 2 * len(req.final_codes)
                    if req.emitted < total:
                        jobs.append((req, req.final_codes, len(req.final_codes),
                                     req.emitted, min(self.chunk, total - req.emitted)))
                if not jobs:
                    break
                self._dispatch_windows(jobs)
        except BaseException as e:  # noqa: BLE001 — surface to the waiters
            logger.exception("window completion dispatch failed")
            for req in reqs:
                req.error = e
                _stream_close(req, e)
                req.done.set()
            return

        def assemble(reqs=reqs):
            for req in reqs:
                if req.done.is_set():
                    continue
                try:
                    total = 2 * len(req.final_codes) * self.char.sovits_cfg.hop_length
                    parts = [req.pieces[k] for k in sorted(req.pieces)]
                    dtype = np.int16 if self.pcm16 else np.float32
                    audio = np.concatenate(parts) if parts else np.zeros(0, dtype)
                    req.result = audio[:total]
                    metrics.incr("slot_utterances")
                    _phase("slot_finish", req, req.t_harvest, time.perf_counter())
                    _stream_close(req)
                except BaseException as e:  # noqa: BLE001
                    logger.exception("window assembly failed")
                    req.error = e
                    _stream_close(req, e)
                finally:
                    req.done.set()

        self._work.append(self._winworker.submit(assemble))

    def _flush_finishers_maybe(self, force: bool = False) -> None:
        """Complete finished rows. Pumped rows (streaming consumers, or
        every row with ``slot_stream_finisher``) complete at once through
        the window path. The rest pool for one batched vocode, flushed on
        ``force`` (idle or shutdown), at ``slot_finisher_batch`` rows, when
        the oldest row has waited ``slot_finisher_wait_segs`` segments, or
        when the machine starves (free slots and an empty queue: the pooled
        rows' clients are the ones who would refill it)."""
        pend = [e for e in self._finish_pending if not e[0].cancelled]
        for e in self._finish_pending:
            if e[0].cancelled and not e[0].done.is_set():
                e[0].done.set()
        win_pend = [e for e in pend
                    if self.windows or e[0].stream_q is not None or e[0].emitted > 0]
        win_ids = {id(e) for e in win_pend}      # identity: == compares arrays
        pend = [e for e in pend if id(e) not in win_ids]
        self._finish_pending = pend
        if win_pend:
            metrics.gauge("slot_finisher_rows", len(win_pend))
            self._flush_finishers_windows(win_pend)
        if not pend:
            return
        oldest = max(e[2] for e in pend)
        starving = self._q.empty() and any(r is None for r in self._slots)
        if not (force or starving or len(pend) >= self.cfg.slot_finisher_batch
                or oldest >= self.cfg.slot_finisher_wait_segs):
            return
        self._finish_pending = []
        metrics.gauge("slot_finisher_rows", len(pend))
        reqs = [r for r, _, _ in pend]
        try:
            # tok0 usually reached the host with a segment fetch
            self._fetch_tok0(reqs)
            items = []
            for req, count, _ in pend:
                codes = finalize_semantic_tokens(self._codes_so_far(req, count)[None],
                                                 np.array([count]),
                                                 self.char.t2s_cfg.eos_id)[0]
                items.append((req.ref, req.phones, codes))
            kw = ({"cfm_seeds": [r.cfm_seed for r in reqs]} if self.char.version == "v4"
                  else {})
            with metrics.span("slot_vocode_dispatch"):
                handle = self.engine.vocode_codes_dispatch(
                    self.char, items, t_buckets=self._t_buckets, pcm16=self.pcm16, **kw)
        except BaseException as e:  # noqa: BLE001 — surface to the waiters
            logger.exception("slot vocode dispatch failed")
            for req in reqs:
                req.error = e
                req.done.set()
            return
        self._work.append(self._vocoder.submit(self._complete_fetch, reqs, handle))

    @torch.inference_mode()
    def _complete_fetch(self, reqs, handle) -> None:
        """Worker half: wait for the finisher's host copy and trim."""
        try:
            for req, audio in zip(reqs, self.engine.vocode_codes_fetch(handle)):
                req.result = audio
            metrics.incr("slot_utterances", len(reqs))
            t = time.perf_counter()
            for req in reqs:
                _phase("slot_finish", req, req.t_harvest, t)
        except BaseException as e:  # noqa: BLE001 — surface to the waiters
            logger.exception("slot request completion failed")
            for req in reqs:
                req.error = e
        finally:
            for req in reqs:
                req.done.set()

    def _dispatch_segment(self, w: int):
        """Dispatch one segment of ``w`` steps and enqueue its outputs'
        copy to the host: the tokens, done flags and counts, and the first
        tokens of rows whose tok0 has not reached the host, in one tensor.
        Returns (the pending fetch, the segment's device tokens)."""
        occ = sum(r is not None for r in self._slots)
        metrics.gauge("slot_occupancy", occ)
        metrics.gauge("slot_attn_kernel", self.attn_kernel)
        metrics.gauge("slot_linear_kernel", self.linear_kernel)
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], occ)
        seg_fn = self._decode_seg if w == self.W else self._decode_segs[w]
        params = self.char.t2s_params
        # the state held from the segment to the copy of its flags
        with slots_mod.holding(params, self._state) as st:
            with (metrics.device_span("slot_segment_device", self.char.device) as dspan,
                  metrics.timer("slot_segment")):
                if metrics.recording:
                    dspan.set(steps=w)
                self._state, seg_tok = seg_fn(params, self._state, generator=self._gen)
            occupants = list(self._slots)
            tok0_rows = [r for r in occupants if r is not None and r.tok0_np is None]
            packed = torch.cat([seg_tok.reshape(-1), st.done.int(), st.counts]
                               + [r.tok0_dev.reshape(-1) for r in tok0_rows])
            copy = start_host_copy(packed)
        self._head = (self._head + w) % self.ring
        self.stats["segments"] += 1
        self.stats["steps"] += w
        self._steps_since_pump += w
        return (copy, occupants, tok0_rows, w), seg_tok

    def _fetch_segment(self, pending) -> None:
        copy, occupants, tok0_rows, W = pending
        B = self.n_slots
        with metrics.timer("slot_fetch"):
            flat = finish_host_copy(copy)
        seg_tok = flat[:B * W].reshape(B, W)
        done, counts = flat[B * W:B * W + B] != 0, flat[B * W + B:B * W + 2 * B]
        for r, t in zip(tok0_rows, flat[B * W + 2 * B:]):
            if r.tok0_np is None:
                r.tok0_np = int(t)
        for e in self._finish_pending:
            e[2] += 1                      # aged one more segment
        self._harvest(seg_tok, done, counts, occupants)

    def _loop(self) -> None:
        drained = False
        try:
            # inference mode is per thread: enter it on the scheduler thread
            with torch.inference_mode():
                drained = self._loop_body()
        finally:
            # drain on shutdown: no waiter may hang on a dead scheduler
            if not drained:
                self._fail_all(RuntimeError("slot batcher stopped"))

    def _drained_exit(self, pending) -> bool:
        """A retired machine with nothing queued, in its slots, in flight
        or awaiting the finisher stops its loop (under the lock, so no
        request is queued behind the check; not waiting for it, since
        ``start`` may hold it while it joins this thread)."""
        if not self._retired or pending is not None or self._occupied() or self._finish_pending:
            return False
        if not self._lock.acquire(blocking=False):
            return False
        try:
            if not self._q.empty():
                return False
            self._running = False
            return True
        finally:
            self._lock.release()

    def _segment_width(self) -> int:
        """Short segments while a streaming row owes its first piece (fewer
        segment boundaries before first audio), and wherever a full one
        would run past the end of the ring (mixed widths leave the head
        off the W grid)."""
        w = self.W
        if self.join_W != self.W and any(
                r is not None and r.stream_q is not None and r.emitted == 0
                and not r.harvested and not r.cancelled for r in self._slots):
            w = self.join_W
        if self._head + w > self.ring:
            w = self.join_W
        return w

    def _loop_body(self) -> bool:
        """The scheduler loop, until stopped, or until a retired machine
        has drained (then True). Depth-1 pipeline: dispatch segment k+1
        BEFORE waiting for segment k's outputs, so the host work overlaps
        the device's. Joins land between dispatches; releases apply to the
        state after the in-flight segment, which is safe (done rows are
        frozen by masks)."""
        pending = None
        while self._running:
            if self._drained_exit(pending):
                return True
            try:
                self._fill_slots(block=not self._occupied() and pending is None
                                 and not self._finish_pending)
                dispatched = None
                if self._occupied():
                    w = self._segment_width()
                    dispatched, seg_tok = self._dispatch_segment(w)
                    self._spec_first_pieces(seg_tok, w)
                if self._defer_pump:
                    # vocode work held back from the previous iteration, so
                    # a joining stream's prefill, segment and first piece
                    # were queued on the device ahead of it
                    self._defer_pump = False
                    self._run_pump_flush()
                if pending is not None:
                    self._fetch_segment(pending)
                pending = dispatched
                # hold this iteration's vocode work back one segment when a
                # stream is waiting and can join: its first piece must not
                # queue behind chunk pumps and finisher flushes
                if self._stream_waiter_queued() and any(r is None for r in self._slots):
                    self._defer_pump = True
                else:
                    self._run_pump_flush()
            except BaseException as e:  # noqa: BLE001 — device or CUDA faults
                # the device state is suspect: fail every waiter loudly and
                # rebuild the slot state for later traffic
                logger.exception("slot scheduler segment failed")
                pending = None
                self._fail_all(e)
                self._reset_state()

    def _fail_all(self, e: BaseException) -> None:
        for req, _, _ in self._finish_pending:
            if not req.done.is_set():
                req.error = e
                _stream_close(req, e)
                req.done.set()
        self._finish_pending = []
        for b, req in enumerate(self._slots):
            if req is not None and not req.harvested:
                req.harvested = True
                req.error = e
                _stream_close(req, e)
                req.done.set()
            self._slots[b] = None
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = e
            _stream_close(req, e)
            req.done.set()

    def _reset_state(self) -> None:
        dev = self.char.device
        self._steps_since_pump = 0
        self._head = 0                         # host mirror of state.ring_head
        with slots_mod.holding(self.char.t2s_params, self._state) as st:
            slots_mod.reset_slots(st, self.ring)
        # one generator on the scheduler thread draws every Gumbel table
        # and every pumped row's noise table
        self._gen = torch.Generator(device=dev).manual_seed(0)
