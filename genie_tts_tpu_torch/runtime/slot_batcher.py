"""In-flight continuous batching scheduler (slot engine).

The non-streaming scheduler of ``genie_tts_tpu/runtime/slot_batcher.py``.
A persistent B-slot decode machine (``models/slots.py``) lives on the
character's device: every dispatch advances all occupied slots
``slot_steps`` tokens, and new requests claim free slots between
dispatches, so a request joins within a segment; per-request
``min_steps``/``max_steps`` and sampling parameters are per-row values.
Finished rows pool for one batched vocode (``engine.vocode_codes_*``).

One scheduler thread dispatches all device work. The loop is pipelined
one segment deep: segment k's tokens and flags reach the host (one
non-blocking copy to pinned memory, and an event) while segment k+1
runs. Finisher workers only wait for their copies and trim.

One scheduler serves one character; ``api.get_slot_batcher`` keeps one
per loaded character. Not ported yet (ROADMAP.md): the window pump and
streaming (``synthesize_stream``), windowed KV reads, AOT warmup units.
"""
from __future__ import annotations

import functools
import logging
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..models import slots as slots_mod
from ..models.t2s import finalize_semantic_tokens
from ..ops.sampling import SamplingConfig, SamplingRows, rows_from_config
from ..utils.metrics import metrics
from .buckets import pad_to, pick_bucket
from .engine import (CharacterModel, ReferenceFeatures, TTSEngine, finish_host_copy,
                     host_to_device, start_host_copy)

logger = logging.getLogger(__name__)


def slot_geometry(cfg, tcfg) -> "tuple[int, int, int, int, int]":
    """(n_slots, seg_steps, ring, phoneme_bucket, prompt_bucket): the
    static geometry of the slot machine."""
    W = cfg.slot_steps
    ring = -(-min(cfg.slot_ring, tcfg.max_decode_steps) // W) * W
    return (cfg.slot_batch, W, ring, cfg.slot_phoneme_bucket, cfg.slot_prompt_bucket)


def _slot_finisher_t_bucket(cfg) -> int:
    """The ONE text bucket the slot finisher pads to."""
    return pick_bucket(cfg.slot_phoneme_bucket, cfg.phoneme_buckets)


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


class SlotBatcher:
    """Persistent B-slot decode loop with between-segment joins.

    ``pcm16``: results are int16 PCM made on the device (half the host
    copy of float32); the serving path enables it.

    ``stats`` counts what the loop dispatched: ``segments``, ``steps``
    (decode steps) and ``peak_occupancy``."""

    def __init__(self, engine: TTSEngine, char: CharacterModel, pcm16: bool = False):
        self.engine = engine
        self.char = char
        self.pcm16 = pcm16
        self.cfg = engine.cfg
        tcfg = char.t2s_cfg
        (self.n_slots, self.W, self.ring, self.sx, self.sp) = slot_geometry(self.cfg, tcfg)
        self._t_buckets = (_slot_finisher_t_bucket(self.cfg),)
        # _decode_seg is an attribute so tests can inject faults through it.
        # int8 KV caches read through the int8_big_attention kernel (on CPU
        # tensors its wrapper runs the plain version)
        self._decode_seg = functools.partial(
            slots_mod.decode_segment, cfg=tcfg, seg_steps=self.W, sx=self.sx,
            sp=self.sp, ring_len=self.ring, kv_kernel=self.cfg.slot_kv_int8)
        self.stats = {"segments": 0, "steps": 0, "peak_occupancy": 0}
        self._reset_state()
        self._slots: List[Optional[_Request]] = [None] * self.n_slots
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._running = False
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()
        self._vocoder = ThreadPoolExecutor(max_workers=2,
                                           thread_name_prefix="slot-vocode")
        # finished rows awaiting the pooled finisher: [req, count, age_in_segments]
        self._finish_pending: List[list] = []

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

    def stop(self) -> None:
        """Signal shutdown. The loop thread fails every queued and
        in-flight request on its way out (no hung waiters)."""
        with self._lock:
            self._running = False

    def fits(self, ref: ReferenceFeatures, phones: np.ndarray) -> bool:
        """Whether a request fits the slot machine's static geometry."""
        return (len(ref.phones) + len(phones) <= self.sx
                and len(ref.prompt_tokens) <= self.sp)

    def warmup(self, ref: ReferenceFeatures, text_phones: np.ndarray,
               max_steps: Optional[int] = None) -> int:
        """One small real request through prefill, insert, a segment and
        the finisher (builds the kernels on first use). Returns 1."""
        max_steps = min(max_steps or self.char.t2s_cfg.max_decode_steps, self.ring)
        bert = np.zeros((len(text_phones), self.char.t2s_cfg.bert_dim), np.float32)
        self.synthesize(ref, text_phones, bert, timeout=600,
                        max_steps=min(2 * self.W, max_steps))
        return 1

    def synthesize(self, ref: ReferenceFeatures, phones: np.ndarray, bert: np.ndarray,
                   timeout: Optional[float] = None, min_steps: int = 0,
                   max_steps: Optional[int] = None,
                   sampling: Optional[SamplingConfig] = None) -> np.ndarray:
        """Blocking submit; decodes in flight with concurrent requests.
        ``sampling`` is per request (rows with different configs share the
        machine)."""
        self.start()
        max_steps = min(max_steps or self.char.t2s_cfg.max_decode_steps, self.ring)
        req = _Request(ref, np.asarray(phones, np.int32), bert,
                       min_steps=min(min_steps, max_steps), max_steps=max_steps,
                       sampling=sampling)
        self._q.put(req)
        if not req.done.wait(timeout):
            # the scheduler drops it from the queue or releases its slot
            req.cancelled = True
            raise TimeoutError("slot-batched synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- scheduler --------------------------------------------------------

    def _occupied(self) -> bool:
        return any(r is not None for r in self._slots)

    def _drop_cancelled(self) -> None:
        """Free slots whose waiters timed out."""
        for b, req in enumerate(self._slots):
            if req is not None and req.cancelled and not req.harvested:
                req.harvested = True
                self._slots[b] = None
                self._state = slots_mod.release_slot(self._state, b)

    def _fill_slots(self, block: bool) -> None:
        self._drop_cancelled()
        free = [i for i, r in enumerate(self._slots) if r is None]
        while free:
            try:
                req = self._q.get(timeout=0.2) if block else self._q.get_nowait()
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
                req.done.set()
                free.insert(0, b)

    def _insert_request(self, b: int, req: _Request) -> None:
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
        req.tok0_dev = tok0   # reaches the host with the next segment's fetch
        # ring invariant: a row never decodes more tokens than the ring holds
        mx = min(req.max_steps, self.ring)
        self._state = slots_mod.insert_slot(
            self._state, b, ctx_k, ctx_v, tok0, hist, len(packed),
            len(ref.prompt_tokens), min(req.min_steps, mx), mx,
            SamplingRows(*(a[0] for a in samp)))
        self._slots[b] = req

    def _harvest(self, seg_tok: np.ndarray, done: np.ndarray, counts: np.ndarray,
                 occupants: List[Optional[_Request]]) -> None:
        """Collect one fetched segment. ``occupants`` is the slot list AT
        DISPATCH TIME: with the depth-1 pipeline a finished row can still
        appear (done) in the next segment, so completion is guarded by the
        request's harvested flag. Finished rows pool for the finisher."""
        for b, req in enumerate(occupants):
            if req is None or req.harvested:
                continue
            req.seg_tokens.append(seg_tok[b])
            if done[b]:
                req.harvested = True
                if self._slots[b] is req:
                    self._slots[b] = None
                self._state = slots_mod.release_slot(self._state, b)
                self._finish_pending.append([req, int(counts[b]), 0])

    def _flush_finishers_maybe(self, force: bool = False) -> None:
        """Dispatch the pooled finisher vocode when the batch is worth it:
        on ``force`` (idle or shutdown), at ``slot_finisher_batch`` rows,
        when the oldest row has waited ``slot_finisher_wait_segs``
        segments, or when the machine starves (free slots and an empty
        queue: the pooled rows' clients are the ones who would refill
        it)."""
        pend = [e for e in self._finish_pending if not e[0].cancelled]
        for e in self._finish_pending:
            if e[0].cancelled and not e[0].done.is_set():
                e[0].done.set()
        self._finish_pending = pend
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
            # tok0 reached the host with the first segment fetched after the
            # row joined, which is no later than the one that harvested it
            items = []
            for req, count, _ in pend:
                toks = np.concatenate([[req.tok0_np]] + req.seg_tokens)[:count]
                codes = finalize_semantic_tokens(toks[None], np.array([count]),
                                                 self.char.t2s_cfg.eos_id)[0]
                items.append((req.ref, req.phones, codes))
            handle = self.engine.vocode_codes_dispatch(
                self.char, items, t_buckets=self._t_buckets, pcm16=self.pcm16)
        except BaseException as e:  # noqa: BLE001 — surface to the waiters
            logger.exception("slot vocode dispatch failed")
            for req in reqs:
                req.error = e
                req.done.set()
            return
        self._vocoder.submit(self._complete_fetch, reqs, handle)

    @torch.inference_mode()
    def _complete_fetch(self, reqs, handle) -> None:
        """Worker half: wait for the finisher's host copy and trim."""
        try:
            for req, audio in zip(reqs, self.engine.vocode_codes_fetch(handle)):
                req.result = audio
            metrics.incr("slot_utterances", len(reqs))
        except BaseException as e:  # noqa: BLE001 — surface to the waiters
            logger.exception("slot request completion failed")
            for req in reqs:
                req.error = e
        finally:
            for req in reqs:
                req.done.set()

    def _dispatch_segment(self):
        """Dispatch one segment and enqueue its outputs' copy to the host:
        the tokens, done flags and counts, and the first tokens of rows
        whose tok0 has not reached the host, in one tensor."""
        occ = sum(r is not None for r in self._slots)
        metrics.gauge("slot_occupancy", occ)
        self.stats["peak_occupancy"] = max(self.stats["peak_occupancy"], occ)
        with metrics.timer("slot_segment"):
            self._state, seg_tok = self._decode_seg(self.char.t2s_params, self._state,
                                                    generator=self._gen)
        self.stats["segments"] += 1
        self.stats["steps"] += self.W
        occupants = list(self._slots)
        tok0_rows = [r for r in occupants if r is not None and r.tok0_np is None]
        st = self._state
        packed = torch.cat([seg_tok.reshape(-1), st.done.int(), st.counts]
                           + [r.tok0_dev.reshape(-1) for r in tok0_rows])
        return start_host_copy(packed), occupants, tok0_rows

    def _fetch_segment(self, pending) -> None:
        copy, occupants, tok0_rows = pending
        B, W = self.n_slots, self.W
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
        # inference mode is per thread: enter it on the scheduler thread
        try:
            with torch.inference_mode():
                self._loop_body()
        finally:
            # drain on shutdown: no waiter may hang on a dead scheduler
            self._fail_all(RuntimeError("slot batcher stopped"))

    def _loop_body(self) -> None:
        # depth-1 pipeline: dispatch segment k+1 BEFORE waiting for segment
        # k's outputs, so the host work overlaps the device's. Joins land
        # between dispatches; releases apply to the state after the
        # in-flight segment, which is safe (done rows are frozen by masks).
        pending = None
        while self._running:
            try:
                self._fill_slots(block=not self._occupied() and pending is None
                                 and not self._finish_pending)
                dispatched = self._dispatch_segment() if self._occupied() else None
                if pending is not None:
                    self._fetch_segment(pending)
                pending = dispatched
                with metrics.timer("slot_flush_host"):
                    self._flush_finishers_maybe(force=not self._occupied())
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
                req.done.set()
        self._finish_pending = []
        for b, req in enumerate(self._slots):
            if req is not None and not req.harvested:
                req.harvested = True
                req.error = e
                req.done.set()
            self._slots[b] = None
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            req.error = e
            req.done.set()

    def _reset_state(self) -> None:
        dev = self.char.device
        self._state = slots_mod.init_slots(
            self.char.t2s_cfg, self.n_slots, self.sx, self.sp, self.ring,
            dtype=self.char.t2s_params["audio_embed"].dtype,
            kv_int8=self.cfg.slot_kv_int8, device=dev)
        # one generator on the scheduler thread draws every Gumbel table
        self._gen = torch.Generator(device=dev).manual_seed(0)
