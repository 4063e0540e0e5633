"""Window batcher: concurrent requests micro-batched into one batch.

The port of ``genie_tts_tpu/runtime/batcher.py``. A scheduler thread
drains the request queue, groups same-character requests that arrive
within ``window_ms`` of the first (up to ``max_batch``) and runs them as
one ``engine.synthesize_batch`` (per-row masks handle the different
lengths; a batch of two or more decodes through the flash kernel). The
serving path sends it the sentences that do not fit the slot machine.

As in the JAX package, every row of a batch runs with the FIRST request's
sampling, ``max_steps`` and ``min_steps`` (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..ops.sampling import SamplingConfig
from ..utils.metrics import metrics
from .engine import CharacterModel, ReferenceFeatures, TTSEngine

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    char: CharacterModel
    ref: ReferenceFeatures
    phones: np.ndarray
    bert: np.ndarray
    sampling: Optional[SamplingConfig]
    max_steps: Optional[int] = None
    min_steps: int = 0
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


class ContinuousBatcher:
    """``stats`` counts what the loop ran: ``batches``, ``rows``,
    ``decode_steps`` and the ``last_batch`` size."""

    def __init__(self, engine: TTSEngine, max_batch: int = 8, window_ms: float = 8.0):
        self.engine = engine
        self.max_batch = max_batch
        self.window_s = window_ms / 1000.0
        self.stats = {"batches": 0, "rows": 0, "decode_steps": 0, "last_batch": 0}
        self._q: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._running = False
        self._lock = threading.Lock()

    # -- public -----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            # a stopped loop may still be finishing its last batch: two
            # loops would split one queue's batches between them
            if self._thread is not None and self._thread.is_alive():
                self._thread.join()
            self._running = True
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="tts-batcher")
            self._thread.start()

    def stop(self, timeout: Optional[float] = None) -> None:
        """Signal shutdown and wait (up to ``timeout``) for the loop to
        end; it fails every request still queued on its way out."""
        with self._lock:
            self._running = False
            thread = self._thread
        if thread is not None and thread is not threading.current_thread():
            thread.join(timeout)

    def synthesize(self, char: CharacterModel, ref: ReferenceFeatures,
                   phones: np.ndarray, bert: np.ndarray,
                   sampling: Optional[SamplingConfig] = None,
                   timeout: Optional[float] = None, max_steps: Optional[int] = None,
                   min_steps: int = 0) -> np.ndarray:
        """Blocking submit; batches with concurrent callers."""
        self.start()
        req = _Request(char, ref, phones, bert, sampling, max_steps=max_steps,
                       min_steps=min_steps)
        self._q.put(req)
        if not req.done.wait(timeout):
            raise TimeoutError("batched synthesis timed out")
        if req.error is not None:
            raise req.error
        return req.result

    # -- scheduler --------------------------------------------------------

    def _collect(self) -> List[_Request]:
        try:
            first = self._q.get(timeout=0.25)
        except queue.Empty:
            return []
        batch = [first]
        # same-character requests arriving within the window join the batch
        t0 = time.perf_counter()
        while len(batch) < self.max_batch:
            remain = self.window_s - (time.perf_counter() - t0)
            if remain <= 0:
                break
            try:
                nxt = self._q.get(timeout=remain)
            except queue.Empty:
                break
            if nxt.char.name == first.char.name:
                batch.append(nxt)
            else:  # another character: it runs in the next batch
                self._q.put(nxt)
                break
        return batch

    def _loop(self) -> None:
        try:
            self._loop_body()
        finally:
            # no waiter may hang on a stopped loop
            while True:
                try:
                    r = self._q.get_nowait()
                except queue.Empty:
                    break
                r.error = RuntimeError("window batcher stopped")
                r.done.set()

    def _loop_body(self) -> None:
        while self._running:
            batch = self._collect()
            if batch:
                self._run_batch(batch)

    def _run_batch(self, batch: List[_Request]) -> None:
        """One batch through the engine, its results (or its error) to its
        waiters. Its locals, which reach the batch's character, end here:
        the idle loop keeps no character alive."""
        metrics.gauge("batch_size", len(batch))
        try:
            st: dict = {}
            outs = self.engine.synthesize_batch(
                batch[0].char, [(r.ref, r.phones, r.bert) for r in batch],
                sampling=batch[0].sampling, max_steps=batch[0].max_steps,
                min_steps=batch[0].min_steps, stats=st)
            self.stats["batches"] += 1
            self.stats["rows"] += len(batch)
            self.stats["decode_steps"] += st.get("decode_steps", 0)
            self.stats["last_batch"] = len(batch)
            for r, a in zip(batch, outs):
                r.result = a
                r.done.set()
        except BaseException as e:  # noqa: BLE001 — to every waiter
            logger.exception("batched synthesis failed")
            for r in batch:
                r.error = e
                r.done.set()
