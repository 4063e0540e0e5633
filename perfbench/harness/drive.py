"""The load: a closed loop of clients offering requests to the system's
entry (``entries/<entry>.py``, named by the mix).

Each request runs on a client thread: the frontend (``get_phones_and_bert``,
timed as the benchmark's own span), then the entry, with the request's
codes pinned (``min_steps = max_steps``) and its sampling (top-k 15, or
top-k 1 for the greedy rows). A request is timed from the moment its
client takes it to its first and its last PCM sample. The entry keeps
the served tokens of the greedy rows for the check: the codes its
synthesizer vocoded."""
from __future__ import annotations

import functools
import threading
import time
from typing import Callable, List

import numpy as np

from .traffic import Request

REQUEST_TIMEOUT_S = 180.0
# after the traced requests are served, the slot machine's last dispatch
# (its pipeline runs one segment ahead) settles before the profiler stops
SETTLE_S = 0.2

_tl = threading.local()


def current():
    """The request the calling client thread is serving, or None."""
    return getattr(_tl, "req", None)


def instrument(system, entry) -> Callable[[], None]:
    """The entry's reading of the served tokens; returns the undo."""
    return entry.instrument(system, current)


def serve_one(system, entry, r: Request, due: float, stages: bool = False) -> None:
    """One request through ``entry``; fills ``r.rec``."""
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig

    rec = r.rec
    rec["due"] = due
    rec["t_start"] = time.perf_counter()
    sampling = SamplingConfig(top_k=1) if r.greedy else SamplingConfig()
    rec["penalty"] = sampling.repetition_penalty
    _tl.req = r
    try:
        phones, bert = system.phones(r.text)
        rec["t_front"] = time.perf_counter()
        rec["phones"] = np.asarray(phones)
        if r.greedy and np.any(bert):
            rec["bert"] = np.asarray(bert, np.float32)
        kw = dict(min_steps=r.codes, max_steps=r.codes, sampling=sampling)
        pieces = entry.serve(system, r, phones, bert, kw, stages)
        rec["pieces"] = pieces
        rec["t_first"] = pieces[0][0] if pieces else None
        rec["t_done"] = time.perf_counter()
        rec["samples"] = int(sum(n for _, n in pieces))
        rec.setdefault("tokens", None)
        rec["ok"] = bool(pieces)
    except Exception as e:  # noqa: BLE001 — a failed request is counted, not fatal
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["t_done"] = time.perf_counter()
    finally:
        _tl.req = None


class Load:
    """Runs a plan of requests against ``system`` for ``seconds``: the
    mix's ``clients`` take the plan's requests in order.

    ``on_close()`` is called as the window closes (a traced run reads the
    program's counters there); every request sent in the window is then
    waited for. With a ``tracer`` (``prime()``, ``start()``, ``stop()``)
    the next ``trace_requests`` requests of the plan then run under the
    profiler from a standing start, ``clients`` at a time: the profiler
    starts and stops with nothing else launching on the card (a profiler
    started or stopped while other threads launch CUDA graphs has hung
    the process), and its own cost falls in no window. They are kept in
    ``tail`` and count in no end-to-end metric."""

    def __init__(self, system, entry, mix, reqs: List[Request], seconds: float,
                 tracer=None, stages: bool = False, on_close=None):
        self.system, self.entry, self.mix, self.reqs = system, entry, mix, reqs
        self.seconds = float(seconds)
        self.tracer = tracer
        self.stages = stages
        self.on_close = on_close
        self.sent: List[Request] = []
        self.tail: List[Request] = []
        self.t0 = self.t1 = None

    def _serve(self, r: Request, due: float) -> None:
        serve_one(self.system, self.entry, r, due, self.stages)

    def run(self) -> None:
        clients = int(self.mix["clients"])
        lock = threading.Lock()
        it = iter(self.reqs)
        self.t0 = time.perf_counter()
        self.t1 = self.t0 + self.seconds

        def take():
            with lock:
                return next(it, None)

        def client():
            while time.perf_counter() < self.t1:
                r = take()
                if r is None:
                    return
                with lock:
                    self.sent.append(r)
                self._serve(r, time.perf_counter())

        threads = _start([client] * clients)
        time.sleep(max(0.0, self.t1 - time.perf_counter()))
        if self.on_close is not None:
            self.on_close()
        for t in threads:
            t.join()
        if self.tracer is not None:
            batch = [r for r in (take() for _ in range(int(self.mix["trace_requests"])))
                     if r is not None]
            self._traced(batch, clients)

    def _traced(self, batch: List[Request], clients: int) -> None:
        def lane(rs):
            for r in rs:
                r.rec["traced"] = True
                self._serve(r, time.perf_counter())

        self.tracer.prime()
        self.tracer.start()
        for t in _start([functools.partial(lane, batch[i::clients])
                         for i in range(min(clients, len(batch)))]):
            t.join()
        time.sleep(SETTLE_S)
        self.tracer.stop()
        self.tail.extend(batch)


def _start(targets) -> List[threading.Thread]:
    threads = [threading.Thread(target=f, name=f"client-{i}") for i, f in enumerate(targets)]
    for t in threads:
        t.start()
    return threads
