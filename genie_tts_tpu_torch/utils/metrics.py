"""Lightweight metrics: per-stage latency histograms, gauges, counters, and
a span recorder.

Own copy of ``genie_tts_tpu/utils/metrics.py`` (host-only; the port
imports nothing of the JAX package). Stages record wall-clock samples into
bounded ring buffers; the slot scheduler reads ``timer``/``gauge``/
``incr``.

Spans (off by default; :meth:`Metrics.record` turns them on): what the
host was doing, on which thread, and from when to when, on the clock of
``time.perf_counter_ns``. :meth:`Metrics.span` times a block on the
calling thread, :meth:`Metrics.span_at` a phase whose ends the caller
stamped (a request's, on a track of its own), :meth:`Metrics.device_span`
a launch's device time (a pair of CUDA events on the current stream),
and every :meth:`Metrics.timer` block is a span too. With recording off
``span`` and ``device_span`` return one shared no-op context and
``span_at`` returns at once: no lock, no clock read, no CUDA call.
:meth:`Metrics.chrome_events` maps the spans onto a ``torch.profiler``
Chrome trace's clock, and :func:`trace` writes both into one file.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict, deque
from typing import Dict, List, NamedTuple, Optional

_WINDOW = 512
# recorded spans kept at most: a 51 s window of the slot machine at ~100
# segments a second and a few spans each, plus a few per request
SPAN_CAP = 1 << 17
# Chrome-trace tracks (tids) of the spans on no thread's row: above any
# Linux thread id (pid_max is at most 2**22)
REQUESTS_TID = 2 ** 31 - 1
DEVICE_TID = 2 ** 31 - 2


class Span(NamedTuple):
    """One recorded span. ``kind``: ``host`` (on thread ``tid``, a native
    thread id; ``ident``: the thread's ``threading.get_ident()``, its
    pthread id), ``request`` (``span_at``: no thread) or ``device``
    (``args["device_ms"]``: the device's milliseconds between the two
    events, None until they completed; ``t0``/``t1``: when the host
    recorded them). Times are ``time.perf_counter_ns()``."""
    kind: str
    name: str
    tid: Optional[int]
    t0: int
    t1: int
    args: Dict
    ident: Optional[int] = None


class _Stat:
    __slots__ = ("samples", "count", "total")

    def __init__(self):
        self.samples: deque = deque(maxlen=_WINDOW)
        self.count = 0
        self.total = 0.0

    def add(self, v: float) -> None:
        self.samples.append(v)
        self.count += 1
        self.total += v

    def summary(self) -> Dict[str, float]:
        xs = sorted(self.samples)
        if not xs:
            return {"count": 0}

        def pct(p):
            return xs[min(len(xs) - 1, int(p * len(xs)))]
        return {
            "count": self.count,
            "mean_ms": round(self.total / self.count * 1000, 4),
            "p50_ms": round(pct(0.50) * 1000, 2),
            "p90_ms": round(pct(0.90) * 1000, 2),
            "p99_ms": round(pct(0.99) * 1000, 2),
        }


class _NoSpan:
    """What ``span`` / ``device_span`` return with recording off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **args) -> None:
        pass


_NO_SPAN = _NoSpan()


class _HostSpan:
    __slots__ = ("_m", "_name", "_args", "_t0")

    def __init__(self, m: "Metrics", name: str, args: Dict):
        self._m, self._name, self._args = m, name, args

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._m._push(["host", self._name, self._t0, t1, self._args, None])
        return False

    def set(self, **args) -> None:
        """Add arguments known only inside the block."""
        self._args.update(args)


class _DeviceSpan(_HostSpan):
    __slots__ = ("_dev", "_start")

    def __init__(self, m: "Metrics", name: str, args: Dict, device):
        super().__init__(m, name, args)
        self._dev = device

    def __enter__(self):
        import torch

        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(torch.cuda.current_stream(self._dev))
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        import torch

        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(self._dev))
        t1 = time.perf_counter_ns()
        self._m._push(["device", self._name, self._t0, t1, self._args, (self._start, end)])
        return False


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)
        self._gauges: Dict[str, _Stat] = defaultdict(_Stat)
        self._counters: Dict[str, int] = defaultdict(int)
        self._recording = False
        self._spans: List[list] = []
        # (time.time_ns(), time.perf_counter_ns()) read as recording started
        self.anchor = (0, 0)

    # -- timers, gauges, counters -------------------------------------------

    @contextlib.contextmanager
    def timer(self, name: str):
        """Wall time of the block as a sample of timer ``name``, and a
        span on the calling thread while recording."""
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self._stats[name].add((t1 - t0) * 1e-9)
                if self._recording:
                    self._push_locked(["host", name, t0, t1, {}, None])

    def observe(self, name: str, seconds: float) -> None:
        with self._lock:
            self._stats[name].add(seconds)

    def gauge(self, name: str, value: float) -> None:
        """Unitless sample (occupancy, batch sizes) — no ms scaling."""
        with self._lock:
            self._gauges[name].add(value)

    def incr(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counters[name] += by

    def snapshot(self) -> Dict:
        with self._lock:
            snap = {
                "timers": {k: s.summary() for k, s in self._stats.items()},
                "counters": dict(self._counters),
            }
            if self._gauges:
                gauges = {}
                for k, s in self._gauges.items():
                    xs = sorted(s.samples)
                    gauges[k] = {
                        "count": s.count,
                        "mean": round(s.total / s.count, 3),
                        "p50": xs[len(xs) // 2],
                        "last": s.samples[-1],
                    }
                snap["gauges"] = gauges
            return snap

    def reset(self) -> None:
        """Clear timers, gauges and counters (not the recorded spans)."""
        with self._lock:
            self._stats.clear()
            self._gauges.clear()
            self._counters.clear()

    # -- spans ------------------------------------------------------------

    @property
    def recording(self) -> bool:
        return self._recording

    def record(self, on: bool) -> None:
        """Turn span recording on (dropping what was recorded, and reading
        the clock anchor :meth:`chrome_events` maps spans by) or off
        (keeping what was recorded for :meth:`spans`)."""
        with self._lock:
            if on:
                self._spans = []
                p0 = time.perf_counter_ns()
                unix = time.time_ns()
                self.anchor = (unix, (p0 + time.perf_counter_ns()) // 2)
            self._recording = bool(on)

    def _push_locked(self, entry: list) -> None:
        """``entry``: [kind, name, t0, t1, args, events]; the calling
        thread's ids are added (a request's phase has none). The native
        id is the one the thread's ``Thread`` object read at its start:
        ``threading.get_native_id()`` is a system call each time."""
        if len(self._spans) < SPAN_CAP:
            if entry[0] != "request":
                entry += [threading.current_thread().native_id, threading.get_ident()]
            else:
                entry += [None, None]
            self._spans.append(entry)
        else:
            self._counters["spans_dropped"] += 1

    def _push(self, entry: list) -> None:
        with self._lock:
            if self._recording:
                self._push_locked(entry)

    def span(self, name: str, **args):
        """A span over the block on the calling thread (a context; its
        ``set(**args)`` adds arguments)."""
        if not self._recording:
            return _NO_SPAN
        return _HostSpan(self, name, args)

    def span_at(self, name: str, t0: float, t1: float, **args) -> None:
        """A span from ``t0`` to ``t1`` (``time.perf_counter()`` seconds)
        on the ``requests`` track: a request's phase that one thread
        starts and another ends."""
        if not self._recording:
            return
        self._push(["request", name, int(t0 * 1e9), int(t1 * 1e9), args, None])

    def span_on_thread(self, name: str, t0: float, t1: float, **args) -> None:
        """A span from ``t0`` to ``t1`` (``time.perf_counter()`` seconds)
        on the calling thread, whose ends the caller stamped."""
        if not self._recording:
            return
        self._push(["host", name, int(t0 * 1e9), int(t1 * 1e9), args, None])

    def device_span(self, name: str, device, **args):
        """The device time of the work the block enqueues on ``device``'s
        current stream: CUDA events before and after, resolved by
        :meth:`spans` once the caller has synchronised (nothing waits
        here). Nothing is recorded on a device that is not a card, or
        while the current stream is capturing a graph (an event recorded
        then would become a node of the graph)."""
        if not self._recording or getattr(device, "type", None) != "cuda":
            return _NO_SPAN
        import torch

        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                return _NO_SPAN
        return _DeviceSpan(self, name, args, device)

    def spans(self) -> List[Span]:
        """What was recorded, in the order the spans ended; a device
        span's ``device_ms`` is read where both its events completed."""
        with self._lock:
            entries = list(self._spans)
        out = []
        for kind, name, t0, t1, args, events, tid, ident in entries:
            if events is not None:
                start, end = events
                args = dict(args, device_ms=(start.elapsed_time(end) if end.query()
                                             else None))
            out.append(Span(kind, name, tid, t0, t1, args, ident))
        return out

    def chrome_events(self, base_ns: int) -> List[Dict]:
        """The recorded spans as Chrome-trace events (``cat: "program"``)
        on the clock of a ``torch.profiler`` trace whose
        ``baseTimeNanoseconds`` is ``base_ns`` (an event at ``ts`` µs is
        at Unix time ``base_ns + 1000 ts`` ns): host spans on their
        thread's row (its native id, under which a profile of the CPU
        files the thread's CUDA runtime calls too), requests and device
        spans on tracks of their own."""
        unix0, perf0 = self.anchor
        shift = unix0 - perf0 - base_ns
        pid = os.getpid()
        out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": label}}
               for tid, label in ((REQUESTS_TID, "requests"), (DEVICE_TID, "device spans"))]
        for s in self.spans():
            tid = {"host": s.tid, "request": REQUESTS_TID}.get(s.kind, DEVICE_TID)
            out.append({"ph": "X", "cat": "program", "name": s.name, "pid": pid, "tid": tid,
                        "ts": (s.t0 + shift) / 1e3, "dur": (s.t1 - s.t0) / 1e3,
                        "args": dict(s.args)})
        return out


metrics = Metrics()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace around a block: the host's operators,
    and the card's kernels where there is one, with the program's spans
    (recorded for the block, or since the caller turned recording on),
    written to ``log_dir`` as one Chrome trace (``trace.json``;
    TensorBoard and Perfetto read it). Nothing is traced without
    ``log_dir``."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    was = metrics.recording
    with profile(activities=activities) as prof:
        if not was:
            metrics.record(True)
        try:
            yield
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            if not was:
                metrics.record(False)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(metrics.chrome_events(int(data["baseTimeNanoseconds"])))
    with open(path, "w") as f:
        json.dump(data, f)
