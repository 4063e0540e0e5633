"""Lightweight metrics: per-stage latency histograms, gauges and counters.

Own copy of ``genie_tts_tpu/utils/metrics.py`` (host-only; the port
imports nothing of the JAX package). Stages record wall-clock samples into
bounded ring buffers; the slot scheduler reads ``timer``/``gauge``/
``incr``. :func:`trace` is the JAX package's profiler context as a
``torch.profiler`` trace.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import torch

_WINDOW = 512


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
            "mean_ms": round(self.total / self.count * 1000, 2),
            "p50_ms": round(pct(0.50) * 1000, 2),
            "p90_ms": round(pct(0.90) * 1000, 2),
            "p99_ms": round(pct(0.99) * 1000, 2),
        }


class Metrics:
    def __init__(self):
        self._lock = threading.Lock()
        self._stats: Dict[str, _Stat] = defaultdict(_Stat)
        self._gauges: Dict[str, _Stat] = defaultdict(_Stat)
        self._counters: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def timer(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._stats[name].add(dt)

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
        with self._lock:
            self._stats.clear()
            self._gauges.clear()
            self._counters.clear()


metrics = Metrics()


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """A ``torch.profiler`` trace around a block: the host's operators,
    and the card's kernels where there is one, written to ``log_dir`` as
    a Chrome trace (``trace.json``; TensorBoard and Perfetto read it).
    Nothing is traced without ``log_dir``."""
    if log_dir is None:
        yield
        return
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
