"""The program's spans against the device trace of a traced run's slice.

The port records spans while ``metrics.record(True)`` is on
(``genie_tts_tpu_torch/utils/metrics.py``); ``metrics.chrome_events``
puts them on the clock of a ``torch.profiler`` Chrome trace, host spans on
their thread's native id, and :func:`on_cupti_rows` moves them to the rows
a profile of CUDA activity alone (``trace.Tracer``) files each thread's
runtime calls under, to be appended to its ``traceEvents``. Here:

- :func:`idle_spans` names every idle gap of the slice (as
  ``trace.analyse`` cuts them, and the lead-in from the slice's first CUDA
  call to its first device operation) by what the launching thread was
  doing: the thread of the runtime call whose ``correlation`` matches the
  first device operation after the gap, and on it the innermost program
  span overlapping the gap most; ``(none)`` where no span there overlaps it;
- :func:`launch_cover` says how many ``cudaGraphLaunch`` calls of each
  thread lie inside a program span on that thread (the shared clock's
  check);
- :func:`window_spans` and :func:`device_ms_per_step` read the spans a run
  recorded;
- :func:`timer_mean_ms` reads a span's timer from the window's snapshot.

Only :func:`timer_mean_ms` is read by the benchmark as it stands: the rest
wait for the harness to record spans in a traced run (``cli.run``) and
merge them into the slice's trace (``trace.Tracer.stop``).
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional

from .trace import _union

NONE = "(none)"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def cupti_tid(ident: int) -> int:
    """The row of a thread's CUDA runtime calls in a ``torch.profiler``
    trace of CUDA activity alone: the low 32 bits of its pthread id
    (``threading.get_ident()``) as a signed number, written without its
    sign (read off such traces on an H100, torch 2.11)."""
    v = ident & 0xFFFFFFFF
    return 2 ** 32 - v if v >= 2 ** 31 else v


def on_cupti_rows(events: List[Dict], spans: List) -> List[Dict]:
    """``metrics.chrome_events``' events with each host span moved from its
    thread's native id to :func:`cupti_tid` of its pthread id (``spans``:
    ``metrics.spans()``, which carry both)."""
    rows = {s.tid: cupti_tid(s.ident) for s in spans if s.kind == "host"}
    return [dict(e, tid=rows[e["tid"]]) if e.get("cat") == "program" and e["tid"] in rows
            else e for e in events]


def _x(evs, cats):
    return [e for e in evs if e.get("ph") == "X" and e.get("cat") in cats]


def _program_by_thread(evs) -> Dict[int, List[tuple]]:
    """Host program spans per thread: (start, end, name), sorted by start."""
    out: Dict[int, List[tuple]] = defaultdict(list)
    for e in _x(evs, ("program",)):
        t = float(e["ts"])
        out[e["tid"]].append((t, t + float(e.get("dur", 0.0)), e["name"]))
    for v in out.values():
        v.sort()
    return out


def _gaps(kern, runtime):
    """(start, end, first device operation after it) of each idle stretch."""
    busy = _union([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                   for e in kern])
    by_start = sorted(kern, key=lambda e: float(e["ts"]))
    starts = [float(e["ts"]) for e in by_start]
    t_lo = min(float(e["ts"]) for e in kern + runtime)
    edges = [(t_lo, busy[0][0])] + [(busy[i][1], busy[i + 1][0])
                                    for i in range(len(busy) - 1)]
    return [(a, b, by_start[bisect.bisect_left(starts, b)]) for a, b in edges if b > a]


class _Sweep:
    """One thread's spans (sorted by start) against intervals that come in
    order of their start: :meth:`at` gives the spans overlapping an
    interval, extended by ``slack`` at both ends."""

    def __init__(self, spans: List[tuple], slack: float = 0.0):
        self.spans, self.slack, self.i, self.active = spans, slack, 0, []

    def at(self, a: float, b: float) -> List[tuple]:
        spans, i = self.spans, self.i
        while i < len(spans) and spans[i][0] - self.slack < b:
            self.active.append(spans[i])
            i += 1
        self.i = i
        self.active = [s for s in self.active if s[1] + self.slack > a]
        return self.active


def _innermost(spans: List[tuple], a: float, b: float) -> Optional[str]:
    """The innermost of ``spans`` overlapping [a, b] most: the largest
    overlap, the shortest span among equal ones."""
    best, key = None, None
    for s0, s1, name in spans:
        over = min(b, s1) - max(a, s0)
        if over > 0 and (key is None or (over, s0 - s1) > key):
            best, key = name, (over, s0 - s1)
    return best


def idle_spans(trace: Dict, longest: int = 0):
    """[[span, seconds]] summed over every idle stretch of the slice, the
    most first; with ``longest``, also the ``longest`` longest stretches
    as [[span, launching thread, seconds]]."""
    evs = trace.get("traceEvents", [])
    kern, runtime = _x(evs, DEVICE_CATS), _x(evs, RUNTIME_CATS)
    if not kern:
        return ([], []) if longest else []
    launcher = {e["args"]["correlation"]: e["tid"] for e in runtime
                if "correlation" in e.get("args", {})}
    sweeps = {tid: _Sweep(v) for tid, v in _program_by_thread(evs).items()}
    total: Dict[str, float] = defaultdict(float)
    named = []
    for a, b, first in _gaps(kern, runtime):
        tid = launcher.get(first.get("args", {}).get("correlation"))
        sweep = sweeps.get(tid)
        name = (_innermost(sweep.at(a, b), a, b) if sweep is not None else None) or NONE
        total[name] += (b - a) * 1e-6
        named.append([name, tid, (b - a) * 1e-6])
    out = sorted(([k, v] for k, v in total.items()), key=lambda x: -x[1])
    if longest:
        return out, sorted(named, key=lambda x: -x[2])[:longest]
    return out


def unattributed_share(spans: List) -> Optional[float]:
    """``(none)``'s share (%) of the idle seconds in ``idle_spans``."""
    idle = sum(v for _, v in spans)
    if idle <= 0:
        return None
    return 100.0 * sum(v for k, v in spans if k == NONE) / idle


def launch_cover(trace: Dict, slack_us: float = 100.0) -> Dict[int, List]:
    """Per thread with program spans: [cudaGraphLaunch calls, those inside
    a program span on the same thread within ``slack_us``]."""
    evs = trace.get("traceEvents", [])
    sweeps = {tid: _Sweep(v, slack_us) for tid, v in _program_by_thread(evs).items()}
    out: Dict[int, List] = {}
    launches = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["tid"])
                      for e in _x(evs, RUNTIME_CATS)
                      if e["name"] == "cudaGraphLaunch" and e["tid"] in sweeps)
    for a, b, tid in launches:
        inside = any(s0 - slack_us <= a and b <= s1 + slack_us
                     for s0, s1, _ in sweeps[tid].at(a, b))
        n = out.setdefault(tid, [0, 0])
        n[0] += 1
        n[1] += inside
    return out


def window_spans(records: Dict) -> List:
    """The spans a run recorded (``records["spans"]``: ``metrics.spans()``)
    that started before its traced slice's first request."""
    spans = records.get("spans") or []
    traced = [r.rec["t_start"] for r in records.get("tail", ()) if r.rec.get("t_start")]
    cut = min(traced) * 1e9 if traced else float("inf")
    return [s for s in spans if s.t0 < cut]


def device_ms_per_step(spans: List, name: str) -> Optional[float]:
    """Σ device ms over Σ ``steps`` of the device spans ``name``."""
    got = [s for s in spans if s.kind == "device" and s.name == name
           and s.args.get("device_ms") is not None and s.args.get("steps")]
    if not got:
        return None
    return sum(s.args["device_ms"] for s in got) / sum(s.args["steps"] for s in got)


def timer_mean_ms(records: Dict, name: str) -> Optional[float]:
    """Mean ms of the program's timer ``name`` in the window (the window's
    ``metrics.snapshot()``: every span of a ``metrics.timer`` block, and
    every request phase of ``runtime/slot_batcher.py::_phase``, is a
    sample, recorded or not)."""
    t = records["metrics"].get("timers", {}).get(name)
    return float(t["mean_ms"]) if t and t.get("count") else None
