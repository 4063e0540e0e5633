"""The device trace of a traced run's slice (``torch.profiler``, CUPTI).

From the slice's Chrome trace: the union of kernel intervals (busy
seconds) over the slice (its first CUDA call to its last device
operation), the kernels' time by name (the top device ops), each kernel
event (for per-kernel readers), and the longest idle gaps, each named by
what the host was doing then: the CPU op or CUDA runtime call that
overlaps the gap most."""
from __future__ import annotations

import json
import os
import re
from pathlib import Path
from typing import Dict, List, Tuple

from .system import scratch_dir


def short(name: str, n: int = 90) -> str:
    """A kernel's name without its return type, namespaces of no name,
    template arguments and parameter list."""
    s = name.replace("(anonymous namespace)::", "")
    prev = None
    while prev != s:
        prev, s = s, re.sub(r"<[^<>]*>", "", s)
    s = re.sub(r"\([^()]*\)\s*$", "", s.strip())
    s = re.sub(r"^void\s+", "", s).strip()
    return (s or name)[:n]


class Tracer:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.result = None

    def prime(self) -> None:
        """Start and stop the profiler once, so its own set-up is not in
        the slice."""
        import torch

        with torch.profiler.profile(activities=self._activities()):
            torch.zeros(1, device=self.device).add_(1)
            torch.cuda.synchronize(self.device)

    def _activities(self):
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA]

    def start(self) -> None:
        import torch

        self.prof = torch.profiler.profile(activities=self._activities())
        self.prof.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        path = scratch_dir() / f"trace-{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        self.prof = None
        try:
            self.result = analyse(json.loads(Path(path).read_text()))
        finally:
            path.unlink(missing_ok=True)


def _union(iv: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def analyse(trace: Dict) -> Dict:
    """events (device operations), busy_s, window_s, device_ops [[name, s]],
    idle_gaps [[name, s]], kernels {short name: [durations s]}."""
    evs = trace.get("traceEvents", [])
    kern = [e for e in evs if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy",
                                                                      "gpu_memset")]
    host = [e for e in evs if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                                      "cuda_runtime",
                                                                      "cuda_driver")]
    if not kern:
        return {"events": 0, "busy_s": 0.0, "window_s": 0.0, "device_ops": [], "idle_gaps": [],
                "kernels": {}}
    iv = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in kern]
    busy = _union(iv)
    # from the first CUDA call to the last device operation: the host's wait
    # before the profiler stops (the slot machine settling) is no idle time
    t_lo = min(float(e["ts"]) for e in kern + host)
    t_hi = max(b for _, b in busy)
    by_name: Dict[str, List[float]] = {}
    for e in kern:
        by_name.setdefault(short(e["name"]), []).append(float(e.get("dur", 0.0)) * 1e-6)
    ops = sorted(((k, sum(v)) for k, v in by_name.items()), key=lambda x: -x[1])[:10]
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    gaps = [g for g in gaps if g[1] > g[0]]
    gaps.sort(key=lambda g: g[0] - g[1])
    host_iv = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                      for e in host), key=lambda x: x[0])
    named = []
    for a, b in gaps[:10]:
        best, over = "host", 0.0
        for ha, hb, name in host_iv:
            if ha >= b:
                break
            o = min(b, hb) - max(a, ha)
            if o > over:
                best, over = name, o
        named.append([short(best, 60), (b - a) * 1e-6])
    return {"events": len(kern), "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (t_hi - t_lo) * 1e-6,
            "device_ops": [[k, v] for k, v in ops],
            "idle_gaps": named,
            "kernels": by_name}
