"""Shared arithmetic of the per-layer readers in ``perfbench/metrics/``:
each reader is a few lines over a run's records, and returns None where
the run left nothing to read."""
from __future__ import annotations

from typing import Dict, Optional


def in_window(records: Dict):
    """Requests sent in the window that were served, outside the traced
    slice's requests (their times carry the profiler's cost)."""
    return [r for r in records["requests"] if r.rec.get("ok") and not r.rec.get("traced")]


def frontend_ms(records: Dict) -> Optional[float]:
    xs = [(r.rec["t_front"] - r.rec["t_start"]) * 1e3 for r in records["requests"]
          if r.rec.get("t_front") is not None]
    return sum(xs) / len(xs) if xs else None


def gauge_mean(records: Dict, name: str) -> Optional[float]:
    s = records["metrics"].get("gauges", {}).get(name)
    return None if not s or not s.get("count") else float(s["mean"])


def graph_captures(records: Dict) -> Optional[float]:
    before, after = records["graphs"]
    if not after:
        return None
    return float(sum(after.get(k, 0) - before.get(k, 0) for k in ("misses", "captures")))


def slot_step_ms(records: Dict) -> Optional[float]:
    before, after = records["batcher"]
    steps = after.get("steps", 0) - before.get("steps", 0)
    if not steps:
        return None
    t0, t1 = records["window"]
    return (t1 - t0) * 1e3 / steps


def device_idle(records: Dict) -> Optional[float]:
    t = records.get("trace")
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def stage_ms_per_request(records: Dict, names) -> Optional[float]:
    xs = [sum(r.rec["stages"].get(n, 0.0) for n in names) * 1e3
          for r in in_window(records) if r.rec.get("stages")]
    return sum(xs) / len(xs) if xs else None


def decode_ms_per_step(records: Dict) -> Optional[float]:
    rs = [r for r in in_window(records) if r.rec.get("stages") and r.rec.get("decode_steps")]
    if not rs:
        return None
    return (sum(r.rec["stages"]["decode"] for r in rs) * 1e3
            / sum(r.rec["decode_steps"] for r in rs))


def kernel_seconds(records: Dict, fragment: str):
    t = records.get("trace")
    if not t:
        return None, 0
    durs = [d for k, v in t["kernels"].items() if fragment in k for d in v]
    return (sum(durs), len(durs)) if durs else (None, 0)


def fused_decode_roofline(records: Dict) -> Optional[float]:
    """Least time of the traced requests' decode steps (each step's bytes
    at the HBM rate) over the fused kernel's device time in the slice;
    None unless the slice holds exactly one launch per decode step."""
    work, cfg = records["work"], records["config"]
    secs, n = kernel_seconds(records, "fused_decode")
    traced = [r for r in records.get("tail", ()) if r.rec.get("traced") and r.rec.get("ok")]
    if not secs or not traced:
        return None
    ctx0 = records["ref_phones"] + records["prompt_len"]
    steps, least = 0, 0.0
    for r in traced:
        ctx = ctx0 + len(r.rec["phones"])
        for s in range(1, r.codes):
            least += work.fused_step_bytes(cfg, ctx + s) / work.HBM_BYTES_PER_S
            steps += 1
    if steps != n:
        return None
    return 100.0 * least / secs


def step_mfu(records: Dict) -> Optional[float]:
    """Model FLOPs of the requests completed inside the window over the
    window's bf16 peak."""
    work, cfg = records["work"], records["config"]
    t0, t1 = records["window"]
    ctx0 = records["ref_phones"] + records["prompt_len"]
    flops = 0.0
    for r in records["requests"]:
        if r.rec.get("ok") and r.rec["t_done"] <= t1:
            n = len(r.rec["phones"])
            flops += work.request_flops(cfg, ctx0 + n, r.codes, n, tokens=len(r.text) + 2)
    if not flops:
        return None
    return 100.0 * flops / ((t1 - t0) * work.PEAK_BF16_FLOPS)
