"""The end-to-end metrics, from the host's clock over every request sent
in the window (a failed request misses: it ranks above every served one,
and a percentile that lands on it reads the request time-out)."""
from __future__ import annotations

import math
from typing import Dict, List

from .drive import REQUEST_TIMEOUT_S
from .traffic import percentile


def _times(requests, key: str) -> List[float]:
    out = []
    for r in requests:
        t = r.rec.get(key)
        out.append((t - r.rec["due"]) * 1e3 if r.rec.get("ok") and t is not None
                   else math.inf)
    return out


def _finite(v: float) -> float:
    return REQUEST_TIMEOUT_S * 1e3 if math.isinf(v) else v


def audio_s_per_s(records: Dict) -> float:
    """Seconds of audio that reached clients inside the window, per
    second of window."""
    t0, t1 = records["window"]
    sr = records["sample_rate"]
    n = sum(k for r in records["requests"] for t, k in r.rec.get("pieces", ())
            if t0 <= t <= t1)
    return n / sr / (t1 - t0)


def value(name: str, records: Dict) -> float:
    """The end-to-end metric ``name`` (``<metric>.<cell kind>``: the kind
    only names whose bound it is)."""
    base = name.split(".")[0]
    if base == "latency_p95_ms":
        return _finite(percentile(_times(records["requests"], "t_done"), 95))
    if base == "audio_s_per_s":
        return audio_s_per_s(records)
    raise KeyError(f"no end-to-end metric {name!r}")
