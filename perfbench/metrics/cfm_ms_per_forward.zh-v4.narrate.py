"""cfm_ms_per_forward.zh-v4.narrate: Device ms of the V4 finisher's CFM launches (timer cfm_device, CUDA events around each batched chunk's Euler loop) over the DiT forwards they ran (counter cfm_forwards)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "CFM sampler and DiT (models/sovits_v4.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v4.narrate"]


def read(records):
    t = records["metrics"].get("timers", {}).get("cfm_device")
    n = records["metrics"].get("counters", {}).get("cfm_forwards", 0)
    mean = timer_mean_ms(records, "cfm_device")
    if mean is None or not n:
        return None
    return mean * t["count"] / n
