"""cfm_mfu.zh-v4.narrate: The DiT's FLOPs over the window's CFM launches (work/gpt_sovits_v4.py::dit_flops of the counters cfm_forwards, cfm_frames, cfm_frames_sq) over their device seconds (timer cfm_device) times 989 TFLOP/s (bf16)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "CFM sampler and DiT (models/sovits_v4.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "program_span"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v4.narrate"]


def read(records):
    c = records["metrics"].get("counters", {})
    t = records["metrics"].get("timers", {}).get("cfm_device")
    mean = timer_mean_ms(records, "cfm_device")
    work = records["work"]
    if mean is None or not c.get("cfm_forwards") or not hasattr(work, "dit_flops"):
        return None
    secs = mean * t["count"] / 1e3
    flops = work.dit_flops(records["config"], c["cfm_forwards"], c.get("cfm_frames", 0),
                           c.get("cfm_frames_sq", 0))
    return 100.0 * flops / (secs * work.PEAK_BF16_FLOPS)
