"""fused_decode_roofline.solo: Least time of the profiled requests' decode steps (int8 weights once a step, each step's KV rows up to its position, at 3.35 TB/s) over the fused kernel's device time."""
from perfbench.harness.readers import fused_decode_roofline

LAYER = "kernels (genie_tts_tpu_torch/csrc/)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.solo"
WORKLOADS = ["ja-v2.solo"]


def read(records):
    return fused_decode_roofline(records)
