"""step_mfu.narrate: Model FLOPs of the requests completed in the window over the window times 989 TFLOP/s (bf16)."""
from perfbench.harness.readers import step_mfu

LAYER = "model step (T2S, SoVITS, RoBERTa)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return step_mfu(records)
