"""step_mfu.zh-v4.narrate: Model FLOPs of the requests completed in the window (work/gpt_sovits_v4.py: T2S, decode_encp, the CFM's chunks, the 48 kHz vocoder, RoBERTa) over the window times 989 TFLOP/s (bf16)."""
from perfbench.harness.readers import step_mfu

LAYER = "model step (T2S, SoVITS, RoBERTa)"
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v4.narrate"]


def read(records):
    return step_mfu(records)
