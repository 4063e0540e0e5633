"""segment_launch_ms.narrate: Mean host time of a decode segment's dispatch: the bind and the segment graph's launch (program span slot_segment)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "slot machine (models/slots.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return timer_mean_ms(records, "slot_segment")
