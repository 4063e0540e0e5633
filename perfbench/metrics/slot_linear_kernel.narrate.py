"""slot_linear_kernel.narrate: Mean of the port's slot_linear_kernel gauge over the segments dispatched (1 where the slot decode layer's int8 linears run through the slot_linear kernel)."""
from perfbench.harness.readers import gauge_mean

LAYER = "T2S slot decode (models/slots.py)"
UNIT = "share"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate", "zh-v4.narrate"]


def read(records):
    return gauge_mean(records, "slot_linear_kernel")
