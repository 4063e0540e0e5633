"""slot_attn_kernel.narrate: Mean of the port's slot_attn_kernel gauge over the segments dispatched (1 where the exact caches' attention kernel reads each segment)."""
from perfbench.harness.readers import gauge_mean

LAYER = "T2S slot decode (models/slots.py)"
UNIT = "share"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return gauge_mean(records, "slot_attn_kernel")
