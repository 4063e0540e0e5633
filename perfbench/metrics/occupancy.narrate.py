"""occupancy.narrate: Mean of the port's slot_occupancy gauge over the segments dispatched."""
from perfbench.harness.readers import gauge_mean

LAYER = "slot machine (models/slots.py)"
UNIT = "slots"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return gauge_mean(records, "slot_occupancy")
