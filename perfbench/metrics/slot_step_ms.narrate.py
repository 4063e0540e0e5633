"""slot_step_ms.narrate: Milliseconds of the window per decode step the slot machine dispatched in it (SlotBatcher.stats)."""
from perfbench.harness.readers import slot_step_ms

LAYER = "slot machine (models/slots.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return slot_step_ms(records)
