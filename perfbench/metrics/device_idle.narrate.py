"""device_idle.narrate: Share of the profiled slice in which no kernel, copy or memset ran."""
from perfbench.harness.readers import device_idle

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return device_idle(records)
