"""device_idle.solo: Share of the profiled requests' span in which no kernel, copy or memset ran."""
from perfbench.harness.readers import device_idle

LAYER = "device"
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
MOVES = "latency_p95_ms.solo"
WORKLOADS = ["ja-v2.solo"]


def read(records):
    return device_idle(records)
