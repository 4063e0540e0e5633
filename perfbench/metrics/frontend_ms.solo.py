"""frontend_ms.solo: Mean milliseconds of get_phones_and_bert per request."""
from perfbench.harness.readers import frontend_ms

LAYER = "frontend (frontend/dispatcher.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "latency_p95_ms.solo"
WORKLOADS = ["ja-v2.solo"]


def read(records):
    return frontend_ms(records)
