"""decode_ms_per_step.solo: The decode stage's milliseconds over its steps (TTSEngine(timing=True), traced runs), outside the profiled requests."""
from perfbench.harness.readers import decode_ms_per_step

LAYER = "T2S decode (models/t2s.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms.solo"
WORKLOADS = ["ja-v2.solo"]


def read(records):
    return decode_ms_per_step(records)
