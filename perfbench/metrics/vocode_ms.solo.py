"""vocode_ms.solo: Latent plus vocode stage milliseconds per request (TTSEngine(timing=True)), outside the profiled requests."""
from perfbench.harness.readers import stage_ms_per_request

LAYER = "SoVITS latent and vocode (models/sovits.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms.solo"
WORKLOADS = ["ja-v2.solo"]


def read(records):
    return stage_ms_per_request(records, ("latent", "vocode"))
