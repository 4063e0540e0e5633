"""frontend_ms.narrate: Mean milliseconds of get_phones_and_bert per request (Chinese G2P and the RoBERTa hook)."""
from perfbench.harness.readers import frontend_ms

LAYER = "frontend (frontend/dispatcher.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return frontend_ms(records)
