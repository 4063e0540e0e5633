"""roberta_ms.narrate: Mean time of the RoBERTa hook on a request's text, apart from G2P (program span frontend_bert; one call a Chinese request)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "frontend RoBERTa hook (models/roberta.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return timer_mean_ms(records, "frontend_bert")
