"""graph_captures.narrate: Graph-cache misses plus captures during the window (GraphCache.stats over the configuration's caches and RoBERTa's)."""
from perfbench.harness.readers import graph_captures

LAYER = "graph cache (runtime/graphs.py)"
UNIT = "graphs"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return graph_captures(records)
