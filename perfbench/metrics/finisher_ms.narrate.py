"""finisher_ms.narrate: Mean time from a row's harvest to its request done: the finisher pool's wait, its vocode and the host copy (program span slot_finish)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "finisher (runtime/slot_batcher.py, models/sovits.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return timer_mean_ms(records, "slot_finish")
