"""queue_wait_ms.narrate: Mean wait of a request in the slot machine's queue, from its submit to the scheduler taking it for its join (program span slot_queue)."""
from perfbench.harness.spans import timer_mean_ms

LAYER = "slot machine (models/slots.py)"
UNIT = "ms"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "latency_p95_ms.narrate"
WORKLOADS = ["zh-v2pp.narrate"]


def read(records):
    return timer_mean_ms(records, "slot_queue")
