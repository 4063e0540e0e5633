"""cfm_rows.zh-v4.narrate: Mean of the port's cfm_rows gauge: the requests' chunks that share one batched CFM launch in the pooled finisher."""
from perfbench.harness.readers import gauge_mean

LAYER = "finisher (runtime/slot_batcher.py, models/sovits.py)"
UNIT = "rows"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v4.narrate"]


def read(records):
    return gauge_mean(records, "cfm_rows")
