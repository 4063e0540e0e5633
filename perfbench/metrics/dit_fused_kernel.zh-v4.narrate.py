"""dit_fused_kernel.zh-v4.narrate: Mean of the port's dit_fused gauge over the batched CFM launches (1 where the DiT's glue runs through the dit_adanorm and dit_rope kernels)."""
from perfbench.harness.readers import gauge_mean

LAYER = "CFM sampler and DiT (models/sovits_v4.py)"
UNIT = "share"
BETTER = "higher"
SOURCE = "program_counter"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v4.narrate"]


def read(records):
    return gauge_mean(records, "dit_fused")
