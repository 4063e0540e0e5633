"""slot_linear_roofline.narrate: Least time of the slice's slot_linear launches (the launches over 4 x layers whole slot steps, each step's int8 weights, scales, biases and norm parameters in their stored dtypes and each launch's input, residual and output rows at 3.35 TB/s) over their device time.

The device time is the sum of the launches' trace durations. Under
programmatic dependent launch a launch starts while its predecessor runs,
so each duration holds that wait too and the durations overlap: the share
reads below the kernel's own (isolated) share, and a change that shortens
the overlap (a later trigger, or no programmatic launch) raises it while
the step gets no faster. Read it beside ``slot_step_ms.narrate``; a gain
claimed on it alone is no gain. A reader of the union of the launches'
intervals would read the kernel's own time."""
from genie_tts_tpu_torch.config import RuntimeConfig
from perfbench.harness.readers import kernel_seconds
from perfbench.work.gpt_sovits import HBM_BYTES_PER_S

LAYER = "T2S slot decode (models/slots.py)"
UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
MOVES = "audio_s_per_s.narrate"
WORKLOADS = ["zh-v2pp.narrate", "zh-v4.narrate"]


def step_bytes(cfg) -> float:
    """Bytes one slot step's four linears a layer must move at least: the
    int8 codes [in, out], their fp32 scales and biases in the activation
    dtype, the two LayerNorms' fp32 scale and bias, and the rows each
    launch reads and writes for every slot (qkv: x and q/k/v; out: the
    attention row, the residual and the output; ffn1: x and the hidden
    row; ffn2: the hidden row, the residual and the output). The slots are
    the runtime's, as the harness builds it from the configuration."""
    t = cfg["t2s"]
    L, D, F = int(t.get("num_layers", 24)), int(t.get("embed_dim", 512)), int(t.get("ffn_dim",
                                                                                    2048))
    act = 2 if cfg.get("dtype", "bfloat16") == "bfloat16" else 4
    rows = RuntimeConfig(**cfg.get("runtime", {})).slot_batch
    codes = 4 * D * D + 2 * D * F
    columns = 3 * D + D + F + D
    norms = 2 * 2 * D * 4
    launch_rows = rows * act * ((D + 3 * D) + (3 * D) + (D + F) + (F + 2 * D))
    return float(L * (codes + columns * (4 + act) + norms + launch_rows))


def read(records):
    secs, n = kernel_seconds(records, "slot_linear")
    if not secs:
        return None
    layers = int(records["config"]["t2s"].get("num_layers", 24))
    least = n / (4 * layers) * step_bytes(records["config"]) / HBM_BYTES_PER_S
    return 100.0 * least / secs
