"""One run of one cell: set-up, the measured window, the check, one line.

``run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``

1. Set-up (``setup_s``, from the process's start): import the port, load
   its nvcc libraries (built inside the checkout on a first run), make
   the weights on the device, run the reference clip through the port's
   reference path, capture the cell's own programs (RoBERTa's buckets,
   and what the mix's entry prepares: ``entries/<entry>.py``), then
   ``warm_seconds`` of the cell's traffic under another seed, unmeasured.
2. The window: ``--seconds`` of the cell's traffic; every request sent in
   it is waited for. With ``--trace 1`` the engine's stage marks are on
   (where the entry has them), and a few whole requests after the window
   run under the profiler (:class:`.drive.Load`).
3. The peak memory is read, the JAX check made, the program's state freed,
   and the reference compares what was served (:mod:`.check`).
4. Earlier lines on stdout: the card, its power limit, the load (a
   closed loop, so no generator lateness), requests sent / succeeded /
   failed, the build cache; the last line: the result. The numbers compared, each with its
   limit, are the last lines on stderr and the result's last key."""
from __future__ import annotations

import argparse
import faulthandler
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List

FORBIDDEN = ("jax", "jaxlib", "flax", "genie_tts_tpu")
# seconds past the window after which a run is ended (a run has 360 s)
WATCHDOG_SLACK_S = 290.0


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that the run may not hold."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="put the control (the reference one step below the stated "
                        "precision) in the program's place and judge it by the cell's "
                        "limits (not part of a benchmark run)")
    return p.parse_args(argv)


def card_line(device) -> str:
    import torch

    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(device.index or 0)],
                             capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = "nvidia-smi unavailable"
    return f"card: {name}; nvidia-smi: {smi}"


def build_kernels() -> str:
    """Load the port's nvcc libraries (``genie_tts_tpu_torch/build/``, keyed
    by a hash of the sources); says whether the build cache hit."""
    from genie_tts_tpu_torch.ops import _build

    names = _build.all_kernels()
    missing = [n for n in names if not _build._library_path(n).is_file()]
    _build.build(names)
    for n in names:
        _build.load_library(n)
    return (f"build cache: {len(names) - len(missing)}/{len(names)} kernels found built"
            + (f", built {missing}" if missing else ""))


class Marks:
    """Set-up's phases on stdout, each with its seconds."""

    def __init__(self, t_start: float, log):
        self.t, self.log = t_start, log

    def __call__(self, what: str) -> None:
        now = time.perf_counter()
        self.log(f"set-up: {what} {now - self.t:.3f} s")
        self.t = now


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        control: bool = False, log=print, tracer_factory=None,
        keep_graphs: bool = False) -> Dict:
    """Everything after the device check; returns the result's dict, with
    the numbers compared (``_rows``), those only logged (``_extra``) and
    the program's judgment (``_program``: (correct, rows), which a
    ``control`` run reports in place of the control's) under keys of
    their own. The system is the mix's entry's own (``system``) where it
    brings one, else :class:`.system.System` on ``device``.
    ``tracer_factory`` replaces the profiler's tracer (tests on the CPU,
    where a traced run has no device trace otherwise); ``keep_graphs``
    leaves the configuration's graphs for a later run in this process."""
    import numpy as np
    import torch

    from . import check, drive, spec, traffic
    from .system import System
    from .trace import Tracer

    cfg, mix = cell.config, cell.traffic
    entry = spec.entry(mix["entry"])
    mark = Marks(t_start, log)
    if device.type == "cuda":
        log(card_line(device))
        log(build_kernels())
    mark("import and kernels")
    sentences = traffic.corpus(cfg)
    counts = traffic.phone_counts(cfg, sentences)
    mark("corpus phonemes")
    system = getattr(entry, "system", System)(
        cfg, seed, device, sentences + [cfg["reference_clip"]["text"]],
        timing=trace and entry.STAGE_MARKS, mark=mark)
    n_ref = len(system.ref.phones)
    limit = system.engine.cfg.slot_phoneme_bucket - n_ref
    plan = traffic.plan(cfg, mix, seed, limit, counts, sentences)
    warm = traffic.plan(cfg, mix, traffic.warm_seed(seed), limit, counts, sentences)
    if cfg.get("roberta"):
        log(f"set-up: RoBERTa units: {system.capture_roberta()}")

    def serve_unmeasured(r):
        drive.serve_one(system, entry, traffic.Request(
            idx=-1, text=r.text, n_phones=r.n_phones, codes=r.codes, greedy=False), 0.0)

    entry.prepare(system, plan + warm, serve_unmeasured, log)
    mark("captures")
    drive.Load(system, entry, mix, warm, float(mix.get("warm_seconds", 3))).run()
    mark("warm traffic")
    undo = drive.instrument(system, entry)
    tracer = None
    if trace and (device.type == "cuda" or tracer_factory is not None):
        tracer = (tracer_factory or Tracer)(device)
    from genie_tts_tpu_torch.utils.metrics import metrics

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    metrics.reset()
    at_open = {"graphs": system.graph_stats(),
               "batcher": dict(system.batcher.stats) if system.batcher is not None else {}}
    at_close = {}

    def on_close():
        at_close["metrics"] = metrics.snapshot()
        at_close["graphs"] = system.graph_stats()
        at_close["batcher"] = (dict(system.batcher.stats) if system.batcher is not None
                               else {})

    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")
    load = drive.Load(system, entry, mix, plan, seconds, tracer=tracer, stages=trace,
                      on_close=on_close)
    load.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    undo()
    snapshot = at_close["metrics"]
    graphs_before, graphs_after = at_open["graphs"], at_close["graphs"]
    batcher_before, batcher_after = at_open["batcher"], at_close["batcher"]
    peak = int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded: {bad}")
    sent = load.sent
    ok = [r for r in sent if r.rec.get("ok")]
    failed = [r for r in sent if not r.rec.get("ok")]
    log(f"load: sent {len(sent)}, succeeded {len(ok)}, failed {len(failed)}; a closed loop "
        f"of {mix['clients']} client(s): no send schedule, so no generator lateness")
    for r in failed[:5]:
        log(f"failed request {r.idx}: {r.rec.get('error')}")
    records = {
        "cell": cell.name, "config": cfg, "mix": mix, "seconds": seconds,
        "window": (load.t0, load.t1), "requests": sent, "tail": load.tail,
        "metrics": snapshot, "graphs": (graphs_before, graphs_after),
        "batcher": (batcher_before, batcher_after),
        "trace": tracer.result if tracer is not None else None,
        "sample_rate": spec.family(cfg["family"]).output_rate(cfg),
        "prompt_len": len(system.ref.prompt_tokens), "ref_phones": n_ref,
        "work": spec.work(cfg["work"]),
    }
    program = system.derived()
    clip = system.clip
    system.close(keep_graphs)
    del system
    sample = traffic.sample_for_check(sent, int(mix.get("check_requests", 8)), seed)
    numbers = check.compare(cfg, seed, device, clip, program, sample, ok, control=control)
    control_numbers = numbers.pop("control", None)
    limits = cell.limits
    correct, rows = check.judge(numbers, limits)
    correct = correct and bool(sample) and not failed
    program_judged = (correct, rows)
    if control_numbers is not None:
        # the control in the program's place, held to the same limits
        log(f"the program (not judged in a control run): correct {correct}; "
            + ", ".join(f"{k} {v!r}" for k, v, _ in rows))
        correct, rows = check.judge(control_numbers, limits)
    metrics_out = {}
    if trace:
        for m in cell.per_layer:
            mod = spec.reader(m["name"])
            v = mod.read(records)
            if v is not None and math.isfinite(v):
                metrics_out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        from . import endtoend

        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics_out["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                metrics_out[m["name"]] = {"value": endtoend.value(m["name"], records),
                                          "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": len(sent), "failed": len(failed),
              "metrics": metrics_out,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                         "kind": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu"),
                         "count": cell.chips, "memory_peak_bytes": peak}}
    if trace and tracer is not None and tracer.result is not None:
        t = tracer.result
        log(f"trace: {t['events']} device operations over {t['window_s']:.3f} s")
        result["device"]["busy_s"] = t["busy_s"]
        result["device"]["window_s"] = t["window_s"]
        result["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    extra = {k: v for k, v in numbers.items() if k not in limits}
    for k, v in extra.items():
        log(f"check (not judged): {k} = {v!r}")
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    result["_rows"] = rows
    result["_extra"] = extra
    result["_program"] = program_judged
    return result


def main(argv, t_start: float) -> int:
    args = parse(argv)
    os.environ.setdefault("USE_FLAX", "0")
    from . import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"needs {cell.chips} CUDA device(s); have "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    # a run still going by then would miss its time limit: every thread's
    # stack to stderr (where it hung), and exit without a result
    faulthandler.dump_traceback_later(args.seconds + WATCHDOG_SLACK_S, exit=True)
    result = run(cell, args.seed, args.seconds, bool(args.trace), device, t_start,
                 control=bool(args.control), log=lambda s: print(s, flush=True))
    rows = result.pop("_rows")
    result.pop("_extra")
    result.pop("_program")
    print(f"correct: {result['correct']}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"check {k}: {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
