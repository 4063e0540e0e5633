"""Readings of the correctness check over many seeds in one process: for
each seed a run of the cell (its own weights and reference clip, a short
window) and the check, with the control (the reference one step below
the stated precision, in the program's place) judged beside the program.
The set-up is paid once: every later seed's character binds its weights
into the configuration's graphs, as a second character of a served
configuration does. For the limits of ``workloads/<cell>.json``.

    python3 perfbench/seeds.py --workload ja-v2.solo --seeds 1,2,3 --seconds 10

One JSON line per seed: the program's numbers and judgment (``checks``,
``correct``), the control's (``control``, ``control_correct``) and the
counts beside them."""
import argparse
import json
import os
import sys
import time


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--params", default="{}", help="JSON overriding the mix's parameters")
    a = p.parse_args(argv)
    import torch

    from perfbench.harness import cli, spec

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.cell(a.workload)
    cell.traffic.update(json.loads(a.params))
    for seed in (int(s) for s in a.seeds.split(",")):
        t = time.perf_counter()
        res = cli.run(cell, seed, a.seconds, False, dev, t, control=True,
                      log=lambda s: None, keep_graphs=True)
        program_correct, program_rows = res["_program"]
        print(json.dumps({"seed": seed, "correct": program_correct,
                          "control_correct": res["correct"], "attempted": res["attempted"],
                          "failed": res["failed"], "seconds": round(time.perf_counter() - t, 1),
                          "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                          "checks": {k: v for k, v, _ in program_rows},
                          "control": {k: v["value"] for k, v in res["checks"].items()},
                          "extra": res["_extra"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
