"""Run one cell of the port's benchmark and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with another code than 0, printing no result, without a CUDA device
(or fewer than the cell needs), or when a JAX module is loaded."""
import os
import sys
import time

T_START = time.perf_counter()
# keep CUPTI set up between profiler sessions: tearing it down at a
# session's end, and setting it up again, while other threads launch CUDA
# graphs can hang the process (the traced slice starts and stops mid-traffic)
os.environ["TEARDOWN_CUPTI"] = "0"

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from perfbench.harness.cli import main

    sys.exit(main(sys.argv[1:], T_START))
