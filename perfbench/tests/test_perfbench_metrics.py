"""End-to-end arithmetic, the per-layer readers, and discovery by name."""
import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest

from perfbench.harness import endtoend, spec, traffic
from perfbench.harness.drive import REQUEST_TIMEOUT_S

REPO = spec.REPO


def _req(i, due, first, done, ok=True, pieces=()):
    r = traffic.Request(i, "t", 10, 48, greedy=False)
    r.rec.update(due=due, t_first=first, t_done=done, ok=ok, pieces=list(pieces))
    return r


@pytest.mark.parametrize("name", ["latency_p95_ms.solo", "latency_p95_ms.narrate"])
def test_tails_count_every_request_sent_and_failures_miss(name):
    reqs = [_req(i, 0.0, 0.1, 1.0 + 0.01 * i) for i in range(95)]
    p95_all_ok = endtoend.value(name, {"requests": reqs})
    assert p95_all_ok == pytest.approx(traffic.percentile([1000 + 10 * i for i in range(95)], 95))
    # five failures rank above every served request: the p95 lands on them
    reqs += [_req(95 + i, 0.0, None, 2.0, ok=False) for i in range(5)]
    assert endtoend.value(name, {"requests": reqs}) == REQUEST_TIMEOUT_S * 1e3
    assert traffic.percentile([1000 + 10 * i for i in range(95)] + [math.inf] * 5, 90) < 2000


def test_timing_runs_from_the_due_time():
    r = _req(0, 10.0, 10.25, 11.5)
    assert endtoend.value("latency_p95_ms.solo", {"requests": [r]}) == pytest.approx(1500.0)


def test_audio_counts_only_what_reached_clients_in_the_window():
    reqs = [_req(0, 0.0, 1.0, 3.0, pieces=[(1.0, 32000), (3.0, 32000)]),
            _req(1, 0.0, 9.0, 11.0, pieces=[(9.0, 16000), (11.0, 64000)])]
    rec = {"requests": reqs, "window": (0.0, 10.0), "sample_rate": 32000}
    assert endtoend.audio_s_per_s(rec) == pytest.approx(2.5 / 10.0)


@pytest.mark.parametrize("q, want", [(0, 1.0), (50, 2.5), (95, 3.85), (100, 4.0)])
def test_percentile_is_linear_between_order_statistics(q, want):
    assert traffic.percentile([4.0, 1.0, 3.0, 2.0], q) == pytest.approx(want)


def test_every_reader_matches_its_benchmark_entry():
    bench = spec.benchmark()
    readers = spec.readers()
    assert sorted(readers) == sorted(m["name"] for m in bench["per_layer"])
    for m in bench["per_layer"]:
        mod = readers[m["name"]]
        assert (mod.LAYER, mod.UNIT, mod.BETTER, mod.SOURCE, mod.MOVES) == \
            (m["layer"], m["unit"], m["better"], m["source"], m["moves"])
        assert list(mod.WORKLOADS) == m["workloads"]
        for w in m["workloads"]:
            cell = spec.cell(w, bench)
            assert m["moves"] in [e["name"] for e in cell.end_to_end]


def test_readers_return_nothing_where_the_run_left_nothing():
    empty = {"requests": [], "tail": [], "metrics": {}, "graphs": ({}, {}),
             "batcher": ({}, {}), "trace": None, "window": (0.0, 1.0),
             "work": spec.work("gpt_sovits"), "config": spec.config("gsv-v2-ja"),
             "ref_phones": 10, "prompt_len": 124}
    for name, mod in spec.readers().items():
        assert mod.read(empty) is None, name


def test_device_idle_and_roofline_read_the_trace():
    from perfbench.harness import readers

    cfg = spec.config("gsv-v2-ja")
    work = spec.work("gpt_sovits")
    r = traffic.Request(0, "t", 10, 5, greedy=False)
    r.rec.update(ok=True, traced=True, phones=np.zeros(10))
    least = sum(work.fused_step_bytes(cfg, 10 + 124 + 10 + s) for s in range(1, 5)) / 3.35e12
    rec = {"trace": {"busy_s": 0.3, "window_s": 0.4,
                     "kernels": {"fused_decode_kernel": [least / 4] * 2 + [least / 4] * 2}},
           "tail": [r], "requests": [], "work": work, "config": cfg, "ref_phones": 10,
           "prompt_len": 124}
    assert readers.device_idle(rec) == pytest.approx(25.0)
    assert readers.fused_decode_roofline(rec) == pytest.approx(100.0)
    rec["trace"]["kernels"]["fused_decode_kernel"].append(1.0)     # a launch too many
    assert readers.fused_decode_roofline(rec) is None


def test_the_trace_runs_from_the_first_cuda_call_to_the_last_device_operation():
    from perfbench.harness.trace import analyse

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    t = analyse({"traceEvents": [
        ev("cuda_runtime", "cudaGraphLaunch", 0.0, 10.0),
        ev("kernel", "void k<int>(float*)", 100.0, 200.0),
        ev("kernel", "void k<int>(float*)", 250.0, 100.0),        # overlaps the first
        ev("gpu_memcpy", "Memcpy DtoH", 600.0, 100.0),
        ev("cuda_runtime", "cudaMemcpyAsync", 380.0, 200.0),
        ev("cuda_runtime", "cudaDeviceSynchronize", 700.0, 5000.0),  # the settle
    ]})
    assert t["events"] == 3 and t["window_s"] == pytest.approx(700e-6)
    assert t["busy_s"] == pytest.approx(350e-6)
    assert t["device_ops"][0] == ["k", pytest.approx(300e-6)]
    assert t["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(250e-6)]]


def _copy_bench(tmp_path):
    dst = tmp_path / "repo"
    shutil.copytree(REPO / "perfbench", dst / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_a_new_cell_mix_entry_and_metrics_are_found_by_name(tmp_path):
    """A cell, its mix (data) with the entry it drives, an end-to-end and
    a per-layer metric, added as files and entries with no code edited,
    are found and reported."""
    dst = _copy_bench(tmp_path)
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    wl = json.loads((dst / "perfbench/workloads/ja-v2.solo.json").read_text())
    wl.update(traffic="duo", params={"clients": 2})
    (dst / "perfbench/workloads/ja-v2.duo.json").write_text(json.dumps(wl))
    mix = json.loads((dst / "perfbench/traffic/solo.json").read_text())
    (dst / "perfbench/traffic/duo.json").write_text(json.dumps(dict(mix, entry="solo_twice")))
    (dst / "perfbench/entries/solo_twice.py").write_text(
        (dst / "perfbench/entries/solo.py").read_text())
    bench["workloads"].append({"name": "ja-v2.duo", "config": "gsv-v2-ja", "traffic": "duo",
                               "chips": 1, "why": "two clients"})
    bench["end_to_end"].insert(0, {"name": "audio_s_per_s.duo", "unit": "s/s",
                                   "better": "higher", "bound": 0.1, "source": "host_clock",
                                   "workloads": ["ja-v2.duo"]})
    (dst / "perfbench/metrics/sent.duo.py").write_text(
        'LAYER = "load"\nUNIT = "requests"\nBETTER = "higher"\nSOURCE = "host_clock"\n'
        'MOVES = "audio_s_per_s.duo"\nWORKLOADS = ["ja-v2.duo"]\n\n\n'
        'def read(records):\n    return float(len(records["requests"]))\n')
    bench["per_layer"].append({"name": "sent.duo", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "load",
                               "moves": "audio_s_per_s.duo", "workloads": ["ja-v2.duo"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from perfbench.harness import spec\n"
            "c = spec.cell('ja-v2.duo')\n"
            "e = spec.entry(c.traffic['entry'])\n"
            "print(c.traffic['clients'], c.traffic['entry'], e.STAGE_MARKS,"
            " [m['name'] for m in c.end_to_end], [m['name'] for m in c.per_layer],"
            " spec.reader('sent.duo').read({'requests': [1, 2]}))\n") % str(dst)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=dst, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2", "solo_twice", "True", "['audio_s_per_s.duo',",
                                  "'setup_s']", "['sent.duo']", "2.0"]
