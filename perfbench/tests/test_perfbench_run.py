"""The command line: what a run refuses, and a run on the card."""
import json
import os
import subprocess
import sys

import pytest

from perfbench.harness import cli, spec

RUN = [sys.executable, str(spec.ROOT / "run.py")]


@pytest.mark.parametrize("mods, bad", [
    (["genie_tts_tpu_torch", "genie_tts_tpu_torch.models.t2s", "torch"], []),
    (["genie_tts_tpu.api", "torch"], ["genie_tts_tpu"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax", "jaxtyping", "genie_tts_tpu_tools"], ["flax"]),
])
def test_the_jax_check_compares_whole_top_level_names(mods, bad):
    assert cli.forbidden_modules(mods) == bad


def test_a_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(RUN + ["--workload", "ja-v2.solo", "--seed", str(2 ** 32 + 1),
                                "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.REPO, env=env, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_an_unknown_cell_exits_nonzero():
    out = subprocess.run(RUN + ["--workload", "nope", "--seed", "1", "--seconds", "1",
                                "--trace", "0"], capture_output=True, text=True,
                         cwd=spec.REPO, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_json_names_every_file_it_needs():
    bench = spec.benchmark()
    assert bench["command"] == ["python3", "perfbench/run.py"] and bench["paths"] == ["perfbench"]
    for c in bench["configs"]:
        assert (spec.REPO / c["file"]).is_file() and c["reduced"] == []
        assert spec.config(c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = spec.cell(w["name"], bench)
        assert cell.config["name"] == w["config"] and w["chips"] == 1
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ja-v2.solo"])
def test_a_short_run_on_the_card_is_correct(card, workload):
    out = subprocess.run(RUN + ["--workload", workload, "--seed", str(2 ** 31 + 11),
                                "--seconds", "5", "--trace", "0"],
                         capture_output=True, text=True, cwd=spec.REPO, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
