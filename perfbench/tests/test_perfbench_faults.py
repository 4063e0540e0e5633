"""Whole runs of each cell on the CPU at tiny widths, past the harness's
look for a card: sound, they come out correct; with the timed path
broken underneath (a token altered where it is produced; a decode step
that leaves its state unchanged; a segment that returns its state
unchanged; noise where the solo rows' audio is made), ``correct`` comes
out false. The control, the reference put in the program's place at one
step of precision below, is judged by the same limits and comes out not
correct."""
import time

import pytest
import torch

from perfbench.harness import cli, drive
from perfbench.tests import tiny

CELLS = {"ja-v2.solo": {}, "zh-v2pp.narrate": {"clients": 4}}
SEED = 2 ** 40 + 17


def _run(name, seconds=2.0, control=False, limits=None):
    cell = tiny.cell(name, **CELLS[name])
    if limits is not None:
        cell.limits = limits
    return cli.run(cell, SEED, seconds, False, torch.device("cpu"), time.perf_counter(),
                   control=control, log=lambda s: None)


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_sound_run_is_correct_and_prints_the_contracts_keys(name):
    res = _run(name)
    rows = res.pop("_rows")
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    res.pop("_extra")
    res.pop("_program")
    assert list(res)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert {r[0] for r in rows} == set(res["checks"])
    assert all(v["value"] <= v["limit"] for v in res["checks"].values())


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_profiler_starts_and_stops_with_no_request_in_flight(name, monkeypatch):
    """A traced run profiles whole requests after its window from a
    standing start: nothing in flight when the profiler is primed,
    started and stopped."""
    in_flight, seen = [], []
    orig = drive.serve_one

    def counted(*a, **k):
        in_flight.append(1)
        try:
            return orig(*a, **k)
        finally:
            in_flight.pop()

    class Stub:
        result = None

        def __init__(self, device):
            pass

        def prime(self):
            seen.append(("prime", len(in_flight)))

        def start(self):
            seen.append(("start", len(in_flight)))

        def stop(self):
            seen.append(("stop", len(in_flight)))

    monkeypatch.setattr(drive, "serve_one", counted)
    cell = tiny.cell(name, **CELLS[name])
    res = cli.run(cell, SEED, 2.0, True, torch.device("cpu"), time.perf_counter(),
                  log=lambda s: None, tracer_factory=Stub)
    assert seen == [("prime", 0), ("start", 0), ("stop", 0)]
    assert res["correct"] is True and res["metrics"]


def _shifted(orig):
    def sample(*a, **k):
        return (orig(*a, **k) + 1) % 1024
    return sample


@pytest.mark.parametrize("name", sorted(CELLS))
def test_a_token_altered_where_it_is_produced_is_caught(name, monkeypatch):
    from genie_tts_tpu_torch.models import slots, t2s

    monkeypatch.setattr(t2s, "sample_token_rows", _shifted(t2s.sample_token_rows))
    monkeypatch.setattr(slots, "sample_token_rows", _shifted(slots.sample_token_rows))
    res = _run(name)
    assert res["correct"] is False


def test_a_solo_step_that_leaves_the_tokens_unchanged_is_caught(monkeypatch):
    from genie_tts_tpu_torch.models import t2s

    def stale(params, cfg, b, *, n_steps, **_):
        for _ in range(n_steps):
            live = b.step < b.ms_dyn
            b.counts.copy_(torch.where(live, b.step + 1, b.counts))
            b.done.copy_(b.done | ((b.step + 1 >= b.ms_dyn) & live))
            b.step.add_(live.long())

    monkeypatch.setattr(t2s, "_decode_block", stale)
    assert _run("ja-v2.solo")["correct"] is False


def test_noise_in_the_solo_rows_audio_is_caught(monkeypatch):
    from genie_tts_tpu_torch.runtime.engine import TTSEngine

    orig = TTSEngine.synthesize_utterance

    def noisy(self, *a, **k):
        k["noise_scale"] = 0.5
        return orig(self, *a, **k)

    monkeypatch.setattr(TTSEngine, "synthesize_utterance", noisy)
    res = _run("ja-v2.solo")
    assert res["correct"] is False and res["checks"]["logit_gap"]["value"] <= \
        res["checks"]["logit_gap"]["limit"]


@pytest.mark.parametrize("name", ["zh-v2pp.narrate"])
def test_a_slot_segment_that_returns_its_state_unchanged_is_caught(name, monkeypatch):
    from genie_tts_tpu_torch.models import slots

    def frozen(params, state, cfg, seg_steps, *a, **k):
        return state, torch.zeros((state.done.shape[0], seg_steps), dtype=torch.long)

    monkeypatch.setattr(slots, "decode_segment", frozen)
    monkeypatch.setattr(drive, "REQUEST_TIMEOUT_S", 4.0)
    res = _run(name, seconds=1.0)
    assert res["correct"] is False and res["failed"] > 0


@pytest.mark.parametrize("name", sorted(CELLS))
def test_the_control_in_the_programs_place_is_judged_not_correct(name):
    """The limits of the cells' files are set at the published widths; at
    the tiny widths each is set between the program's reading and the
    control's, as at full size. A control run then reports the control
    judged by them: not correct, while the program is."""
    first = _run(name, control=True)
    program = {k: v for k, v, _ in first["_program"][1]}
    control = {k: v for k, v, _ in first["_rows"]}
    assert control["logit_gap"] > 0 and control["logit_gap"] >= 3 * program["logit_gap"]
    limits = {k: (program[k] * control[k]) ** 0.5 if control[k] > program[k] else program[k]
              for k in program}
    res = _run(name, control=True, limits=limits)
    assert res["_program"][0] is True
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["checks"].values())
