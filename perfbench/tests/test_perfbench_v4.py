"""The GPT-SoVITS V4 family (``families/gpt_sovits_v4.py``): its tiny cut
through ``spec.family``, a whole tiny ``zh-v4.narrate`` run on the CPU
judged correct, and the timed path broken underneath in the ways a CFM
can be (an Euler step skipped, the conditioner cache kept across chunks,
noise that is not the request's seed's, the prompt region left noisy):
``correct`` comes out false each time, and so does the control."""
import itertools
import time

import pytest
import torch

from perfbench.harness import cli, spec, weights
from perfbench.tests import tiny

SEED = 2 ** 40 + 29
CELL = "zh-v4.narrate"


def _run(seconds=3.0, control=False, limits=None):
    cell = tiny.cell(CELL, clients=4)
    if limits is not None:
        cell.limits = limits
    return cli.run(cell, SEED, seconds, False, torch.device("cpu"), time.perf_counter(),
                   control=control, log=lambda s: None)


def test_the_tiny_cut_names_every_model_and_draws_every_leaf():
    cfg = tiny.config("gsv-v4-zh")
    fam = spec.family(cfg["family"])
    assert fam.models(cfg) == ["t2s", "sovits", "hubert", "roberta"]
    assert fam.output_rate(cfg) == 48000 and fam.samples_per_code(cfg) == 4 * 8
    assert spec.family("gpt_sovits_v4").samples_per_code(spec.config("gsv-v4-zh")) == 1920
    tree = weights.make("sovits", cfg, SEED, torch.device("cpu"))
    assert {"cfm", "dec", "bridge", "wns1", "enc_p", "ref_enc"} <= set(tree)
    assert "flow" not in tree
    for path, t in weights._leaves(tree):
        if path[0] == "cfm" and path[-1] in ("w", "gamma", "beta"):
            assert float(t.float().abs().max()) > 0, path     # every block acts


def test_a_sound_tiny_run_is_correct():
    res = _run()
    checks = res["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert {"mel_err", "audio_err", "ge_err"} <= set(checks)
    assert res["_extra"]["audio_compared"] >= 1


def _skip_a_step(sv):
    calls = itertools.count()
    orig = sv.euler_step
    return "euler_step", lambda x, v, d: x if next(calls) % 4 == 2 else orig(x, v, d)


def _stale_text(sv):
    cache, orig = {}, sv.text_embed

    def text_embed(p, mu, maskf):
        return cache.setdefault(tuple(mu.shape), orig(p, mu, maskf))
    return "text_embed", text_embed


def _other_noise(sv):
    orig = sv.cfm_noise
    return "cfm_noise", lambda seed, chunk, *a: orig(seed + 1, chunk, *a)


def _noisy_prompt(sv):
    return "zero_prompt", lambda x, pmask: x


@pytest.mark.parametrize("fault", [_skip_a_step, _stale_text, _other_noise, _noisy_prompt],
                         ids=["euler_step_skipped", "conditioner_cache_stale",
                              "noise_not_the_seeds", "prompt_not_zeroed"])
def test_a_broken_cfm_is_caught(fault, monkeypatch):
    from genie_tts_tpu_torch.models import sovits_v4

    name, broken = fault(sovits_v4)
    monkeypatch.setattr(sovits_v4, name, broken)
    res = _run()
    assert res["correct"] is False
    assert res["checks"]["mel_err"]["value"] > res["checks"]["mel_err"]["limit"]


def test_the_control_is_judged_not_correct():
    """At tiny widths each limit is set between the program's reading and
    the control's, as the cell's file sets them at full size."""
    first = _run(control=True)
    program = {k: v for k, v, _ in first["_program"][1]}
    control = {k: v for k, v, _ in first["_rows"]}
    assert control["mel_err"] > 10 * program["mel_err"]
    limits = {k: (program[k] * control[k]) ** 0.5 if control[k] > program[k] else program[k]
              for k in program}
    res = _run(control=True, limits=limits)
    assert res["_program"][0] is True and res["correct"] is False
