"""Model families: a configuration names the module (``families/<name>.py``)
that makes its weights, builds its system and checks its output.

The GPT-SoVITS V2 family's readings are pinned, bit for bit, at the
values the harness gave before its version code moved into the family:
every weight tree, what set-up derived from the clip, and every number
the check compares (the control's too), after three greedy requests of
each tiny cell through the cell's entry, on one CPU thread (a
reduction's order, and so its bits, follow the thread count). A toy
family in a directory of its own then plugs in with no edit to any file
of the harness."""
import hashlib
import json
import shutil
import time

import numpy as np
import pytest
import torch

from perfbench.harness import check, cli, drive, endtoend, spec, traffic, weights
from perfbench.harness.system import System
from perfbench.tests import tiny

SEED = 2 ** 33 + 5

PINNED = {
    "ja-v2.solo": {
        "weights": {
            "t2s": "edb3db7cc948a4d253a160f27d2661b2973d76d6b4a3ffc145b68d3c52b48caf",
            "sovits": "ce37f9465c63d4706a579c349ca373b0d7a6d168535c02d431e66b63c807d15b",
            "hubert": "6d8c601efc2ccf7c51893bc842510b0ed520c31053a65ff7132ffa74b81edbd9"
        },
        "derived": {
            "prompts": "f6b983091c0321d0b375ef02cacae54ca015c88c1220d5f04fba56ed248afa9c",
            "ssl": "109a57c91c9f4c5df8b06eb5609eeeefa906590d245b6cee16535a5ef30c3747",
            "ge": "86fadc8c34af922dc48a6e74c32a04256e777b2bd9faede442f5f451886598f0",
            "ge_mrte": "86fadc8c34af922dc48a6e74c32a04256e777b2bd9faede442f5f451886598f0"
        },
        "compare": {
            "length_differ": 0.0,
            "ssl_err": 1.8991853778516088e-07,
            "ge_err": 0.0,
            "prompt_gap": 0.0,
            "prompts_not_nearest": 0.0,
            "phones_differ": 0.0,
            "audio_err": 5.081171548226848e-05,
            "audio_compared": 3.0,
            "logit_gap": 0.0,
            "tokens_compared": 52.0,
            "tokens_not_best": 0.0,
            "control": {
                "length_differ": 0.0,
                "phones_differ": 0.0,
                "ssl_err": 0.43840518593788147,
                "ge_err": 0.004825192969292402,
                "audio_err": 0.0087277265265584,
                "logit_gap": 0.16303682327270508
            }
        },
    },
    "zh-v2pp.narrate": {
        "weights": {
            "t2s": "edb3db7cc948a4d253a160f27d2661b2973d76d6b4a3ffc145b68d3c52b48caf",
            "sovits": "71caffe935e5b0c3b9cbcb932eb31131f7a9cd6be518fd8374cbfb76d45751f2",
            "hubert": "6d8c601efc2ccf7c51893bc842510b0ed520c31053a65ff7132ffa74b81edbd9",
            "prompt_encoder": "4007957f6d9a49f00617a23a318cdb4d604de369198dd32ab0697ec536316538",
            "sv": "7db2f6ccad35cb4bc64a08333e9666e3c7048808c3ef17c3fe92f8f7f44d2eb4",
            "roberta": "07e5f6b5f3b1e16dbfdf1deb11f5dd47253bf5360454e862ec4186ebc23bf525"
        },
        "derived": {
            "prompts": "f6b983091c0321d0b375ef02cacae54ca015c88c1220d5f04fba56ed248afa9c",
            "ssl": "109a57c91c9f4c5df8b06eb5609eeeefa906590d245b6cee16535a5ef30c3747",
            "ge": "69c27173760cd5c4af645f46675c6514e5214352dd9a386ddbbc6f4bd828bcca",
            "ge_mrte": "1d7b56ccbfceb5d928ce06348e1fd83e130aadcb67bec16cdfeecd711fab9bad",
            "sv": "afd4209ec273bd7fbf61377b38f8fd557618fdce4abffad4442ea882c65255de"
        },
        "compare": {
            "length_differ": 0.0,
            "ssl_err": 1.8991853778516088e-07,
            "ge_err": 1.5618621773683117e-06,
            "sv_err": 5.92616970607196e-07,
            "prompt_gap": 0.0,
            "prompts_not_nearest": 0.0,
            "phones_differ": 0.0,
            "bert_err": 2.1195731392253947e-07,
            "logit_gap": 0.00033664703369140625,
            "tokens_compared": 39.0,
            "tokens_not_best": 1.0,
            "control": {
                "length_differ": 0.0,
                "phones_differ": 0.0,
                "ssl_err": 0.43840518593788147,
                "ge_err": 0.00856364518404007,
                "sv_err": 0.005863725673407316,
                "bert_err": 0.010236728005111217,
                "logit_gap": 0.5233478546142578
            }
        },
    },
}


def _tree_hash(tree) -> str:
    h = hashlib.sha256()
    for path, t in weights._leaves(tree):
        t = t.detach().contiguous()
        h.update(f"{'/'.join(path)} {t.dtype} {tuple(t.shape)}".encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _array_hash(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype} {a.shape}".encode() + a.tobytes()).hexdigest()


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_the_v2_familys_readings_are_pinned(name, one_thread):
    cell = tiny.cell(name, clients=1, pool=3, greedy_share=1.0)
    cfg, dev, want = cell.config, torch.device("cpu"), PINNED[name]
    family = spec.family(cfg["family"])
    assert {m: _tree_hash(weights.make(m, cfg, SEED, dev))
            for m in family.models(cfg)} == want["weights"]
    sentences = traffic.corpus(cfg)
    system = System(cfg, SEED, dev, sentences + [cfg["reference_clip"]["text"]])
    try:
        entry = spec.entry(cell.traffic["entry"])
        limit = system.engine.cfg.slot_phoneme_bucket - len(system.ref.phones)
        plan = traffic.plan(cfg, cell.traffic, SEED, limit,
                            traffic.phone_counts(cfg, sentences), sentences)
        entry.prepare(system, plan, lambda r: None, lambda s: None)
        undo = drive.instrument(system, entry)
        for r in plan:
            drive.serve_one(system, entry, r, 0.0)
        undo()
        program = system.derived()
        clip = system.clip
    finally:
        system.close()
    assert [r.rec.get("error") for r in plan] == [None] * 3
    assert {k: _array_hash(v) for k, v in program.items()} == want["derived"]
    numbers = check.compare(cfg, SEED, dev, clip, program, plan, plan, control=True)
    assert numbers == want["compare"] and list(numbers) == list(want["compare"])


def test_a_configuration_without_a_family_is_refused(tmp_path, monkeypatch):
    (tmp_path / "configs").mkdir()
    cfg = spec.load_json(spec.ROOT / "configs" / "gsv-v2-ja.json")
    del cfg["family"]
    (tmp_path / "configs" / "nameless.json").write_text(json.dumps(cfg))
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    with pytest.raises(SystemExit, match="names no family"):
        spec.config("nameless")


def test_a_family_that_lacks_a_key_is_refused(tmp_path, monkeypatch):
    (tmp_path / "partial.py").write_text("def models(cfg):\n    return []\n")
    monkeypatch.setattr(spec, "FAMILIES", tmp_path)
    with pytest.raises(SystemExit, match="lacks .*'port_init'"):
        spec.family("partial")


# V2 with a tree of its own (its own init rule), its own output rate and
# samples per code, and a number of its own read from each request's record
TOY = '''"""A toy family: GPT-SoVITS V2 and a tree more."""
import torch

from perfbench.harness import spec, weights

base = spec.family("gpt_sovits_v2")
character, sv_fn, derived, tiny = base.character, base.sv_fn, base.derived, base.tiny


def models(cfg):
    return base.models(cfg) + ["toy"]


def port_init(model, cfg):
    if model == "toy":
        return lambda g: {"proj": {"w": torch.zeros(6, 4)}}
    return base.port_init(model, cfg)


def init_rule(model, path, shape):
    return (0.5, 0.0) if model == "toy" else base.init_rule(model, path, shape)


def output_rate(cfg):
    return 3 * base.output_rate(cfg) // 2


def samples_per_code(cfg):
    return base.samples_per_code(cfg) + 1


class Check(base.Check):
    def __init__(self, cfg, seed, device, clip, audio_16k, control=False):
        super().__init__(cfg, seed, device, clip, audio_16k, control)
        self.toy = weights.make("toy", cfg, seed, device)["proj"]["w"]
        self.tokens = 0

    def request(self, rec, tokens, phones):
        super().request(rec, tokens, phones)
        self.tokens += len(rec["tokens"])

    def request_numbers(self):
        out, ctl = super().request_numbers()
        # the toy tree reads 0.5 everywhere, by its init rule
        out["toy_tokens"] = float(self.tokens) * float(self.toy.mean()) * 2
        return out, ctl
'''


def test_a_family_plugs_in_as_new_files_alone(tmp_path, monkeypatch):
    shutil.copy(spec.ROOT / "families" / "gpt_sovits_v2.py", tmp_path)
    (tmp_path / "toy_family.py").write_text(TOY)
    monkeypatch.setattr(spec, "FAMILIES", tmp_path)
    made, seen = [], {}
    make = weights.make

    def counted(model, cfg, seed, device):
        made.append(model)
        return make(model, cfg, seed, device)

    def value(name, records):
        seen.update(records)
        return orig_value(name, records)

    orig_value = endtoend.value
    monkeypatch.setattr(weights, "make", counted)
    monkeypatch.setattr(endtoend, "value", value)
    cell = tiny.cell("ja-v2.solo")
    cell.config["family"] = "toy_family"
    cell.limits = dict(cell.limits, toy_tokens=1e9)
    res = cli.run(cell, SEED, 2.0, False, torch.device("cpu"), time.perf_counter(),
                  log=lambda s: None)
    assert made.count("toy") == 2                      # the system's and the reference's
    served = res["attempted"] - res["failed"]
    assert served > 0 and res["checks"]["length_differ"]["value"] == served
    assert res["checks"]["toy_tokens"]["value"] == res["_extra"]["tokens_compared"] > 0
    assert seen["sample_rate"] == 48000
    t0, t1 = seen["window"]
    n = sum(k for r in seen["requests"] for t, k in r.rec["pieces"] if t0 <= t <= t1)
    assert res["metrics"]["audio_s_per_s.solo"]["value"] == pytest.approx(n / 48000 / (t1 - t0))
    for path in (spec.ROOT / "harness").glob("*.py"):
        assert "toy_family" not in path.read_text(encoding="utf-8"), path
