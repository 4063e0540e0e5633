"""The span recorder of ``utils/metrics.py`` and the spans the port places.

Off, ``span`` / ``device_span`` return one shared no-op and take no lock;
on, spans carry their thread's native id, the buffer is bounded
(``spans_dropped``), spans map onto a ``torch.profiler`` trace's clock
through ``chrome_events`` (within 0.1 ms of the profiler's own
``user_annotation``), ``trace(log_dir)`` writes them into its file, the
slot machine gives every served request one ``slot_queue`` and one
``slot_finish`` phase inside its submit-to-done interval, and the solo
route gives a span per stage, with no ``stage_sync`` while timing is off.
"""
import json
import threading
import time

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch.config import RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.runtime.engine import (ReferenceFeatures, TTSEngine,
                                                make_random_character)
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher
from genie_tts_tpu_torch.utils import metrics as metrics_mod
from genie_tts_tpu_torch.utils.metrics import Metrics, metrics, trace

TCFG = T2SConfig(phoneme_vocab=40, semantic_vocab=33, embed_dim=32, num_layers=2,
                 num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
                 max_decode_steps=64)
VCFG = SoVITSConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16, ssl_dim=8, vq_codes=32,
    vq_dim=8, gin_channels=16, flow_layers=2, wn_layers=2, wn_kernel=5,
    upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
    resblock_kernels=(3,), resblock_dilations=((1, 3),), n_fft=64, hop_length=8,
    win_length=64)
BUCKETS = dict(phoneme_buckets=(16, 32), prompt_buckets=(16,), frame_buckets=(32, 64))


class _NoLock:
    def __enter__(self):
        raise AssertionError("the off path took the lock")

    def __exit__(self, *exc):
        return False


def _no_event(*a, **k):
    raise AssertionError("the off path made a CUDA event")


@pytest.fixture
def recording():
    """The process's recorder, on for the test."""
    metrics.record(True)
    try:
        yield metrics
    finally:
        metrics.record(False)


def test_off_path_is_one_shared_no_op(monkeypatch):
    m = Metrics()
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    monkeypatch.setattr(m, "_lock", _NoLock())
    cuda = torch.device("cuda", 0)
    a, b = m.span("a"), m.span("b", x=1)
    d = m.device_span("d", cuda, steps=4)
    assert a is b is d
    with a as s, d as t:
        s.set(n=1)
        t.set(steps=5)
    m.span_at("q", 1.0, 2.0, req=3)
    m.span_on_thread("t", 1.0, 2.0)
    monkeypatch.undo()
    assert m.spans() == [] and not m.recording


def test_nested_spans_on_two_threads_and_the_bound(monkeypatch):
    m = Metrics()
    m.record(True)
    tids = {}

    def work(tag):
        tids[tag] = threading.get_native_id()
        with m.span("outer", tag=tag):
            with m.span("inner", tag=tag) as s:
                s.set(more=tag)
                time.sleep(0.01)

    threads = [threading.Thread(target=work, args=(t,)) for t in ("a", "b")]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    with m.timer("timed"):
        pass
    m.span_at("phase", 1.0, 1.5, req=7)
    spans = m.spans()
    for tag in ("a", "b"):
        mine = {s.name: s for s in spans if s.args.get("tag") == tag}
        assert set(mine) == {"outer", "inner"}
        outer, inner = mine["outer"], mine["inner"]
        assert outer.tid == inner.tid == tids[tag] and outer.kind == "host"
        assert outer.t0 <= inner.t0 < inner.t1 <= outer.t1
        assert inner.args["more"] == tag
    assert tids["a"] != tids["b"]
    timed = next(s for s in spans if s.name == "timed")
    assert timed.tid == threading.get_native_id()
    assert m.snapshot()["timers"]["timed"]["count"] == 1
    phase = next(s for s in spans if s.name == "phase")
    assert (phase.kind, phase.tid, phase.t0, phase.t1) == ("request", None, 10 ** 9,
                                                           int(1.5e9))
    # past the bound: kept spans stay, the rest are counted
    monkeypatch.setattr(metrics_mod, "SPAN_CAP", len(spans) + 2)
    for i in range(5):
        with m.span("late", i=i):
            pass
    assert [s.args["i"] for s in m.spans() if s.name == "late"] == [0, 1]
    assert m.snapshot()["counters"]["spans_dropped"] == 3
    m.record(False)
    with m.span("after"):
        pass
    assert not any(s.name == "after" for s in m.spans())


def test_device_span_records_nothing_off_a_card(monkeypatch):
    m = Metrics()
    m.record(True)
    monkeypatch.setattr(torch.cuda, "Event", _no_event)
    with m.device_span("d", torch.device("cpu"), steps=3) as s:
        s.set(steps=4)
    assert m.spans() == []


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    m = Metrics()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        m.record(True)
        for i in range(5):
            with m.span("blk", i=i), record_function(f"ann{i}"):
                torch.ones(64).cumsum(0)
                time.sleep(0.002)
        m.record(False)
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = m.chrome_events(int(data["baseTimeNanoseconds"]))
    ann = {e["name"]: e for e in data["traceEvents"] if e.get("cat") == "user_annotation"}
    slack = 100.0                                    # µs
    for e in (e for e in events if e.get("name") == "blk"):
        a = ann[f"ann{e['args']['i']}"]
        assert e["cat"] == "program" and e["tid"] == a["tid"]
        assert e["ts"] <= a["ts"] + slack, (e, a)
        assert e["ts"] + e["dur"] >= a["ts"] + a["dur"] - slack, (e, a)


class _DoneEvents:
    """Two CUDA events that completed 2.5 ms apart."""

    def query(self):
        return True

    def elapsed_time(self, end):
        return 2.5


@pytest.mark.parametrize("kind, row", [
    ("host", "thread"), ("request", metrics_mod.REQUESTS_TID),
    ("device", metrics_mod.DEVICE_TID)])
def test_chrome_events_put_each_kind_on_its_row(kind, row):
    m = Metrics()
    m.record(True)
    events = (_DoneEvents(), _DoneEvents()) if kind == "device" else None
    m._push([kind, "s", m.anchor[1], m.anchor[1] + 3000, {"steps": 2}, events])
    m.record(False)
    (e,) = [e for e in m.chrome_events(m.anchor[0] - 10 ** 6) if e.get("ph") == "X"]
    assert e["tid"] == (threading.get_native_id() if row == "thread" else row)
    assert e["cat"] == "program" and e["ts"] == pytest.approx(1000.0)
    assert e["dur"] == pytest.approx(3.0)
    assert e["args"] == ({"steps": 2, "device_ms": 2.5} if kind == "device" else {"steps": 2})


def test_trace_keeps_a_callers_recording(tmp_path):
    metrics.record(True)
    try:
        with metrics.span("before"):
            pass
        with trace(str(tmp_path / "t")):
            with metrics.span("inside"):
                pass
        assert metrics.recording
        assert [s.name for s in metrics.spans()] == ["before", "inside"]
    finally:
        metrics.record(False)
    with open(tmp_path / "t" / "trace.json") as f:
        ours = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "program"}
    assert ours == {"before", "inside"}


def test_trace_writes_the_programs_spans(tmp_path):
    with trace(str(tmp_path / "t")):
        with metrics.span("blk", n=1):
            torch.ones(8).cumsum(0)
        metrics.span_at("phase", time.perf_counter() - 0.001, time.perf_counter())
    assert not metrics.recording
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = {e["name"]: e for e in events if e.get("cat") == "program"}
    assert ours["blk"]["tid"] == threading.get_native_id()
    assert ours["blk"]["args"] == {"n": 1}
    assert ours["phase"]["tid"] == metrics_mod.REQUESTS_TID
    assert any("cumsum" in e.get("name", "") for e in events)


@pytest.fixture(scope="module")
def char():
    return make_random_character(t2s_cfg=TCFG, sovits_cfg=VCFG, dtype=torch.float32,
                                 device="cpu")


def _reference(char, seed=0):
    rng = np.random.default_rng(seed)
    ge = char.synth.reference(
        char, (rng.standard_normal(int(0.2 * 32000)) * 0.05).astype(np.float32))["ge"]
    return ReferenceFeatures(
        phones=rng.integers(1, TCFG.phoneme_vocab, 12).astype(np.int32),
        bert=np.zeros((12, TCFG.bert_dim), np.float32),
        prompt_tokens=rng.integers(0, 32, 5).astype(np.int32), ge=ge,
        ge_mrte=ge[:VCFG.mrte_channels])


def test_slot_requests_get_one_queue_and_one_finish_phase(char, recording):
    eng = TTSEngine(RuntimeConfig(**BUCKETS, slot_phoneme_bucket=32, slot_prompt_bucket=16,
                                  slot_steps=8, slot_batch=2, slot_ring=32))
    sb = SlotBatcher(eng, char)
    ref = _reference(char)
    served, bounds = {}, {}
    orig = sb._submit

    def submit(req):
        served[threading.get_ident()] = req
        return orig(req)

    sb._submit = submit

    def client(i):
        ph = np.arange(1, 5 + i, dtype=np.int32)
        t0 = time.perf_counter()
        sb.synthesize(ref, ph, np.zeros((len(ph), TCFG.bert_dim), np.float32), timeout=300,
                      min_steps=6 + 3 * i, max_steps=6 + 3 * i)
        bounds[threading.get_ident()] = (t0, time.perf_counter())

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    sb.stop()
    assert not any(t.is_alive() for t in threads) and len(bounds) == 3
    spans = recording.spans()
    for ident, req in served.items():
        t0, t1 = bounds[ident]
        for name in ("slot_queue", "slot_finish"):
            mine = [s for s in spans if s.name == name and s.args["req"] == id(req)]
            assert len(mine) == 1, (name, mine)
            s = mine[0]
            assert s.kind == "request" and t0 * 1e9 <= s.t0 <= s.t1 <= t1 * 1e9
    names = {s.name for s in spans}
    assert {"slot_join", "slot_segment", "slot_fetch", "slot_release",
            "slot_vocode_dispatch", "slot_wait"} <= names
    # no card: no device span
    assert not any(s.kind == "device" for s in spans)
    timers = metrics.snapshot()["timers"]
    assert timers["slot_queue"]["count"] >= 3 and timers["slot_finish"]["count"] >= 3


@pytest.mark.parametrize("timing", [False, True])
def test_solo_stages_are_spans_with_timing_on_or_off(char, recording, timing):
    eng = TTSEngine(RuntimeConfig(**BUCKETS), timing=timing)
    ph = np.arange(1, 7, dtype=np.int32)
    recording.record(True)
    eng.synthesize_utterance(char, _reference(char), ph,
                             np.zeros((len(ph), TCFG.bert_dim), np.float32), seed=0,
                             fixed_steps=8)
    names = [s.name for s in recording.spans() if s.tid == threading.get_native_id()]
    assert [n for n in names if n.startswith("solo_")] == [
        "solo_host", "solo_decode", "solo_latent", "solo_vocode", "solo_host"]
    # the synchronising marks wait only with timing on, and only on a card
    assert "stage_sync" not in names
    assert bool(eng.last_stats["stages"]) == timing


def test_frontend_spans_g2p_and_the_bert_hook_apart(recording):
    from genie_tts_tpu_torch.frontend import dispatcher

    calls = []

    def hook(norm_text, word2ph):
        calls.append(norm_text)
        return np.ones((sum(word2ph), dispatcher.BERT_DIM), np.float32)

    dispatcher.set_bert_feature_fn(hook)
    try:
        before = metrics.snapshot()["timers"].get("frontend_bert", {}).get("count", 0)
        ids, bert = dispatcher.get_phones_and_bert("今天天气很好。", "zh")
        dispatcher.get_phones_and_bert("こんにちは。", "ja")
    finally:
        dispatcher.set_bert_feature_fn(None)
    assert len(calls) == 1 and bert.shape == (len(ids), dispatcher.BERT_DIM) and bert.all()
    mine = [s for s in recording.spans() if s.tid == threading.get_native_id()]
    assert [s.name for s in mine] == ["frontend_g2p", "frontend_bert", "frontend_g2p"]
    assert metrics.snapshot()["timers"]["frontend_bert"]["count"] == before + 1
