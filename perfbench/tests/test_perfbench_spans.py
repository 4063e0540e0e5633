"""Idle gaps named by the program's spans, over synthetic Chrome traces."""
import threading
import time

import pytest

from perfbench.harness import spans as sp
from perfbench.harness import traffic


def _k(ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def _rt(ts, dur, corr, tid, name="cudaGraphLaunch"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": {"correlation": corr}}


def _p(name, ts, dur, tid):
    return {"ph": "X", "cat": "program", "name": name, "ts": ts, "dur": dur, "tid": tid}


def _trace():
    """Kernels at 0-10, 30-40, 100-110 and 150-160 µs. The first three are
    launched by thread 1, the last by thread 2. Thread 1: ``outer``
    (5-95) holding ``inner`` (12-28); thread 2: ``busy`` (0-200), which
    overlaps every gap more than thread 1's spans do."""
    return {"traceEvents": [
        _rt(0, 1, 1, 1), _rt(20, 1, 2, 1), _rt(60, 1, 3, 1), _rt(140, 1, 4, 2),
        _k(0, 10, 1), _k(30, 10, 2), _k(100, 10, 3), _k(150, 10, 4),
        _p("outer", 5, 90, 1), _p("inner", 12, 16, 1), _p("busy", 0, 200, 2),
    ]}


def test_a_gap_goes_to_the_launching_threads_innermost_span():
    got, longest = sp.idle_spans(_trace(), longest=3)
    # each gap goes whole to one span. 10-30: thread 1 launched the next
    # kernel; outer overlaps it 20 µs, inner 16 -> outer; 40-100: outer
    # overlaps 55 of 60 µs; 110-150: thread 2's busy
    assert dict(got) == pytest.approx({"outer": 80e-6, "busy": 40e-6})
    assert longest[0] == ["outer", 1, pytest.approx(60e-6)]
    assert sp.unattributed_share(got) == 0.0


def test_innermost_wins_among_equal_overlaps():
    tr = _trace()
    tr["traceEvents"].append(_p("tight", 9, 22, 1))       # covers 10-30 whole
    got = dict(sp.idle_spans(tr))
    assert got["tight"] == pytest.approx(20e-6)
    assert got["outer"] == pytest.approx(60e-6)


def test_gaps_with_no_span_count_as_none():
    tr = _trace()
    tr["traceEvents"] = [e for e in tr["traceEvents"] if e["name"] != "busy"]
    # and a kernel whose launch the trace lacks
    tr["traceEvents"] += [_k(300, 10, 99)]
    got = dict(sp.idle_spans(tr))
    assert got[sp.NONE] == pytest.approx(40e-6 + 140e-6)
    assert sp.unattributed_share(list(got.items())) == pytest.approx(
        100 * 180 / (80 + 180))
    assert sp.idle_spans({"traceEvents": []}) == []
    assert sp.unattributed_share([]) is None


def test_the_lead_in_is_idle_too():
    tr = _trace()
    tr["traceEvents"] += [_rt(-50, 1, 0, 1, name="cudaMemcpyAsync"), _p("first", -60, 30, 1)]
    # -50-0, before the first kernel, which thread 1 launched
    assert dict(sp.idle_spans(tr))["first"] == pytest.approx(50e-6)


def test_launch_cover_counts_launches_inside_their_threads_spans():
    tr = _trace()
    tr["traceEvents"] += [_rt(300, 2, 5, 1), _rt(96, 2, 6, 1)]
    cover = sp.launch_cover(tr)
    # thread 1: 0 (outer starts at 5: inside the slack), 20, 60, 96 (3 µs
    # past outer's end) inside; 300 is not
    assert cover[1] == [5, 4]
    assert cover[2] == [1, 1]
    assert sp.launch_cover(tr, slack_us=0.0)[1] == [5, 2]


@pytest.mark.parametrize("ident, tid", [
    (0x7F3A30FFD6C0, 0x30FFD6C0),           # read off traces of a card
    (0x7F3AC1FFF6C0, 0x3E000940),
    (0xFFFFF6C0, 0x940),
])
def test_cupti_thread_ids_are_the_pthread_ids_low_bits_unsigned(ident, tid):
    assert sp.cupti_tid(ident) == tid


def test_only_host_spans_move_to_cupti_rows():
    from genie_tts_tpu_torch.utils.metrics import REQUESTS_TID, Metrics

    m = Metrics()
    m.record(True)
    with m.span("blk"):
        pass
    m.span_at("phase", 1.0, 2.0)
    m.record(False)
    got = {e["name"]: e["tid"] for e in sp.on_cupti_rows(m.chrome_events(0), m.spans())
           if e.get("ph") == "X"}
    assert got == {"blk": sp.cupti_tid(threading.get_ident()), "phase": REQUESTS_TID}


def test_the_recorders_own_events_name_a_gap():
    from genie_tts_tpu_torch.utils.metrics import Metrics

    m = Metrics()
    m.record(True)
    with m.span("s"):
        time.sleep(0.002)
    m.record(False)
    base = m.anchor[0] - 10 ** 9               # the trace's clock starts 1 s earlier
    events = sp.on_cupti_rows(m.chrome_events(base), m.spans())
    (s,) = [e for e in events if e.get("ph") == "X"]
    assert s["tid"] == sp.cupti_tid(threading.get_ident())
    tid, mid = s["tid"], s["ts"] + s["dur"] / 2
    tr = {"traceEvents": [_rt(mid - 500, 1, 1, tid), _rt(mid - 2, 1, 2, tid),
                          _k(mid - 400, 1, 1), _k(mid + 1, 1, 2), s]}
    # the lead-in (100 µs) and the gap between the kernels (400 µs)
    assert dict(sp.idle_spans(tr)) == {"s": pytest.approx(500e-6)}
    assert sp.launch_cover(tr) == {tid: [2, 2]}          # both inside its ~2 ms


def _span(kind, name, t0, ms=None, steps=None):
    from genie_tts_tpu_torch.utils.metrics import Span

    args = {} if ms is None else {"device_ms": ms, "steps": steps}
    return Span(kind, name, 1, t0, t0 + 10, args)


def test_device_ms_per_step_and_the_window():
    r = traffic.Request(0, "t", 10, 5, greedy=False)
    r.rec.update(t_start=2.0, traced=True)
    spans = [_span("device", "seg", 1e9, 4.0, 8), _span("device", "seg", 1.5e9, 2.0, 4),
             _span("device", "seg", 1.6e9, None, 4), _span("device", "seg", 2.5e9, 9.0, 1),
             _span("host", "seg", 1e9)]
    win = sp.window_spans({"spans": spans, "tail": [r]})
    assert len(win) == 4
    assert sp.device_ms_per_step(win, "seg") == pytest.approx(6.0 / 12)
    assert sp.device_ms_per_step(win, "other") is None
    assert sp.window_spans({"tail": []}) == []


def test_timer_mean_ms():
    rec = {"metrics": {"timers": {"slot_queue": {"count": 3, "mean_ms": 12.5},
                                  "x": {"count": 0}}}}
    assert sp.timer_mean_ms(rec, "slot_queue") == 12.5
    assert sp.timer_mean_ms(rec, "x") is None
    assert sp.timer_mean_ms({"metrics": {}}, "slot_queue") is None
