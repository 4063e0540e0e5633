"""Windowed KV reads on the port's exact-KV slot route, on the CPU.

The JAX package's slot machine reads only the first ``ctx_win`` context
columns and the last ``ring_win`` ring writes on its exact-KV route, with
windows the scheduler picks from host bookkeeping. Here, on the tiny
amplified T2S of tests/test_torch_slots.py (fp32):

* the port's windowed segments equal its full-read segments leaf for leaf
  (integers and tokens exactly, floats within 1e-5: fp32 sums over fewer
  masked columns), windows picked by the port's own ``_pick_windows``;
* the port's windowed segments equal the JAX package's windowed
  ``decode_segment`` leaf for leaf (same tolerances), including a ring
  wrap that starts mid-ring (tests/test_slots.py:194-265);
* ``_pick_windows`` and ``seg_window_combos`` give the JAX functions'
  answers on the same bookkeeping;
* a ``SlotBatcher`` with ``GENIE_SLOT_WINDOWED_KV`` on and off decodes
  identical greedy codes, and reads windows when it is on.
"""
import threading
import types

import jax
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.runtime import slot_batcher as jsb
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.ops import sampling as ts
from genie_tts_tpu_torch.runtime import slot_batcher as tsb
from test_torch_slots import (LEAVES, RING, SP, SX, TCFG, W, Pair, _jseg, _noise,
                              _request, assert_states_equal, params)  # noqa: F401

LADDERS = dict(slot_ctx_windows=(12, 20), slot_ring_windows=(8, 16, 24))


def _bookkeeping(ctx_cols, merged):
    """A stand-in scheduler holding what ``_pick_windows`` reads."""
    n = len(ctx_cols)
    slots = [None if c is None else types.SimpleNamespace(ctx_cols=c) for c in ctx_cols]
    return types.SimpleNamespace(
        windowed_kv=True, _slots=slots, _merged=list(merged) + [0] * (n - len(merged)),
        _ctx_ladder=LADDERS["slot_ctx_windows"],
        _ring_ladder=LADDERS["slot_ring_windows"])


class Machine:
    """One port slot machine plus the scheduler's window bookkeeping."""

    def __init__(self, tp, windowed):
        self.tp, self.windowed = tp, windowed
        self.t = tslots.init_slots(TCFG, 4, SX, SP, RING, dtype=torch.float32)
        self.book = _bookkeeping([None] * 4, [0] * 4)
        self.book.windowed_kv = windowed
        self.max_steps = [0] * 4
        self.windows = []

    def join(self, slot, ctx, req, steps):
        k, v, tok0, hist = ctx
        x_len, p_len = int(req["x_len"][0]), int(req["p_len"][0])
        samp = ts.rows_from_config(ts.SamplingConfig(top_k=1), 1)
        self.t = tslots.insert_slot(self.t, slot, k, v, tok0, hist, x_len, p_len, steps,
                                    steps, ts.SamplingRows(*(a[0] for a in samp)))
        self.book._slots[slot] = types.SimpleNamespace(ctx_cols=x_len + p_len)
        self.book._merged[slot] = 0
        self.max_steps[slot] = steps

    def segment(self, noise):
        cw, rw = tsb.SlotBatcher._pick_windows(self.book)
        self.windows.append((cw, rw))
        self.t, tok = tslots.decode_segment(self.tp, self.t, TCFG, W, SX, SP, RING,
                                            noise=noise, ctx_win=cw, ring_win=rw)
        for b, r in enumerate(self.book._slots):
            if r is not None:
                self.book._merged[b] = min(self.book._merged[b] + W, self.max_steps[b])
        return tok.numpy()


def _t_prefill(tp, req, seed):
    samp = ts.rows_from_config(ts.SamplingConfig(top_k=1), 1)
    return tslots.prefill_join(
        tp, TCFG, torch.from_numpy(req["phones"]).long(), None,
        torch.from_numpy(req["x_len"]), torch.from_numpy(req["prompts"]).long(),
        torch.from_numpy(req["p_len"]), samp,
        noise=torch.from_numpy(_noise(jax.random.PRNGKey(seed), (1, TCFG.semantic_vocab))))


def _ports_equal(a, b):
    assert a.ring_head == b.ring_head
    for name in LEAVES:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        if x.is_floating_point():
            np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5, atol=1e-5,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


def test_windowed_states_equal_full_read(params):
    """Staggered joins, a release and slot reuse, over a ring wrap: the
    windowed machine's state equals the full-read machine's after every
    segment, and its windows move from the ladder to the full read."""
    _, tp = params
    win, full = Machine(tp, True), Machine(tp, False)
    reqs = {0: _request(0, 5, 3), 1: _request(1, 11, 8), 2: _request(4, 9, 6)}
    plan = {0: [(0, 0, 24)], 1: [(2, 1, 16)], 4: [(0, 2, RING)]}  # seg: (slot, req, steps)
    for seg in range(9):
        if seg == 4:
            for m in (win, full):               # slot 0 finished: release it
                assert bool(m.t.done[0])
                m.t = tslots.release_slot(m.t, 0)
                m.book._slots[0] = None
                m.book._merged[0] = 0
        for slot, r, steps in plan.get(seg, []):
            ctx = _t_prefill(tp, reqs[r], 100 + r)
            for m in (win, full):
                m.join(slot, ctx, reqs[r], steps)
        noise = torch.from_numpy(_noise(jax.random.PRNGKey(seg), (W, 4, TCFG.semantic_vocab)))
        tw, tf = win.segment(noise), full.segment(noise)
        np.testing.assert_array_equal(tw, tf)
        _ports_equal(win.t, full.t)
    assert all(w == (None, None) for w in full.windows)
    used = [w for w in win.windows if w != (None, None)]
    assert len(used) >= 4 and (None, None) in win.windows, win.windows
    assert win.t.ring_head == 9 * W % RING


def _jt_segment(pair, ctx_win, ring_win):
    key = jax.random.PRNGKey(pair.step)
    pair.step += 1
    pair.j, jtok = _jseg(pair.jp, pair.j, key, cfg=pair.jcfg, seg_steps=pair.W,
                         **pair.geom, ctx_win=ctx_win, ring_win=ring_win)
    pair.t, ttok = tslots.decode_segment(
        pair.tp, pair.t, pair.tcfg, pair.W, **pair.geom, ctx_win=ctx_win,
        ring_win=ring_win,
        noise=torch.from_numpy(_noise(key, (pair.W, pair.n, pair.tcfg.semantic_vocab))))
    return np.asarray(jtok), ttok.numpy()


@pytest.mark.parametrize("ctx_win,ring_win", [(16, None), (None, RING - W), (8, RING - W)],
                         ids=["ctx", "ring", "both"])
def test_windowed_segments_equal_jax(params, ctx_win, ring_win):
    """A solo 24-step decode (8 context columns) with fixed windows that
    cover it, as tests/test_slots.py::test_slot_windowed_reads_match_full
    runs it: the states equal the JAX windowed machine's after each
    segment, and the tokens those of the port's full read."""
    pair = Pair(params)
    pair.join(1, _request(0, 5, 3), 24, 24, same_ctx=True)
    full = Pair(params)
    full.join(1, _request(0, 5, 3), 24, 24, same_ctx=True)
    for _ in range(RING // W):
        jtok, ttok = _jt_segment(pair, ctx_win, ring_win)
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
        np.testing.assert_array_equal(ttok, full.segment()[1])
    assert int(pair.t.counts[1]) == 24


def test_windowed_ring_wrap_equals_jax(params):
    """A request that fills the whole ring, joined when the head is
    mid-ring, read through growing ring windows (the scheduler's contract:
    window >= merged keys): its reads cross the end of the first ring copy
    into the second. States equal the JAX windowed machine's, tokens the
    full read's."""
    runs = {}
    for name, windowed in (("win", True), ("full", False)):
        pair = Pair(params)
        pair.join(2, _request(3, 6, 4), 8, 8, same_ctx=True)
        _jt_segment(pair, 12 if windowed else None, W if windowed else None)  # head -> 8
        pair.release(2)
        pair.join(0, _request(0, 5, 3), RING, RING, same_ctx=True)
        toks = []
        for seg in range(RING // W):
            rw = min(max(W, (seg + 1) * W), RING) if windowed else None
            jtok, ttok = _jt_segment(pair, 8 if windowed else None, rw)
            np.testing.assert_array_equal(ttok, jtok)
            assert_states_equal(pair.j, pair.t)
            toks.append(ttok[0])
        assert int(pair.t.counts[0]) == RING and pair.t.ring_head == 8
        runs[name] = np.concatenate(toks)
    np.testing.assert_array_equal(runs["win"], runs["full"])


def test_pick_windows_matches_jax():
    rng = np.random.default_rng(0)
    cases = [([None] * 4, [0] * 4), ([8, None, 20, None], [0, 0, 16, 0]),
             ([12, 21, None, 3], [8, 0, 0, 24]), ([20, 20, 20, 20], [24, 24, 24, 25])]
    for _ in range(40):
        ctx = [None if rng.random() < 0.3 else int(rng.integers(1, 26)) for _ in range(4)]
        cases.append((ctx, [int(rng.integers(0, 30)) for _ in range(4)]))
    picked = set()
    for ctx, merged in cases:
        for on in (True, False):
            book = _bookkeeping(ctx, merged)
            book.windowed_kv = on
            got = tsb.SlotBatcher._pick_windows(book)
            assert got == jsb.SlotBatcher._pick_windows(book), (ctx, merged, on)
            picked.add(got)
    assert (None, None) in picked and len(picked) >= 4, picked


@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("geom", [(16, 8, 32), (192, 192, 512), (128, 64, 256)],
                         ids=["tiny", "default", "short_ring"])
def test_seg_window_combos_match_jax(geom, windowed):
    sx, sp, ring = geom
    kw = dict(slot_windowed_kv=windowed)
    want = jsb.seg_window_combos(JRuntimeConfig(**kw), sx, sp, ring)
    assert tsb.seg_window_combos(RuntimeConfig(**kw), sx, sp, ring) == want
    lad = dict(slot_ctx_windows=(8, 24, 256), slot_ring_windows=(16, 24, 300), **kw)
    assert tsb.seg_window_combos(RuntimeConfig(**lad), sx, sp, ring) == \
        jsb.seg_window_combos(JRuntimeConfig(**lad), sx, sp, ring)
    # the int8 kernel route takes no windows
    assert tsb.seg_window_combos(RuntimeConfig(slot_kv_int8=True, **lad), sx, sp,
                                 ring) == [(None, None)]


def test_windowed_kv_env_default(monkeypatch):
    monkeypatch.delenv("GENIE_SLOT_WINDOWED_KV", raising=False)
    cfg = RuntimeConfig()
    assert cfg.slot_windowed_kv and cfg.slot_ctx_windows == (256,) \
        and cfg.slot_ring_windows == (256, 384)
    for off in ("0", "false", "off"):
        monkeypatch.setenv("GENIE_SLOT_WINDOWED_KV", off)
        assert not RuntimeConfig().slot_windowed_kv
        assert not JRuntimeConfig().slot_windowed_kv


def _serve(char, ref, windowed, monkeypatch):
    """Four concurrent greedy requests through a SlotBatcher; returns the
    codes each request vocoded (by its phonemes) and the batcher's stats.
    Context windows (24, 40) cover every request; the last request's 29
    steps outgrow the ring ladder (8, 16, 24), so the full read follows."""
    from test_torch_slot_batcher import BUCKETS, _phones
    from genie_tts_tpu_torch.runtime.engine import TTSEngine

    monkeypatch.setenv("GENIE_SLOT_WINDOWED_KV", "1" if windowed else "0")
    eng = TTSEngine(RuntimeConfig(**BUCKETS, slot_phoneme_bucket=32, slot_prompt_bucket=16,
                                  slot_steps=8, slot_batch=4, slot_ring=32,
                                  slot_ctx_windows=(24, 40), slot_ring_windows=(8, 16, 24)))
    sb = tsb.SlotBatcher(eng, char)
    assert sb.windowed_kv == windowed
    codes = {}
    real = eng.vocode_codes_dispatch

    def record(char_, items, **kw):
        for _, ph, c in items:
            codes[tuple(ph)] = np.asarray(c).copy()
        return real(char_, items, **kw)

    eng.vocode_codes_dispatch = record
    greedy = ts.SamplingConfig(top_k=1)
    outs = {}

    def client(i):
        outs[i] = sb.synthesize(ref, *_phones(3 + 2 * i), timeout=300, min_steps=14 + 5 * i,
                                max_steps=14 + 5 * i, sampling=greedy)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sb.stop()
    assert len(outs) == 4 and all(np.isfinite(a).all() for a in outs.values())
    return codes, dict(sb.stats)


def test_slot_batcher_windowed_codes_identical(monkeypatch):
    from test_torch_slot_batcher import VCFG, _reference
    from genie_tts_tpu_torch.runtime.engine import make_random_character

    char = make_random_character(t2s_cfg=TCFG, sovits_cfg=VCFG, dtype=torch.float32,
                                 device="cpu")
    ref = _reference(char)
    on_codes, on = _serve(char, ref, True, monkeypatch)
    off_codes, off = _serve(char, ref, False, monkeypatch)
    assert on["windowed_segments"] > 0 and off["windowed_segments"] == 0
    assert set(on_codes) == set(off_codes) and len(on_codes) == 4
    for k in on_codes:
        np.testing.assert_array_equal(on_codes[k], off_codes[k])
        assert len(on_codes[k]) == 14 + 5 * ((len(k) - 3) // 2)
