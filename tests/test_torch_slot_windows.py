"""The JAX package's windowed KV reads against the port's in-place read.

The JAX package's slot machine reads only the first ``ctx_win`` context
columns and the last ``ring_win`` ring writes on its exact-KV route, with
windows its scheduler picks from host bookkeeping. The port has no read
windows: it reads its exact caches in place over the first ring copy,
visibility recomputed from the segment-frozen lengths
(``ops/slot_attention.py``, whose plain version runs on the CPU). Here,
on the tiny amplified T2S of tests/test_torch_slots.py (fp32), the port's
segments equal the JAX package's windowed ``decode_segment`` leaf for
leaf (integers and tokens exactly, floats within 1e-5: fp32 sums over
other columns in other orders):

* with the windows the JAX scheduler's own ``_pick_windows`` picks, over
  staggered joins, a release and slot reuse, across a ring wrap;
* with fixed windows that cover a solo decode (tests/test_slots.py:194-265);
* with growing ring windows whose reads cross the end of the first ring
  copy into the second, from a head mid-ring.
"""
import types

import jax
import numpy as np
import pytest
import torch

from genie_tts_tpu.runtime import slot_batcher as jsb
from genie_tts_tpu_torch.models import slots as tslots
from test_torch_slots import (RING, W, Pair, _jseg, _noise, _request,  # noqa: F401
                              assert_states_equal, params)

LADDERS = dict(slot_ctx_windows=(12, 20), slot_ring_windows=(8, 16, 24))


def _jt_segment(pair, ctx_win, ring_win):
    """One segment in both packages: the JAX machine reads the windows,
    the port its caches in place."""
    key = jax.random.PRNGKey(pair.step)
    pair.step += 1
    pair.j, jtok = _jseg(pair.jp, pair.j, key, cfg=pair.jcfg, seg_steps=pair.W,
                         **pair.geom, ctx_win=ctx_win, ring_win=ring_win)
    pair.t, ttok = tslots.decode_segment(
        pair.tp, pair.t, pair.tcfg, pair.W, **pair.geom,
        noise=torch.from_numpy(_noise(key, (pair.W, pair.n, pair.tcfg.semantic_vocab))))
    return np.asarray(jtok), ttok.numpy()


def test_windowed_states_equal_full_read(params):
    """Staggered joins, a release and slot reuse, over a ring wrap: the
    JAX machine reads the windows that its scheduler's ``_pick_windows``
    picks from the bookkeeping (each row's context columns, the ring keys
    merged into each slot, bumped at dispatch), the port reads in place.
    After every segment the states are equal and the tokens identical,
    and the windows moved from the ladder to the full read."""
    pair = Pair(params)
    book = types.SimpleNamespace(windowed_kv=True, _slots=[None] * 4, _merged=[0] * 4,
                                 _ctx_ladder=LADDERS["slot_ctx_windows"],
                                 _ring_ladder=LADDERS["slot_ring_windows"])
    max_steps = [0] * 4
    reqs = {0: _request(0, 5, 3), 1: _request(1, 11, 8), 2: _request(4, 9, 6)}
    plan = {0: [(0, 0, 24)], 1: [(2, 1, 16)], 4: [(0, 2, RING)]}  # seg: (slot, req, steps)
    windows = []
    for seg in range(9):
        if seg == 4:                            # slot 0 finished: release it
            assert bool(pair.t.done[0])
            pair.release(0)
            book._slots[0] = None
            book._merged[0] = 0
        for slot, r, steps in plan.get(seg, []):
            pair.join(slot, reqs[r], steps, steps, same_ctx=True)
            ctx_cols = int(reqs[r]["x_len"][0] + reqs[r]["p_len"][0])
            book._slots[slot] = types.SimpleNamespace(ctx_cols=ctx_cols)
            book._merged[slot] = 0
            max_steps[slot] = steps
        windows.append(jsb.SlotBatcher._pick_windows(book))
        jtok, ttok = _jt_segment(pair, *windows[-1])
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
        for b, r in enumerate(book._slots):
            if r is not None:
                book._merged[b] = min(book._merged[b] + W, max_steps[b])
    used = [w for w in windows if w != (None, None)]
    assert len(used) >= 4 and (None, None) in windows, windows
    assert int(pair.t.ring_head) == 9 * W % RING


@pytest.mark.parametrize("ctx_win,ring_win", [(16, None), (None, RING - W), (8, RING - W)],
                         ids=["ctx", "ring", "both"])
def test_windowed_segments_equal_jax(params, ctx_win, ring_win):
    """A solo 24-step decode (8 context columns) with fixed windows that
    cover it, as tests/test_slots.py::test_slot_windowed_reads_match_full
    runs it: the states equal the JAX windowed machine's after each
    segment."""
    pair = Pair(params)
    pair.join(1, _request(0, 5, 3), 24, 24, same_ctx=True)
    for _ in range(RING // W):
        jtok, ttok = _jt_segment(pair, ctx_win, ring_win)
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
    assert int(pair.t.counts[1]) == 24


def test_windowed_ring_wrap_equals_jax(params):
    """A request that fills the whole ring, joined when the head is
    mid-ring, read through growing ring windows (the scheduler's contract:
    window >= merged keys): the JAX machine's reads cross the end of the
    first ring copy into the second, the port's wrap inside the first.
    States equal the JAX windowed and full-read machines', and the tokens
    of both runs are the same. The released slot 2 keeps its 10 context
    columns, past the JAX machine's context window of 8, which covers the
    occupied rows only: its masked garbage differs there, so the windowed
    run compares the caches of the occupied row."""
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
            assert_states_equal(pair.j, pair.t, cache_rows=[0] if windowed else None)
            toks.append(ttok[0])
        assert int(pair.t.counts[0]) == RING and pair.t.ring_head == 8
        runs[name] = np.concatenate(toks)
    np.testing.assert_array_equal(runs["win"], runs["full"])
