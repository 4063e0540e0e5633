"""The exact-cache slot attention (``ops/slot_attention.py``) on the CPU.

The kernel's plain version reads the whole first ring copy of the slot
cache with visibility recomputed from four segment-frozen scalars. Over
rows of different lengths and ring counts, a ring wrapped and not, a row
that sees nothing of the big cache, buffer columns 0 and W-1, 16 heads
and a tp shard's 8, at fp32:

* the port's buffered decode layer through it equals the JAX package's
  ``_layer_decode_buffered`` on its windowed route (the context and ring
  windows gathered as the JAX ``slots.decode_segment`` gathers them, with
  masks; the whole context and ring where a case names no window), and
  writes the step's own column into the buffer;
* it equals ``t2s.buffered_attention``'s masked read (the int8 masked
  route's code) over the same columns under ``int8_decode.visibility``;
* the kernel's share of a row (the CPU twins of its interval and chunk
  arithmetic, ``int8_decode.visible_intervals`` and ``chunk_share``)
  covers exactly the columns ``int8_decode.visibility`` marks, each once;
* greedy slot segments through it (``decode_segment`` on exact caches,
  rows joining in turn) equal the JAX package's windowed and full-read
  ``decode_segment`` leaf for leaf and token for token (the harness of
  tests/test_torch_slots.py).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops import int8_decode as i8
from genie_tts_tpu_torch.ops.slot_attention import slot_attention, slot_attention_plain
from test_torch_int8_decode import _layer_params, _tree
from test_torch_slot_windows import _jt_segment
from test_torch_slots import RING, Pair, _request, assert_states_equal, params  # noqa: F401

# B, H, sx, sp, ring, W, x_len, p_len, keys_written, head, col, (ctx_win, ring_win)
CASES = {
    "partial_ring": (4, 16, 24, 16, 32, 8, [24, 3, 10, 17], [16, 9, 1, 4], [5, 12, 8, 1],
                     20, 3, (None, None)),
    "wrapped_ring": (4, 16, 24, 16, 32, 8, [7, 24, 12, 1], [2, 16, 5, 13], [30, 9, 17, 32],
                     6, 7, (None, None)),
    "empty_row": (3, 16, 24, 16, 32, 8, [11, 0, 20], [6, 0, 3], [4, 0, 20], 11, 5,
                  (None, None)),
    "empty_row_col0": (3, 16, 24, 16, 32, 8, [11, 0, 20], [6, 0, 3], [4, 0, 20], 11, 0,
                       (None, None)),
    "buffer_last_col": (2, 16, 24, 16, 32, 8, [9, 21], [12, 4], [16, 24], 24, 7,
                        (None, None)),
    "windows": (4, 16, 24, 16, 32, 8, [10, 3, 12, 5], [8, 9, 4, 12], [5, 12, 8, 16], 28, 4,
                (24, 16)),
    "windows_wrapped": (3, 16, 24, 16, 32, 8, [2, 11, 6], [9, 1, 14], [20, 13, 24], 9, 6,
                        (24, 24)),
    "tp_shard_heads": (4, 8, 24, 16, 32, 8, [7, 24, 12, 1], [2, 16, 5, 13], [30, 9, 17, 32],
                       6, 2, (None, None)),
    "one_row": (1, 16, 24, 16, 32, 8, [13], [7], [19], 13, 1, (None, None)),
}


def _case(name, dtype=torch.float32):
    B, H, sx, sp, ring, W, x_len, p_len, kw, head, col, win = CASES[name]
    Dh = 32
    g = torch.Generator().manual_seed(0)
    S = sx + sp + ring

    def rand(*shape):
        return torch.randn(shape, generator=g).to(dtype)

    # the doubled ring as the slot state keeps it: the second copy repeats
    # the first, so the ring window ending at head + ring reads the last
    # writes in order
    k_big, v_big = (torch.cat([t, t[..., sx + sp:]], dim=-1) for t in
                    (rand(B, H, Dh, S), rand(B, H, Dh, S)))
    qkv = rand(B, 1, 3 * H * Dh)
    q, k_new, v_new = (t2s._split_heads(t, H) for t in qkv.chunk(3, dim=-1))
    return dict(
        q=q, k_new=k_new[:, :, 0], v_new=v_new[:, :, 0], k_big=k_big, v_big=v_big,
        k_buf=rand(B, H, Dh, W), v_buf=rand(B, H, Dh, W), col=col,
        x_len=torch.tensor(x_len, dtype=torch.int32),
        p_len=torch.tensor(p_len, dtype=torch.int32),
        keys_written=torch.tensor(kw, dtype=torch.int32),
        ring_head=torch.tensor(head, dtype=torch.int32), geom=dict(sx=sx, sp=sp, ring=ring),
        win=win)


def _windows(c):
    """The big-cache regions and masks of the JAX package's windowed read
    (``slots.decode_segment``): the first ``ctx_win`` context columns and
    the ``ring_win`` ring columns that end at the head in the doubled ring."""
    sx, sp, ring = c["geom"]["sx"], c["geom"]["sp"], c["geom"]["ring"]
    ctx_win = c["win"][0] or sx + sp
    ring_win = c["win"][1] or ring
    ring_cols = sx + sp + ring + int(c["ring_head"]) - ring_win + torch.arange(ring_win)
    ctx_len = c["x_len"] + c["p_len"]
    win_age = ring_win - 1 - torch.arange(ring_win)[None, :]
    kv_mask = (torch.arange(ctx_win)[None, :] < ctx_len[:, None],
               win_age < c["keys_written"][:, None])
    return ((c["k_big"][..., :ctx_win], c["k_big"][..., ring_cols]),
            (c["v_big"][..., :ctx_win], c["v_big"][..., ring_cols]), kv_mask)


def _plain(c, route=slot_attention_plain):
    S = sum(c["geom"].values())
    return route(c["q"][:, :, 0], c["k_new"], c["v_new"], c["k_big"][..., :S],
                 c["v_big"][..., :S], c["k_buf"], c["v_buf"], c["col"], c["x_len"],
                 c["p_len"], c["keys_written"], c["ring_head"], **c["geom"])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_the_windowed_route(name):
    """One buffered decode layer (random weights, fp32): the port's,
    through the plain version over the first ring copy, against the JAX
    package's over its windows; the output and the new K/V columns, and
    the port's buffer gains the step's column and keeps every other."""
    c = _case(name)
    B, H, Dh, W = c["k_buf"].shape
    D = H * Dh
    rng = np.random.default_rng(7)
    lp = _layer_params(rng, D)
    h = (rng.standard_normal((B, 1, D)) * 0.3).astype(np.float32)
    buf_mask = torch.arange(W) < c["col"]
    k_reg, v_reg, kv_mask = _windows(c)
    j = lambda t: jnp.asarray(t.numpy())                     # noqa: E731
    want = jt2s._layer_decode_buffered(
        _tree(lp, jnp.asarray), jnp.asarray(h), tuple(map(j, k_reg)), tuple(map(j, v_reg)),
        j(c["k_buf"]), j(c["v_buf"]), j(buf_mask), tuple(map(j, kv_mask)), H)
    k_buf0, v_buf0 = c["k_buf"].clone(), c["v_buf"].clone()
    S = sum(c["geom"].values())
    g = c["geom"]
    got = t2s._layer_decode_buffered(
        _tree(lp, torch.from_numpy), torch.from_numpy(h), c["k_big"][..., :S],
        c["v_big"][..., :S], c["k_buf"], c["v_buf"], buf_mask, None, H,
        kv_kernel_ctx=(c["x_len"], c["p_len"], c["keys_written"], c["ring_head"], g["sx"],
                       g["sp"], g["ring"]), col=c["col"])
    assert got[0].shape == (B, 1, D) and got[0].dtype == torch.float32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-6, atol=1e-6)
    col = c["col"]
    assert torch.equal(c["k_buf"][..., col], got[1])
    assert torch.equal(c["v_buf"][..., col], got[2])
    others = [i for i in range(W) if i != col]
    assert torch.equal(c["k_buf"][..., others], k_buf0[..., others])
    assert torch.equal(c["v_buf"][..., others], v_buf0[..., others])


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_equals_the_masked_read(name):
    """The attention alone against ``buffered_attention``'s one softmax
    over the first ring copy masked by ``int8_decode.visibility``."""
    c = _case(name)
    g = c["geom"]
    S = sum(g.values())
    W = c["k_buf"].shape[-1]
    mask = i8.visibility(S, c["x_len"], c["p_len"], c["keys_written"], c["ring_head"], **g)
    want = t2s.buffered_attention(c["q"], c["k_new"], c["v_new"], c["k_big"][..., :S],
                                  c["v_big"][..., :S], c["k_buf"], c["v_buf"],
                                  torch.arange(W) < c["col"], mask)      # [B,H,1,Dh]
    got = _plain(c)                                                     # [B,1,H*Dh]
    torch.testing.assert_close(got, t2s._merge_heads(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["empty_row", "empty_row_col0"])
def test_a_row_that_sees_nothing_of_the_cache(name):
    """Row 1 sees no cache column: the buffer before ``col`` and itself;
    at column 0 only itself, so its output is its own V."""
    c = _case(name)
    row = slice(1, 2)
    sub = {k: (v[row] if isinstance(v, torch.Tensor) and v.dim() else v)
           for k, v in c.items()}
    out = _plain(sub)[0, 0]
    if c["col"] == 0:
        torch.testing.assert_close(out, c["v_new"][1].reshape(-1))
    else:
        qf, col = c["q"][1, :, 0], c["col"]
        s = torch.cat([torch.einsum("hd,hdw->hw", qf, c["k_buf"][1, ..., :col]),
                       (qf * c["k_new"][1]).sum(-1, keepdim=True)], -1) / math.sqrt(32)
        p = torch.softmax(s, -1)
        want = (torch.einsum("hw,hdw->hd", p[:, :col], c["v_buf"][1, ..., :col])
                + p[:, col:] * c["v_new"][1])
        torch.testing.assert_close(out, want.reshape(-1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_runs_the_plain_version_on_the_cpu(dtype):
    c = _case("wrapped_ring", dtype)
    before = slot_attention.launches
    a = _plain(dict(c, k_buf=c["k_buf"].clone(), v_buf=c["v_buf"].clone()))
    b = _plain(c, route=slot_attention)
    assert slot_attention.launches == before and b.dtype == dtype
    assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_the_kernels_share_covers_the_visible_columns(name):
    """Every column ``int8_decode.visibility`` marks lies in exactly one
    rank's chunks of the cluster of 4, and no other column is visible."""
    c = _case(name)
    sx, sp, ring = c["geom"]["sx"], c["geom"]["sp"], c["geom"]["ring"]
    S = sx + sp + ring
    mask = i8.visibility(S, c["x_len"], c["p_len"], c["keys_written"], c["ring_head"],
                         sx=sx, sp=sp, ring=ring)
    for b in range(mask.shape[0]):
        iv = i8.visible_intervals(S, int(c["x_len"][b] + c["p_len"][b]),
                                  int(c["keys_written"][b]), int(c["ring_head"]), sx=sx,
                                  sp=sp, ring=ring)
        seen = torch.zeros(S, dtype=torch.int64)
        for rank in range(4):
            for first, n in i8.chunk_share(iv, rank):
                for s in range(16 * first, min(16 * (first + n), S)):
                    seen[s] += any(a <= s < e for a, e in iv)
        assert torch.equal(seen, mask[b].long()), b


# ---------------------------------------------------------------------------
# the route through a slot segment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reference", ["full_read", "windows"])
def test_segments_through_the_route_equal_the_windowed_route(params, reference):
    """Three greedy rows join in turn, one a segment, and decode across
    six segments: the port's segments (exact caches, read in place) equal
    the JAX package's, which reads the whole cache or, for the first two
    segments, windows (20, 16) that cover every occupied row."""
    pair = Pair(params)
    for seg in range(6):
        if seg < 3:
            pair.join(seg, _request(10 + seg, 4 + 3 * seg, 2 + 2 * seg), RING, RING,
                      same_ctx=True)
        win = (20, 16) if reference == "windows" and seg < 2 else (None, None)
        jtok, ttok = _jt_segment(pair, *win)
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
    assert pair.t.counts[:3].tolist() == [RING] * 3
