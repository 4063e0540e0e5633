"""The port's int8 slot-cache attention vs the JAX package, on the CPU.

``int8_big_attention_plain`` against the Pallas kernel in interpret mode
and against ``xla_big_attention``, in fp32, for an empty ring, a partial
ring, a wrapped ring (head < keys_written) and a row with nothing visible:
rtol/atol 1e-5 (fp32 sums in other orders). The buffered decode layer's
kernel-partials route against the JAX package's monolithic and kernel
routes (the cases of tests/test_int8_decode.py): 1e-5 on the layer output,
the new K/V columns within 1e-6.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops import int8_decode as jint8
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops import int8_decode as tint8

B, H, Dh = 2, 4, 32
SX, SP, RING = 16, 8, 32
S = SX + SP + RING
GEOM = dict(sx=SX, sp=SP, ring=RING)


def _case(seed, head, kw, empty_row=False):
    rng = np.random.default_rng(seed)
    c = dict(
        q=rng.standard_normal((B, H, Dh)).astype(np.float32),
        kq=rng.integers(-127, 128, (B, H, Dh, S)).astype(np.int8),
        ks=(rng.random((B, H, S)) * 0.02 + 0.001).astype(np.float32),
        vq=rng.integers(-127, 128, (B, H, Dh, S)).astype(np.int8),
        vs=(rng.random((B, H, S)) * 0.02 + 0.001).astype(np.float32),
        x_len=rng.integers(1, SX + 1, (B,)).astype(np.int32),
        p_len=rng.integers(1, SP + 1, (B,)).astype(np.int32),
        keys_written=np.asarray(kw, np.int32))
    if empty_row:                 # row 1 sees nothing: m = -1e30, l = 0, o = 0
        c["x_len"][1] = c["p_len"][1] = c["keys_written"][1] = 0
    return c, head


ORDER = ("q", "kq", "ks", "vq", "vs", "x_len", "p_len", "keys_written")
CASES = {
    "empty_ring": (0, [0, 0], False),
    "partial_ring": (8, [8, 3], False),
    "wrapped_ring": (4, [RING, 20], False),
    "empty_row": (8, [8, 5], True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret_and_xla(name):
    head, kw, empty = CASES[name]
    c, head = _case(0, head, kw, empty)
    jargs = [jnp.asarray(c[k]) for k in ORDER] + [jnp.int32(head)]
    o, m, l = tint8.int8_big_attention_plain(
        *[torch.from_numpy(c[k]) for k in ORDER], head, **GEOM)
    refs = (jint8.int8_big_attention(*jargs, **GEOM, interpret=True),
            jint8.xla_big_attention(*jargs, **GEOM))
    for ref in refs:
        for got, want in zip((o, m, l), ref):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    if empty:
        assert bool((m[1] == torch.tensor(-1e30)).all()) and float(l[1].abs().max()) == 0.0
        assert float(o[1].abs().max()) == 0.0 and torch.isfinite(o).all()
    else:
        assert (l > 0).all()


def test_wrapped_ring_needs_floor_modulo():
    """Columns after the head are visible only through floor modulo
    (C's truncating % would hide them): the wrapped case sees them."""
    c, head = _case(0, 4, [RING, 20])
    vis = tint8.visibility(S, torch.from_numpy(c["x_len"]), torch.from_numpy(c["p_len"]),
                           torch.from_numpy(c["keys_written"]), head, **GEOM)
    assert bool(vis[0, SX + SP + head:].all())            # a full ring: all visible
    ring_vis = vis[1, SX + SP:]
    assert int(ring_vis.sum()) == 20 and bool(ring_vis[head:].any())


@pytest.mark.parametrize("ctx_kind", ["zero", "inside", "compacted", "into_ring", "past_S"])
@pytest.mark.parametrize("ring", range(1, 18))
def test_visible_intervals_and_chunk_shares_match_visibility(ring, ctx_kind):
    """The kernel's interval arithmetic (its CPU twin) against the mask,
    column for column, for every head in [-ring, 2 ring) and keys_written
    in [-1, ring + 2]; and the cluster's chunk shares: every visible column
    in exactly one rank's chunks, shares within one chunk of each other and
    within the kernel's buffer of a quarter of S's chunks."""
    sx, sp = 13, 6                      # the ring starts mid-chunk
    S = sx + sp + ring
    ctx = {"zero": 0, "inside": sx + sp - 4, "compacted": sx + sp,
           "into_ring": sx + sp + ring // 2 + 1, "past_S": S + 3}[ctx_kind]
    kws = list(range(-1, ring + 3))
    cap = ((S + 15) // 16 + 3) // 4     # chunks a block's buffers hold
    for head in range(-ring, 2 * ring):
        vis = tint8.visibility(S, torch.full((len(kws),), ctx), torch.zeros(len(kws)),
                               torch.tensor(kws), head, sx=sx, sp=sp, ring=ring)
        for kw, want in zip(kws, vis.tolist()):
            iv = tint8.visible_intervals(S, ctx, kw, head, sx=sx, sp=sp, ring=ring)
            assert len(iv) <= 3 and all(a < e <= a2 for (a, e), (a2, _) in zip(iv, iv[1:]))
            got = [any(a <= s < e for a, e in iv) for s in range(S)]
            assert got == want, (head, kw, iv)
            owner = [0] * S
            counts = []
            for rank in range(4):
                runs = tint8.chunk_share(iv, rank)
                assert len(runs) <= 3
                counts.append(sum(n for _, n in runs))
                for first, n in runs:
                    for s in range(16 * first, min(16 * (first + n), S)):
                        owner[s] += got[s]
            assert owner == [int(v) for v in got], (head, kw, iv)
            assert max(counts) - min(counts) <= 1 and max(counts) <= cap


def _layer_params(rng, D):
    def dense(i, o):
        return {"w": rng.standard_normal((i, o)).astype(np.float32) * 0.05,
                "b": rng.standard_normal(o).astype(np.float32) * 0.1}

    def norm():
        return {"scale": 1 + rng.standard_normal(D).astype(np.float32) * 0.1,
                "bias": rng.standard_normal(D).astype(np.float32) * 0.1}

    return {"qkv": dense(D, 3 * D), "out": dense(D, D), "ffn1": dense(D, 2 * D),
            "ffn2": dense(2 * D, D), "norm1": norm(), "norm2": norm()}


def _tree(tree, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_layer_merge_matches_both_jax_routes(monkeypatch):
    """The kernel-partials route (plain version on the CPU) == the JAX
    package's monolithic int8 route and its kernel route."""
    monkeypatch.setattr(jint8, "int8_big_attention",
                        functools.partial(jint8.int8_big_attention, interpret=True))
    rng = np.random.default_rng(1)
    D, Wb = H * Dh, 8
    lp = _layer_params(rng, D)
    c, head = _case(2, 8, [8, 5])
    h = (rng.standard_normal((B, 1, D)) * 0.3).astype(np.float32)
    k_buf = (rng.standard_normal((B, H, Dh, Wb)) * 0.2).astype(np.float32)
    v_buf = (rng.standard_normal((B, H, Dh, Wb)) * 0.2).astype(np.float32)
    buf_mask = np.arange(Wb) < 5
    kv_mask = tint8.visibility(S, *(torch.from_numpy(c[k]) for k in
                                    ("x_len", "p_len", "keys_written")), head, **GEOM)
    j = {k: jnp.asarray(v) for k, v in c.items()}
    jlp = _tree(lp, jnp.asarray)
    jin = (jlp, jnp.asarray(h), j["kq"], j["vq"], jnp.asarray(k_buf), jnp.asarray(v_buf),
           jnp.asarray(buf_mask), jnp.asarray(kv_mask.numpy()), H)
    ctx = (j["x_len"], j["p_len"], j["keys_written"], jnp.int32(head), SX, SP, RING)
    mono = jt2s._layer_decode_buffered(*jin, k_scale=j["ks"], v_scale=j["vs"])
    kern = jt2s._layer_decode_buffered(*jin, k_scale=j["ks"], v_scale=j["vs"],
                                       kv_kernel_ctx=ctx)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    tin = (_tree(lp, torch.from_numpy), torch.from_numpy(h), t["kq"], t["vq"],
           torch.from_numpy(k_buf), torch.from_numpy(v_buf), torch.from_numpy(buf_mask),
           kv_mask, H)
    ported = tt2s._layer_decode_buffered(
        *tin, k_scale=t["ks"], v_scale=t["vs"],
        kv_kernel_ctx=(t["x_len"], t["p_len"], t["keys_written"], head, SX, SP, RING))
    ported_mono = tt2s._layer_decode_buffered(*tin, k_scale=t["ks"], v_scale=t["vs"])
    for ref in (mono, kern):
        for got in (ported, ported_mono):
            np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                       rtol=1e-5, atol=1e-5)
            for i in (1, 2):
                np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                           rtol=1e-6, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    c, head = _case(3, 8, [8, 3])
    args = [torch.from_numpy(c[k]) for k in ORDER]
    before = tint8.int8_big_attention.launches
    got = tint8.int8_big_attention(*args, head, **GEOM)
    want = tint8.int8_big_attention_plain(*args, head, **GEOM)
    assert tint8.int8_big_attention.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_takes_the_ring_head_in_device_memory(name):
    """The slot state keeps its ring head as a 0-d int32 tensor, which the
    kernel reads from device memory: the plain version (and the
    visibility it computes) gives, bit for bit, what it gives with the
    head as an int."""
    head, kw, empty = CASES[name]
    c, head = _case(0, head, kw, empty)
    args = [torch.from_numpy(c[k]) for k in ORDER]
    want = tint8.int8_big_attention_plain(*args, head, **GEOM)
    for h in (torch.tensor(head, dtype=torch.int32), torch.tensor([head], dtype=torch.int32)):
        got = tint8.int8_big_attention(*args, h, **GEOM)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert torch.equal(tint8.visibility(S, *args[5:], h, **GEOM),
                           tint8.visibility(S, *args[5:], head, **GEOM))
