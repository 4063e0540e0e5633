"""The slot machine's join programs over static buffers vs the JAX package.

On the card a request joins the slot machine (and the segmented stream)
through CUDA graphs: the prefill program (``slots.prefill_join``), the
insert and release programs on the machine's state (``insert_slot`` /
``release_slot``, the slot index in device memory) and the speculative
codes of a streaming row's first piece (``slot_batcher.spec_codes``),
the JAX package's ``_prefill_jit``, ``_insert_jit``, ``_release_jit`` and
``_spec_codes_jit``. Here the same programs run eagerly on the same
static buffers, under the same cache keys. The tiny fp32 T2S of
tests/test_torch_slots.py, inputs from numpy seeds, Gumbel noise drawn
by JAX:

* the join through the graph route against ``_prefill_jit``, with and
  without BERT features and top-p, at a slot geometry and a stream
  geometry: tok0 and the histogram identical, the compacted context
  columns within 1e-5;
* the insert graph against ``_insert_jit`` into slots 2 and 1, in bf16
  and int8 KV modes, on a persistent state (resident in the graph's
  buffers) and on one copied in and back: every leaf (integers, bf16 and int8 values
  exactly; fp32 scales within 1e-5, as tests/test_torch_slots.py holds
  the JAX package's compiled quantizer);
* ``release_slot`` and ``spec_codes`` against ``_release_jit`` and
  ``_spec_codes_jit``;
* each program reads nothing back to the host;
* a staggered slot run joined through the graphs gives the tokens and
  state of the same run joined eagerly (the cache set ``eager``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import slots as jslots
from genie_tts_tpu.ops import sampling as js
from genie_tts_tpu.runtime import slot_batcher as jsb
from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.ops import sampling as ts
from genie_tts_tpu_torch.runtime import graphs
from genie_tts_tpu_torch.runtime import slot_batcher as tsb
from test_torch_graphs import _NoHostReads
from test_torch_slots import (JCFG, KW, LEAVES, RING, SP, SX, TCFG, W, _noise,  # noqa: F401
                              _request, params)

V = KW["semantic_vocab"]
GEOMETRIES = {"slot": (SX, SP), "stream": (24, 16)}


def _bert(seed, sx):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((1, sx, KW["bert_dim"])) * 0.5).astype(np.float32)


def _join_both(params, req, bert, top_p, key, sx, sp):
    """The JAX ``_prefill_jit`` and the port's graph route on one input."""
    jp, tp = params
    scfg = dict(top_p=top_p)
    jout = jsb._prefill_jit(
        jp, cfg=JCFG, key=key, phones=jnp.asarray(req["phones"]),
        bert=None if bert is None else jnp.asarray(bert), x_len=jnp.asarray(req["x_len"]),
        prompts=jnp.asarray(req["prompts"]), p_len=jnp.asarray(req["p_len"]),
        samp=js.rows_from_config(js.SamplingConfig(**scfg), 1))
    tout = tslots.prefill_join(
        tp, TCFG, torch.from_numpy(req["phones"]).long(),
        None if bert is None else torch.from_numpy(bert), torch.from_numpy(req["x_len"]),
        torch.from_numpy(req["prompts"]).long(), torch.from_numpy(req["p_len"]),
        ts.rows_from_config(ts.SamplingConfig(**scfg), 1),
        noise=torch.from_numpy(_noise(key, (1, V))))
    return jout, tout


@pytest.mark.parametrize("top_p", [1.0, 0.8], ids=["top_k", "top_p"])
@pytest.mark.parametrize("with_bert", [False, True], ids=["no_bert", "bert"])
@pytest.mark.parametrize("geometry", list(GEOMETRIES))
def test_join_matches_jax(params, geometry, with_bert, top_p):
    sx, sp = GEOMETRIES[geometry]
    _, tp = params
    for seed, (n_ids, n_prm) in enumerate([(5, 3), (sx - 2, sp)]):
        req = _request(seed, n_ids, n_prm, sx=sx, sp=sp)
        bert = _bert(seed, sx) if with_bert else None
        (jk, jv, jtok0, jhist), (tk, tv, ttok0, thist) = _join_both(
            params, req, bert, top_p, jax.random.PRNGKey(50 + seed), sx, sp)
        assert tk.shape == (KW["num_layers"], 1, KW["num_heads"], 8, sx + sp)
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        assert ttok0.dtype == torch.int32 and ttok0.tolist() == np.asarray(jtok0).tolist()
        np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    variant = (with_bert, top_p < 1.0)
    assert (("join", sx, sp, torch.float32), variant) in graphs.cache_for(tp).programs()


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def assert_leaves_equal(j, t):
    """Every leaf: integers, bool, int8 and bf16 values exactly; fp32
    within 1e-5."""
    for name in LEAVES:
        jl, tl = getattr(j, name), getattr(t, name)
        if jl is None:
            assert tl is None, name
            continue
        exact = tl.dtype != torch.float32
        jl, tl = _as_np(jl), _as_np(tl)
        assert jl.shape == tl.shape, name
        if exact:
            np.testing.assert_array_equal(tl, jl, err_msg=name)
        else:
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5, err_msg=name)


def _insert_both(params, j, t, slot, seed, mn, mx):
    jp, tp = params
    req = _request(seed, 4 + seed, 3 + seed)
    key = jax.random.PRNGKey(seed)
    (jk, jv, jtok0, jhist), _ = _join_both(params, req, None, 0.8, key, SX, SP)
    samp = js.rows_from_config(js.SamplingConfig(top_p=0.8, temperature=0.7), 1)
    x_len, p_len = int(req["x_len"][0]), int(req["p_len"][0])
    kc, vc, ks, vs, small = jsb._insert_jit(
        j.k_cache, j.v_cache, j.k_scale, j.v_scale, jsb._strip_big(j), jnp.int32(slot),
        jk, jv, jtok0, jhist, jnp.int32(x_len), jnp.int32(p_len), jnp.int32(mn),
        jnp.int32(mx), js.SamplingRows(*(a[0] for a in samp)), ring=RING)
    j = small._replace(k_cache=kc, v_cache=vc, k_scale=ks, v_scale=vs)
    tsamp = ts.rows_from_config(ts.SamplingConfig(top_p=0.8, temperature=0.7), 1)
    t = tslots.insert_slot(t, slot, torch.from_numpy(np.array(jk)),
                           torch.from_numpy(np.array(jv)), torch.from_numpy(np.array(jtok0)),
                           torch.from_numpy(np.array(jhist)), x_len, p_len, mn, mx,
                           ts.SamplingRows(*(a[0] for a in tsamp)), params=tp)
    assert t.top_p_host[slot] == np.float32(0.8)
    return j, t


def _states(kv_int8, dtype, binding):
    j = jslots.init_slots(JCFG, 4, SX, SP, RING, dtype=jnp.bfloat16
                          if dtype == torch.bfloat16 else jnp.float32, kv_int8=kv_int8)
    t = tslots.init_slots(TCFG, 4, SX, SP, RING, dtype=dtype, kv_int8=kv_int8)
    if binding == "persistent":
        t = dataclasses.replace(t, persistent=True)
    return j, t


@pytest.mark.parametrize("binding", ["persistent", "copied"])
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_insert_matches_jax(params, mode, binding):
    _, tp = params
    j, t = _states(mode == "int8", torch.bfloat16, binding)
    j, t = _insert_both(params, j, t, 2, 0, 12, 20)
    assert_leaves_equal(j, t)
    j, t = _insert_both(params, j, t, 1, 1, 4, 24)
    assert_leaves_equal(j, t)
    keys = [k for k in graphs.cache_for(tp).keys() if k[0] == "insert"]
    assert any(k[-2] == (mode == "int8") for k in keys)


@pytest.mark.parametrize("binding", ["persistent", "copied"])
def test_release_matches_jax(params, binding):
    _, tp = params
    j, t = _states(False, torch.float32, binding)
    j, t = _insert_both(params, j, t, 2, 0, 12, 20)
    j, t = _insert_both(params, j, t, 3, 1, 12, 20)
    j = jsb._release_jit(j, jnp.int32(2))
    t = tslots.release_slot(t, 2, params=tp)
    assert t.active.tolist() == [False, False, False, True]
    assert_leaves_equal(j, t)
    assert ("release",) + tslots._geometry_key(t) in graphs.cache_for(tp).keys()


@pytest.mark.parametrize("rows", [1, 3])
def test_spec_codes_match_jax(params, rows):
    _, tp = params
    rng = np.random.default_rng(rows)
    seg = rng.integers(0, V + 3, (4, W)).astype(np.int32)       # past the codebook too
    tok0s = rng.integers(0, V, rows).astype(np.int32)
    slot_rows = rng.integers(0, 4, rows).astype(np.int64)
    fb, count, vq = 16, 6, 30
    want = np.asarray(jsb._spec_codes_jit(
        tuple(jnp.asarray(tok0s[r:r + 1]) for r in range(rows)), jnp.asarray(seg),
        jnp.asarray(slot_rows), fb=fb, count=count, vq_codes=vq))
    got = tsb.spec_codes([torch.from_numpy(tok0s[r:r + 1]) for r in range(rows)],
                         torch.from_numpy(seg), torch.from_numpy(slot_rows), fb=fb,
                         count=count, vq_codes=vq, params=tp)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ("spec_codes", rows, 4, W, fb, count, vq) in graphs.cache_for(tp).keys()


@pytest.mark.parametrize("program", ["join", "insert", "release", "spec_codes"])
def test_join_programs_read_nothing_back(params, program):
    _, tp = params
    req = _request(0, 5, 3)
    if program == "join":
        g, progs = tslots.join_graph(tp, TCFG, SX, SP)
        with g.lock:
            b = g.static
            for buf, a in ((b.phones, req["phones"]), (b.x_len, req["x_len"]),
                           (b.prompts, req["prompts"]), (b.p_len, req["p_len"])):
                buf.copy_(torch.from_numpy(a))
            with _NoHostReads():
                progs[(True, True)](b)
            assert int(b.hist.sum()) == 3 + 1          # the prompts and tok0
        return
    state = dataclasses.replace(tslots.init_slots(TCFG, 4, SX, SP, RING, torch.float32,
                                                  kv_int8=True), persistent=True)
    if program == "insert":
        ctx = torch.randn((KW["num_layers"], 1, KW["num_heads"], 8, SX + SP))
        with tslots.holding(tp, state):         # its leaves: the graph's buffers
            g = tslots.insert_graph(tp, state, (ctx,), (ctx,))
            assert g.static.state.active is state.active
            with g.lock:
                tslots._fill_row(g.static.row, (2, 5, 3, 0, 9, 15, 7), (0.8, 1.0, 1.35))
                with _NoHostReads():
                    tslots._insert(g.static)
        assert state.active.tolist() == [False, False, True, False]
        assert state.max_steps[2] == 9 and state.cur_tok[2] == 7
    elif program == "release":
        state.active.fill_(True)
        bufs = tslots.ReleaseBuffers(state.active, state.done, torch.tensor([1]))
        with _NoHostReads():
            tslots._release(bufs)
        assert state.active.tolist() == [True, False, True, True]
    else:
        g, prog = tsb.spec_codes_graph(tp, 2, 4, W, 16, 6, 30)
        with _NoHostReads():
            prog(g.static)


@pytest.mark.parametrize("binding", ["persistent", "copied"])
def test_graph_join_equals_eager_through_staggered_run(params, binding):
    """Request A joins slot 0 before segment 0, B slot 2 before segment 1,
    then A is released and C joins slot 0 (default sampling, top-p for
    B): the same noise gives the same tokens and state through the join
    graphs as through the eager join."""
    _, tp = params
    cache = graphs.cache_for(tp)
    plan = {0: [(0, 0, 24)], 1: [(2, 1, 16)], 3: [(0, 4, 8)]}
    runs = {}
    for eager in (False, True):
        cache.eager = eager
        try:
            t = tslots.init_slots(TCFG, 4, SX, SP, RING, torch.float32, kv_int8=True)
            if binding == "persistent":
                t = dataclasses.replace(t, persistent=True)
            toks = []
            for seg in range(RING // W):
                if seg == 3:
                    tslots.release_slot(t, 0, params=tp)
                for slot, seed, steps in plan.get(seg, []):
                    req = _request(seed, 5 + seed, 3 + seed)
                    top_p = 0.8 if seed == 1 else 1.0
                    samp = ts.rows_from_config(ts.SamplingConfig(top_p=top_p), 1)
                    ck, cv, tok0, hist = tslots.prefill_join(
                        tp, TCFG, torch.from_numpy(req["phones"]).long(),
                        torch.from_numpy(_bert(seed, SX)), torch.from_numpy(req["x_len"]),
                        torch.from_numpy(req["prompts"]).long(),
                        torch.from_numpy(req["p_len"]), samp,
                        noise=torch.from_numpy(_noise(jax.random.PRNGKey(seed), (1, V))))
                    tslots.insert_slot(t, slot, ck, cv, tok0, hist, 5 + seed, 3 + seed,
                                       steps, steps, ts.SamplingRows(*(a[0] for a in samp)),
                                       params=tp)
                    toks.append(tok0)
                t, seg_tok = tslots.decode_segment(
                    tp, t, TCFG, W, SX, SP, RING, kv_kernel=True,
                    noise=torch.from_numpy(_noise(jax.random.PRNGKey(100 + seg), (W, 4, V))))
                toks.append(seg_tok)
            runs[eager] = (toks, t)
        finally:
            cache.eager = False
    (gt, gs), (et, es) = runs[False], runs[True]
    assert len(gt) == len(et) and all(torch.equal(a, b) for a, b in zip(gt, et))
    assert_leaves_equal(gs, es)
    assert len(set(torch.cat([x.reshape(-1) for x in gt]).tolist())) > 4
    assert int(gs.counts[2]) == 16 and int(gs.counts[0]) == 8
