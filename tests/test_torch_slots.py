"""The port's slot machine vs the JAX package's, on the CPU.

A tiny T2S (the ``CFG`` of tests/test_slots.py) in fp32, made to decode
with clear logit margins (embeddings x10, random biases and norms), so
greedy tokens do not hinge on the last bit of a sum:

* ``quantize_kv_columns`` gives the JAX codes and scales bit for bit;
* the port's ``SlotState`` equals the JAX state leaf by leaf after two
  inserts (the same context columns given to both) and after each of two
  segments, in fp32 and int8, kernel route and full-read route: integer
  leaves, int8 codes and tokens exactly; float leaves within 1e-5 (fp32
  sums in other orders, and the JAX package's compiled quantizer rounds
  the last bit of some scales differently from its eager one);
* greedy tokens are IDENTICAL to the JAX slot machine's and to the port's
  ``t2s.generate`` for a solo request, a staggered join and ring reuse
  after release (tests/test_slots.py:66-172);
* with the JAX package's Gumbel noise and default sampling the tokens are
  identical too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.models import slots as jslots
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops import int8_decode as jint8
from genie_tts_tpu.ops import sampling as js
from genie_tts_tpu_torch.config import T2SConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops import sampling as ts

KW = dict(phoneme_vocab=40, semantic_vocab=33, embed_dim=32, num_layers=2,
          num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
          max_decode_steps=64)
JCFG, TCFG = JT2SConfig(**KW), T2SConfig(**KW)
V = KW["semantic_vocab"]
SX, SP, RING, W, NSLOT = 16, 8, 32, 8, 4
GREEDY = dict(top_k=1, temperature=1.0, repetition_penalty=1.0)
GEOM = dict(sx=SX, sp=SP, ring_len=RING)

# the device leaves, in the JAX package's SlotState order
LEAVES = ("k_cache", "v_cache", "k_scale", "v_scale", "cur_tok", "keys_written",
          "counts", "done", "active", "hist", "x_len", "p_len", "min_steps",
          "max_steps", "samp_top_k", "samp_top_p", "samp_temp", "samp_rep")

_jseg = jax.jit(jslots.decode_segment,
                static_argnames=("cfg", "seg_steps", "sx", "sp", "ring_len",
                                 "layer_unroll", "kv_kernel", "ctx_win", "ring_win"))
_jprefill = jax.jit(jslots.prefill_join, static_argnames=("cfg",))
_jinsert = jax.jit(jslots.insert_slot)


@pytest.fixture(scope="module")
def params():
    p = jt2s.init_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    p["audio_embed"] = p["audio_embed"] * 10.0
    p["text_embed"] = p["text_embed"] * 10.0
    rng = np.random.default_rng(3)
    lp = dict(p["layers"])
    for k in ("qkv", "out", "ffn1", "ffn2"):
        lp[k] = dict(lp[k], b=jnp.asarray(rng.standard_normal(lp[k]["b"].shape) * 0.1,
                                          jnp.float32))
    for k in ("norm1", "norm2"):
        s = lp[k]["scale"].shape
        lp[k] = {"scale": jnp.asarray(1 + rng.standard_normal(s) * 0.1, jnp.float32),
                 "bias": jnp.asarray(rng.standard_normal(s) * 0.1, jnp.float32)}
    p["layers"] = lp
    return p, params_from_numpy(p, torch.float32)


@pytest.fixture
def jax_kernel_interpret(monkeypatch):
    """The JAX package's kernel route on the CPU: its Pallas kernel in
    interpret mode, as its own tests run it."""
    monkeypatch.setattr(jint8, "int8_big_attention",
                        functools.partial(jint8.int8_big_attention, interpret=True))


def _request(seed, n_ids, n_prm, sx=SX, sp=SP, kw=KW):
    rng = np.random.default_rng(seed)
    phones = np.zeros((1, sx), np.int32)
    phones[0, :n_ids] = rng.integers(1, kw["phoneme_vocab"], n_ids)
    prompts = np.zeros((1, sp), np.int32)
    prompts[0, :n_prm] = rng.integers(0, kw["semantic_vocab"] - 1, n_prm)
    return dict(phones=phones, x_len=np.array([n_ids], np.int32),
                prompts=prompts, p_len=np.array([n_prm], np.int32))


def _noise(key, shape):
    return np.array(jax.random.gumbel(key, shape, dtype=jnp.float32))


class Pair:
    """The same slot machine in both packages, driven in lockstep."""

    def __init__(self, params, kv_int8=False, kv_kernel=False, cfgs=(JCFG, TCFG),
                 geom=(SX, SP, RING, W, NSLOT)):
        self.jp, self.tp = params
        # each package's big-cache read route (kernel or full read)
        self.jkernel = self.tkernel = kv_kernel
        self.jcfg, self.tcfg = cfgs
        sx, sp, ring, self.W, self.n = geom
        self.geom = dict(sx=sx, sp=sp, ring_len=ring)
        self.j = jslots.init_slots(self.jcfg, self.n, sx, sp, ring, dtype=jnp.float32,
                                   kv_int8=kv_int8)
        self.t = tslots.init_slots(self.tcfg, self.n, sx, sp, ring, dtype=torch.float32,
                                   kv_int8=kv_int8)
        self.step = 0

    def join(self, slot, req, min_steps, max_steps, samp_cfg=GREEDY, same_ctx=False):
        """Prefill + insert in both. ``same_ctx``: give the port's insert the
        JAX prefill's outputs (so the states can be compared exactly)."""
        key = jax.random.PRNGKey(1000 + self.step)
        self.step += 1
        samp = js.rows_from_config(js.SamplingConfig(**samp_cfg), 1)
        jk, jv, jtok0, jhist = _jprefill(
            self.jp, cfg=self.jcfg, key=key, phones=jnp.asarray(req["phones"]), bert=None,
            x_len=jnp.asarray(req["x_len"]), prompts=jnp.asarray(req["prompts"]),
            p_len=jnp.asarray(req["p_len"]), samp=samp)
        tsamp = ts.rows_from_config(ts.SamplingConfig(**samp_cfg), 1)
        tk, tv, ttok0, thist = tslots.prefill_join(
            self.tp, self.tcfg, torch.from_numpy(req["phones"]).long(), None,
            torch.from_numpy(req["x_len"]), torch.from_numpy(req["prompts"]).long(),
            torch.from_numpy(req["p_len"]), tsamp,
            noise=torch.from_numpy(_noise(key, (1, self.tcfg.semantic_vocab))))
        np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-5)
        assert int(ttok0[0]) == int(jtok0[0])
        np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
        if same_ctx:
            tk, tv = torch.from_numpy(np.array(jk)), torch.from_numpy(np.array(jv))
        x_len, p_len = int(req["x_len"][0]), int(req["p_len"][0])
        self.j = _jinsert(self.j, jnp.int32(slot), jk, jv, jtok0, jhist,
                          jnp.int32(x_len), jnp.int32(p_len), jnp.int32(min_steps),
                          jnp.int32(max_steps), js.SamplingRows(*(a[0] for a in samp)))
        self.t = tslots.insert_slot(self.t, slot, tk, tv, ttok0, thist, x_len, p_len,
                                    min_steps, max_steps,
                                    ts.SamplingRows(*(a[0] for a in tsamp)))
        return int(jtok0[0])

    def release(self, slot):
        self.j = jslots.release_slot(self.j, jnp.int32(slot))
        self.t = tslots.release_slot(self.t, slot)

    def segment(self):
        key = jax.random.PRNGKey(self.step)
        self.step += 1
        self.j, jtok = _jseg(self.jp, self.j, key, cfg=self.jcfg, seg_steps=self.W,
                             **self.geom, kv_kernel=self.jkernel)
        self.t, ttok = tslots.decode_segment(
            self.tp, self.t, self.tcfg, self.W, **self.geom, kv_kernel=self.tkernel,
            noise=torch.from_numpy(_noise(key, (self.W, self.n, self.tcfg.semantic_vocab))))
        return np.asarray(jtok), ttok.numpy()


def assert_states_equal(j, t, cache_rows=None):
    """Every leaf equal; ``cache_rows``: compare the caches and scales on
    these rows only (a free row's cache holds masked garbage, which depends
    on the columns a machine read)."""
    assert int(j.ring_head) == t.ring_head
    for name in LEAVES:
        jl, tl = getattr(j, name), getattr(t, name)
        if jl is None:
            assert tl is None, name
            continue
        jl, tl = np.asarray(jl), tl.numpy()
        if cache_rows is not None and name in LEAVES[:4]:
            jl, tl = jl[:, cache_rows], tl[:, cache_rows]
        assert jl.shape == tl.shape and jl.dtype == tl.dtype, name
        if jl.dtype.kind == "f":
            np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(tl, jl, err_msg=name)


def test_quantize_kv_columns_codes_equal():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 2, 4, 8, 16)) * 2.0).astype(np.float32)
    x[..., 0, :3] = 0.0                     # columns with a zero row
    x[..., :, 5] = 0.0                      # an all-zero column (scale floor)
    jq, js_ = jslots.quantize_kv_columns(jnp.asarray(x))
    tq, ts_ = tslots.quantize_kv_columns(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts_.shape == (3, 2, 4, 16)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    # half-way values round to even in both
    half = np.tile(np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)[:, None],
                   (1, 4)) * (1 / 127.0)
    jq, _ = jslots.quantize_kv_columns(jnp.asarray(half[None]) * 127.0)
    tq, _ = tslots.quantize_kv_columns(torch.from_numpy(half[None]) * 127.0)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


@pytest.mark.parametrize("kv_int8,kv_kernel", [(False, False), (True, False), (True, True)],
                         ids=["fp32", "int8_full_read", "int8_kernel"])
def test_state_equals_jax_leaf_by_leaf(params, jax_kernel_interpret, kv_int8, kv_kernel):
    pair = Pair(params, kv_int8, kv_kernel)
    assert_states_equal(pair.j, pair.t)
    pair.join(0, _request(0, 5, 3), 24, 24, same_ctx=True)
    pair.join(2, _request(1, 11, 8), 12, 20, same_ctx=True)
    assert_states_equal(pair.j, pair.t)
    for _ in range(2):
        jtok, ttok = pair.segment()
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
    assert pair.t.keys_written.tolist() == [16, 0, 16, 0]


def _run(pair, plan, segments=RING // W + 1):
    """Drive ``plan`` = {segment index: [(slot, request, steps, name)]}
    (joins before that segment); returns each request's stream as
    (JAX tokens, port tokens), tok0 first."""
    streams = {}
    for seg in range(segments):
        for slot, req, steps, name in plan.get(seg, []):
            tok0 = pair.join(slot, req, steps, steps)
            streams[name] = (slot, [tok0], [tok0])
        jtok, ttok = pair.segment()
        for slot, jstream, tstream in streams.values():
            jstream.extend(jtok[slot])
            tstream.extend(ttok[slot])
    return {name: (j, t) for name, (_, j, t) in streams.items()}


def _port_generate(tp, req, steps):
    x = tt2s.embed_text(tp, torch.from_numpy(req["phones"]).long(),
                        torch.zeros((1, SX, KW["bert_dim"])))
    res = tt2s.generate(tp, TCFG, ts.SamplingConfig(**GREEDY), None, x,
                        torch.from_numpy(req["x_len"]), torch.from_numpy(req["prompts"]).long(),
                        torch.from_numpy(req["p_len"]), max_steps=steps,
                        cache_len=SX + SP + steps, min_steps=steps)
    return res.tokens[0, : int(res.counts[0])].numpy()


def _check(pair, name, js_, ts_, slot, req, steps):
    count = int(pair.t.counts[slot])
    assert count == int(np.asarray(pair.j.counts)[slot]) == steps, name
    np.testing.assert_array_equal(np.array(ts_[:count]), np.array(js_[:count]), name)
    np.testing.assert_array_equal(np.array(ts_[:count]), _port_generate(pair.tp, req, steps),
                                  name)
    assert len(set(ts_[:count])) > 2, f"{name}: degenerate decode; reseed"


@pytest.mark.parametrize("scenario", ["solo", "staggered_join", "ring_reuse"])
def test_greedy_tokens_match_jax_and_generate(params, scenario):
    pair = Pair(params)
    A, Bq = _request(0, 5, 3), _request(1, 4, 3)
    if scenario == "solo":
        got = _run(pair, {0: [(1, A, 24, "A")]})
        _check(pair, "A", *got["A"], 1, A, 24)
    elif scenario == "staggered_join":
        got = _run(pair, {0: [(0, A, 24, "A")], 1: [(2, Bq, 16, "B")]})
        _check(pair, "A", *got["A"], 0, A, 24)
        _check(pair, "B", *got["B"], 2, Bq, 16)
    else:
        # occupy + finish + release slot 0 (the ring head moves mid-ring),
        # then a fresh request reuses the slot
        pair.join(0, Bq, 8, 8)
        pair.segment()
        assert bool(pair.t.done[0]) and bool(np.asarray(pair.j.done)[0])
        pair.release(0)
        C = _request(4, 9, 6)
        got = _run(pair, {0: [(0, C, 16, "C")]}, segments=RING // W)
        _check(pair, "C", *got["C"], 0, C, 16)


def test_default_sampling_with_jax_noise_identical(params):
    """Default sampling (top_k 15, repetition penalty 1.35): the same
    Gumbel noise gives the same tokens, joins staggered, fp32."""
    pair = Pair(params)
    A, Bq = _request(2, 9, 6), _request(3, 6, 7)
    default = dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35)
    pair.join(1, A, 20, 20, samp_cfg=default)
    jt, tt = pair.segment()
    pair.join(3, Bq, 12, 12, samp_cfg=default)
    toks = [(jt, tt)]
    for _ in range(2):
        toks.append(pair.segment())
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(pair.t.counts.numpy(), np.asarray(pair.j.counts))
    np.testing.assert_array_equal(pair.t.hist.numpy(), np.asarray(pair.j.hist))


@pytest.mark.slow
@pytest.mark.parametrize("kv_int8", [False, True], ids=["fp32", "int8_kernel"])
def test_full_width_24_layers_staggered_join(kv_int8):
    """T2SConfig() widths (24 layers, d512, 16 heads), fp32 weights: a
    staggered join decodes the JAX slot machine's greedy tokens and
    bookkeeping. int8 KV: the port's kernel route (plain version on the
    CPU) against the JAX package's full-read route; the int8 codes agree
    within one step (a few column values land across a rounding boundary
    after 24 layers of sums in another order)."""
    jp = jt2s.init_params(jax.random.PRNGKey(7), JT2SConfig(), dtype=jnp.float32)
    jp["audio_embed"] = jp["audio_embed"] * 10.0
    kw = dict(phoneme_vocab=732, semantic_vocab=1025)
    sx, sp, ring, w = 32, 64, 32, 8
    pair = Pair((jp, params_from_numpy(jp, torch.float32)), kv_int8,
                cfgs=(JT2SConfig(), T2SConfig()), geom=(sx, sp, ring, w, 2))
    pair.tkernel = kv_int8        # the port's kernel route; JAX reads in full
    pair.join(0, _request(0, 20, 50, sx, sp, kw), 16, 16)
    toks = [pair.segment()]
    pair.join(1, _request(1, 27, 33, sx, sp, kw), 8, 8)
    toks.append(pair.segment())
    for jt, tt in toks:
        np.testing.assert_array_equal(tt, jt)
    for name in ("keys_written", "counts", "done", "hist", "cur_tok"):
        np.testing.assert_array_equal(getattr(pair.t, name).numpy(),
                                      np.asarray(getattr(pair.j, name)), name)
    if kv_int8:
        # 24 layers of fp32 sums in another order move a few column values
        # across a rounding boundary: codes within one step, almost all equal
        d = np.abs(pair.t.k_cache.numpy().astype(np.int32)
                   - np.asarray(pair.j.k_cache).astype(np.int32))
        assert d.max() <= 1 and d.mean() < 1e-3
