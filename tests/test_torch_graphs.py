"""The decode programs over static buffers vs the JAX package, on the CPU.

On the card each decode program of the port (``generate``'s block of
``DONE_READ_EVERY`` steps, a slot or stream segment) is captured once per
geometry as a CUDA graph and replayed (``runtime/graphs.py``); here the
same programs run eagerly on the same static buffers, under the same
cache keys. Tiny T2S models, fp32, inputs and Gumbel noise from seeds:

* ``generate`` (the graph route: the cache's buffers) against the JAX
  package's ``generate`` with top-k 1, and with default sampling on the
  JAX package's own Gumbel table, at B=1 (the fused route, on its plain
  version) and B=4 (the flash route, rows that end at different steps),
  with a cap of 37 steps (not a multiple of 16): tokens and counts
  IDENTICAL, and tokens, counts and steps identical to ``eager=True``;
* ``decode_segment`` with the ring head in device memory against the
  JAX package's segment, leaf by leaf and token by token (the harness of
  tests/test_torch_slots.py: integers exactly, floats within 1e-5), on
  the int8 kernel route (its plain version) and the exact route's full
  read and each window pair, across a ring wrap that starts mid-ring;
  both on a state copied into the graph's buffers and on a persistent
  state that is the graph's buffers;
* the step functions read nothing back to the host (a dispatch mode
  fails on ``aten._local_scalar_dense``, which ``.item()``, ``bool()``
  and ``int()`` of a tensor call);
* the graphs' buffers keep their addresses from one run to the next;
* ``TTSEngine.warmup(..., sweep=True)`` prepares every key and variant
  that solo, batched, slot and stream requests then ask for, with and
  without top-p and at caps other than the character's: no miss and no
  new variant while serving; a slot machine owns its state (the one the
  sweep left, else its own), so a second machine or a later sweep never
  writes it; ``/set_reference_audio`` with ``"warmup": true`` sweeps;
* ``utils/metrics.py::trace`` writes a trace file.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu_torch.config import RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import graphs
from genie_tts_tpu_torch.runtime.engine import TTSEngine, make_random_character
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher
from genie_tts_tpu_torch.utils.metrics import trace
from test_torch_slot_batcher import _reference
from test_torch_slots import TCFG as TCFG_S
from test_torch_slots import (RING, W, Pair, _jseg, _noise, _request,  # noqa: F401
                              assert_states_equal, params)
from test_torch_t2s import JCFG, SP, SX, TCFG, _inputs, _lively, _t

CAP = 37
SAMPLING = {"greedy": (JSampling(top_k=1, top_p=1.0, temperature=1.0,
                                 repetition_penalty=1.35),
                       SamplingConfig(top_k=1, top_p=1.0, temperature=1.0,
                                      repetition_penalty=1.35)),
            "jax_noise": (JSampling(), SamplingConfig())}


@pytest.fixture(scope="module")
def t2s_params():
    jp = _lively(jt2s.init_params(jax.random.PRNGKey(4), JCFG, dtype=jnp.float32), 5)
    return jp, params_from_numpy(jp, torch.float32)


def _port_generate(tp, B, scfg, noise, eager):
    phones, bert, x_len, prompts, p_len = _inputs(B)
    x = tt2s.embed_text(tp, _t(phones), _t(bert))
    return tt2s.generate(tp, TCFG, scfg, None, x, _t(x_len), _t(prompts), _t(p_len),
                         max_steps=CAP, cache_len=SX + SP + CAP, noise=noise, eager=eager)


@pytest.mark.parametrize("sampling", ["greedy", "jax_noise"])
@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_generate_matches_jax_and_eager(t2s_params, B, sampling):
    jp, tp = t2s_params
    jscfg, scfg = SAMPLING[sampling]
    phones, bert, x_len, prompts, p_len = _inputs(B)
    key = jax.random.PRNGKey(11)
    jx = jt2s.embed_text(jp, jnp.asarray(phones), jnp.asarray(bert))
    jres = jt2s.generate(jp, JCFG, jscfg, key, jx, jnp.asarray(x_len), jnp.asarray(prompts),
                         jnp.asarray(p_len), max_steps=CAP, cache_len=SX + SP + CAP)
    # the JAX package's generate draws this table from its key
    noise = torch.from_numpy(np.array(jax.random.gumbel(
        key, (CAP, B, TCFG.semantic_vocab), dtype=jnp.float32)))
    cache = graphs.cache_for(tp)
    misses = cache.stats["misses"]
    res = _port_generate(tp, B, scfg, noise, eager=False)
    eager = _port_generate(tp, B, scfg, noise, eager=True)
    assert cache.stats["misses"] <= misses + 1       # one key for both routes
    jt, jc = np.asarray(jres.tokens), np.asarray(jres.counts)
    np.testing.assert_array_equal(res.counts.numpy(), jc)
    np.testing.assert_array_equal(res.tokens.numpy(), jt)
    np.testing.assert_array_equal(eager.tokens.numpy(), res.tokens.numpy())
    np.testing.assert_array_equal(eager.counts.numpy(), res.counts.numpy())
    assert eager.steps == res.steps
    assert jc.min() > 3, "degenerate decode; reseed the fixture"
    if B == 4:
        assert len(set(jc.tolist())) > 1, "rows ended together; reseed the fixture"


def test_generate_cap_reached_inside_a_block(t2s_params):
    """Every row runs to a cap of 37 (min_steps = cap): two blocks of 16
    steps and 4 single steps (the block that ends at the cap: the
    one-step variant of the same graph) run 36 steps and end at the cap,
    as the eager loop does; a block with steps past the cap changes
    nothing."""
    _, tp = t2s_params
    phones, bert, x_len, prompts, p_len = _inputs(4)
    x = tt2s.embed_text(tp, _t(phones), _t(bert))
    out = [tt2s.generate(tp, TCFG, SamplingConfig(), torch.Generator().manual_seed(2), x,
                         _t(x_len), _t(prompts), _t(p_len), max_steps=CAP,
                         cache_len=SX + SP + CAP, min_steps=CAP, eager=eager)
           for eager in (False, True)]
    for r in out:
        assert r.steps == CAP and r.counts.tolist() == [CAP] * 4
    np.testing.assert_array_equal(out[0].tokens.numpy(), out[1].tokens.numpy())
    g, _ = tt2s.decode_graph(tp, TCFG, 4, SX, SP, SX + SP + CAP, CAP, torch.float32)
    assert sorted(g.variants) == [(1, False), (16, False)]
    assert tt2s.DECODE_BLOCKS == (16, 1)
    with g.lock:
        b = g.static
        before = [t.clone() for t in (b.tokens, b.counts, b.hist, b.step, b.done)]
        tt2s._decode_block(tp, TCFG, b, n_steps=5, Sx=SX, Sp=SP, any_top_p=False)
        for x, y in zip(before, (b.tokens, b.counts, b.hist, b.step, b.done)):
            assert torch.equal(x, y)


def _segment(pair, ctx_win, ring_win, eager=False):
    key = jax.random.PRNGKey(pair.step)
    pair.step += 1
    pair.j, jtok = _jseg(pair.jp, pair.j, key, cfg=pair.jcfg, seg_steps=pair.W,
                         **pair.geom, kv_kernel=pair.jkernel, ctx_win=ctx_win,
                         ring_win=ring_win)
    noise = torch.from_numpy(_noise(key, (pair.W, pair.n, pair.tcfg.semantic_vocab)))
    pair.t, ttok = tslots.decode_segment(
        pair.tp, pair.t, pair.tcfg, pair.W, **pair.geom, kv_kernel=pair.tkernel,
        ctx_win=ctx_win, ring_win=ring_win, noise=noise, eager=eager)
    return np.asarray(jtok), ttok.numpy()


ROUTES = {"int8_kernel": (True, True, None, None), "full": (False, False, None, None),
          "ctx": (False, False, 12, None), "ring": (False, False, None, "grow"),
          "both": (False, False, 12, "grow")}


@pytest.fixture
def jax_kernel_interpret(monkeypatch):
    from genie_tts_tpu.ops import int8_decode as jint8

    monkeypatch.setattr(jint8, "int8_big_attention",
                        functools.partial(jint8.int8_big_attention, interpret=True))


@pytest.mark.parametrize("binding", ["copied", "persistent"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_segment_matches_jax_across_a_ring_wrap(params, jax_kernel_interpret, route,
                                                binding):
    """A short request moves the head to mid-ring and is released; a
    request that fills the ring then decodes across the wrap (the ring
    window grows with its keys, the scheduler's contract), beside a
    second row. After every segment the state equals the JAX machine's
    leaf by leaf and the tokens are identical; the ring head is a device
    int32."""
    kv_int8, kv_kernel, ctx_win, ring_win = ROUTES[route]
    pair = Pair(params, kv_int8, kv_kernel)
    if binding == "persistent":
        pair.t = dataclasses.replace(pair.t, persistent=True)
    bound = pair.t
    pair.join(2, _request(3, 6, 4), 8, 8, same_ctx=True)
    _segment(pair, ctx_win, W if ring_win else None)       # head -> 8
    pair.release(2)
    pair.join(0, _request(0, 5, 3), RING, RING, same_ctx=True)
    pair.join(3, _request(1, 4, 3), 16, 16, same_ctx=True)
    for seg in range(RING // W):
        rw = min((seg + 1) * W, RING) if ring_win else None
        jtok, ttok = _segment(pair, ctx_win, rw)
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
    assert pair.t is bound
    assert pair.t.ring_head.dtype == torch.int32 and pair.t.ring_head.dim() == 0
    assert int(pair.t.counts[0]) == RING and int(pair.t.ring_head) == 8


def test_segment_graph_route_equals_eager(params):
    """The same segments through the graph's buffers and eagerly on a
    copy: tokens and every leaf identical."""
    a = Pair(params, kv_int8=True, kv_kernel=True)
    a.join(1, _request(0, 5, 3), 24, 24, same_ctx=True)
    b_state = tslots.clone_state(a.t)
    _, tp = params
    for seg in range(3):
        noise = torch.from_numpy(_noise(jax.random.PRNGKey(seg), (W, 4, TCFG_S.semantic_vocab)))
        a.t, ta = tslots.decode_segment(tp, a.t, TCFG_S, W, **a.geom, kv_kernel=True,
                                        noise=noise)
        b_state, tb = tslots.decode_segment(tp, b_state, TCFG_S, W, **a.geom,
                                            kv_kernel=True, noise=noise, eager=True)
        assert torch.equal(ta, tb)
        for f in dataclasses.fields(a.t):
            x = getattr(a.t, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(b_state, f.name)), f.name


class _NoHostReads(TorchDispatchMode):
    """Fails on a read of a tensor's value by the host."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a step function read a tensor back to the host")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_decode_block_reads_nothing_back(t2s_params, B):
    _, tp = t2s_params
    g, packed = tt2s.decode_graph(tp, TCFG, B, SX, SP, SX + SP + CAP, CAP,
                                  torch.float32)
    with g.lock:
        g.static.step.fill_(1)
        with _NoHostReads():
            tt2s._decode_block(tp, TCFG, g.static, n_steps=3, Sx=SX, Sp=SP,
                               any_top_p=True, packed=packed)
        assert int(g.static.step) == 4


@pytest.mark.parametrize("route", ["int8_kernel", "full", "both"])
def test_segment_reads_nothing_back(params, route):
    kv_int8, kv_kernel, ctx_win, ring_win = ROUTES[route]
    pair = Pair(params, kv_int8, kv_kernel)
    pair.join(0, _request(0, 5, 3), 24, 24, same_ctx=True)
    bufs = tslots.SegmentBuffers(pair.t, torch.zeros((W, 4, TCFG_S.semantic_vocab)),
                                 torch.zeros((4, W), dtype=torch.int32))
    with _NoHostReads():
        tslots._segment(pair.tp, TCFG_S, bufs, W=W, sx=pair.geom["sx"], sp=pair.geom["sp"],
                        ring_len=RING, use_kernel=kv_kernel, ctx_win=ctx_win or 24,
                        ring_win=W if ring_win else RING, any_top_p=True)
    assert int(pair.t.ring_head) == W and int(pair.t.keys_written[0]) == W


def test_buffers_keep_their_addresses(t2s_params, params):
    _, tp = t2s_params
    ptrs = []
    for _ in range(2):
        _port_generate(tp, 4, SamplingConfig(), None, eager=False)
        g, _ = tt2s.decode_graph(tp, TCFG, 4, SX, SP, SX + SP + CAP, CAP,
                                 torch.float32)
        ptrs.append([t.data_ptr() for t in graphs.tensors_of(g.static)])
    assert ptrs[0] == ptrs[1]
    pair = Pair(params)
    pair.t = dataclasses.replace(pair.t, persistent=True)
    pair.join(0, _request(0, 5, 3), 24, 24, same_ctx=True)
    seen = []
    for _ in range(2):
        before = [t.data_ptr() for t in graphs.tensors_of(pair.t)]
        pair.segment()
        seen.append([t.data_ptr() for t in graphs.tensors_of(pair.t)])
        assert seen[-1] == before
    assert seen[0] == seen[1]


TINY_T2S = T2SConfig(phoneme_vocab=40, semantic_vocab=33, embed_dim=32, num_layers=2,
                     num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
                     max_decode_steps=32)
TINY_VITS = SoVITSConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16, ssl_dim=8, vq_codes=32,
    vq_dim=8, gin_channels=16, flow_layers=2, wn_layers=2, wn_kernel=5,
    upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
    resblock_kernels=(3,), resblock_dilations=((1, 3),), n_fft=64, hop_length=8,
    win_length=64)


def _sweep_case(kv_int8):
    cfg = RuntimeConfig(phoneme_buckets=(16, 32), prompt_buckets=(16,),
                        frame_buckets=(32, 64), step_caps=(32,), batch_buckets=(1, 2, 4),
                        slot_batch=4, slot_steps=8, slot_join_steps=4, slot_ring=32,
                        slot_phoneme_bucket=24, slot_prompt_bucket=16,
                        slot_ctx_windows=(16,), slot_ring_windows=(16,),
                        slot_windowed_kv=True, slot_kv_int8=kv_int8,
                        stream_seg_steps=8, vocode_chunk=16, vocode_halo=4,
                        stream_first_chunk=8, stream_chunk=16, slot_first_piece=8)
    eng = TTSEngine(cfg)
    char = make_random_character(t2s_cfg=TINY_T2S, sovits_cfg=TINY_VITS,
                                 dtype=torch.float32, device="cpu", seed=3)
    return eng, char, _reference(char)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["exact_windows", "int8_kernel"])
def test_sweep_covers_every_serving_key(kv_int8):
    """After ``warmup(char, ref, sweep=True)``: solo ``tts`` with and
    without top-p, batches of two and three (the window batcher's B=2 and
    B=4) with and without top-p, slot requests with and without top-p, a
    segmented stream, and a fused stream head with and without top-p, at
    the character's cap and at a cap of 12, take keys and variants the
    sweep prepared (no miss, no new variant); the sweep prepared every
    segment graph of the slot geometry on the state the slot machine
    then takes."""
    eng, char, ref = _sweep_case(kv_int8)
    n = eng.warmup(char, ref, sweep=True)
    cache = graphs.cache_for(char.t2s_params)
    keys = cache.keys()
    programs = cache.programs()
    segs = [k for k in keys if k[0] == "segment" and k[-1] is not None]
    combos = 1 if kv_int8 else 2            # full read, and (16, 16)
    assert len(segs) == 2 * combos * 2      # widths 8 and 4, top-p flag
    gens = [k for k in keys if k[0] == "generate"]
    assert len(gens) == 3 * 2               # B 1/2/4 x phoneme buckets
    assert {(k, v) for k, v in programs if k[0] == "generate"} == {
        (k, (n, top_p)) for k in gens for n in tt2s.DECODE_BLOCKS for top_p in (False, True)}
    assert n > len(keys) and cache.stats["captures"] == 0     # no card here
    cache.reset_stats()

    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    long = np.arange(1, 31, dtype=np.int32) % 39 + 1      # past the stream geometry
    long_bert = np.zeros((30, TINY_T2S.bert_dim), np.float32)
    top_p = SamplingConfig(top_p=0.8)
    for sampling in (None, top_p):
        eng.synthesize_utterance(char, ref, short, bert, seed=1, sampling=sampling)
        eng.synthesize_utterance(char, ref, short, bert, seed=1, sampling=sampling,
                                 max_steps=12)
        for rows in (2, 3):
            eng.synthesize_batch(char, [(ref, short, bert)] * rows, seed=1, sampling=sampling)
        for max_steps in (None, 12):            # the fused stream head
            list(eng.synthesize_utterance_stream(char, ref, long, long_bert, seed=1,
                                                 sampling=sampling, max_steps=max_steps))
    sb = SlotBatcher(eng, char, pcm16=True)
    assert {k[-1] for k in segs} == {id(sb._state)}       # the sweep's state
    try:
        sb.synthesize(ref, short, bert, timeout=120, max_steps=12)
        sb.synthesize(ref, short, bert, timeout=120, max_steps=12, sampling=top_p)
        list(sb.synthesize_stream(ref, short, bert, timeout=120, max_steps=12))
    finally:
        sb.stop()
    list(eng.synthesize_utterance_stream(char, ref, short, bert, seed=1, max_steps=12))
    assert cache.stats["hits"] > 0
    assert cache.stats["misses"] == 0, cache.keys()
    assert cache.stats["variants"] == 0 and cache.programs() == programs


def test_slot_machines_own_their_state():
    """The slot machine made after a sweep takes the sweep's state; a
    second machine on the same engine and character gets one of its own;
    a sweep while the first machine lives captures on a new state and
    leaves the machine's (its leaves and its ring head) as they were."""
    eng, char, ref = _sweep_case(True)
    eng.warmup(char, ref, sweep=True)
    swept = {k[-1] for k in graphs.cache_for(char.t2s_params).keys() if k[0] == "segment"}
    a, b = SlotBatcher(eng, char, pcm16=True), SlotBatcher(eng, char, pcm16=True)
    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    try:
        assert {id(a._state)} == swept - {None} and b._state is not a._state
        a.synthesize(ref, short, bert, timeout=120, max_steps=12)
        b.synthesize(ref, short, bert, timeout=120, max_steps=12)
        before = tslots.clone_state(a._state)
        assert int(a._state.ring_head) == a._head != 0
        eng.warmup(char, ref, sweep=True)
        for f in dataclasses.fields(before):
            x = getattr(before, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(a._state, f.name)), f.name
        a.synthesize(ref, short, bert, timeout=120, max_steps=12)
        assert int(a._state.ring_head) == a._head
    finally:
        a.stop()
        b.stop()


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with trace(None):                       # no directory: nothing traced
        pass
