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
  the same through the prefill program that embeds the text itself
  (``generate_e2e``'s route), equal to the embedded-input route;
* ``decode_segment`` with the ring head in device memory against the
  JAX package's segment, leaf by leaf and token by token (the harness of
  tests/test_torch_slots.py: integers exactly, floats within 1e-5), on
  the int8 kernel route (its plain version) and on the exact route (the
  slot attention's plain version) against the JAX package's full read and
  each of its window pairs, across a ring wrap that starts mid-ring;
  both on a state copied into the graph's buffers and on a persistent
  state, resident in them (its leaves are the graph's buffers);
* the step functions and the prefill program read nothing back to the
  host (a dispatch mode fails on ``aten._local_scalar_dense``, which
  ``.item()``, ``bool()`` and ``int()`` of a tensor call);
* the graphs' buffers keep their addresses from one run to the next;
* ``TTSEngine.warmup(..., sweep=True)`` prepares every key and variant
  that solo, batched, slot and stream requests then ask for, with and
  without top-p and at caps other than the character's: no miss and no
  new variant while serving, in the decode and in the SoVITS caches; a
  slot machine owns its state (the one the sweep left, else its own),
  and two machines take turns in the resident state, so neither writes
  the other's, and a second sweep of the configuration runs 0 units;
* a server with ``serve --warmup``'s flag sweeps the first character of
  a configuration at its ``/set_reference_audio``, and a second character
  of that configuration sweeps nothing and serves with no miss; a
  character evicted by the character cache frees its weights and leaves
  its configuration's caches (``gc.collect()``), and its next request
  reloads it with no sweep and no miss; a request in flight in its slot
  machine across the eviction finishes with the audio it would have
  had;
* ``utils/metrics.py::trace`` writes a trace file.
"""
import dataclasses
import functools
import json
import threading

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


@pytest.mark.parametrize("sampling", ["greedy", "jax_noise"])
@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_generate_prefill_program_matches_jax_and_eager(t2s_params, B, sampling):
    """``generate`` given phone ids and BERT features (``generate_e2e``'s
    route): the prefill program embeds the text, writes the graph's own
    caches, seeds the histogram and draws the first token. Tokens and
    counts identical to the JAX package's ``generate`` on the same noise,
    to the eager run of the same programs and to the embedded-input
    route."""
    jp, tp = t2s_params
    jscfg, scfg = SAMPLING[sampling]
    phones, bert, x_len, prompts, p_len = _inputs(B)
    key = jax.random.PRNGKey(12)
    jx = jt2s.embed_text(jp, jnp.asarray(phones), jnp.asarray(bert))
    jres = jt2s.generate(jp, JCFG, jscfg, key, jx, jnp.asarray(x_len), jnp.asarray(prompts),
                         jnp.asarray(p_len), max_steps=CAP, cache_len=SX + SP + CAP)
    noise = torch.from_numpy(np.array(jax.random.gumbel(
        key, (CAP, B, TCFG.semantic_vocab), dtype=jnp.float32)))
    out = {}
    for route, eager in (("program", False), ("eager", True)):
        out[route] = tt2s.generate(tp, TCFG, scfg, None, (_t(phones), _t(bert)), _t(x_len),
                                   _t(prompts), _t(p_len), max_steps=CAP,
                                   cache_len=SX + SP + CAP, noise=noise, eager=eager)
    out["embedded"] = _port_generate(tp, B, scfg, noise, eager=False)
    np.testing.assert_array_equal(out["program"].tokens.numpy(), np.asarray(jres.tokens))
    np.testing.assert_array_equal(out["program"].counts.numpy(), np.asarray(jres.counts))
    for route in ("eager", "embedded"):
        assert torch.equal(out[route].tokens, out["program"].tokens), route
        assert torch.equal(out[route].counts, out["program"].counts), route
        assert out[route].steps == out["program"].steps, route
    g, _ = tt2s.decode_graph(tp, TCFG, B, SX, SP, SX + SP + CAP, CAP, torch.float32)
    top_p = scfg.top_p < 1.0
    assert {("prefill", True, top_p), ("prefill", False, top_p)} <= set(g.variants)


@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_prefill_block_reads_nothing_back(t2s_params, B):
    _, tp = t2s_params
    phones, bert, x_len, prompts, p_len = _inputs(B)
    g, _ = tt2s.decode_graph(tp, TCFG, B, SX, SP, SX + SP + CAP, CAP, torch.float32)
    with g.lock:
        b = g.static
        for buf, a in ((b.phones, phones), (b.bert, bert), (b.x_len, x_len),
                       (b.prompts, prompts), (b.p_len, p_len)):
            buf.copy_(_t(a))
        b.step.fill_(7)
        with _NoHostReads():
            tt2s._prefill_block(tp, TCFG, b, Sx=SX, Sp=SP, embed=True, any_top_p=True)
        assert int(b.step) == 1 and b.counts.tolist() == [1] * B
        assert int(b.hist.sum()) == int(p_len.sum()) + B      # the prompts and tok0


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
    assert {v for v in g.variants if v[0] != "prefill"} == {(1, False), (16, False)}
    assert ("prefill", False, False) in g.variants
    assert tt2s.DECODE_BLOCKS == (16, 1)
    with g.lock:
        b = g.static
        before = [t.clone() for t in (b.tokens, b.counts, b.hist, b.step, b.done)]
        tt2s._decode_block(tp, TCFG, b, n_steps=5, Sx=SX, Sp=SP, any_top_p=False)
        for x, y in zip(before, (b.tokens, b.counts, b.hist, b.step, b.done)):
            assert torch.equal(x, y)


def _segment(pair, ctx_win, ring_win, eager=False):
    """One segment in both packages; the read windows are the JAX
    package's (the port reads its caches in place)."""
    key = jax.random.PRNGKey(pair.step)
    pair.step += 1
    pair.j, jtok = _jseg(pair.jp, pair.j, key, cfg=pair.jcfg, seg_steps=pair.W,
                         **pair.geom, kv_kernel=pair.jkernel, ctx_win=ctx_win,
                         ring_win=ring_win)
    noise = torch.from_numpy(_noise(key, (pair.W, pair.n, pair.tcfg.semantic_vocab)))
    pair.t, ttok = tslots.decode_segment(
        pair.tp, pair.t, pair.tcfg, pair.W, **pair.geom, kv_kernel=pair.tkernel,
        noise=noise, eager=eager)
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
    leaf by leaf and the tokens are identical, whichever windows the JAX
    machine reads; the ring head is a device int32."""
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


@pytest.mark.parametrize("kv_int8,kv_kernel", [(True, True), (False, False), (True, False)],
                         ids=["int8_kernel", "exact", "int8_masked"])
def test_segment_reads_nothing_back(params, kv_int8, kv_kernel):
    pair = Pair(params, kv_int8, kv_kernel)
    pair.join(0, _request(0, 5, 3), 24, 24, same_ctx=True)
    bufs = tslots.SegmentBuffers(pair.t, torch.zeros((W, 4, TCFG_S.semantic_vocab)),
                                 torch.zeros((4, W), dtype=torch.int32))
    with _NoHostReads():
        tslots._segment(pair.tp, TCFG_S, bufs, W=W, sx=pair.geom["sx"], sp=pair.geom["sp"],
                        ring_len=RING, use_kernel=kv_kernel or not kv_int8, any_top_p=True)
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
    pair.segment()                  # resident: its leaves are the graph's buffers
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


def _sweep_case(kv_int8, language="Japanese"):
    # a lookahead of 1: a slot stream's speculative first piece (4 + 1
    # codes) fits a join segment of 4 steps
    cfg = RuntimeConfig(phoneme_buckets=(16, 32), prompt_buckets=(16,),
                        frame_buckets=(32, 64), step_caps=(32,), batch_buckets=(1, 2, 4),
                        slot_batch=4, slot_steps=8, slot_join_steps=4, slot_ring=32,
                        slot_phoneme_bucket=24, slot_prompt_bucket=16,
                        slot_kv_int8=kv_int8,
                        stream_seg_steps=8, vocode_chunk=16, vocode_halo=4,
                        stream_first_chunk=8, stream_chunk=16, slot_first_piece=8,
                        stream_lookahead=1)
    eng = TTSEngine(cfg)
    graphs.clear_caches()           # the configuration's caches start empty
    char = make_random_character(language=language, t2s_cfg=TINY_T2S, sovits_cfg=TINY_VITS,
                                 dtype=torch.float32, device="cpu", seed=3)
    return eng, char, _reference(char)


ZH_TEXTS = ("你好世界。", "今天天气很好，我们一起去北京。")


@pytest.fixture
def tiny_roberta(tmp_path):
    """A tiny RoBERTa (3 layers, d1024) on the CPU in the port's model
    manager, its BERT hook installed; removed after the test."""
    from genie_tts_tpu_torch.config import RobertaConfig
    from genie_tts_tpu_torch.frontend import dispatcher
    from genie_tts_tpu_torch.frontend.g2p_zh import chinese_to_phones
    from genie_tts_tpu_torch.frontend.wordpiece import WordPieceTokenizer, bert_layout
    from genie_tts_tpu_torch.models import roberta
    from genie_tts_tpu_torch.runtime.model_manager import model_manager

    rcfg = RobertaConfig(vocab_size=64, embed_dim=1024, num_layers=3, num_heads=2,
                         ffn_dim=32, max_position=64)
    params = roberta.init_params(torch.Generator().manual_seed(5), rcfg, torch.float32)
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3, "[MASK]": 4}
    for c in sorted({c for t in ZH_TEXTS for c in chinese_to_phones(t)[0]}):
        vocab[c] = len(vocab)
    (tmp_path / "tokenizer.json").write_text(json.dumps(bert_layout(vocab)), "utf-8")
    model_manager.set_roberta(params, rcfg, WordPieceTokenizer.from_file(
        tmp_path / "tokenizer.json"))
    try:
        yield params
    finally:
        model_manager._roberta.pop(torch.device("cpu"), None)
        dispatcher.set_bert_feature_fn(None)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["exact", "int8_kernel"])
def test_sweep_covers_every_serving_key(kv_int8, tiny_roberta):
    """After ``warmup(char, ref, sweep=True)`` of a Chinese character: solo
    ``tts`` with and without top-p, batches of two and three (the window
    batcher's B=2 and B=4) with and without top-p, slot requests with and
    without top-p, a slot-joined stream (its speculative first piece), a
    segmented stream, and a fused stream head with and without top-p, at
    the character's cap and at a cap of 12, take keys and variants the
    sweep prepared (no miss, no new variant), the joins included (the
    prefill, insert, release and speculative-codes programs), and so does
    the BERT hook's RoBERTa at each text's token bucket; the sweep
    prepared every segment, insert and release graph of the slot and
    stream geometries, and left the state the slot machine then takes."""
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert

    eng, char, ref = _sweep_case(kv_int8, language="Chinese")
    n = eng.warmup(char, ref, sweep=True)
    cache = graphs.cache_for(char.t2s_params)
    keys = cache.keys()
    programs = cache.programs()
    segs = [k for k in keys if k[0] == "segment" and k[1] == eng.cfg.slot_batch]
    assert len(segs) == 2 * 2               # widths 8 and 4, top-p flag
    stream_segs = [k for k in keys if k[0] == "segment" and k[1] == 1]
    assert len(stream_segs) == 2
    assert {(k, v) for k, v in programs if k[0] == "join"} == {
        (("join", 24, 16, torch.float32), (bert, top_p))
        for bert in (False, True) for top_p in (False, True)}
    # one insert graph per geometry (slot and stream), no key per state
    inserts = [k for k in keys if k[0] == "insert"]
    assert sorted(k[3][1] for k in inserts) == [1, eng.cfg.slot_batch]
    assert [k[1][1] for k in keys if k[0] == "release"] == [eng.cfg.slot_batch]
    # rows 1, 2 and 4 x widths 8 and 4: 5 codes claimed, within either
    assert len([k for k in keys if k[0] == "spec_codes"]) == 3 * 2
    rcache = graphs.cache_for(tiny_roberta)
    assert rcache.family and sorted(rcache.keys()) == [("roberta", T)
                                                       for T in (32, 64, 128, 256)]
    gens = [k for k in keys if k[0] == "generate"]
    assert len(gens) == 3 * 2               # B 1/2/4 x phoneme buckets
    assert {(k, v) for k, v in programs if k[0] == "generate"} == {
        (k, v) for k in gens for top_p in (False, True)
        for v in [("prefill", True, top_p)] + [(n, top_p) for n in tt2s.DECODE_BLOCKS]}
    assert n > len(keys) and cache.stats["captures"] == 0     # no card here
    vcache = graphs.cache_for(char.sovits_params)
    vkeys = vcache.keys()
    assert {k[0] for k in vkeys} == {"latent", "vocode"} and vcache.family
    assert vcache.stats["captures"] == 0 and vcache is not cache
    cache.reset_stats()
    vcache.reset_stats()

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
    pooled = [st for pool in eng._slot_states.values() for st in pool]
    sb = SlotBatcher(eng, char, pcm16=True)
    assert any(sb._state is st for st in pooled)          # the sweep's state
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
    rcache.reset_stats()
    for text in ZH_TEXTS:
        assert np.abs(get_phones_and_bert(text, "zh")[1]).sum() > 0
    assert rcache.stats["hits"] == len(ZH_TEXTS)
    assert rcache.stats["misses"] == rcache.stats["variants"] == 0
    # the SoVITS programs of every route: solo, the window batcher, the
    # slot finisher and window pump, and both stream routes
    assert vcache.stats["hits"] > 0
    assert vcache.stats["misses"] == 0, set(vcache.keys()) - set(vkeys)
    assert vcache.stats["variants"] == 0


def test_slot_machines_own_their_state():
    """The slot machine made after a sweep takes the sweep's state; a
    second machine on the same engine and character gets one of its own;
    the two take turns in the configuration's resident state (the second
    one's requests move the first one's state out and back), a second
    sweep of the configuration runs 0 units, and the first machine's
    state (its leaves and its ring head) stays as its own requests left
    it."""
    eng, char, ref = _sweep_case(True)
    assert eng.warmup(char, ref, sweep=True) > 0
    pooled = [st for pool in eng._slot_states.values() for st in pool]
    a, b = SlotBatcher(eng, char, pcm16=True), SlotBatcher(eng, char, pcm16=True)
    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    try:
        assert any(a._state is st for st in pooled) and b._state is not a._state
        a.synthesize(ref, short, bert, timeout=120, max_steps=12)
        b.synthesize(ref, short, bert, timeout=120, max_steps=12)
        before = tslots.clone_state(a._state)
        assert int(a._state.ring_head) == a._head != 0
        assert eng.warmup(char, ref, sweep=True) == 0
        b.synthesize(ref, short, bert, timeout=120, max_steps=12)
        for f in dataclasses.fields(before):
            x = getattr(before, f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(a._state, f.name)), f.name
        a.synthesize(ref, short, bert, timeout=120, max_steps=12)
        assert int(a._state.ring_head) == a._head
    finally:
        a.stop()
        b.stop()


@pytest.fixture
def warm_server(tmp_path, monkeypatch):
    """The port's server on the CPU as ``serve --warmup`` leaves it
    (``api.sweep_on_reference``), with a small bucket ladder; yields (base
    URL, a tiny character's dir, a reference wav)."""
    from genie_tts_tpu_torch import api
    from test_torch_pair import write_character

    char_dir, hub, ref = write_character(tmp_path)
    eng = TTSEngine(RuntimeConfig(
        phoneme_buckets=(32, 64, 128), prompt_buckets=(32, 128), frame_buckets=(32, 64),
        batch_buckets=(1, 2), slot_batch=2, slot_steps=8, slot_phoneme_bucket=64,
        slot_prompt_bucket=128, batch_window_ms=1.0))
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(hub))
    monkeypatch.setattr(api, "engine", eng)
    monkeypatch.setattr(api, "_batcher", None)
    monkeypatch.setattr(api, "sweep_on_reference", True)
    srv = api.start_server(host="127.0.0.1", port=0, block=False, device="cpu")
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", char_dir, ref
    finally:
        srv.shutdown()
        srv.server_close()
        for name in ("w1", "w2", "w3"):
            api.unload_character(name)
            api._reference_audios.pop(name, None)
        if api._batcher is not None:
            api._batcher.stop()


def _post(base, path, payload):
    import urllib.request

    req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, r.read()


def _load_and_reference(base, name, char_dir, ref):
    for path, payload in (("/load_character", {"character_name": name,
                                                "model_dir": str(char_dir), "language": "ja"}),
                          ("/set_reference_audio", {"character_name": name,
                                                    "audio_path": str(ref),
                                                    "audio_text": "こんにちは、てすとです",
                                                    "language": "ja"})):
        assert _post(base, path, payload)[0] == 200


def _caches(char):
    return graphs.cache_for(char.t2s_params), graphs.cache_for(char.sovits_params)


def test_warmup_server_sweeps_each_character_at_its_reference(warm_server):
    """With ``serve --warmup``'s flag, the first character of a
    configuration is swept at its ``/set_reference_audio`` (its decode and
    SoVITS keys exist before its first request); a second character of
    the same configuration shares its caches, sweeps nothing (no miss and
    no new variant at its reference) and serves with no miss and no new
    variant; a later reference at a swept prompt bucket sweeps nothing."""
    from genie_tts_tpu_torch import api

    base, char_dir, ref = warm_server
    _load_and_reference(base, "w1", char_dir, ref)
    first = api.model_manager.get("w1")
    assert len(api.engine.swept) == 1
    t2s_cache, vcache = _caches(first)
    assert any(k[0] == "generate" for k in t2s_cache.keys())
    assert any(k[0] == "latent" for k in vcache.keys())
    for c in (t2s_cache, vcache):
        c.reset_stats()
    _load_and_reference(base, "w2", char_dir, ref)
    second = api.model_manager.get("w2")
    assert _caches(second) == (t2s_cache, vcache) and second is not first
    assert len(api.engine.swept) == 1
    for c in (t2s_cache, vcache):
        assert c.stats["misses"] == c.stats["variants"] == 0, c.stats
    for name in ("w2", "w1"):
        status, body = _post(base, "/tts", {"character_name": name, "text": "きょうは。",
                                            "split_sentence": False})
        assert status == 200 and len(body) > 0
    for c in (t2s_cache, vcache):
        assert c.stats["hits"] > 0 and c.stats["misses"] == c.stats["variants"] == 0
        assert c.stats["binds"] > 0          # each character bound the bank in turn
    assert api.warmup_character("w1") == api.warmup_character("w2") == 0


def test_evicted_character_is_released_and_swept_again_at_reload(warm_server, monkeypatch):
    """A character evicted by the character cache (capacity 1 here) frees
    its weights (gone after ``gc.collect()``, its slot machine stopped)
    and leaves its configuration's graph caches; its next request reloads
    it with no sweep (0 units) and misses nothing."""
    import gc
    import weakref

    from genie_tts_tpu_torch import api

    base, char_dir, ref = warm_server
    _load_and_reference(base, "w1", char_dir, ref)
    assert _post(base, "/tts", {"character_name": "w1", "text": "きょうは。",
                                "split_sentence": False})[0] == 200
    old = api.model_manager.get("w1")
    gone = [weakref.ref(x) for x in (old, old.t2s_params["audio_embed"])]
    caches = _caches(old)
    sb = api._slot_batchers["w1"]
    del old
    monkeypatch.setattr(api.model_manager._cache, "capacity", 1)
    _load_and_reference(base, "w2", char_dir, ref)        # evicts w1
    assert "w1" not in api._slot_batchers
    sb._thread.join(timeout=60)
    assert not sb._thread.is_alive()
    del sb
    gc.collect()
    assert all(r() is None for r in gone), [r() is None for r in gone]
    swept = set(api.engine.swept)
    for c in caches:
        assert c.keys()
        c.reset_stats()
    assert _post(base, "/tts", {"character_name": "w1", "text": "きょうは。",
                                "split_sentence": False})[0] == 200    # reloads w1
    new = api.model_manager.get("w1")
    assert _caches(new) == caches and api.engine.swept == swept
    for c in caches:
        assert c.stats["hits"] > 0 and c.stats["misses"] == c.stats["variants"] == 0


def test_request_in_flight_across_an_eviction_finishes(warm_server, monkeypatch):
    """A request decoding in its character's slot machine when another
    load evicts the character finishes with the audio it would have had:
    the evicted machine drains (its queue and slots), then exits, and the
    character is gone after ``gc.collect()`` while its configuration's
    graph caches stay."""
    import gc
    import weakref

    from genie_tts_tpu_torch import api

    base, char_dir, ref = warm_server
    _load_and_reference(base, "w1", char_dir, ref)
    payload = {"character_name": "w1", "text": "きょうは。", "split_sentence": False}
    sb = api._slot_batchers.get("w1")
    if sb is None:                       # built by the first request
        assert _post(base, "/tts", payload)[0] == 200
        sb = api._slot_batchers["w1"]
    sb._reset_state()                    # the same ring head and noise draws for both
    status, want = _post(base, "/tts", payload)
    assert status == 200 and len(want) > 0
    sb._reset_state()
    # hold the machine's next segment until the eviction is done
    entered, release = threading.Event(), threading.Event()
    dispatch = sb._dispatch_segment

    def held(w):
        entered.set()
        assert release.wait(120)
        return dispatch(w)

    monkeypatch.setattr(sb, "_dispatch_segment", held)
    got = {}
    client = threading.Thread(target=lambda: got.update(r=_post(base, "/tts", payload)))
    client.start()
    assert entered.wait(120)             # the request sits in a slot
    old = api.model_manager.get("w1")
    gone = [weakref.ref(old)]
    caches = _caches(old)
    del old
    monkeypatch.setattr(api.model_manager._cache, "capacity", 1)
    assert _post(base, "/load_character", {"character_name": "w2", "model_dir": str(char_dir),
                                           "language": "ja"})[0] == 200    # evicts w1
    assert "w1" not in api.model_manager._cache and "w1" not in api._slot_batchers
    assert sb._thread.is_alive()         # still serving what it holds
    release.set()
    client.join(120)
    assert got["r"] == (200, want)
    sb._thread.join(timeout=60)
    assert not sb._thread.is_alive()
    monkeypatch.undo()                   # drops the wrapper's hold on the machine
    del sb, dispatch, held
    gc.collect()
    assert all(r() is None for r in gone), [r() is None for r in gone]
    assert all(c.keys() for c in caches)


def test_trace_writes_a_trace_file(tmp_path):
    with trace(str(tmp_path / "t")):
        torch.ones(8).cumsum(0)
    with open(tmp_path / "t" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("cumsum" in e.get("name", "") for e in events)
    with trace(None):                       # no directory: nothing traced
        pass
