"""The tp-sharded routes as graphs of their parameter set's cache, and
every dp replica swept, on the CPU.

A tp-sharded T2S set (``engine.shard_character`` on a mesh whose rows
hold more than one device) serves every route from programs over static
buffers in its own ``GraphCache``, as a whole set does: ``generate``
(key route "tp", a cache per shard on its device), the slot join, insert,
release and segments, and the segmented stream. On the card each is a
replay of one captured graph per dp row; here the same programs run
eagerly on the same buffers, under the same keys. Meshes repeat
``"cpu"`` (``["cpu"] * n``), so every line of the dp and tp code runs.
The tiny T2S of tests/test_torch_dp_serving.py, fp32:

* after ``engine.warmup(sweep=True)`` of a 1x2 character its T2S cache
  holds the "tp" decode keys and the join, insert, release and segment
  keys, and solo, batched, slot and segmented-stream requests then add no
  miss and no variant to any cache;
* greedy codes through the cached tp buffers equal the JAX package's
  ``generate_e2e`` on ``shard_params(..., make_mesh(dp=1, tp=2))`` and the
  port's 1x1 ``generate`` (identical tokens and lengths), and
  ``eager=True`` on the same buffers gives the same tokens;
* a tp slot join and segment on a persistent state give the 1x1 codes
  and state, exact KV and int8 KV (integers identical, caches within
  1e-5, int8 codes within one step);
* on a 2x1 mesh a sweep warms replica 1 too: a batch of 4 afterwards adds
  no miss to any replica's T2S or SoVITS cache;
* unloading a 2x2 character frees every replica's caches.
"""
import copy
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops.sampling import SamplingRows
from genie_tts_tpu_torch.runtime import graphs
from genie_tts_tpu_torch.runtime.engine import TTSEngine
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher
from test_torch_dp_serving import GREEDY, TCFG, _character, _cpu_mesh, _placed, _to_jax
from test_torch_graphs import TINY_T2S, _sweep_case

V = TCFG.semantic_vocab


@pytest.fixture(scope="module")
def setup():
    return _character(TCFG)


def _tp_char(char, dp=1, tp=2):
    eng, c = _placed(_cpu_mesh(dp, tp), char)
    assert all(len(r.t2s_params["layer_shards"]) == tp for r in c.replicas)
    return eng, c


def _inputs(B, seed=3):
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, TCFG.phoneme_vocab, (B, 8)).astype(np.int32)
    prompts = rng.integers(0, V - 1, (B, 12)).astype(np.int32)
    x_len = np.array([8, 5, 7, 3][:B], np.int32)
    p_len = np.array([12, 9, 4, 12][:B], np.int32)
    return phones, prompts, x_len, p_len


@pytest.mark.parametrize("B", [1, 4])
def test_tp_generate_through_its_graph_matches_jax_and_1x1(setup, B):
    """Greedy fp32 codes of the tp route through the buffers of its cached
    graph (key route "tp", tp degree 2): identical to the JAX package's
    ``generate_e2e`` on a tp=2 mesh and to the port's 1x1 ``generate``;
    the same programs run with ``eager=True`` on the same buffers give the
    same tokens, counts and steps."""
    import jax
    import jax.numpy as jnp

    from genie_tts_tpu.config import T2SConfig as JT2SConfig
    from genie_tts_tpu.models import t2s as jt2s
    from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
    from genie_tts_tpu.parallel.mesh import make_mesh, shard_params

    _, char, _, _ = setup
    _, c = _tp_char(char)
    params = c.t2s_params
    phones, prompts, x_len, p_len = _inputs(B)
    args = dict(max_steps=8, cache_len=8 + 12 + 8, min_steps=8)
    jparams, _ = shard_params(_to_jax(char.t2s_params), make_mesh(dp=1, tp=2))
    fn = jax.jit(jt2s.generate_e2e,
                 static_argnames=("cfg", "scfg", "max_steps", "cache_len",
                                  "min_steps", "use_flash", "layer_unroll"))
    codes_j, len_j = fn(jparams, JT2SConfig(**dataclasses.asdict(TCFG)),
                        JSampling(top_k=1, repetition_penalty=1.35), jax.random.PRNGKey(0),
                        jnp.asarray(phones), None, jnp.asarray(x_len), jnp.asarray(prompts),
                        jnp.asarray(p_len), **args)

    def port(p, eager=False):
        x = (torch.as_tensor(phones).long(), torch.zeros((B, 8, TCFG.bert_dim)))
        with torch.inference_mode():
            res = t2s.generate(p, TCFG, GREEDY, None, x, torch.as_tensor(x_len).long(),
                               torch.as_tensor(prompts).long(),
                               torch.as_tensor(p_len).long(), eager=eager, **args)
        return res, t2s.finalize_tokens_device(res.tokens, res.counts, TCFG.eos_id)

    cache = graphs.cache_for(params)
    cache.reset_stats()
    res, (codes, n) = port(params)
    key = t2s._generate_key(B, 8, 12, args["cache_len"], 8, torch.float32, tp=2)
    assert key[:2] == ("generate", "tp") and key in cache.keys()
    assert cache.stats["misses"] == 1
    np.testing.assert_array_equal(np.asarray(len_j), n.numpy())
    np.testing.assert_array_equal(np.asarray(codes_j), codes.numpy())
    # the port's 1x1 route (fused for B = 1, flash for B = 4)
    _, (codes1, n1) = port(char.t2s_params)
    np.testing.assert_array_equal(codes1.numpy(), codes.numpy())
    np.testing.assert_array_equal(n1.numpy(), n.numpy())
    eager, _ = port(params, eager=True)
    assert cache.stats["misses"] == 1          # the same graph's buffers
    np.testing.assert_array_equal(eager.tokens.numpy(), res.tokens.numpy())
    np.testing.assert_array_equal(eager.counts.numpy(), res.counts.numpy())
    assert eager.steps == res.steps
    assert n.min() > 3, "degenerate decode; reseed the fixture"


def _join_and_segment(params, state, req, noise0, seg_noise, kv_kernel):
    """Join ``req`` into slot 1 of ``state`` through the join and insert
    graphs of ``params``, then one segment of 8 steps through its graph."""
    samp = SamplingRows(*(torch.tensor([v]) for v in (1, 1.0, 1.0, 1.35)))
    ctx_k, ctx_v, tok0, hist = tslots.prefill_join(
        params, TCFG, torch.as_tensor(req[0]).long(), None, torch.tensor([req[2]]),
        torch.as_tensor(req[1]).long(), torch.tensor([req[3]]), samp, noise=noise0,
        any_top_p=False)
    tslots.insert_slot(state, 1, ctx_k, ctx_v, tok0, hist, req[2], req[3], 0, 24,
                       SamplingRows(1, 1.0, 1.0, 1.35), params=params)
    _, seg = tslots.decode_segment(params, state, TCFG, 8, 16, 16, 32, kv_kernel=kv_kernel,
                                   noise=seg_noise)
    return tok0, seg


@pytest.mark.parametrize("kv_int8,kv_kernel", [(False, False), (True, True), (True, False)],
                         ids=["exact", "int8_kernel", "int8_masked"])
def test_tp_slot_join_and_segment_match_1x1(setup, kv_int8, kv_kernel):
    """The join (``("join", "tp", ...)``), insert and segment graphs of a
    tp set on a persistent state sharded over 2 shards give the 1x1 set's
    first token, segment codes and small state exactly, and its caches
    shard for shard (fp32 within 1e-5; int8 codes within one step). The
    exact caches' attention (``ops/slot_attention.py``, its plain version
    here), the int8 kernel's and the int8 masked read run per shard."""
    _, char, _, _ = setup
    _, c = _tp_char(char)
    rng = np.random.default_rng(5)
    phones = np.zeros((1, 16), np.int64)
    phones[0, :11] = rng.integers(1, TCFG.phoneme_vocab, 11)
    prompts = np.zeros((1, 16), np.int64)
    prompts[0, :9] = rng.integers(0, V - 1, 9)
    req = (phones, prompts, 11, 9)
    g = torch.Generator().manual_seed(1)
    noise0 = torch.rand((1, V), generator=g)
    seg_noise = torch.rand((8, 4, V), generator=g)
    out = {}
    for name, params in (("1x1", char.t2s_params), ("tp", c.t2s_params)):
        state = dataclasses.replace(tslots.init_slots(
            TCFG, 4, 16, 16, 32, dtype=torch.float32, kv_int8=kv_int8,
            tp_devices=t2s.shard_devices(params)), persistent=True)
        tok0, seg = _join_and_segment(params, state, req, noise0, seg_noise, kv_kernel)
        out[name] = (tok0, seg, state)
        keys = graphs.cache_for(params).keys()
        join = ("join", "tp") if name == "tp" else ("join", 16)
        assert any(k[:2] == join for k in keys)
        # the insert and segment graphs of the geometry, on its resident
        # state, which holds ``state`` (its leaves are the graphs' buffers)
        assert {"insert", "segment"} <= {k[0] for k in keys}
        with tslots.holding(params, state):
            home = graphs.cache_for(params).shared(
                ("slot_state",) + tslots._geometry_key(state), None).state
            assert state.k_cache is home.k_cache
    (t1, s1, st1), (t2, s2, st2) = out["1x1"], out["tp"]
    assert len(st2.tp_caches) == 1 and st2.k_cache.shape[2] == TCFG.num_heads // 2
    assert torch.equal(t1, t2) and torch.equal(s1, s2)
    assert len(set(s1[1].tolist())) > 2, "degenerate decode; reseed"
    for leaf in ("cur_tok", "keys_written", "counts", "done", "active", "hist",
                 "ring_head"):
        assert torch.equal(getattr(st1, leaf), getattr(st2, leaf)), leaf
    whole = st1.cache_shards[0]
    for j in range(4):
        if whole[j] is None:
            continue
        merged = torch.cat([sh[j] for sh in st2.cache_shards], dim=2)
        if merged.dtype == torch.int8:
            assert (merged.int() - whole[j].int()).abs().max() <= 1
        else:
            np.testing.assert_allclose(merged.numpy(), whole[j].numpy(), rtol=1e-5,
                                       atol=1e-5)


def _mesh_sweep_case(dp, tp, kv_int8=True):
    eng, char, ref = _sweep_case(kv_int8)
    mesh_eng = TTSEngine(eng.cfg, mesh=_cpu_mesh(dp, tp))
    mesh_eng.shard_character(char)
    return mesh_eng, char, ref


def _stats(eng, char):
    return [dict(c.stats) for c in eng.graph_caches(char)]


def test_sweep_of_a_tp_character_covers_its_routes():
    """``warmup(sweep=True)`` of a 1x2 character prepares the "tp" decode
    keys, the tp join and the insert, release and segment graphs of the
    slot and stream states; then solo, batched (B=2 and B=4), slot and
    segmented-stream requests add no miss and no variant."""
    eng, char, ref = _mesh_sweep_case(1, 2)
    n = eng.warmup(char, ref, sweep=True)
    cache = graphs.cache_for(char.t2s_params)
    keys = cache.keys()
    gens = [k for k in keys if k[0] == "generate"]
    assert gens and {k[1] for k in gens} == {"tp"} and {k[-1] for k in gens} == {2}
    assert {k[2] for k in gens} == {1, 2, 4}
    assert {k[:2] for k in keys if k[0] == "join"} == {("join", "tp")}
    segs = [k for k in keys if k[0] == "segment"]
    assert {k[1] for k in segs} == {eng.cfg.slot_batch, 1}  # slot and stream geometries
    assert sorted(k[3][1] for k in keys if k[0] == "insert") == [1, eng.cfg.slot_batch]
    assert any(k[0] == "release" for k in keys)
    assert any(k[0] == "spec_codes" for k in keys) and n > len(keys)
    assert eng.graph_caches(char)[0] is cache and len(eng.graph_caches(char)) == 2
    for c in eng.graph_caches(char):
        c.reset_stats()

    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    eng.synthesize_utterance(char, ref, short, bert, seed=1, max_steps=12)
    for rows in (2, 3):
        eng.synthesize_batch(char, [(ref, short, bert)] * rows, seed=1, max_steps=12)
    pooled = [st for pool in eng._slot_states.values() for st in pool]
    sb = SlotBatcher(eng, char, pcm16=True)
    assert bool(sb._state.tp_caches) and any(sb._state is st for st in pooled)
    try:
        sb.synthesize(ref, short, bert, timeout=120, max_steps=12)
    finally:
        sb.stop()
    list(eng.synthesize_utterance_stream(char, ref, short, bert, seed=1, max_steps=12))
    for st in _stats(eng, char):
        assert st["hits"] > 0 and st["misses"] == 0 and st["variants"] == 0, st


def test_sweep_warms_every_dp_replica():
    """On a 2x1 mesh the sweep prepares replica 1's decode (B = 1 per row
    on the fused route, 2 on the flash route) and finisher programs; a
    batch of 4 (2 rows per replica) then adds no miss to any replica's
    T2S or SoVITS cache, and the log of captures counts both replicas."""
    eng, char, ref = _mesh_sweep_case(2, 1)
    eng.warmup(char, ref, sweep=True)
    rep1 = char.replicas[1]
    gens = [k for k in graphs.cache_for(rep1.t2s_params).keys() if k[0] == "generate"]
    assert {(k[1], k[2]) for k in gens} == {("fused", 1), ("flash", 2)}
    assert graphs.cache_for(rep1.sovits_params).keys()
    caches = eng.graph_caches(char)
    assert len(caches) == 4 and len({id(c) for c in caches}) == 4
    for c in caches:
        c.reset_stats()
    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    eng.synthesize_batch(char, [(ref, short, bert)] * 4, seed=1, max_steps=12)
    for st in _stats(eng, char):
        assert st["hits"] > 0 and st["misses"] == 0 and st["variants"] == 0, st


def test_unloading_a_2x2_character_frees_every_replica(tmp_path, monkeypatch):
    """A character loaded through the API onto a 2x2 mesh and served in a
    batch (both replicas' graphs made) is freed with every replica once
    unloaded (``gc.collect()``); the replicas' graph caches, four
    configurations (replica 1's marked with its row), stay for the next
    character."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.runtime.engine import make_random_reference
    from test_torch_pair import write_character

    char_dir, _, _ = write_character(tmp_path)
    eng = TTSEngine(RuntimeConfig(phoneme_buckets=(32,), prompt_buckets=(32,),
                                  frame_buckets=(32, 64), batch_buckets=(1, 2, 4)),
                    mesh=_cpu_mesh(2, 2))
    monkeypatch.setattr(api, "engine", eng)
    monkeypatch.setattr(api, "_batcher", None)
    api.load_character("m22", char_dir, "ja", device="cpu")
    char = api.model_manager.get("m22")
    ref = make_random_reference(char, eng, ref_seconds=0.2)
    ref.prompt_tokens = ref.prompt_tokens[:8]
    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), char.t2s_cfg.bert_dim), np.float32)
    eng.synthesize_batch(char, [(ref, short, bert)] * 4, seed=1, max_steps=6)
    caches = eng.graph_caches(char)
    assert len(caches) == 4 and all(c.keys() for c in caches)
    assert len({id(c) for c in caches}) == 4
    gone = [weakref.ref(x) for x in (char, *char.replicas)]
    del char
    api.unload_character("m22")
    gc.collect()
    assert all(r() is None for r in gone), [r() is None for r in gone]
    assert all(c.keys() for c in caches)


def test_tp_segment_on_a_copied_state_matches_eager(setup):
    """A tp join and segment on a state that is not persistent run on a
    copy in the graphs' buffers (its shards' caches copied into the
    resident state and back) and give the eager baseline's codes and
    caches."""
    _, char, _, _ = setup
    _, c = _tp_char(char)
    params = c.t2s_params
    rng = np.random.default_rng(9)
    phones = np.zeros((1, 16), np.int64)
    phones[0, :7] = rng.integers(1, TCFG.phoneme_vocab, 7)
    prompts = np.zeros((1, 16), np.int64)
    prompts[0, :5] = rng.integers(0, V - 1, 5)
    g = torch.Generator().manual_seed(2)
    noise0, seg_noise = torch.rand((1, V), generator=g), torch.rand((8, 4, V), generator=g)
    states = []
    for eager in (False, True):
        st = tslots.init_slots(TCFG, 4, 16, 16, 32, dtype=torch.float32,
                               tp_devices=t2s.shard_devices(params))
        samp = SamplingRows(*(torch.tensor([v]) for v in (1, 1.0, 1.0, 1.35)))
        ctx_k, ctx_v, tok0, hist = tslots.prefill_join(
            params, TCFG, torch.as_tensor(phones), None, torch.tensor([7]),
            torch.as_tensor(prompts), torch.tensor([5]), samp, noise=noise0, any_top_p=False)
        tslots.insert_slot(st, 0, ctx_k, ctx_v, tok0, hist, 7, 5, 0, 24,
                           SamplingRows(1, 1.0, 1.0, 1.35), params=params)
        _, seg = tslots.decode_segment(params, st, TCFG, 8, 16, 16, 32, noise=seg_noise,
                                       eager=eager)
        states.append((copy.copy(st), seg))
    (a, seg_a), (b, seg_b) = states
    assert torch.equal(seg_a, seg_b)
    for x, y in zip(a.cache_shards, b.cache_shards):
        for u, v in zip(x, y):
            assert (u is None and v is None) or torch.equal(u, v)
    segs = [k for k in graphs.cache_for(params).keys() if k[0] == "segment"]
    assert segs and not a.persistent
