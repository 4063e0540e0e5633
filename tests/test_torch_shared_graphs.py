"""One graph set per configuration, as the JAX programs are, on the CPU.

The JAX package jits every stage with the parameters as arguments, so one
compile serves every character of the same shapes. The port's graphs read
a BANK of their configuration (``runtime/graphs.py``): a character binds
it (its tensors copied in when the bank holds another's) before a replay,
and a slot geometry's graphs replay on a RESIDENT state that holds one
machine's state at a time (``models/slots.py::StateHome``). Here the
programs run eagerly on the bank and the resident state, so the bind and
the switches run as on the card. Tiny fp32 configurations, weights from
the JAX ``init_params`` with two seeds, inputs from numpy seeds:

* two characters of one configuration share one cache; interleaved (A,
  B, A), each one's greedy ``generate`` tokens (the fused B=1 route on
  its plain version, the flash B=4 route) are the JAX package's for that
  character, and each one's SoVITS latent and vocode are the JAX
  package's within the tolerances of tests/test_torch_sovits_graphs.py;
* two persistent slot states of two characters, joined and decoded
  segment by segment in turn, leaf by leaf and token by token equal to
  the JAX slot machine of each character (the resident state switching
  between them at every segment);
* two characters' slot machines running at once, and their segmented
  streams interleaved, give each character what it gives alone;
* a sweep of one character leaves the other with no miss on every route,
  and a second sweep of the configuration runs 0 units;
* other configurations (int8 against float weights, V2 against
  V2ProPlus, another layer count, a dp replica's row) get other caches;
* a process that serves a character through its slot machine, unloads it
  with requests in flight and ends at once exits with code 0.
"""
import dataclasses
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import slots as tslots
from genie_tts_tpu_torch.models import sovits as tsovits
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.runtime import graphs
from genie_tts_tpu_torch.runtime.engine import TTSEngine, make_random_character
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher
from genie_tts_tpu_torch.runtime.stream import synthesize_stream_segments
from test_torch_graphs import SAMPLING, TINY_T2S, TINY_VITS, _sweep_case
from test_torch_slot_batcher import _reference
from test_torch_slots import JCFG as JCFG_S
from test_torch_slots import (RING, W, Pair, _request, assert_states_equal,  # noqa: F401
                              jax_kernel_interpret)
from test_torch_sovits_hubert import JV, TV, _inputs, _t
from test_torch_t2s import JCFG, SP, SX, TCFG, _inputs as _t2s_inputs, _lively

CAP = 21


def _t2s_pair(seed):
    jp = _lively(jt2s.init_params(jax.random.PRNGKey(seed), JCFG, dtype=jnp.float32), seed)
    return jp, params_from_numpy(jp, torch.float32)


@pytest.fixture(scope="module")
def t2s_chars():
    return [_t2s_pair(s) for s in (21, 22)]


@pytest.fixture(scope="module")
def sovits_chars():
    out = []
    for s in (31, 32):
        jp = jsovits.init_params(jax.random.PRNGKey(s), JV, dtype=jnp.float32)
        out.append((jp, params_from_numpy(jp, torch.float32)))
    return out


@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_interleaved_generate_gives_each_character_its_jax_tokens(t2s_chars, B):
    jscfg, scfg = SAMPLING["greedy"]
    phones, bert, x_len, prompts, p_len = _t2s_inputs(B)
    (_, ta), (_, tb) = t2s_chars
    cache = graphs.cache_for(ta)
    assert graphs.cache_for(tb) is cache and cache.bank is not None
    binds = cache.stats["binds"]
    want = {}
    for name, (jp, _) in zip("AB", t2s_chars):
        jx = jt2s.embed_text(jp, jnp.asarray(phones), jnp.asarray(bert))
        res = jt2s.generate(jp, JCFG, jscfg, jax.random.PRNGKey(0), jx, jnp.asarray(x_len),
                            jnp.asarray(prompts), jnp.asarray(p_len), max_steps=CAP,
                            cache_len=SX + SP + CAP)
        want[name] = (np.asarray(res.tokens), np.asarray(res.counts))
    assert not np.array_equal(want["A"][0], want["B"][0]), "the characters agree; reseed"
    for name in "ABA":
        tp = ta if name == "A" else tb
        res = tt2s.generate(tp, TCFG, scfg, None, (_t(phones), _t(bert)), _t(x_len),
                            _t(prompts), _t(p_len), max_steps=CAP, cache_len=SX + SP + CAP,
                            noise=torch.zeros((CAP, B, TCFG.semantic_vocab)))
        np.testing.assert_array_equal(res.tokens.numpy(), want[name][0])
        np.testing.assert_array_equal(res.counts.numpy(), want[name][1])
    assert cache.stats["binds"] >= binds + 2          # B in, then A back


def test_interleaved_sovits_gives_each_character_its_jax_audio(sovits_chars):
    (_, ta), (_, tb) = sovits_chars
    cache = graphs.cache_for(ta)
    assert graphs.cache_for(tb) is cache and cache.family
    codes, codes_len, text, text_len, ge = _inputs(B=2, Ts=20, Tx=9, seed=7)
    key = jax.random.PRNGKey(5)
    noise = np.array(jax.random.normal(key, (2, 40, TV.inter_channels), dtype=jnp.float32))
    want = {}
    for name, (jp, _) in zip("AB", sovits_chars):
        jz = jsovits.synthesize_latent(jp, JV, key, *(jnp.asarray(a) for a in
                                                      (codes, codes_len, text, text_len,
                                                       ge, ge)), noise_scale=0.5)
        ja = jsovits.vocode_frames(jp, JV, jz, jnp.asarray(ge), 2 * jnp.asarray(codes_len))
        want[name] = (np.asarray(jz), np.asarray(ja))
    assert np.abs(want["A"][1] - want["B"][1]).max() > 1e-3, "the characters agree; reseed"
    binds = cache.stats["binds"]
    for name in "ABA":
        tp = ta if name == "A" else tb
        z = tsovits.latent(tp, TV, *(_t(a) for a in (codes, codes_len, text, text_len, ge, ge)),
                           0.5, noise=_t(noise))
        np.testing.assert_allclose(z.numpy(), want[name][0], rtol=1e-4, atol=1e-4)
        audio = tsovits.vocode(tp, TV, z, _t(ge), 2 * _t(codes_len))
        np.testing.assert_allclose(audio.numpy(), want[name][1], rtol=2e-4, atol=2e-4)
    assert cache.stats["binds"] >= binds + 2


@pytest.fixture(scope="module")
def slot_chars():
    """Two slot-test T2S sets (tests/test_torch_slots.py's configuration)
    of different seeds."""
    out = []
    for s in (41, 42):
        jp = _lively(jt2s.init_params(jax.random.PRNGKey(s), JCFG_S, dtype=jnp.float32), s)
        out.append((jp, params_from_numpy(jp, torch.float32)))
    return out


@pytest.mark.parametrize("kv_int8", [False, True], ids=["exact", "int8_kernel"])
def test_state_switches_keep_each_machine_equal_to_jax(slot_chars, jax_kernel_interpret,
                                                       kv_int8):
    """Two characters' persistent states, joined and decoded in turn, each
    against its own JAX slot machine after every segment; the resident
    state switches at every segment (each state is resident while it
    runs, and back in buffers of its own after)."""
    pairs = [Pair(p, kv_int8, kv_int8) for p in slot_chars]
    for i, pair in enumerate(pairs):
        pair.t = dataclasses.replace(pair.t, persistent=True)
        pair.join(1, _request(3 + i, 6, 4), 8, RING, same_ctx=True)
        pair.join(2, _request(5 + i, 5, 3), 8, 16, same_ctx=True)
    for seg in range(RING // W):
        for pair, other in (pairs, pairs[::-1]):
            jtok, ttok = pair.segment()
            np.testing.assert_array_equal(ttok, jtok)
            # the one that ran is resident; the other is in its own buffers
            home = tslots._home(pair.tp, pair.t)
            assert pair.t.k_cache is home.state.k_cache
            assert other.t.k_cache is not home.state.k_cache
            assert_states_equal(pair.j, pair.t)
            assert_states_equal(other.j, other.t)
    assert home.residency.switches >= 2 * (RING // W) - 1
    a, b = (np.concatenate(p.t.hist.numpy()) for p in pairs)
    assert not np.array_equal(a, b), "the characters agree; reseed"


def _two_characters(seed_a=3, seed_b=4, **kw):
    return [make_random_character(t2s_cfg=TINY_T2S, sovits_cfg=TINY_VITS, dtype=torch.float32,
                                  device="cpu", seed=s, **kw) for s in (seed_a, seed_b)]


SLOT_RT = dict(phoneme_buckets=(16, 32), prompt_buckets=(16,), frame_buckets=(32, 64),
               step_caps=(32,), batch_buckets=(1, 2, 4), slot_batch=4, slot_steps=8,
               slot_ring=32, slot_phoneme_bucket=24, slot_prompt_bucket=16,
               stream_seg_steps=8, vocode_chunk=16, vocode_halo=4, stream_chunk=16,
               stream_lookahead=2)


def test_machines_of_two_characters_at_once_give_each_its_own_audio():
    """Each character's slot machine alone, then both at once (two
    requests each, one after the other, the resident state switching
    between the machines), give the same audio per request; so do their
    segmented streams interleaved piece by piece."""
    chars = _two_characters()
    refs = [_reference(c, seed=i) for i, c in enumerate(chars)]
    phones = [np.arange(1, 7, dtype=np.int32), np.arange(3, 11, dtype=np.int32)]
    bert = [np.zeros((len(p), TINY_T2S.bert_dim), np.float32) for p in phones]

    def serve(which):
        eng = TTSEngine(RuntimeConfig(**SLOT_RT))
        sbs = {i: SlotBatcher(eng, chars[i], pcm16=True) for i in which}
        out, threads = {}, []

        def run(i):
            for j in range(2):          # in order: the machine's draws are the same
                out[i, j] = sbs[i].synthesize(refs[i], phones[j], bert[j], timeout=120,
                                              max_steps=16)

        try:
            threads = [threading.Thread(target=run, args=(i,)) for i in which]
            for t in threads:
                t.start()
            for t in threads:
                t.join(120)
        finally:
            for sb in sbs.values():
                sb.stop()
        return out

    alone = {**serve([0]), **serve([1])}
    together = serve([0, 1])
    assert set(together) == set(alone) and len(alone) == 4
    for k in alone:
        np.testing.assert_array_equal(together[k], alone[k])
    assert not np.array_equal(alone[0, 0], alone[1, 0]), "the characters agree; reseed"

    eng = TTSEngine(RuntimeConfig(**SLOT_RT))

    def stream(i):
        return synthesize_stream_segments(eng, chars[i], refs[i], phones[0], bert[0], seed=5,
                                          max_steps=24)

    want = [np.concatenate(list(stream(i))) for i in range(2)]
    got = [[], []]
    gens = [stream(0), stream(1)]
    live = [True, True]
    while any(live):                      # one piece of each stream in turn
        for i, g in enumerate(gens):
            if live[i]:
                piece = next(g, None)
                live[i] = piece is not None
                if piece is not None:
                    got[i].append(piece)
    for i in range(2):
        np.testing.assert_array_equal(np.concatenate(got[i]), want[i])


def test_sweep_of_one_character_warms_the_other():
    """After ``warmup(A, sweep=True)``, B of the same configuration shares
    every cache, a sweep of B runs 0 units, and B's solo, batched (B=2 and
    B=4), slot, slot-stream and segmented-stream requests miss nothing
    and prepare no variant."""
    eng, a, ref_a = _sweep_case(True)
    b = make_random_character(t2s_cfg=TINY_T2S, sovits_cfg=TINY_VITS, dtype=torch.float32,
                              device="cpu", seed=9)
    ref_b = _reference(b)
    assert eng.warmup(a, ref_a, sweep=True) > 0
    caches = eng.graph_caches(a)
    assert eng.graph_caches(b) == caches
    assert eng.warmup(b, ref_b, sweep=True) == 0
    for c in caches:
        c.reset_stats()
    short = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((len(short), TINY_T2S.bert_dim), np.float32)
    eng.synthesize_utterance(b, ref_b, short, bert, seed=1, max_steps=12)
    for rows in (2, 3):
        eng.synthesize_batch(b, [(ref_b, short, bert)] * rows, seed=1, max_steps=12)
    sb = SlotBatcher(eng, b, pcm16=True)
    try:
        sb.synthesize(ref_b, short, bert, timeout=120, max_steps=12)
        list(sb.synthesize_stream(ref_b, short, bert, timeout=120, max_steps=12))
    finally:
        sb.stop()
    list(eng.synthesize_utterance_stream(b, ref_b, short, bert, seed=1, max_steps=12))
    for c in caches:
        assert c.stats["hits"] > 0 and c.stats["misses"] == c.stats["variants"] == 0, c.stats
        assert c.stats["binds"] >= 1


def test_other_configurations_get_other_caches():
    a, b = _two_characters()
    t2s_cache = graphs.cache_for(a.t2s_params)
    assert graphs.cache_for(b.t2s_params) is t2s_cache
    assert graphs.cache_for(b.sovits_params) is graphs.cache_for(a.sovits_params)
    # int8 weights against float ones, and the float set again
    q = tt2s.quantize_params(a.t2s_params)
    assert graphs.cache_for(q) is not t2s_cache
    assert q["_packed"]["wqkv"].dtype == torch.int8
    assert graphs.cache_for(a.t2s_params) is t2s_cache
    # another layer count
    deep = make_random_character(t2s_cfg=dataclasses.replace(TINY_T2S, num_layers=3),
                                 sovits_cfg=TINY_VITS, dtype=torch.float32, device="cpu")
    assert graphs.cache_for(deep.t2s_params) is not t2s_cache
    # V2 against V2ProPlus synthesizers
    pp = make_random_character(t2s_cfg=TINY_T2S, sovits_cfg=dataclasses.replace(
        TINY_VITS, version="v2ProPlus"), dtype=torch.float32, device="cpu")
    assert graphs.cache_for(pp.sovits_params) is not graphs.cache_for(a.sovits_params)
    assert graphs.cache_for(pp.t2s_params) is t2s_cache
    # a dp replica's row
    row1 = dict(a.t2s_params, **{graphs.DP_ROW: 1})
    assert graphs.cache_for(row1) is not t2s_cache
    sigs = {graphs.signature(p) for p in (a.t2s_params, q, deep.t2s_params, row1)}
    assert len(sigs) == 4 and graphs.signature(b.t2s_params) in sigs


def test_bind_waits_for_the_resident_set_and_copies_once():
    """``GraphCache.bind``: holds of the resident set go straight through
    and nest; another set's bind waits until they end, then copies the
    set in (one switch, ``bind_bytes`` the bank's bytes); a thread that
    holds one set and asks for another raises."""
    a, b = _two_characters()
    cache = graphs.cache_for(a.t2s_params)
    with cache.bind(a.t2s_params):
        pass                              # A resident
    cache.reset_stats()
    entered = threading.Event()
    order = []

    def other():
        entered.set()
        with cache.bind(b.t2s_params) as bank:
            order.append("B")
            assert torch.equal(bank["audio_embed"], b.t2s_params["audio_embed"])

    with cache.bind(a.t2s_params) as bank:
        with cache.bind(a.t2s_params) as inner:
            assert inner is bank
        t = threading.Thread(target=other)
        t.start()
        assert entered.wait(30)
        t.join(0.2)
        assert t.is_alive() and not order       # waiting for A's hold
        assert torch.equal(bank["audio_embed"], a.t2s_params["audio_embed"])
        order.append("A")
        with pytest.raises(RuntimeError):
            with cache.bind(b.t2s_params):
                pass
    t.join(30)
    assert order == ["A", "B"]
    assert cache.stats["binds"] == 1 and cache.stats["bind_bytes"] == cache.bank_bytes() > 0
    with cache.bind(b.t2s_params, eager=True) as own:
        assert own is b.t2s_params


def test_binds_from_many_threads_never_read_another_set():
    """24 threads (more than the cores), each binding one of three sets of
    a configuration in turn, with a shortened switch interval: inside
    every bind the bank holds exactly that set (a switch while another
    set's hold is live would break it), nested binds pass, and every
    thread finishes in time."""
    chars = _two_characters() + _two_characters(seed_a=5, seed_b=5)[:1]
    sets = [c.t2s_params for c in chars]
    cache = graphs.cache_for(sets[0])
    assert all(graphs.cache_for(p) is cache for p in sets)
    bad, done = [], []

    def worker(i):
        try:
            for k in range(30):
                params = sets[(i + k) % 3]
                with cache.bind(params) as bank:
                    with cache.bind(params) as again:
                        ok = again is bank
                    ok &= torch.equal(bank["audio_embed"], params["audio_embed"])
                    ok &= torch.equal(bank["_packed"]["wqkv"], params["_packed"]["wqkv"])
                    if not ok:
                        bad.append((i, k))
            done.append(i)
        except Exception as e:  # noqa: BLE001 — reported below
            bad.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == 24 and not bad, bad
    assert cache.stats["binds"] > 0


CHILD = textwrap.dedent('''
    import os
    import sys
    import threading
    import time

    import numpy as np

    char_dir, hub, ref = sys.argv[1:4]
    os.environ["GENIE_HUBERT_DIR"] = hub
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.runtime.engine import TTSEngine

    api.engine = TTSEngine(RuntimeConfig(
        phoneme_buckets=(32, 64), prompt_buckets=(32, 128), frame_buckets=(32, 64),
        batch_buckets=(1, 2), slot_batch=2, slot_steps=8, slot_phoneme_bucket=64,
        slot_prompt_bucket=128))
    api.load_character("c", char_dir, "ja", device="cpu")
    api.set_reference_audio("c", ref, "こんにちは、てすとです", "ja")
    char = api.model_manager.get("c")
    feats = api._reference_features(char, api._reference_audios["c"])
    sb = api.get_slot_batcher(char)
    phones = np.arange(1, 7, dtype=np.int32)
    bert = np.zeros((6, char.t2s_cfg.bert_dim), np.float32)
    for _ in range(8):
        threading.Thread(target=sb.synthesize, args=(feats, phones, bert)).start()
    time.sleep(0.2)
    del char, sb
    api.unload_character("c")
    print("unloaded", flush=True)
''')


def test_exit_right_after_unloading_a_serving_character(tmp_path):
    """Eight requests through a tiny character's slot machine, the
    character unloaded while they decode, and the process ends at once:
    the requests finish, the machine comes to rest, and the exit code is
    0 (not an abort in a draining daemon thread, nor a hang on a thread
    pool that shut down first)."""
    from test_torch_pair import write_character

    char_dir, hub, ref = write_character(tmp_path)
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, str(script), str(char_dir), str(hub), str(ref)],
                          cwd=root, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0 and "unloaded" in proc.stdout, proc.stderr[-2000:]
