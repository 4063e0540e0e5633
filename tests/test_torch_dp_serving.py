"""The port's serving over a device mesh (dp x tp), on the CPU.

The counterpart of tests/test_dp_serving.py, at its tiny size (the same
T2S/SoVITS configs, fp32): the port's mesh is a grid of devices that one
process drives, and here every grid cell is ``"cpu"``, so every line of
the dp and tp code runs with no transfer between devices. Each mesh
result is held to the port's own 1x1 result on the same character (rtol
1e-4 / atol 1e-5), and the tp-sharded decode to the JAX package's
``generate_e2e`` on ``shard_params(..., make_mesh(1, 4))`` over the
conftest's 8 virtual CPU devices (greedy: identical tokens and lengths).

The port splits the decoder's heads whole over tp (Megatron), so tp must
divide ``num_heads``: the 1x8 solo test runs the same config with 8 heads
(the JAX package's 4-head 1x8 run splits the qkv columns inside heads,
which GSPMD allows), and a 4-head character on tp=8 raises.

Beyond the JAX file: the slot batcher and the segmented stream on a 1x2
mesh against 1x1, the qkv columns each tp shard holds, and ``GENIE_MESH``
read by the port's ``api`` in a subprocess.
"""
import copy
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch.config import RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.parallel.mesh import make_serving_mesh
from genie_tts_tpu_torch.runtime.engine import (ReferenceFeatures, TTSEngine,
                                                make_random_character,
                                                make_random_reference)

TCFG = T2SConfig(
    phoneme_vocab=64, semantic_vocab=33, embed_dim=32, num_layers=2,
    num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=24, eos_id=32,
    max_decode_steps=10,
)
VCFG = SoVITSConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16, ssl_dim=24,
    vq_codes=32, vq_dim=24, gin_channels=16,
    flow_layers=2, wn_layers=2, wn_kernel=5,
    upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
    resblock_kernels=(3,), resblock_dilations=((1, 3),),
    n_fft=64, hop_length=8, win_length=64,
)
GREEDY = SamplingConfig(top_k=1, temperature=1.0, repetition_penalty=1.35)
TOL = dict(rtol=1e-4, atol=1e-5)


def _cpu_mesh(dp, tp):
    return make_serving_mesh(dp, tp, devices=["cpu"] * (dp * tp))


def _character(tcfg):
    solo = TTSEngine(RuntimeConfig())
    char = make_random_character(t2s_cfg=tcfg, sovits_cfg=VCFG, dtype=torch.float32,
                                 device="cpu")
    # embeddings x50 (std 1, as large as the position table), so that
    # greedy decodes vary from step to step
    for k in ("audio_embed", "text_embed"):
        char.t2s_params[k] *= 50.0
    ref = make_random_reference(char, solo, ref_seconds=0.2)
    # the stand-in HuBERT features pick codebook rows of 1024; this T2S has
    # 33 semantic tokens (the JAX package's gather clamps such ids)
    ref.prompt_tokens = ref.prompt_tokens % (tcfg.semantic_vocab - 1)
    rng = np.random.default_rng(0)
    items = []
    for i in range(8):
        tp = rng.integers(1, tcfg.phoneme_vocab, 6 + i % 3).astype(np.int32)
        items.append((ref, tp, np.zeros((len(tp), tcfg.bert_dim), np.float32)))
    return solo, char, ref, items


@pytest.fixture(scope="module")
def setup():
    return _character(TCFG)


def _placed(mesh, char, shard=True):
    eng = TTSEngine(RuntimeConfig(), mesh=mesh)
    c = copy.copy(char)
    (eng.shard_character if shard else eng.replicate_character)(c)
    return eng, c


def _assert_rows_close(outs_a, outs_b):
    assert len(outs_a) == len(outs_b)
    for a, b in zip(outs_a, outs_b):
        assert a.shape == b.shape and len(a) > 0
        np.testing.assert_allclose(a, b, **TOL)


def test_dp_batch_matches_single_device(setup):
    """dp=8, default sampling: the Gumbel table and the flow noise are drawn
    once for the padded batch and split by rows, so every row equals 1x1's."""
    solo, char, ref, items = setup
    outs_solo = solo.synthesize_batch(char, items, seed=7, fixed_steps=8)
    eng, c = _placed(_cpu_mesh(8, 1), char, shard=False)
    assert len(c.replicas) == 8
    outs_dp = eng.synthesize_batch(c, items, seed=7, fixed_steps=8)
    assert len(outs_dp) == 8
    _assert_rows_close(outs_solo, outs_dp)


def test_dp_pads_partial_batches(setup):
    solo, char, ref, items = setup
    eng, c = _placed(_cpu_mesh(8, 1), char, shard=False)
    outs = eng.synthesize_batch(c, items[:3], seed=1, fixed_steps=8)
    assert len(outs) == 3
    for a in outs:
        assert np.isfinite(a).all() and len(a) > 0


def test_dp_with_mesh_tp_axis_present(setup):
    """A 4x2 mesh serves: replicated weights, the batch split over dp."""
    solo, char, ref, items = setup
    eng, c = _placed(_cpu_mesh(4, 2), char, shard=False)
    outs = eng.synthesize_batch(c, items[:4], seed=2, fixed_steps=8)
    assert len(outs) == 4
    for a in outs:
        assert np.isfinite(a).all()
    _assert_rows_close(solo.synthesize_batch(char, items[:4], seed=2, fixed_steps=8),
                       outs)


def _to_jax(tree):
    import jax.numpy as jnp

    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items() if not k.startswith("_")}
    return jnp.asarray(tree.numpy())


@pytest.mark.parametrize("B", [1, 4])
def test_tp_sharded_decode_matches(setup, B):
    """The port's generate_e2e on a 1x4 mesh (one head per shard) gives the
    JAX package's tp-sharded greedy tokens and lengths."""
    import jax
    import jax.numpy as jnp

    from genie_tts_tpu.config import T2SConfig as JT2SConfig
    from genie_tts_tpu.models import t2s as jt2s
    from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
    from genie_tts_tpu.parallel.mesh import make_mesh, shard_params

    solo, char, ref, items = setup
    jcfg = JT2SConfig(**dataclasses.asdict(TCFG))
    jparams, _ = shard_params(_to_jax(char.t2s_params), make_mesh(dp=1, tp=4))
    _, c = _placed(_cpu_mesh(1, 4), char)
    assert len(c.t2s_params["layer_shards"]) == 4

    rng = np.random.default_rng(3)
    phones = rng.integers(1, TCFG.phoneme_vocab, (B, 8)).astype(np.int32)
    prompts = rng.integers(0, TCFG.semantic_vocab - 1, (B, 12)).astype(np.int32)
    x_len = np.array([8, 5, 7, 3][:B], np.int32)
    p_len = np.array([12, 9, 4, 12][:B], np.int32)
    args = dict(max_steps=8, cache_len=8 + 12 + 8, min_steps=8)
    fn = jax.jit(jt2s.generate_e2e,
                 static_argnames=("cfg", "scfg", "max_steps", "cache_len",
                                  "min_steps", "use_flash", "layer_unroll"))
    codes_j, len_j = fn(jparams, jcfg, JSampling(top_k=1, repetition_penalty=1.35),
                        jax.random.PRNGKey(0), jnp.asarray(phones), None,
                        jnp.asarray(x_len), jnp.asarray(prompts), jnp.asarray(p_len),
                        **args)
    with torch.inference_mode():
        codes_t, len_t = t2s.generate_e2e(
            c.t2s_params, TCFG, GREEDY, None, torch.as_tensor(phones).long(), None,
            torch.as_tensor(x_len).long(), torch.as_tensor(prompts).long(),
            torch.as_tensor(p_len).long(), **args)
    np.testing.assert_array_equal(np.asarray(len_j), len_t.numpy())
    np.testing.assert_array_equal(np.asarray(codes_j), codes_t.numpy())


def test_tp_sharded_serving_matches(setup):
    """shard_character on 2x4: synthesize_batch decodes tp-sharded over
    each dp row's block and gives 1x1's rows."""
    solo, char, ref, items = setup
    outs_solo = solo.synthesize_batch(char, items, seed=11, fixed_steps=8)
    eng, c = _placed(_cpu_mesh(2, 4), char)
    assert all(len(r.t2s_params["layer_shards"]) == 4 for r in c.replicas)
    _assert_rows_close(outs_solo, eng.synthesize_batch(c, items, seed=11, fixed_steps=8))


def test_tp_sharded_solo_utterance_matches():
    """synthesize_utterance (the solo path) on a 1x8 mesh: the per-layer
    route over 8 shards of one head each, against 1x1's fused route."""
    solo, char, ref, items = _character(dataclasses.replace(TCFG, num_heads=8))
    _, tp_, tb_ = items[0]
    kw = dict(sampling=GREEDY, seed=5, min_steps=8, max_steps=8)
    a_solo = solo.synthesize_utterance(char, ref, tp_, tb_, **kw)
    eng, c = _placed(_cpu_mesh(1, 8), char)
    a_tp = eng.synthesize_utterance(c, ref, tp_, tb_, **kw)
    assert a_solo.shape == a_tp.shape and len(a_tp) > 0
    np.testing.assert_allclose(a_solo, a_tp, **TOL)


def test_shard_character_refuses_a_split_inside_heads(setup):
    solo, char, ref, items = setup
    with pytest.raises(ValueError, match="does not split"):
        _placed(_cpu_mesh(1, 8), char)


def test_qkv_shards_hold_their_heads(setup):
    """Each tp shard's layers/qkv/w is [L, D, 3D/tp] and holds its heads'
    Q, K and V columns; ffn1 its columns, out and ffn2 their rows."""
    solo, char, ref, items = setup
    tp, D, Dh = 2, TCFG.embed_dim, TCFG.head_dim
    _, c = _placed(_cpu_mesh(1, tp), char)
    full = char.t2s_params["layers"]
    hs = TCFG.num_heads // tp
    for i, sh in enumerate(c.t2s_params["layer_shards"]):
        w = sh["qkv"]["w"]
        assert tuple(w.shape) == (TCFG.num_layers, D, 3 * D // tp)
        cols = torch.cat([torch.arange(part * D + i * hs * Dh, part * D + (i + 1) * hs * Dh)
                          for part in range(3)])
        torch.testing.assert_close(w, full["qkv"]["w"][..., cols], rtol=0, atol=0)
        torch.testing.assert_close(sh["qkv"]["b"], full["qkv"]["b"][..., cols],
                                   rtol=0, atol=0)
        f = TCFG.ffn_dim // tp
        torch.testing.assert_close(sh["ffn1"]["w"], full["ffn1"]["w"][..., i * f:(i + 1) * f],
                                   rtol=0, atol=0)
        torch.testing.assert_close(sh["out"]["w"],
                                   full["out"]["w"][:, i * D // tp:(i + 1) * D // tp],
                                   rtol=0, atol=0)
        torch.testing.assert_close(sh["ffn2"]["w"], full["ffn2"]["w"][:, i * f:(i + 1) * f],
                                   rtol=0, atol=0)
        torch.testing.assert_close(sh["out"]["b"], full["out"]["b"], rtol=0, atol=0)
    assert "layers" not in c.t2s_params
    # the replica's other leaves are the character's own tensors
    assert c.t2s_params["predict"]["w"] is char.t2s_params["predict"]["w"]


def test_int8_qkv_scales_split_with_their_columns(setup):
    """Int8 weights: qkv/ffn1 scales split with their columns, out/ffn2
    scales stay whole, and the sharded decode gives 1x1's greedy tokens."""
    solo, char, ref, items = setup
    c8 = dataclasses.replace(char, t2s_params=t2s.quantize_params(char.t2s_params))
    _, c = _placed(_cpu_mesh(1, 2), c8)
    for sh in c.t2s_params["layer_shards"]:
        assert sh["qkv"]["w"].dtype == torch.int8
        assert sh["qkv"]["scale"].shape[-1] == 3 * TCFG.embed_dim // 2
        assert sh["out"]["scale"].shape[-1] == TCFG.embed_dim
    rng = np.random.default_rng(4)
    args = (torch.as_tensor(rng.integers(1, 64, (2, 8))), None, torch.tensor([8, 6]),
            torch.as_tensor(rng.integers(0, 32, (2, 12))), torch.tensor([12, 7]))
    with torch.inference_mode():
        whole = t2s.generate_e2e(c8.t2s_params, TCFG, GREEDY, None, *args,
                                 max_steps=8, cache_len=28, min_steps=8)
        shard = t2s.generate_e2e(c.t2s_params, TCFG, GREEDY, None, *args,
                                 max_steps=8, cache_len=28, min_steps=8)
    for a, b in zip(whole, shard):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


SLOT_CFG = dict(phoneme_buckets=(16, 32), prompt_buckets=(16,), frame_buckets=(32, 64),
                slot_phoneme_bucket=32, slot_prompt_bucket=16, slot_steps=4,
                vocode_chunk=16, vocode_halo=4, stream_seg_steps=4, stream_lookahead=2,
                stream_chunk=8)


def _long(char):
    """The character with a 32-step cap: several segments and ring merges."""
    return dataclasses.replace(char, t2s_cfg=dataclasses.replace(TCFG, max_decode_steps=32))


def _slot_ref(char):
    rng = np.random.default_rng(5)
    ge = char.synth.reference(
        char, (rng.standard_normal(int(0.2 * 32000)) * 0.05).astype(np.float32))["ge"]
    return ReferenceFeatures(
        phones=rng.integers(1, TCFG.phoneme_vocab, 10).astype(np.int32),
        bert=np.zeros((10, TCFG.bert_dim), np.float32),
        prompt_tokens=rng.integers(0, 32, 9).astype(np.int32), ge=ge,
        ge_mrte=ge[:VCFG.mrte_channels])


@pytest.mark.parametrize("kv_int8", [True, False], ids=["int8_kv", "exact_kv"])
def test_slot_batcher_on_tp2_gives_1x1_codes(setup, kv_int8):
    """SlotBatcher on a 1x2 mesh: per-shard slot caches (the int8 cache
    read through int8_big_attention's plain version per shard, or the
    exact cache with windowed reads), the same greedy codes as 1x1."""
    from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher

    char = _long(setup[1])
    sref = _slot_ref(char)
    texts = [np.arange(3, 3 + n, dtype=np.int32) for n in (5, 9, 7)]
    cfg = RuntimeConfig(**SLOT_CFG, slot_kv_int8=kv_int8)
    codes = {}
    for name, mesh in (("1x1", None), ("1x2", _cpu_mesh(1, 2))):
        eng = TTSEngine(cfg, mesh=mesh)
        c = copy.copy(char)
        eng.shard_character(c)
        seen = []
        dispatch = eng.vocode_codes_dispatch

        def spy(ch, its, *a, _d=dispatch, _seen=seen, **k):
            _seen.extend(np.asarray(cc).copy() for _, _, cc in its)
            return _d(ch, its, *a, **k)

        eng.vocode_codes_dispatch = spy
        sb = SlotBatcher(eng, c)
        try:
            for ph in texts:
                audio = sb.synthesize(sref, ph, np.zeros((len(ph), TCFG.bert_dim),
                                                         np.float32), sampling=GREEDY,
                                      min_steps=20)
                assert np.isfinite(audio).all() and len(audio) > 0
        finally:
            sb.stop()
        if mesh is not None:
            st = sb._state
            assert len(st.tp_caches) == 1 and st.k_cache.shape[2] == TCFG.num_heads // 2
        codes[name] = seen
    assert len(codes["1x1"]) == len(codes["1x2"]) == len(texts)
    for a, b in zip(codes["1x1"], codes["1x2"]):
        np.testing.assert_array_equal(a, b)


def test_segmented_stream_on_tp2_gives_1x1_chunks(setup):
    from genie_tts_tpu_torch.runtime.stream import synthesize_stream_segments

    char = _long(setup[1])
    sref = _slot_ref(char)
    ph = np.arange(2, 14, dtype=np.int32)
    bert = np.zeros((len(ph), TCFG.bert_dim), np.float32)
    cfg = RuntimeConfig(**SLOT_CFG)
    chunks = {}
    for name, mesh in (("1x1", None), ("1x2", _cpu_mesh(1, 2))):
        eng = TTSEngine(cfg, mesh=mesh)
        c = copy.copy(char)
        eng.shard_character(c)
        with torch.inference_mode():
            chunks[name] = list(synthesize_stream_segments(
                eng, c, sref, ph, bert, sampling=GREEDY, seed=3, min_steps=24))
    assert len(chunks["1x1"]) == len(chunks["1x2"]) > 1
    for a, b in zip(chunks["1x1"], chunks["1x2"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **TOL)


def test_api_load_character_places_on_the_mesh(setup, tmp_path, monkeypatch):
    """api.load_character with a mesh engine: the character lands on the
    mesh's first device, tp-sharded; another device raises."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.convert.io import save_character_config, save_params

    solo, char, ref, items = setup
    save_params(char.t2s_params, tmp_path / "t2s.safetensors")
    save_params(char.sovits_params, tmp_path / "vits.safetensors")
    save_character_config(tmp_path / "config.json", version="v2", language="ja",
                          extra={"t2s": dataclasses.asdict(TCFG),
                                 "sovits": dataclasses.asdict(VCFG)})
    monkeypatch.setattr(api, "engine", TTSEngine(RuntimeConfig(), mesh=_cpu_mesh(2, 2)))
    with pytest.raises(ValueError, match="first device"):
        api.load_character("meshc", tmp_path, "ja", device="meta")
    try:
        api.load_character("meshc", tmp_path, "ja", device="cpu", dtype=torch.float32)
        c = api.model_manager.get("meshc")
        assert len(c.replicas) == 2 and len(c.t2s_params["layer_shards"]) == 2
        assert c.device == torch.device("cpu")
    finally:
        api.unload_character("meshc")


def test_api_mesh_env_wiring():
    """GENIE_MESH read by the port's api (a subprocess: the module-level
    engine is built at import): "1x1" gives no mesh, "4" is not DPxTP, and
    "2x4" with no GPU names the device count, at import too."""
    code = (
        "import importlib, os\n"
        "import torch\n"
        "assert not torch.cuda.is_available()\n"
        "os.environ['GENIE_MESH'] = '1x1'\n"
        "from genie_tts_tpu_torch import api\n"
        "assert api.engine.mesh is None\n"
        "for spec, msg in (('4', 'DPxTP'), ('2x4', 'needs 8 devices, have 0')):\n"
        "    os.environ['GENIE_MESH'] = spec\n"
        "    try:\n"
        "        importlib.reload(api)\n"
        "    except ValueError as e:\n"
        "        assert msg in str(e), e\n"
        "    else:\n"
        "        raise AssertionError(spec)\n"
        "print('MESH-OK')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert "MESH-OK" in out.stdout, out.stderr[-2000:]
