"""The port's whole slice vs the JAX package, on one tiny character.

A V2 character written by the JAX package's ``save_params`` (narrow
widths, the real 640-sample hop, ``config.json`` overrides) is loaded by
both packages' model managers; the same reference arrays give both
packages their ReferenceFeatures; ``synthesize_utterance`` then runs with
greedy sampling and noise_scale 0, so codes must be identical and the fp32
waveform allclose (rtol/atol 2e-4: fp32 sums in other orders through the
latent stack and HiFi-GAN). The port's api and CLI run the whole path on
``device="cpu"`` and write a 32 kHz wav.
"""
import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.config import SoVITSConfig as JSoVITSConfig
from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.config import HubertConfig as JHubertConfig
from genie_tts_tpu.convert.io import save_params as j_save
from genie_tts_tpu.models import hubert as jhubert
from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu.runtime import engine as jengine
from genie_tts_tpu.runtime.model_manager import ModelManager as JModelManager
from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import RuntimeConfig, SoVITSConfig, T2SConfig, V4Config
from genie_tts_tpu_torch.convert.io import flatten_tree
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import engine as tengine
from genie_tts_tpu_torch.runtime.model_manager import ModelManager
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher

REPO = Path(__file__).resolve().parents[1]
T2S_KW = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64, bert_dim=1024,
              ssl_dim=24, max_decode_steps=24)
VITS_KW = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
               n_layers=2, mrte_channels=16, ssl_dim=24, vq_dim=24,
               gin_channels=16, flow_layers=2, wn_layers=2, upsample_initial=32,
               resblock_kernels=(3,), resblock_dilations=((1, 3),))
HUBERT_KW = dict(conv_dims=(32,) * 7, embed_dim=24, num_layers=2, num_heads=4,
                 ffn_dim=48, conv_pos_kernel=16, conv_pos_groups=4)
BUCKETS = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64),
               frame_buckets=(32, 64))
JGREEDY = JSampling(top_k=1)
GREEDY = SamplingConfig(top_k=1)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """A tiny V2 character dir + a tiny HuBERT, written by the JAX package."""
    root = tmp_path_factory.mktemp("genie")
    char = root / "char"
    char.mkdir()
    tp = jt2s.init_params(jax.random.PRNGKey(0), JT2SConfig(**T2S_KW), dtype=jnp.float32)
    # varied tokens and an EOS inside the cap (random weights decode flat)
    tp["audio_embed"] = tp["audio_embed"] * 10.0
    w = tp["predict"]["w"]
    tp["predict"]["w"] = w.at[:, 1024].set(w[:, 1024] * 3.0)
    j_save(tp, char / "t2s.safetensors")
    j_save(jsovits.init_params(jax.random.PRNGKey(1), JSoVITSConfig(**VITS_KW),
                               dtype=jnp.float32), char / "vits.safetensors")
    (char / "config.json").write_text(json.dumps(
        {"version": "v2", "language": "ja", "t2s": T2S_KW, "sovits": VITS_KW}))
    hub = root / "GenieData" / "chinese-hubert-base"
    hub.mkdir(parents=True)
    j_save(jhubert.init_params(jax.random.PRNGKey(2), JHubertConfig(**HUBERT_KW),
                               dtype=jnp.float32), hub / "hubert.safetensors")
    (hub / "config.json").write_text(json.dumps(HUBERT_KW))
    rng = np.random.default_rng(0)
    t = np.arange(int(3.2 * 32000)) / 32000.0
    ref = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size))
    ref_path = root / "ref.wav"
    with wave.open(str(ref_path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(32000)
        f.writeframes((ref * 32767).astype("<i2").tobytes())
    return {"char": char, "hubert": hub, "ref": ref_path, "root": root}


@pytest.fixture(scope="module")
def pair(assets):
    """The same character loaded by both packages (fp32, no int8)."""
    jmm = JModelManager(JRuntimeConfig(t2s_int8=False))
    tmm = ModelManager(RuntimeConfig(t2s_int8=False))
    jchar = jmm.load_character("c", str(assets["char"]), "Japanese",
                               compute_dtype=jnp.float32)
    tchar = tmm.load_character("c", str(assets["char"]), "Japanese",
                               compute_dtype=torch.float32, device="cpu")
    return jchar, tchar


def test_load_character_same_tensors(pair):
    jchar, tchar = pair
    assert tchar.t2s_cfg.embed_dim == 32 and tchar.sovits_cfg.gin_channels == 16
    assert tchar.sovits_cfg.upsample_rates == jchar.sovits_cfg.upsample_rates
    for jtree, ttree in ((jchar.t2s_params, tchar.t2s_params),
                         (jchar.sovits_params, tchar.sovits_params)):
        jflat = {k: np.asarray(v) for k, v in _flat(jtree).items()}
        tflat = flatten_tree(ttree)
        assert set(jflat) == set(tflat)
        for k, v in tflat.items():
            np.testing.assert_array_equal(v.numpy(), jflat[k], k)


def _flat(tree):
    from genie_tts_tpu.convert.io import flatten_tree as jflatten

    return jflatten(tree)


@pytest.fixture(scope="module")
def refs(pair):
    """ReferenceFeatures of both packages from the same arrays."""
    jchar, tchar = pair
    rng = np.random.default_rng(1)
    audio_32k = (rng.standard_normal(3 * 32000) * 0.1).astype(np.float32)
    ssl = rng.standard_normal((150, 24)).astype(np.float32)
    phones = rng.integers(1, 732, 12).astype(np.int32)
    jeng = jengine.TTSEngine(JRuntimeConfig(**BUCKETS))
    teng = tengine.TTSEngine(RuntimeConfig(**BUCKETS))
    out = []
    for eng, char, feats, ge in (
            (jeng, jchar, jengine.ReferenceFeatures,
             jeng.compute_v2_speaker_embedding(jchar, audio_32k)),
            (teng, tchar, tengine.ReferenceFeatures, tchar.synth.reference(tchar, audio_32k)["ge"])):
        out.append(feats(
            phones=phones, bert=np.zeros((12, 1024), np.float32),
            prompt_tokens=eng.compute_prompt_tokens(char, ssl), ge=ge,
            ge_mrte=ge[:16]))
    return jeng, teng, out[0], out[1]


def test_reference_features_agree(refs):
    _, _, jref, tref = refs
    np.testing.assert_array_equal(tref.prompt_tokens, jref.prompt_tokens)
    np.testing.assert_allclose(tref.ge, jref.ge, rtol=1e-4, atol=1e-5)


def test_synthesize_utterance_identical_codes(pair, refs):
    jchar, tchar = pair
    jeng, teng, jref, tref = refs
    text = np.array([5, 40, 17, 99, 230, 12, 8], np.int32)
    bert = np.zeros((len(text), 1024), np.float32)
    jw = jeng.synthesize_utterance(jchar, jref, text, bert, sampling=JGREEDY, seed=0,
                                   noise_scale=0.0)
    tw = teng.synthesize_utterance(tchar, tref, text, bert, sampling=GREEDY, seed=0,
                                   noise_scale=0.0)
    n = teng.last_stats["codes_len"]
    assert 3 < n < 24, "degenerate decode; reseed the fixture"
    assert len(tw) == len(jw) == 2 * n * 640
    np.testing.assert_allclose(tw, jw, rtol=2e-4, atol=2e-4)

    # the codes themselves, from each package's generate_e2e on the packed
    # [ref_text | text] inputs the engines build
    from genie_tts_tpu.runtime.buckets import pad_to, pick_bucket

    phones = np.concatenate([jref.phones, text])
    sx = pick_bucket(len(phones), BUCKETS["phoneme_buckets"])
    sp = pick_bucket(len(jref.prompt_tokens), BUCKETS["prompt_buckets"])
    x_len, p_len = min(len(phones), sx), min(len(jref.prompt_tokens), sp)
    padded = pad_to(phones, sx)[None]
    prompts = pad_to(jref.prompt_tokens, sp)[None]
    cap = 64                         # the step_caps bucket of max_decode_steps=24
    jc, jn = jt2s.generate_e2e(jchar.t2s_params, jchar.t2s_cfg, JGREEDY,
                               jax.random.PRNGKey(0), jnp.asarray(padded), None,
                               jnp.array([x_len]), jnp.asarray(prompts),
                               jnp.array([p_len]), max_steps=cap,
                               cache_len=sx + sp + cap, max_steps_dyn=24)
    tc, tn = tt2s.generate_e2e(tchar.t2s_params, tchar.t2s_cfg, GREEDY, None,
                               torch.tensor(padded).long(), None,
                               torch.tensor([x_len]), torch.tensor(prompts).long(),
                               torch.tensor([p_len]), max_steps=cap,
                               cache_len=sx + sp + cap, max_steps_dyn=24)
    assert int(tn[0]) == int(jn[0]) == n
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_staged_branch_matches_fused_branch(pair, refs):
    """Above solo_fused_max_codes the engine reads the emitted length first
    and vocodes a frame bucket of it; the waveform is the same."""
    _, tchar = pair
    _, teng, _, tref = refs
    text = np.array([5, 40, 17, 99, 230, 12, 8], np.int32)
    bert = np.zeros((len(text), 1024), np.float32)
    staged = tengine.TTSEngine(RuntimeConfig(solo_fused_max_codes=0, **BUCKETS))
    a = teng.synthesize_utterance(tchar, tref, text, bert, sampling=GREEDY, seed=0,
                                  noise_scale=0.0)
    b = staged.synthesize_utterance(tchar, tref, text, bert, sampling=GREEDY, seed=0,
                                    noise_scale=0.0)
    assert len(a) == len(b) > 0
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _read_wav(path):
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == 32000 and f.getnchannels() == 1
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def test_api_tts_writes_wav(assets, monkeypatch, tmp_path):
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(assets["hubert"]))
    monkeypatch.setattr(api, "engine", tengine.TTSEngine(RuntimeConfig(**BUCKETS)))
    lengths = []
    synth = api.engine.synthesize_utterance

    def record(*a, **k):
        out = synth(*a, **k)
        lengths.append(api.engine.last_stats["codes_len"])
        return out

    monkeypatch.setattr(api.engine, "synthesize_utterance", record)
    api.load_character("t", assets["char"], "ja", device="cpu", dtype="float32")
    assert api.set_reference_audio("t", assets["ref"], "こんにちは、てすとです", "ja")
    out = tmp_path / "out.wav"
    audio = api.tts("t", "きょうはいいてんきですね。あしたもはれるでしょう。", save_path=out)
    pcm = _read_wav(out)
    assert len(lengths) == 2
    assert len(pcm) == len(audio) == sum(2 * n * 640 for n in lengths) > 0
    assert np.isfinite(audio).all()
    api.unload_character("t")


def test_cli_tts_on_cpu(assets, tmp_path):
    out = tmp_path / "cli.wav"
    env = dict(os.environ, GENIE_HUBERT_DIR=str(assets["hubert"]),
               PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "genie_tts_tpu_torch", "tts", "--model",
         str(assets["char"]), "--lang", "ja", "--ref", str(assets["ref"]),
         "--ref-text", "こんにちは", "--text", "きょうはいいてんきですね。",
         "--out", str(out), "--device", "cpu", "--dtype", "float32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pcm = _read_wav(out)
    assert len(pcm) > 0 and len(pcm) % (2 * 640) == 0


def test_ja_g2p_ids_match_jax_frontend():
    from genie_tts_tpu.frontend.dispatcher import get_phones_and_bert as j_g2p
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert as t_g2p

    lines = [s for s in (REPO / "tests/data/ja_corpus.txt").read_text(
        encoding="utf-8").splitlines() if s.strip()]
    assert len(lines) > 50
    for s in lines:
        np.testing.assert_array_equal(t_g2p(s, "ja")[0], j_g2p(s, "ja")[0], s)


def test_port_imports_nothing_of_jax():
    code = ("import importlib, pkgutil, sys, genie_tts_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "for m in ('models.slots', 'runtime.slot_batcher', 'ops.int8_decode',\n"
            "          'utils.metrics', 'server.http', 'runtime.session',\n"
            "          'runtime.stream', 'runtime.batcher', 'convert.torch_convert',\n"
            "          'models.roberta', 'frontend.wordpiece', 'frontend.g2p_zh',\n"
            "          'frontend.g2p_en', 'frontend.g2p_en_nn', 'frontend.tone_sandhi',\n"
            "          'parallel.mesh', 'parallel.tp', 'parallel.train',\n"
            "          'convert.shared_models'):\n"
            "    assert p.__name__ + '.' + m in sys.modules, m\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('jax', 'genie_tts_tpu', 'tokenizers')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], env=dict(os.environ, PYTHONPATH=str(REPO)),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_entry_point_without_device_raises_when_no_gpu(assets, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_character("nodev", assets["char"], "ja")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tengine.make_random_character()


# -- one synthesizer object per GPT-SoVITS version ------------------------------

V4_TINY = V4Config(fea_channels=16, wn_layers=2, dit_dim=32, dit_depth=2, dit_heads=2,
                   dit_head_dim=16, freq_embed_dim=16, sample_steps=4, T_ref=16, T_chunk=40,
                   upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
                   resblock_kernels=(3,), resblock_dilations=((1, 3),))
VERSION_RCFG = RuntimeConfig(
    phoneme_buckets=(16, 32, 64), prompt_buckets=(32, 64), frame_buckets=(16, 32, 64),
    step_caps=(16, 32, 64), slot_batch=4, slot_steps=8, slot_join_steps=4, slot_ring=32,
    slot_phoneme_bucket=64, slot_prompt_bucket=64, vocode_chunk=16, vocode_halo=12,
    batch_window_ms=1.0, t2s_int8=False, stream_segmented=False)


@pytest.mark.parametrize("version,rate,per_code", [("v2", 32000, 1280),
                                                   ("v2ProPlus", 32000, 1280),
                                                   ("v4", 48000, 32)])
def test_each_version_serves_through_its_synthesizer(version, rate, per_code):
    """A random character of each version and its random reference through
    the solo route, the batched tail and the slot machine: each waveform is
    its codes times the version's samples a code, at the version's rate;
    V4's per-request CFM seed reaches its tail (V2's tails ignore it); and
    the streaming route refuses exactly the versions that do not stream."""
    char = tengine.make_random_character(
        version, seed=1, t2s_cfg=T2SConfig(**T2S_KW),
        sovits_cfg=SoVITSConfig(**VITS_KW, version=version, sv_dim=64),
        dtype=torch.float32, device="cpu", v4_cfg=V4_TINY, eos_boost=0.0)
    synth = char.synth
    assert char.sample_rate == rate and synth.samples_per_code(char) == per_code
    eng = tengine.TTSEngine(VERSION_RCFG)
    ref = tengine.make_random_reference(char, eng, ref_seconds=1.0, seed=2)
    assert (ref.mel2 is not None) == (version == "v4")
    phones = np.arange(1, 12).astype(np.int32)
    bert = np.zeros((len(phones), T2S_KW["bert_dim"]), np.float32)

    solo = eng.synthesize_utterance(char, ref, phones, bert, sampling=GREEDY, seed=5,
                                    fixed_steps=9)
    assert solo.shape == (9 * per_code,) and np.isfinite(solo).all()

    rng = np.random.default_rng(3)
    items = [(ref, phones[:n], rng.integers(0, 1024, k)) for n, k in ((11, 7), (6, 12))]
    a, b = eng.vocode_codes_batch(char, items, cfm_seeds=[10, 11])
    assert a.shape == (7 * per_code,) and b.shape == (12 * per_code,)
    same = eng.vocode_codes_batch(char, items, cfm_seeds=[10, 11])
    other = eng.vocode_codes_batch(char, items, cfm_seeds=[12, 13])
    np.testing.assert_array_equal(same[0], a)
    assert np.array_equal(other[0], a) == synth.inline

    sb = SlotBatcher(eng, char)
    try:
        slot = [sb.synthesize(ref, phones, bert, sampling=GREEDY, min_steps=9, max_steps=9,
                              cfm_seed=s) for s in (77, 77, 78)]
    finally:
        sb.stop()
    assert all(x.shape == (9 * per_code,) for x in slot)
    np.testing.assert_array_equal(slot[1], slot[0])
    assert np.array_equal(slot[2], slot[0]) == synth.inline

    stream = eng.synthesize_utterance_stream(char, ref, phones, bert, sampling=GREEDY,
                                             max_steps=8)
    if synth.streams:
        assert len(next(stream)) > 0
    else:
        with pytest.raises(NotImplementedError, match=synth.__class__.__name__):
            next(stream)
