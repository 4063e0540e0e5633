"""V2ProPlus voice cloning in the port vs the JAX package, on the CPU.

Each module on the V2ProPlus path is held against its JAX counterpart on
the same inputs, made from a seed with numpy:

* ``kaldi_mel_banks`` (within 1e-6) and ``kaldi_fbank`` (fp32, rtol 1e-4,
  atol 1e-3: the log of a power spectrum scaled by 32768^2);
* ERes2NetV2 at full width on 64 frames, fp32, from the converted weights
  of tests/test_eres2net_convert.py::_build_sd (rtol 2e-3, atol 2e-4, the
  JAX package's own tolerance against its torch oracle: sixteen blocks of
  fp32 convolutions summed in other orders);
* the prompt encoder at a tiny width (gin 24), fp32, within 1e-5;
* the slice: the tiny V2ProPlus character of tests/test_v2pp.py:20-38
  (with the SV embedding at its real 20480 width), written by the port and loaded by both model managers in fp32, fed the
  same SV embedding: ``ge``/``ge_mrte`` within 1e-5, identical greedy
  codes and the waveform within 1e-4 at noise scale 0;
* conversion of the v2pp-shaped checkpoint of tests/test_v2pp.py:104-180
  (the same files as the JAX converter, bit for bit), the model-dir check,
  the SV model read from ``GENIE_SV_MODEL``, and the whole path through
  the port's api and CLI on ``device="cpu"``.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_v2pp as jv2pp
from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.config import SoVITSConfig as JSoVITSConfig
from genie_tts_tpu.convert import torch_convert as jconv
from genie_tts_tpu.convert.io import flatten_tree as j_flatten
from genie_tts_tpu.convert.io import load_params as j_load
from genie_tts_tpu.models import eres2net as jeres
from genie_tts_tpu.models import prompt_encoder as jpe
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops import audio as jaudio
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu.runtime import engine as jengine
from genie_tts_tpu.runtime.model_manager import ModelManager as JModelManager
from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import HubertConfig, RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert import torch_convert as tconv
from genie_tts_tpu_torch.convert.io import (flatten_tree, load_params, params_from_numpy,
                                            read_safetensors, save_params)
from genie_tts_tpu_torch.models import eres2net, hubert, prompt_encoder, sv
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops import audio
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import engine as tengine
from genie_tts_tpu_torch.runtime.model_manager import ModelManager, check_model_dir
from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
from test_eres2net_convert import _build_sd

REPO = Path(__file__).resolve().parents[1]
GIN = jv2pp.GIN
T2S_KW = {f.name: getattr(jv2pp.TCFG, f.name) for f in dataclasses.fields(jv2pp.TCFG)}
# sv_dim at the real SV model's width (tests/test_v2pp.py stubs a 64-d one),
# so the api and CLI drives run the real ERes2NetV2
VITS_KW = {**{f.name: getattr(jv2pp.VCFG, f.name) for f in dataclasses.fields(jv2pp.VCFG)},
           "sv_dim": 20480}
HUBERT_KW = {f.name: getattr(jv2pp.HCFG, f.name) for f in dataclasses.fields(jv2pp.HCFG)}
TCFG, VCFG = T2SConfig(**T2S_KW), SoVITSConfig(**VITS_KW)
BUCKETS = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64), frame_buckets=(32, 64))


# ---------------------------------------------------------------------------
# Kaldi fbank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_bins,n_fft,sr,lo,hi", [
    (80, 512, 16000, 20.0, 0.0), (40, 512, 16000, 60.0, -400.0), (23, 256, 8000, 20.0, 3600.0)])
def test_kaldi_mel_banks_match_jax(num_bins, n_fft, sr, lo, hi):
    got = audio.kaldi_mel_banks(num_bins, n_fft, sr, lo, hi)
    want = jaudio.kaldi_mel_banks(num_bins, n_fft, sr, lo, hi)
    assert got.shape == want.shape == (num_bins, n_fft // 2 + 1) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("batch,samples", [(1, 16000), (2, 8123), (1, 400)])
def test_kaldi_fbank_matches_jax(batch, samples):
    rng = np.random.default_rng(samples)
    t = np.arange(samples) / 16000.0
    x = (0.2 * np.sin(2 * np.pi * 310 * t)[None] + 0.05 * rng.standard_normal((batch, samples))
         + 0.01).astype(np.float32)              # a DC offset the mean removal takes out
    got = audio.kaldi_fbank(torch.from_numpy(x)).numpy()
    want = np.asarray(jaudio.kaldi_fbank(jnp.asarray(x)))
    assert got.shape == want.shape == (batch, 1 + (samples - 400) // 160, 80)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)


# ---------------------------------------------------------------------------
# ERes2NetV2
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eres_sd():
    return {k: v.numpy() for k, v in _build_sd(seed=0).items()}


def test_eres2net_convert_equals_jax(eres_sd):
    got, want = flatten_tree(eres2net.convert_from_torch(eres_sd)), \
        j_flatten(jeres.convert_from_torch(eres_sd))
    assert set(got) == set(want)
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], k)


def test_eres2net_full_width_matches_jax(eres_sd):
    tree = eres2net.convert_from_torch(eres_sd)
    fbank = np.random.default_rng(1).standard_normal((1, 64, 80)).astype(np.float32)
    want = np.asarray(jeres.apply(jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree),
                                  jnp.asarray(fbank)))
    with torch.inference_mode():
        got = eres2net.apply(params_from_numpy(tree, torch.float32),
                             torch.from_numpy(fbank)).numpy()
    assert got.shape == (1, eres2net.EMB_DIM) == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_eres2net_convert_raises_on_missing_res2_convs(eres_sd):
    sd = {k: v for k, v in eres_sd.items() if not k.startswith("layer1.0.convs.3")}
    with pytest.raises(KeyError, match="res2 convs"):
        eres2net.convert_from_torch(sd)


def test_eres2net_init_tree_is_the_jax_tree():
    got = flatten_tree(eres2net.init_params(torch.Generator().manual_seed(0), torch.float32))
    want = flatten_tree(jax.eval_shape(lambda k: jeres.init_params(k, jnp.float32),
                                    jax.random.PRNGKey(0)))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k


def test_io_carries_list_trees(eres_sd, tmp_path):
    """The ERes2NetV2 and prompt-encoder trees go through the port's writer
    and come back with their list nodes as lists, holding what the JAX
    reader reads from the same file."""
    trees = {"sv": eres2net.convert_from_torch(eres_sd),
             "pe": jpe.init_params(jax.random.PRNGKey(0), jv2pp.VCFG, jnp.float32, gin=GIN,
                                   mrte_dim=16)}
    for name, tree in trees.items():
        path = tmp_path / f"{name}.safetensors"
        save_params(params_from_numpy(tree, torch.float32), path)
        back = load_params(path, torch.float32)
        jback = j_load(path, jnp.float32)
        if name == "sv":
            assert isinstance(back["layer3"], list) and len(back["layer3"]) == 6
            assert isinstance(back["layer3"][0]["convs"], list)
            assert isinstance(back["layer3"][0]["fuse"], list) and "fuse" not in back["layer1"][0]
        else:
            assert isinstance(back["ref_enc"]["temporal"], list)
        flat, jflat = flatten_tree(back), j_flatten(jback)
        assert set(flat) == set(jflat) == set(flatten_tree(tree))
        for k, v in flat.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]), k)


def test_get_sv_fn_reads_the_port_written_model(tmp_path, monkeypatch):
    """GENIE_SV_MODEL names a full-width random ERes2NetV2 the port wrote;
    the port's SV function (bf16 weights computed in fp32, as the JAX
    package loads them) agrees with the JAX package's forward over the
    same file and clip within 1e-4 relative L2 (fp32 sums in other
    orders; the weights are well conditioned, see ``eres2net.init_params``)."""
    path = tmp_path / "speaker_encoder.safetensors"
    save_params(eres2net.init_params(torch.Generator().manual_seed(9), torch.float32), path)
    monkeypatch.setenv("GENIE_SV_MODEL", str(path))
    monkeypatch.setattr(sv, "_custom_fn", None)
    monkeypatch.setattr(sv, "_loaded_fns", {})
    fn = sv.get_sv_fn("cpu")
    assert fn is not None and sv.get_sv_fn("cpu") is fn
    t = np.arange(12000) / 16000.0
    wav = (0.3 * np.sin(2 * np.pi * 180 * t)
           + 0.02 * np.random.default_rng(3).standard_normal(t.size)).astype(np.float32)
    emb = fn(wav)
    want = np.asarray(jeres.apply(j_load(path), jaudio.kaldi_fbank(jnp.asarray(wav)[None])))[0]
    assert emb.shape == (sv.SV_EMB_DIM,) and emb.dtype == np.float32 and np.isfinite(emb).all()
    assert np.linalg.norm(emb - want) <= 1e-4 * np.linalg.norm(want)
    monkeypatch.setenv("GENIE_SV_MODEL", str(tmp_path / "missing.safetensors"))
    monkeypatch.setattr(sv, "_loaded_fns", {})
    assert sv.get_sv_fn("cpu") is None


# ---------------------------------------------------------------------------
# prompt encoder
# ---------------------------------------------------------------------------

def test_prompt_encoder_matches_jax():
    jp = jpe.init_params(jax.random.PRNGKey(2), JSoVITSConfig(**VITS_KW), jnp.float32,
                         gin=GIN, mrte_dim=16)
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: a, jp)
    jp["prelu_weight"] = jnp.asarray(rng.uniform(0.05, 0.5, GIN), jnp.float32)
    jp["sv_emb"]["b"] = jnp.asarray(rng.standard_normal(GIN) * 0.1, jnp.float32)
    spec = np.abs(rng.standard_normal((2, 50, VCFG.spec_channels))).astype(np.float32)
    spec_len = np.array([50, 37])
    sv_emb = rng.standard_normal((2, VCFG.sv_dim)).astype(np.float32)
    jge, jgm = jpe.apply(jp, jnp.asarray(spec), jnp.asarray(spec_len), jnp.asarray(sv_emb))
    with torch.inference_mode():
        ge, gm = prompt_encoder.apply(params_from_numpy(jp, torch.float32),
                                      torch.from_numpy(spec), torch.from_numpy(spec_len),
                                      torch.from_numpy(sv_emb))
    assert ge.shape == (2, GIN, 1) and gm.shape == (2, 16, 1)
    assert bool((ge < 0).any())                  # the PReLU's negative side is exercised
    np.testing.assert_allclose(ge.numpy(), np.asarray(jge), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gm.numpy(), np.asarray(jgm), rtol=1e-5, atol=1e-5)


def test_prompt_encoder_init_tree_is_the_jax_tree():
    got = flatten_tree(prompt_encoder.init_params(torch.Generator().manual_seed(0), VCFG,
                                                  torch.float32, gin=GIN, mrte_dim=16))
    want = flatten_tree(jax.eval_shape(lambda k: jpe.init_params(
        k, JSoVITSConfig(**VITS_KW), jnp.float32, gin=GIN, mrte_dim=16), jax.random.PRNGKey(0)))
    assert set(got) == set(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape, k


# ---------------------------------------------------------------------------
# the slice: one tiny V2ProPlus character in both packages
# ---------------------------------------------------------------------------

def _write_wav(path, seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 32000)) / 32000.0
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(32000)
        f.writeframes((x * 32767).astype("<i2").tobytes())


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """The tiny V2ProPlus character (port init, port writer), a tiny HuBERT,
    a full-width random ERes2NetV2 and a short reference clip."""
    root = tmp_path_factory.mktemp("v2pp")
    rc = tengine.make_random_character(t2s_cfg=TCFG, sovits_cfg=VCFG, dtype=torch.float32,
                                       device="cpu")
    assert "ref_enc" not in rc.sovits_params and rc.prompt_encoder_params is not None
    rc.t2s_params["audio_embed"] *= 10.0          # varied greedy tokens
    # a codebook of the 32 codes the tiny T2S speaks, as a converted
    # checkpoint's is (its .pth codebook), so prompt tokens stay in vocabulary
    rc.t2s_params["codebook"] = rc.t2s_params["codebook"][:VCFG.vq_codes].clone()
    char = root / "char"
    char.mkdir()
    save_params(rc.t2s_params, char / "t2s.safetensors")
    save_params(rc.sovits_params, char / "vits.safetensors")
    save_params(rc.prompt_encoder_params, char / "prompt_encoder.safetensors")
    (char / "config.json").write_text(json.dumps(
        {"version": "v2ProPlus", "language": "ja", "t2s": T2S_KW, "sovits": VITS_KW}))
    hub = root / "hubert"
    hub.mkdir()
    save_params(hubert.init_params(torch.Generator().manual_seed(3), HubertConfig(**HUBERT_KW),
                                   dtype=torch.float32), hub / "hubert.safetensors")
    (hub / "config.json").write_text(json.dumps(HUBERT_KW))
    svp = root / "speaker_encoder.safetensors"
    save_params(eres2net.init_params(torch.Generator().manual_seed(4), torch.float32), svp)
    _write_wav(root / "ref.wav", 0.25, 0)
    return {"root": root, "char": char, "hubert": hub, "sv": svp, "ref": root / "ref.wav"}


@pytest.fixture(scope="module")
def pair(assets):
    jchar = JModelManager(JRuntimeConfig(t2s_int8=False)).load_character(
        "pp", str(assets["char"]), "Japanese", compute_dtype=jnp.float32)
    tchar = ModelManager(RuntimeConfig(t2s_int8=False)).load_character(
        "pp", str(assets["char"]), "Japanese", compute_dtype=torch.float32, device="cpu")
    return jchar, tchar


def test_load_character_same_tensors(pair):
    jchar, tchar = pair
    assert tchar.version == jchar.version == "v2ProPlus"
    assert tchar.sovits_cfg.gin_channels == jchar.sovits_cfg.gin_channels == GIN
    for jtree, ttree in ((jchar.t2s_params, tchar.t2s_params),
                         (jchar.sovits_params, tchar.sovits_params),
                         (jchar.prompt_encoder_params, tchar.prompt_encoder_params)):
        jflat, tflat = j_flatten(jtree), flatten_tree(ttree)
        assert set(jflat) == set(tflat)
        for k, v in tflat.items():
            np.testing.assert_array_equal(v.numpy(), np.asarray(jflat[k]), k)


@pytest.fixture(scope="module")
def refs(pair):
    """Both packages' ReferenceFeatures from the same arrays and SV embedding."""
    jchar, tchar = pair
    rng = np.random.default_rng(1)
    audio_32k = (rng.standard_normal(int(0.25 * 32000)) * 0.1).astype(np.float32)
    sv_emb = rng.standard_normal(VCFG.sv_dim).astype(np.float32)
    ssl = rng.standard_normal((60, 24)).astype(np.float32)
    phones = rng.integers(1, 732, 12).astype(np.int32)
    jeng = jengine.TTSEngine(JRuntimeConfig(**BUCKETS))
    teng = tengine.TTSEngine(RuntimeConfig(**BUCKETS))
    out = []
    tr = tchar.synth.reference(tchar, audio_32k, sv_emb=sv_emb)
    for eng, char, feats, (ge, ge_mrte) in (
            (jeng, jchar, jengine.ReferenceFeatures,
             jeng.compute_v2pp_speaker_embedding(jchar, audio_32k, sv_emb)),
            (teng, tchar, tengine.ReferenceFeatures, (tr["ge"], tr["ge_mrte"]))):
        out.append(feats(phones=phones, bert=np.zeros((12, 1024), np.float32),
                         prompt_tokens=eng.compute_prompt_tokens(char, ssl), ge=ge,
                         ge_mrte=ge_mrte))
    return jeng, teng, out[0], out[1]


def test_speaker_embeddings_match_jax(refs):
    _, _, jref, tref = refs
    assert tref.ge.shape == (GIN, 1) and tref.ge_mrte.shape == (16, 1)
    np.testing.assert_array_equal(tref.prompt_tokens, jref.prompt_tokens)
    np.testing.assert_allclose(tref.ge, np.asarray(jref.ge), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tref.ge_mrte, np.asarray(jref.ge_mrte), rtol=1e-5, atol=1e-5)


def test_synthesize_utterance_matches_jax(pair, refs):
    jchar, tchar = pair
    jeng, teng, jref, tref = refs
    text = np.array([5, 40, 17, 99, 230, 12, 8], np.int32)
    bert = np.zeros((len(text), 1024), np.float32)
    jw = jeng.synthesize_utterance(jchar, jref, text, bert, sampling=JSampling(top_k=1),
                                   seed=0, noise_scale=0.0)
    tw = teng.synthesize_utterance(tchar, tref, text, bert, sampling=SamplingConfig(top_k=1),
                                   seed=0, noise_scale=0.0)
    n = teng.last_stats["codes_len"]
    assert 0 < n <= TCFG.max_decode_steps and len(tw) == len(jw) == 2 * n * VCFG.hop_length
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-4)
    # the codes, from each package's generate_e2e on the inputs the engines build
    phones = np.concatenate([jref.phones, text])
    sx, sp, cap = 32, 32, 64
    padded = np.pad(phones, (0, sx - len(phones)))[None]
    prompts = np.pad(jref.prompt_tokens, (0, sp - len(jref.prompt_tokens)))[None]
    jc, jn = jt2s.generate_e2e(jchar.t2s_params, jchar.t2s_cfg, JSampling(top_k=1),
                               jax.random.PRNGKey(0), jnp.asarray(padded), None,
                               jnp.array([len(phones)]), jnp.asarray(prompts),
                               jnp.array([len(jref.prompt_tokens)]), max_steps=cap,
                               cache_len=sx + sp + cap, max_steps_dyn=TCFG.max_decode_steps)
    tc, tn = tt2s.generate_e2e(tchar.t2s_params, tchar.t2s_cfg, SamplingConfig(top_k=1), None,
                               torch.tensor(padded).long(), None, torch.tensor([len(phones)]),
                               torch.tensor(prompts).long(),
                               torch.tensor([len(jref.prompt_tokens)]), max_steps=cap,
                               cache_len=sx + sp + cap, max_steps_dyn=TCFG.max_decode_steps)
    assert int(tn[0]) == int(jn[0]) == n
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert len(set(tc[0, :n].tolist())) > 2, "degenerate decode; reseed the fixture"


def test_model_dir_requires_prompt_encoder(assets, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(assets["char"], broken)
    assert check_model_dir(broken)["version"] == "v2ProPlus"
    (broken / "prompt_encoder.safetensors").unlink()
    with pytest.raises(FileNotFoundError, match="prompt_encoder"):
        check_model_dir(broken)
    with pytest.raises(FileNotFoundError, match="prompt_encoder"):
        ModelManager().load_character("broken", str(broken), "ja", device="cpu")


def test_random_v2pp_reference(pair):
    _, tchar = pair
    ref = tengine.make_random_reference(tchar, tengine.TTSEngine(RuntimeConfig(**BUCKETS)),
                                        ref_seconds=0.2)
    assert ref.ge.shape == (GIN, 1) and ref.ge_mrte.shape == (16, 1)
    assert np.isfinite(ref.ge).all() and not np.array_equal(ref.ge[:16], ref.ge_mrte)


def _read_wav(path):
    with wave.open(str(path), "rb") as f:
        assert f.getframerate() == 32000 and f.getnchannels() == 1
        return np.frombuffer(f.readframes(f.getnframes()), "<i2")


def test_api_drives_v2pp_on_cpu(assets, monkeypatch, tmp_path):
    """load_character -> set_reference_audio (HuBERT, Kaldi fbank ->
    ERes2NetV2 -> prompt encoder, on the CPU) -> tts writes a finite wav.
    Without a device named and no GPU, loading stops."""
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(assets["hubert"]))
    monkeypatch.setenv("GENIE_SV_MODEL", str(assets["sv"]))
    monkeypatch.setattr(sv, "_custom_fn", None)
    monkeypatch.setattr(sv, "_loaded_fns", {})
    monkeypatch.setattr(api, "engine", tengine.TTSEngine(RuntimeConfig(**BUCKETS)))
    calls = []
    real_apply = eres2net.apply
    monkeypatch.setattr(eres2net, "apply", lambda p, f: calls.append(f.shape) or real_apply(p, f))
    api.load_character("pp", assets["char"], "ja", device="cpu", dtype="float32")
    try:
        assert api.set_reference_audio("pp", assets["ref"], "こんにちは、てすとです", "ja")
        assert len(calls) == 1 and calls[0][-1] == 80      # the SV model ran on the fbank
        char = api.model_manager.get("pp")
        feats = reference_audio_cache._features.get((str(assets["ref"]), "pp"))
        assert feats is not None and feats.ge.shape == (GIN, 1) and feats.ge_mrte.shape == (16, 1)
        clip = reference_audio_cache.get_clip(str(assets["ref"]), "こんにちは、てすとです",
                                              "Japanese")
        tr = char.synth.reference(char, clip.audio_32k,
                                  sv_emb=sv.get_sv_fn("cpu")(clip.audio_16k))
        np.testing.assert_array_equal(feats.ge, tr["ge"])
        np.testing.assert_array_equal(feats.ge_mrte, tr["ge_mrte"])
        n_calls = len(calls)
        out = tmp_path / "pp.wav"
        wav = api.tts("pp", "きょうはいいてんきですね。", save_path=out)
        pcm = _read_wav(out)
        assert len(pcm) == len(wav) > 0 and np.isfinite(wav).all()
        assert len(calls) == n_calls                        # the features were cached
    finally:
        api.unload_character("pp")
        reference_audio_cache.clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        api.load_character("nodev", assets["char"], "ja")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sv.get_sv_fn()


def test_sv_model_missing_stops_the_reference(assets, monkeypatch, tmp_path):
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(assets["hubert"]))
    monkeypatch.setenv("GENIE_SV_MODEL", str(tmp_path / "none.safetensors"))
    monkeypatch.setattr(sv, "_custom_fn", None)
    monkeypatch.setattr(sv, "_loaded_fns", {})
    api.load_character("nosv", assets["char"], "ja", device="cpu", dtype="float32")
    try:
        with pytest.raises(RuntimeError, match="speaker-verification"):
            api.set_reference_audio("nosv", assets["ref"], "こんにちは", "ja")
    finally:
        api.unload_character("nosv")
        reference_audio_cache.clear()


# ---------------------------------------------------------------------------
# conversion and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pp_ckpts(tmp_path_factory):
    """The v2pp-shaped .pth of tests/test_v2pp.py and a matching T2S .ckpt."""
    root = tmp_path_factory.mktemp("ppckpt")
    g = torch.Generator().manual_seed(5)
    vcfg, jv2pp.VCFG = jv2pp.VCFG, JSoVITSConfig(**VITS_KW)   # its sv_emb at 20480
    try:
        pth = jv2pp.TestV2ppConvertPath()._build_pth(torch, g)
    finally:
        jv2pp.VCFG = vcfg
    d, ck = TCFG.embed_dim, {}

    def r(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    ck["model.ar_text_embedding.word_embeddings.weight"] = r(732, d)
    ck["model.ar_audio_embedding.word_embeddings.weight"] = r(TCFG.semantic_vocab, d)
    ck["model.ar_text_position.alpha"] = torch.ones(1)
    ck["model.ar_audio_position.alpha"] = torch.ones(1)
    ck["model.bert_proj.weight"] = r(d, 1024)
    ck["model.bert_proj.bias"] = r(d)
    ck["model.ar_predict_layer.weight"] = r(TCFG.semantic_vocab, d)
    for i in range(TCFG.num_layers):
        p = f"model.h.layers.{i}"
        for name, shape in (("self_attn.in_proj_weight", (3 * d, d)),
                            ("self_attn.in_proj_bias", (3 * d,)),
                            ("self_attn.out_proj.weight", (d, d)),
                            ("self_attn.out_proj.bias", (d,)),
                            ("linear1.weight", (TCFG.ffn_dim, d)),
                            ("linear1.bias", (TCFG.ffn_dim,)),
                            ("linear2.weight", (d, TCFG.ffn_dim)), ("linear2.bias", (d,))):
            ck[f"{p}.{name}"] = r(*shape)
        for n in ("norm1", "norm2"):
            ck[f"{p}.{n}.weight"] = torch.ones(d)
            ck[f"{p}.{n}.bias"] = torch.zeros(d)
    torch.save({"weight": ck}, root / "m.ckpt")
    torch.save({"weight": pth}, root / "m.pth")
    return root


def test_convert_v2pp_writes_the_jax_files(pp_ckpts, tmp_path):
    jout, tout = tmp_path / "jax", tmp_path / "torch"
    assert jconv.convert_character(pp_ckpts / "m.ckpt", pp_ckpts / "m.pth", jout,
                                   t2s_cfg=jv2pp.TCFG,
                                   sovits_cfg=JSoVITSConfig(**VITS_KW)) == "v2ProPlus"
    assert tconv.convert_character(pp_ckpts / "m.ckpt", pp_ckpts / "m.pth", tout,
                                   t2s_cfg=TCFG, sovits_cfg=VCFG) == "v2ProPlus"
    for name in ("t2s.safetensors", "vits.safetensors", "prompt_encoder.safetensors"):
        a, b = read_safetensors(tout / name), read_safetensors(jout / name)
        assert set(a) == set(b), name
        for k, v in a.items():
            assert v.dtype == b[k].dtype, k
            np.testing.assert_array_equal(v, b[k], k)
    assert json.loads((tout / "config.json").read_text()) == \
        json.loads((jout / "config.json").read_text())
    vits = load_params(tout / "vits.safetensors")
    pe = load_params(tout / "prompt_encoder.safetensors")
    assert "ref_enc" not in vits and {"ref_enc", "sv_emb", "ge_to512", "prelu_weight"} <= set(pe)


def test_cli_converts_and_drives_v2pp(pp_ckpts, assets, tmp_path, monkeypatch):
    """``python -m genie_tts_tpu_torch convert`` detects V2ProPlus by its keys
    and binds gin 1024 by default; the tiny checkpoint's sizes go into its
    config.json (as any non-default model's do), and ``tts --device cpu``
    then runs the whole V2ProPlus path in a fresh process."""
    from genie_tts_tpu_torch import __main__ as cli

    seen = {}
    real = tconv.convert_sovits

    def spy(sd, cfg):
        seen["cfg"] = cfg
        return real(sd, cfg)

    monkeypatch.setattr(tconv, "convert_sovits", spy)
    monkeypatch.setattr(tconv, "T2SConfig", lambda: TCFG)
    monkeypatch.setattr(tconv, "SoVITSConfig",
                        lambda: dataclasses.replace(VCFG, version="v2", gin_channels=512))
    out = tmp_path / "cli"
    assert cli.main(["convert", "--ckpt", str(pp_ckpts / "m.ckpt"), "--pth",
                     str(pp_ckpts / "m.pth"), "--out", str(out)]) == 0
    assert seen["cfg"].version == "v2ProPlus" and seen["cfg"].gin_channels == 1024
    cfg = json.loads((out / "config.json").read_text())
    assert cfg["version"] == "v2ProPlus" and (out / "prompt_encoder.safetensors").is_file()
    cfg.update(t2s=T2S_KW, sovits=VITS_KW)
    (out / "config.json").write_text(json.dumps(cfg))
    wav = tmp_path / "cli.wav"
    env = dict(os.environ, GENIE_HUBERT_DIR=str(assets["hubert"]),
               GENIE_SV_MODEL=str(assets["sv"]), PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "genie_tts_tpu_torch", "tts", "--model", str(out), "--lang",
         "ja", "--ref", str(assets["ref"]), "--ref-text", "こんにちは", "--text",
         "きょうは。", "--out", str(wav), "--device", "cpu", "--dtype", "float32"],
        env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    pcm = _read_wav(wav)
    assert len(pcm) > 0 and len(pcm) % (2 * VCFG.hop_length) == 0
