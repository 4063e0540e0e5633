"""GPT-SoVITS V4 in the port against the benchmark's plain reference
(``perfbench/reference/sovits_v4.py``: float32 PyTorch, one request at a
time, unpadded), on the CPU at tiny widths with seeded random weights.

Every comparison runs in float32 on both sides, so what is left is the
order of float32 sums: the port pads, batches and runs convolutions as
``F.conv1d`` over [B, C, T], the reference convolves one row and writes
attention out by hand. The tolerances say which stack they cover:

* the Slaney filterbank: two implementations of librosa's formula, one
  in numpy float64 cast to float32 (within 1e-6 of the largest weight);
* the log-mel: a float32 rfft against ``torch.stft`` (within 1e-4, logs
  of magnitudes near the 1e-5 floor);
* ``decode_encp``, the DiT, the CFM, the chunk loop and the vocoder:
  relative L2 distances of 1e-5 or less (dozens of float32 convolutions
  and matmuls, tens of Euler steps compounding their roundings).
"""
import dataclasses
import json
import urllib.request
import wave

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch.config import (HubertConfig, RuntimeConfig, SoVITSConfig, T2SConfig,
                                        V4Config)
from genie_tts_tpu_torch.models import hubert, sovits, sovits_v4, t2s
from genie_tts_tpu_torch.ops import audio
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import engine as tengine
from genie_tts_tpu_torch.runtime.engine import TTSEngine
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher
from perfbench.reference import sovits_v4 as ref

TCFG = T2SConfig(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=24,
                 max_decode_steps=64)
SCFG = SoVITSConfig(spec_channels=1025, inter_channels=16, hidden_channels=16,
                    filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16,
                    ssl_dim=24, vq_codes=1024, vq_dim=24, gin_channels=16, version="v4")
V4 = V4Config(fea_channels=16, wn_layers=2, dit_dim=32, dit_depth=2, dit_heads=2,
              dit_head_dim=16, freq_embed_dim=16, sample_steps=4, T_ref=16, T_chunk=40,
              upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
              resblock_kernels=(3,), resblock_dilations=((1, 3),))
V4D = dict(vars(V4))
RCFG = RuntimeConfig(phoneme_buckets=(16, 32, 64), prompt_buckets=(32, 64),
                     frame_buckets=(16, 32, 64), step_caps=(16, 32, 64), slot_batch=4,
                     slot_steps=8, slot_join_steps=4, slot_ring=32, slot_phoneme_bucket=64,
                     slot_prompt_bucket=64, vocode_chunk=16, vocode_halo=12,
                     batch_window_ms=1.0, t2s_int8=False)
GREEDY = SamplingConfig(top_k=1)


def rel(a, b) -> float:
    a, b = torch.as_tensor(a).float(), torch.as_tensor(b).float()
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a - b).norm() / b.norm())


@pytest.fixture(scope="module")
def params():
    return sovits_v4.init_params(torch.Generator().manual_seed(3), SCFG, V4, dtype=torch.float32)


def _rows(params, lens, seed=0, prompts=(16,)):
    """Random ``fea`` rows of ``lens`` frames and prompts of ``prompts`` frames."""
    g = torch.Generator().manual_seed(seed)
    out = []
    for i, n in enumerate(lens):
        P = prompts[i % len(prompts)]
        out.append(sovits_v4.Row(fea=torch.randn((n, 16), generator=g),
                                 fea_ref=torch.randn((P, 16), generator=g),
                                 mel2=torch.rand((P, 100), generator=g) * 2 - 1,
                                 seed=100 + i))
    return out


# -- the prompt mel ---------------------------------------------------------

def test_the_slaney_filterbank_and_the_prompt_mel_are_the_references():
    fb = audio.slaney_mel_banks(100, 1280, 32000, 0.0, 16000.0)
    want = ref.filterbank(100, 1280, 32000, 0.0, 16000.0)
    assert fb.shape == (100, 641)
    np.testing.assert_allclose(fb, want, rtol=0, atol=1e-6 * want.max())
    rng = np.random.default_rng(0)
    t = np.arange(32000) / 32000.0
    clip = (0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * rng.standard_normal(t.size)
            ).astype(np.float32)
    got = sovits_v4.reference_mel(torch.from_numpy(clip), V4)
    want = ref.mel(torch.from_numpy(clip), V4D).T
    assert got.shape == (100, 100)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


# -- decode_encp and the WaveNet ---------------------------------------------

def test_decode_encp_alone_and_padded_is_the_references(params):
    g = torch.Generator().manual_seed(1)
    ge = torch.randn((2, 16, 1), generator=g)
    lens, tlens = [9, 5], [7, 11]
    codes = torch.randint(0, 1024, (2, 9), generator=g)
    text = torch.randint(1, 700, (2, 11), generator=g)
    fea = sovits_v4.decode_encp(params, SCFG, V4, codes, torch.tensor(lens), text,
                                torch.tensor(tlens), ge)
    assert fea.shape == (2, 36, 16)
    for i in range(2):
        want = ref.decode_encp(params, codes[i, :lens[i]], text[i, :tlens[i]], ge[i, :, 0],
                               SCFG.n_heads).T
        assert rel(fea[i, :4 * lens[i]], want) < 1e-5
        assert float(fea[i, 4 * lens[i]:].abs().sum()) == 0.0


# -- the DiT ------------------------------------------------------------------

@pytest.mark.parametrize("lens", [[23], [23, 17, 9]], ids=["alone", "padded"])
def test_the_dit_forward_is_the_references(params, lens):
    p = params["cfm"]
    g = torch.Generator().manual_seed(2)
    R, T = len(lens), max(lens)
    x, cond = torch.randn((R, T, 100), generator=g), torch.randn((R, T, 100), generator=g)
    mu = torch.randn((R, T, 16), generator=g)
    mask = torch.arange(T)[None] < torch.tensor(lens)[:, None]
    maskf = mask[..., None].float()
    text = sovits_v4.text_embed(p["text_blocks"], mu, maskf)
    temb = sovits_v4.timestep_embed(p["time_embed"], 0.25, V4, torch.float32) + \
        sovits_v4.timestep_embed(p["d_embed"], 0.25, V4, torch.float32)
    v = sovits_v4.dit(p, V4, x, cond, text, temb, mask, sovits_v4._rope(T, 16, x.device))
    for i, n in enumerate(lens):
        t_ref = ref._text(p["text_blocks"], mu[i, :n], False)
        assert rel(text[i, :n], t_ref) < 1e-5
        e = ref._t_embed(p["time_embed"], 0.25, 16) + ref._t_embed(p["d_embed"], 0.25, 16)
        want = ref.dit(p, V4D, x[i, :n], cond[i, :n], t_ref, e)
        assert rel(v[i, :n], want) < 1e-5


def test_a_four_step_cfm_with_given_noise_is_the_references(params):
    g = torch.Generator().manual_seed(4)
    T, P = 37, 12
    mu, x0 = torch.randn((1, T, 16), generator=g), torch.randn((1, T, 100), generator=g)
    prompt = torch.zeros((1, T, 100))
    prompt[0, :P] = torch.rand((P, 100), generator=g)
    got = sovits_v4.cfm_sample(params["cfm"], V4, mu, prompt, x0, torch.tensor([T]),
                               torch.tensor([P]), 4)[0]
    want = ref.cfm(params["cfm"], V4D, mu[0], prompt[0, :P], x0[0], 4)
    assert float(got[:P].abs().max()) == 0.0
    assert rel(got, want) < 1e-5


# -- the chunk loop, the vocoder -----------------------------------------------

def test_the_chunk_loop_and_vocoder_over_four_chunks_are_the_references(params):
    row = _rows(params, [80])[0]                  # 80 frames: slices of 24 -> 4 chunks
    assert len(sovits_v4._chunk_plan(row, V4)) == 4
    events = []
    mel = sovits_v4.cfm_rows(params, V4, [row], (1, 2, 4), events)[0]
    want_mel, want_audio = ref.synthesize(params, V4D, row.fea.T, row.fea_ref, row.mel2,
                                          row.seed)
    assert mel.shape == (80, 100) and rel(mel, want_mel) < 1e-5
    got = sovits.hifigan(params["dec"], sovits_v4.denorm_spec(mel)[None], None, V4)[0]
    assert got.shape == (80 * 8,) and rel(got, want_audio) < 1e-5


def test_the_vocoder_at_published_rates_makes_480_samples_a_frame():
    v4 = dataclasses.replace(V4, upsample_rates=(10, 6, 2, 2, 2),
                             upsample_kernels=(20, 12, 4, 4, 4),
                             resblock_kernels=(3, 7, 11), resblock_dilations=((1, 3, 5),) * 3)
    p = sovits_v4.init_params(torch.Generator().manual_seed(5), SCFG, v4,
                              dtype=torch.float32)["dec"]
    m = torch.randn((1, 8, 100), generator=torch.Generator().manual_seed(6)) - 5.0
    got = sovits.hifigan(p, m, None, v4)[0]
    want = ref.vocode(p, m[0].T, dict(vars(v4)))
    assert got.shape == want.shape == (8 * 480,) and v4.samples_per_code == 1920
    assert rel(got, want) < 1e-5


def test_a_padded_batch_of_rows_at_other_lengths_and_chunks_equals_each_alone(params):
    """Three requests (two references: prompts of 16 and 11 frames) of 3,
    2 and 1 chunks: the first launch batches all three at other lengths,
    the second two, the third one; each row is what it is alone."""
    rows = _rows(params, [70, 40, 20], seed=7, prompts=(16, 11))
    calls = []
    orig = sovits_v4.cfm_graph

    def spy(p, cfg, R, T, steps):
        calls.append((R, T))
        return orig(p, cfg, R, T, steps)

    sovits_v4.cfm_graph = spy
    try:
        batched = sovits_v4.cfm_rows(params, V4, rows, (1, 2, 4))
    finally:
        sovits_v4.cfm_graph = orig
    assert calls == [(4, 40), (2, 40), (1, 40)]
    for row, got in zip(rows, batched):
        alone = sovits_v4.cfm_rows(params, V4, [row], (1, 2, 4))[0]
        assert got.shape == (row.fea.shape[0], 100)
        assert rel(got, alone) < 1e-6


# -- the normal path ----------------------------------------------------------

@pytest.fixture(scope="module")
def char():
    return tengine.make_random_character("v4", seed=1, t2s_cfg=TCFG, sovits_cfg=SCFG,
                                         dtype=torch.float32, device="cpu", v4_cfg=V4,
                                         eos_boost=0.0)


def _served(eng, monkeypatch):
    """Each finisher batch's rows and CFM seeds, as dispatched."""
    seen = []
    real = eng.vocode_codes_dispatch

    def spy(ch, items, *a, **k):
        seen.extend((np.asarray(c).copy(), s) for (_, _, c), s in zip(items, k["cfm_seeds"]))
        return real(ch, items, *a, **k)

    monkeypatch.setattr(eng, "vocode_codes_dispatch", spy)
    return seen


def _reference_audio(char, feats, phones, codes, seed):
    fea = ref.decode_encp(char.sovits_params, torch.as_tensor(codes), torch.as_tensor(phones),
                          torch.as_tensor(feats.ge[:, 0]), SCFG.n_heads)
    return ref.synthesize(char.sovits_params, V4D, fea, feats.fea_ref, feats.mel2, seed)[1]


def test_solo_and_the_slot_machine_serve_the_references_audio(char, monkeypatch):
    eng = TTSEngine(RCFG)
    feats = tengine.make_random_reference(char, eng, ref_seconds=1.0, seed=2)
    assert feats.mel2.shape == feats.fea_ref.shape[:1] + (100,) and len(feats.mel2) == 16
    seen = _served(eng, monkeypatch)
    phones = np.arange(1, 12).astype(np.int32)
    bert = np.zeros((len(phones), TCFG.bert_dim), np.float32)
    solo = eng.synthesize_utterance(char, feats, phones, bert, sampling=GREEDY, seed=5,
                                    fixed_steps=18)
    sb = SlotBatcher(eng, char)
    try:
        slot = [sb.synthesize(feats, phones[:n], bert[:n], sampling=GREEDY, min_steps=k,
                              max_steps=k, cfm_seed=77 + k) for n, k in ((11, 18), (6, 9))]
    finally:
        sb.stop()
    assert [len(c) for c, _ in seen] == [18, 18, 9] and [s for _, s in seen] == [5, 95, 86]
    for audio_, (codes, seed), ph in zip([solo] + slot, seen, [phones, phones, phones[:6]]):
        assert audio_.shape == (len(codes) * V4.samples_per_code,)
        assert rel(audio_, _reference_audio(char, feats, ph, codes, seed)) < 1e-5
    assert char.sample_rate == 48000


def test_the_streaming_routes_refuse_v4(char):
    eng = TTSEngine(RCFG)
    feats = tengine.make_random_reference(char, eng, ref_seconds=1.0, seed=2)
    phones = np.arange(1, 8).astype(np.int32)
    bert = np.zeros((7, TCFG.bert_dim), np.float32)
    with pytest.raises(NotImplementedError, match="V4"):
        next(eng.synthesize_utterance_stream(char, feats, phones, bert))
    sb = SlotBatcher(eng, char)
    try:
        with pytest.raises(NotImplementedError, match="V4"):
            next(sb.synthesize_stream(feats, phones, bert))
    finally:
        sb.stop()
    with pytest.raises(NotImplementedError, match="V4"):
        SlotBatcher(TTSEngine(dataclasses.replace(RCFG, slot_stream_finisher=True)), char)


# -- a V4 character directory through the api and the server --------------------

HUB = HubertConfig(conv_dims=(16,) * 7, embed_dim=24, num_layers=1, num_heads=4, ffn_dim=32,
                   conv_pos_kernel=16, conv_pos_groups=4)


def _write_v4(root):
    from genie_tts_tpu_torch.convert.io import save_params

    gen = torch.Generator().manual_seed(0)
    d = root / "v4"
    d.mkdir()
    tp = t2s.init_params(gen, TCFG, dtype=torch.float32)
    tp["predict"]["w"][:, 1024] = 0.0
    save_params(tp, d / "t2s.safetensors")
    save_params(sovits_v4.init_params(gen, SCFG, V4, dtype=torch.float32),
                d / "vits.safetensors")
    cfg = {"version": "v4", "language": "zh", "t2s": dataclasses.asdict(TCFG),
           "sovits": dataclasses.asdict(SCFG), "v4": dataclasses.asdict(V4)}
    (d / "config.json").write_text(json.dumps(cfg))
    hub = root / "hubert"
    hub.mkdir()
    save_params(hubert.init_params(gen, HUB, dtype=torch.float32), hub / "hubert.safetensors")
    (hub / "config.json").write_text(json.dumps(dataclasses.asdict(HUB)))
    t = np.arange(int(3.2 * 32000)) / 32000.0
    wav = root / "ref.wav"
    with wave.open(str(wav), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(32000)
        f.writeframes((0.3 * np.sin(2 * np.pi * 200 * t) * 32767).astype("<i2").tobytes())
    return d, hub, wav


def test_tts_and_http_tts_on_a_v4_character_dir(tmp_path, monkeypatch):
    from genie_tts_tpu_torch import api

    d, hub, wav = _write_v4(tmp_path)
    eng = TTSEngine(dataclasses.replace(RCFG, serve_slots=False))
    monkeypatch.setenv("GENIE_HUBERT_DIR", str(hub))
    monkeypatch.setattr(api, "engine", eng)
    monkeypatch.setattr(api, "_batcher", None)
    seen = _served(eng, monkeypatch)
    api.load_character("v4c", d, "ja", device="cpu", dtype=torch.float32)
    srv = None
    try:
        assert api.set_reference_audio("v4c", wav, "こんにちは", "ja")
        char = api.model_manager.get("v4c")
        assert char.version == "v4" and char.v4_cfg == V4 and api.sample_rate("v4c") == 48000
        feats = api._reference_features(char, api._reference_audios["v4c"])
        assert len(feats.mel2) == 16            # 3.2 s: 320 mel frames, cut to T_ref
        text = "きょうはいいてんきです"
        out = api.tts("v4c", text, split_sentence=False)
        (codes, seed), = seen
        from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert

        phones = get_phones_and_bert("。" + text, char.language)[0]
        assert out.shape == (len(codes) * V4.samples_per_code,)
        assert rel(out, _reference_audio(char, feats, phones, codes, seed)) < 1e-5
        srv = api.start_server(host="127.0.0.1", port=0, block=False, device="cpu")
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/tts",
            data=json.dumps({"character_name": "v4c", "text": text}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            body = r.read()
            assert r.headers["X-Sample-Rate"] == "48000"
        assert len(body) == 2 * len(seen[-1][0]) * V4.samples_per_code
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        api.unload_character("v4c")
        api._reference_audios.pop("v4c", None)
        if api._batcher is not None:
            api._batcher.stop()


# -- conversion ----------------------------------------------------------------

def test_the_converter_tells_v4_and_refuses_it(tmp_path, monkeypatch):
    from genie_tts_tpu_torch.convert import torch_convert as tc

    z = np.zeros(1, np.float32)
    sd = {"ref_enc.fc.fc.weight": z, "enc_p.proj.weight": z}
    assert tc.detect_version_from_keys(sd) == "v2"
    for k in ("cfm.estimator.proj_out.weight", "bridge.0.weight", "wns1.pre.weight"):
        assert tc.detect_version_from_keys({**sd, "vq_model." + k: z}) == "v4"
    monkeypatch.setattr(tc, "load_torch_ckpt", lambda p: {})
    monkeypatch.setattr(tc, "load_torch_pth", lambda p: {**sd, "cfm.estimator.x": z})
    out = tmp_path / "out"
    with pytest.raises(NotImplementedError, match="V4"):
        tc.convert_character("a.ckpt", "b.pth", out)
    assert not out.exists()
