"""The port's slot scheduler on the CPU (tiny models).

Mirrors tests/test_slots.py:311-420: concurrent clients get finite audio,
a segment fault fails its waiters and the machine recovers, ``stop()``
fails in-flight waiters instead of hanging them. Also: the pooled
finisher's batched rows equal each row vocoded alone with the same flow
noise (rtol/atol 1e-5: fp32 sums over other paddings), and
``api._make_synth_fn(use_batcher=True)`` takes the slot route (int8 KV,
kernel route, whose wrapper runs the plain version on the CPU).
"""
import json
import threading
import time
import wave

import numpy as np
import pytest
import torch

from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import HubertConfig, RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert.io import save_character_config, save_params
from genie_tts_tpu_torch.models import hubert
from genie_tts_tpu_torch.runtime.engine import (ReferenceFeatures, TTSEngine,
                                                make_random_character)
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher, seg_widths, slot_geometry

TCFG = T2SConfig(phoneme_vocab=40, semantic_vocab=33, embed_dim=32, num_layers=2,
                 num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
                 max_decode_steps=64)
VCFG = SoVITSConfig(
    spec_channels=33, inter_channels=16, hidden_channels=16, filter_channels=32,
    n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16, ssl_dim=8, vq_codes=32,
    vq_dim=8, gin_channels=16, flow_layers=2, wn_layers=2, wn_kernel=5,
    upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
    resblock_kernels=(3,), resblock_dilations=((1, 3),), n_fft=64, hop_length=8,
    win_length=64)
BUCKETS = dict(phoneme_buckets=(16, 32), prompt_buckets=(16,), frame_buckets=(32, 64))


@pytest.fixture(scope="module")
def char():
    return make_random_character(t2s_cfg=TCFG, sovits_cfg=VCFG, dtype=torch.float32,
                                 device="cpu")


def _reference(char, seed=0):
    rng = np.random.default_rng(seed)
    ge = char.synth.reference(
        char, (rng.standard_normal(int(0.2 * 32000)) * 0.05).astype(np.float32))["ge"]
    return ReferenceFeatures(
        phones=rng.integers(1, TCFG.phoneme_vocab, 12).astype(np.int32),
        bert=np.zeros((12, TCFG.bert_dim), np.float32),
        prompt_tokens=rng.integers(0, 32, 5).astype(np.int32), ge=ge,
        ge_mrte=ge[:VCFG.mrte_channels])


def _batcher(char, **slot_kw):
    eng = TTSEngine(RuntimeConfig(**BUCKETS, slot_phoneme_bucket=32,
                                  slot_prompt_bucket=16, slot_steps=8, **slot_kw))
    return SlotBatcher(eng, char)


def _phones(n):
    ph = np.arange(1, n + 1, dtype=np.int32)
    return ph, np.zeros((len(ph), TCFG.bert_dim), np.float32)


def test_concurrent_clients_get_audio(char):
    sb = _batcher(char, slot_batch=4, slot_ring=32)
    ref = _reference(char)
    outs = {}

    def client(i):
        outs[i] = sb.synthesize(ref, *_phones(4 + i), timeout=300, min_steps=10,
                                max_steps=20)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    sb.stop()
    assert set(outs) == {0, 1, 2}
    for a in outs.values():
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert 0 < len(a) <= 2 * 20 * VCFG.hop_length and len(a) % (2 * VCFG.hop_length) == 0
    assert sb.stats["segments"] >= 2 and sb.stats["steps"] == 8 * sb.stats["segments"]


def test_segment_fault_fails_waiters_then_recovers(char):
    sb = _batcher(char, slot_batch=2, slot_ring=16)
    ref = _reference(char)
    real_seg = sb._decode_seg
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected device fault")
        return real_seg(*a, **kw)

    sb._decode_seg = flaky
    with pytest.raises(RuntimeError, match="injected device fault"):
        sb.synthesize(ref, *_phones(5), timeout=120, max_steps=12)
    audio = sb.synthesize(ref, *_phones(5), timeout=120, max_steps=12)
    sb.stop()
    assert len(audio) > 0 and np.isfinite(audio).all()


def test_stop_fails_waiters(char):
    sb = _batcher(char, slot_batch=2, slot_ring=64)
    ref = _reference(char)
    result = {}

    def client():
        try:
            # a long pinned decode, so stop() lands mid-flight
            result["audio"] = sb.synthesize(ref, *_phones(5), timeout=120,
                                            min_steps=64, max_steps=64)
        except BaseException as e:  # noqa: BLE001
            result["error"] = e

    t = threading.Thread(target=client)
    t.start()
    time.sleep(0.5)
    sb.stop()
    t.join(timeout=60)
    assert not t.is_alive(), "waiter hung after stop()"
    assert "audio" in result or isinstance(result.get("error"), RuntimeError)
    sb._thread.join(timeout=60)
    assert not sb._thread.is_alive()


def test_pooled_finisher_rows_equal_solo(char):
    eng = TTSEngine(RuntimeConfig(**BUCKETS))
    ref = _reference(char)
    rng = np.random.default_rng(5)
    lens = (10, 23, 40)                  # frame buckets 32, 32, 64
    items = [(ref, rng.integers(1, 40, 5 + 3 * i).astype(np.int32),
              rng.integers(0, 32, n).astype(np.int32)) for i, n in enumerate(lens)]
    noise = rng.standard_normal((3, 2 * max(lens), VCFG.inter_channels)).astype(np.float32)
    batched = eng.vocode_codes_batch(char, items, noise=noise)
    for i, n in enumerate(lens):
        solo = eng.vocode_codes_batch(char, [items[i]], noise=noise[i:i + 1])[0]
        assert len(batched[i]) == len(solo) == 2 * n * VCFG.hop_length
        np.testing.assert_allclose(batched[i], solo, rtol=1e-5, atol=1e-5)
    pcm = eng.vocode_codes_batch(char, items[:2], noise=noise[:2], pcm16=True)
    assert pcm[0].dtype == np.int16
    np.testing.assert_allclose(pcm[1].astype(np.float32) / 32767.0, batched[1],
                               atol=1.0 / 32767.0 + 1e-6)


T2S_KW = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64, bert_dim=1024,
              ssl_dim=24, max_decode_steps=24)
VITS_KW = dict(inter_channels=16, hidden_channels=16, filter_channels=32, n_layers=2,
               mrte_channels=16, ssl_dim=24, vq_dim=24, gin_channels=16, flow_layers=2,
               wn_layers=2, upsample_initial=32, resblock_kernels=(3,),
               resblock_dilations=((1, 3),))
HUBERT_KW = dict(conv_dims=(32,) * 7, embed_dim=24, num_layers=2, num_heads=4,
                 ffn_dim=48, conv_pos_kernel=16, conv_pos_groups=4)


def test_make_synth_fn_takes_the_slot_route_on_cpu(tmp_path, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    rc = make_random_character(t2s_cfg=T2SConfig(**T2S_KW),
                               sovits_cfg=SoVITSConfig(**VITS_KW),
                               dtype=torch.float32, device="cpu")
    cdir = tmp_path / "char"
    cdir.mkdir()
    save_params(rc.t2s_params, cdir / "t2s.safetensors")
    save_params(rc.sovits_params, cdir / "vits.safetensors")
    save_character_config(cdir / "config.json", version="v2", language="ja",
                          extra={"t2s": T2S_KW, "sovits": VITS_KW})
    hub = tmp_path / "hubert"
    hub.mkdir()
    save_params(hubert.init_params(gen, HubertConfig(**HUBERT_KW), dtype=torch.float32),
                hub / "hubert.safetensors")
    (hub / "config.json").write_text(json.dumps(HUBERT_KW))
    rng = np.random.default_rng(0)
    t = np.arange(int(3.2 * 32000)) / 32000.0
    ref = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.standard_normal(t.size)
    with wave.open(str(tmp_path / "ref.wav"), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(32000)
        f.writeframes((ref * 32767).astype("<i2").tobytes())

    monkeypatch.setenv("GENIE_HUBERT_DIR", str(hub))
    monkeypatch.setattr(api, "engine", TTSEngine(RuntimeConfig(
        phoneme_buckets=(32, 64), prompt_buckets=(32, 128), frame_buckets=(32, 64),
        slot_batch=2, slot_steps=8, slot_phoneme_bucket=64, slot_prompt_bucket=128,
        slot_kv_int8=True)))
    api.load_character("slots", cdir, "ja", device="cpu", dtype="float32")
    try:
        assert api.set_reference_audio("slots", tmp_path / "ref.wav",
                                       "こんにちは、てすとです", "ja")
        synth, _ = api._make_synth_fn("slots", use_batcher=True)
        audio = synth("きょうはいいてんきですね。")
        sb = api._slot_batchers["slots"]
        assert sb.cfg.slot_kv_int8 and sb._state.k_cache.dtype == torch.int8
        assert sb.stats["segments"] > 0 and sb.pcm16
        assert audio.dtype == np.int16 and len(audio) > 0
        assert len(audio) % (2 * 640) == 0
        # the solo route without the batcher: float32, no new segments
        segs = sb.stats["segments"]
        solo = api._make_synth_fn("slots")[0]("きょうはいいてんきですね。")
        assert solo.dtype == np.float32 and sb.stats["segments"] == segs
    finally:
        api.unload_character("slots")
    assert "slots" not in api._slot_batchers
    sb._thread.join(timeout=60)
    assert not sb._thread.is_alive()


def test_seg_widths_keep_the_join_width_only_on_the_grid():
    """The join width is kept only where it divides slot_steps and the
    ring: mixed widths then keep the head on its grid. The defaults
    (32 / 16) are unchanged."""
    assert seg_widths(RuntimeConfig(), 512) == (32, 16)
    assert seg_widths(RuntimeConfig(slot_steps=12, slot_join_steps=8), 48) == (12,)
    assert seg_widths(RuntimeConfig(slot_steps=8, slot_join_steps=16), 32) == (8,)
    assert seg_widths(RuntimeConfig(slot_steps=12, slot_join_steps=4), 48) == (12, 4)
    assert seg_widths(RuntimeConfig(slot_join_steps=0), 512) == (32,)


def test_slot_batcher_refuses_widths_that_overflow_the_ring(char):
    """slot_steps 12 with a join width of 8 over a 48-step ring: a head at
    44 (8 + 3 x 12) fits neither width, and the segment's merge would
    write past the ring (an IndexError here, a device assert inside a
    graph replay on the card). The machine refuses the configuration at
    construction, naming the three settings."""
    cfg = RuntimeConfig(**BUCKETS, slot_phoneme_bucket=32, slot_prompt_bucket=16,
                        slot_steps=12, slot_join_steps=8, slot_ring=48)
    assert slot_geometry(cfg, char.t2s_cfg)[2] == 48
    with pytest.raises(ValueError, match="slot_join_steps=8.*slot_steps=12.*slot_ring=48"):
        SlotBatcher(TTSEngine(cfg), char)
    ok = SlotBatcher(TTSEngine(RuntimeConfig(**BUCKETS, slot_phoneme_bucket=32,
                                             slot_prompt_bucket=16, slot_steps=12,
                                             slot_join_steps=4, slot_ring=48)), char)
    assert ok.join_W == 4
    ok.stop()
