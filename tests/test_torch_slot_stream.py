"""The port's slot streaming (window pump), mirroring tests/test_slot_windows.py.

Tiny random characters on the CPU (the configs of test_slot_windows.py):

* per-row noise tables make prefix latents noise-stable: the same request
  recomputed in another batch position, beside another row and in a
  bigger frame bucket gives the same latent on its frames (rtol 1e-4,
  atol 1e-5: fp32 sums over other paddings), and growing the codes moves
  the early prefix far less than fresh noise does;
* window vocoding is interior-exact: two halo-padded windows equal one
  whole-latent pass (rtol 2e-2, atol 2e-3, as the JAX test), and equal the
  JAX ``vocode_window_rows`` on the same latent (rtol/atol 1e-4);
* ``synthesize_stream`` yields ordered pieces that reassemble to 2 * codes
  * hop samples, with concurrent streams;
* streaming rows pump per row with the machine-wide windows flag off,
  beside blocking requests served by the pooled finisher;
* a decode long enough for several pumps assembles contiguously;
* ``_win_for`` picks the smallest window covering a job;
* the speculative first-piece codes put together on the device equal the
  host assembly and the JAX ``_spec_codes_jit``.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu.runtime.slot_batcher import _spec_codes_jit
from genie_tts_tpu_torch.config import RuntimeConfig, SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert.io import flatten_tree
from genie_tts_tpu_torch.models import sovits
from genie_tts_tpu_torch.runtime.engine import (ReferenceFeatures, TTSEngine,
                                                make_random_character)
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher, spec_codes

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
HOP = VCFG.hop_length
PH = np.arange(1, 6, dtype=np.int32)
BERT = np.zeros((len(PH), TCFG.bert_dim), np.float32)
TIMEOUT = 120


@pytest.fixture(scope="module")
def char():
    return make_random_character(t2s_cfg=TCFG, sovits_cfg=VCFG, dtype=torch.float32,
                                 device="cpu")


def _batcher(char, windows: bool, **over):
    cfg = RuntimeConfig(**{
        **dict(phoneme_buckets=(16, 32), prompt_buckets=(16,), frame_buckets=(16, 32, 64),
               slot_batch=4, slot_steps=4, slot_ring=32, slot_phoneme_bucket=32,
               slot_prompt_bucket=16, vocode_chunk=16, vocode_halo=4),
        **over, "slot_stream_finisher": windows})
    eng = TTSEngine(cfg)
    rng = np.random.default_rng(0)
    ge = char.synth.reference(
        char, (rng.standard_normal(int(0.2 * 32000)) * 0.05).astype(np.float32))["ge"]
    # prompt tokens inside this character's 33-token vocabulary
    ref = ReferenceFeatures(
        phones=rng.integers(1, TCFG.phoneme_vocab, 12).astype(np.int32),
        bert=np.zeros((12, TCFG.bert_dim), np.float32),
        prompt_tokens=rng.integers(0, 32, 5).astype(np.int32), ge=ge,
        ge_mrte=ge[:VCFG.mrte_channels])
    return SlotBatcher(eng, char), ref


def _run(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads), "a client hung"


def test_latent_rows_prefix_noise_stable():
    vcfg = SoVITSConfig(**{**VCFG.__dict__, "flow_layers": 1, "wn_layers": 1,
                           "wn_kernel": 3})
    params = sovits.init_params(torch.Generator().manual_seed(0), vcfg, torch.float32)
    rng = np.random.default_rng(0)
    codes80 = rng.integers(0, vcfg.vq_codes, 80)
    text = torch.as_tensor(rng.integers(1, 40, 6))
    ge = torch.zeros((1, vcfg.gin_channels, 1))
    gm = torch.zeros((1, vcfg.mrte_channels, 1))
    tabA = torch.randn((256, vcfg.inter_channels), generator=torch.Generator().manual_seed(1))
    tabB = torch.randn((256, vcfg.inter_channels), generator=torch.Generator().manual_seed(2))

    def latent(tabs, codes_b, lens):
        B = codes_b.shape[0]
        return sovits.synthesize_latent_rows(
            params, vcfg, torch.stack(tabs), torch.as_tensor(codes_b),
            torch.tensor(lens), text.expand(B, -1), torch.full((B,), len(text)),
            ge.expand(B, -1, -1), gm.expand(B, -1, -1), 0.5).numpy()

    c60 = np.zeros((1, 64), np.int64)
    c60[0, :60] = codes80[:60]
    zA = latent([tabA], c60, [60])
    cB = np.zeros((2, 96), np.int64)
    cB[0, :25] = rng.integers(0, vcfg.vq_codes, 25)
    cB[1, :60] = codes80[:60]
    zBA = latent([tabB, tabA], cB, [25, 60])
    np.testing.assert_allclose(zA[0, :120], zBA[1, :120], rtol=1e-4, atol=1e-5)
    c80 = np.zeros((1, 96), np.int64)
    c80[0, :80] = codes80
    z80 = latent([tabA], c80, [80])
    zfresh = latent([tabB], c60, [60])
    d_grow = float(np.sqrt(np.mean((zA[0, :60] - z80[0, :60]) ** 2)))
    d_key = float(np.sqrt(np.mean((zA[0, :60] - zfresh[0, :60]) ** 2)))
    assert d_grow < 0.5 * d_key, (d_grow, d_key)


def test_window_vocode_interior_exact():
    gen = torch.Generator().manual_seed(0)
    params = sovits.init_params(gen, VCFG, torch.float32)
    rng = np.random.default_rng(1)
    F = 48
    z = torch.as_tensor(rng.standard_normal((1, F, VCFG.inter_channels)) * 0.3,
                        dtype=torch.float32)
    ge = torch.zeros((1, VCFG.gin_channels, 1))
    whole = sovits.vocode_frames(params, VCFG, z, ge, torch.tensor([F]))[0].numpy()
    jparams = jax.tree.map(jnp.asarray, {k: v.numpy() for k, v in
                                         flatten_tree(params).items()})
    from genie_tts_tpu.convert.io import unflatten_tree

    jparams = unflatten_tree(jparams)
    halo, chunk = 6, 24
    win = chunk + 2 * halo
    pieces = []
    for start in (0, chunk):
        s0 = int(np.clip(start - halo, 0, F - win))
        a = sovits.vocode_window_rows(params, VCFG, z, ge, torch.tensor([s0]),
                                      torch.tensor([F]), win)[0].numpy()
        j = np.asarray(jsovits.vocode_window_rows(
            jparams, VCFG, jnp.asarray(z.numpy()), jnp.asarray(ge.numpy()),
            jnp.array([s0], jnp.int32), jnp.array([F], jnp.int32), win))[0]
        np.testing.assert_allclose(a, j, rtol=1e-4, atol=1e-4)
        pieces.append(a[(start - s0) * HOP:(start - s0 + chunk) * HOP])
    stitched = np.concatenate(pieces)
    assert stitched.shape == whole.shape
    np.testing.assert_allclose(stitched, whole, rtol=2e-2, atol=2e-3)


def test_synthesize_stream_pieces(char):
    sb, ref = _batcher(char, True, vocode_chunk=8, vocode_halo=2)
    outs = {}

    def client(i):
        outs[i] = list(sb.synthesize_stream(ref, PH, BERT, timeout=TIMEOUT,
                                            min_steps=24, max_steps=24))

    _run([threading.Thread(target=client, args=(i,)) for i in range(2)])
    sb.stop()
    assert sb.stats["streams"] == 2
    for i, pieces in outs.items():
        assert len(pieces) >= 2, f"req {i} streamed {len(pieces)} pieces"
        total = np.concatenate(pieces)
        assert len(total) == 2 * 24 * HOP and np.isfinite(total).all()


def test_mixed_streaming_without_windows_flag(char):
    sb, ref = _batcher(char, False, vocode_chunk=8, vocode_halo=2)
    assert not sb.windows
    outs = {}

    def stream_client():
        outs["s"] = list(sb.synthesize_stream(ref, PH, BERT, timeout=TIMEOUT,
                                              min_steps=24, max_steps=24))

    def block_client(i):
        outs[i] = sb.synthesize(ref, PH, BERT, timeout=TIMEOUT, min_steps=24,
                                max_steps=24)

    _run([threading.Thread(target=stream_client)]
         + [threading.Thread(target=block_client, args=(i,)) for i in range(2)])
    sb.stop()
    assert len(outs["s"]) >= 2, f"streamed {len(outs['s'])} pieces"
    total = np.concatenate(outs["s"])
    assert len(total) == 2 * 24 * HOP and np.isfinite(total).all()
    for i in range(2):
        assert len(outs[i]) == 2 * 24 * HOP and np.isfinite(outs[i]).all()
    # the blocking rows never pumped: no noise table drawn for them
    assert sb.stats["streams"] == 1


def test_windows_multi_pump_assembly(char):
    sb, ref = _batcher(char, True, vocode_chunk=8, vocode_halo=2)
    assert sb.windows and sb.chunk // 2 <= sb.join_W  # pumps every segment
    outs = {}

    def client(i):
        outs[i] = sb.synthesize(ref, PH, BERT, timeout=TIMEOUT, min_steps=24,
                                max_steps=24)

    _run([threading.Thread(target=client, args=(i,)) for i in range(3)])
    sb.stop()
    for i, a in outs.items():
        assert len(a) == 2 * 24 * HOP, f"req {i}: {len(a)} samples"
        assert np.isfinite(a).all() and a.dtype == np.float32


def test_win_for_picks_smallest_covering_window(char):
    sb, _ = _batcher(char, True, vocode_chunk=64, vocode_halo=4)
    fp = sb.first_piece
    assert fp == 16 and sb.win_first == fp + 2 * sb.halo
    assert sb._win_for([(None, None, 8, 0, fp)]) == sb.win_first
    assert sb._win_for([(None, None, 8, 0, sb.chunk)]) == sb.win
    assert sb._win_for([(None, None, 8, 0, fp),
                        (None, None, 8, 0, sb.chunk // 2)]) == sb.win_small


def test_spec_codes_matches_host_assembly():
    rng = np.random.default_rng(0)
    W, B, fb, count, vq = 16, 4, 64, 12, 32
    seg_tok = rng.integers(0, 35, (B, W)).astype(np.int32)
    tok0s = rng.integers(0, 35, (2,)).astype(np.int32)
    slots = np.array([2, 0], np.int64)
    got = spec_codes([torch.as_tensor(tok0s[r:r + 1]) for r in range(2)],
                     torch.as_tensor(seg_tok), torch.as_tensor(slots), fb=fb,
                     count=count, vq_codes=vq).numpy()
    jgot = np.asarray(_spec_codes_jit(tuple(jnp.asarray(tok0s[r:r + 1]) for r in range(2)),
                                      jnp.asarray(seg_tok), slots.astype(np.int32),
                                      fb=fb, count=count, vq_codes=vq))
    np.testing.assert_array_equal(got, jgot)
    for r in range(2):
        want = np.zeros(fb, np.int64)
        want[0] = tok0s[r]
        want[1:count] = seg_tok[slots[r], :count - 1]
        np.testing.assert_array_equal(got[r], np.clip(want, 0, vq - 1))


def test_speculative_first_piece(char, monkeypatch):
    """With the default shape of the geometry (a join width of 16 that
    holds the claimed 16 codes, full segments of 32), a stream's first
    piece is vocoded speculatively from its first segment: first_piece
    frames long, then the rest of the utterance, 2 * codes * hop in all;
    the join segments show in the step count."""
    from genie_tts_tpu_torch.runtime import slot_batcher as sbm

    calls = []
    real = sbm.spec_codes
    monkeypatch.setattr(sbm, "spec_codes", lambda *a, **k: calls.append(1) or real(*a, **k))
    sb, ref = _batcher(char, False, vocode_chunk=64, vocode_halo=4, slot_steps=32,
                       slot_ring=64, slot_join_steps=16)
    assert sb.join_W == 16 and sb.W == 32
    pieces = list(sb.synthesize_stream(ref, PH, BERT, timeout=TIMEOUT, max_steps=48))
    sb.stop()
    assert calls, "no speculative first piece"
    assert len(pieces[0]) == sb.first_piece * HOP
    total = np.concatenate(pieces)
    assert len(total) % (2 * HOP) == 0 and 16 <= len(total) // (2 * HOP) <= 48
    assert sb.stats["steps"] % 32 == 16
