"""The port's streaming routes vs the JAX package's, on the CPU.

One tiny character loaded by both packages (tests/test_torch_pair.py), greedy
sampling in fp32 at noise_scale 0, so tokens are identical and the flow
noise plays no part:

* the segmented stream (``runtime/stream.py::synthesize_stream_segments``)
  yields the same pieces as the JAX one, piece for piece: the same
  boundaries (lengths) and waveforms allclose (rtol/atol 2e-4: fp32 sums
  in other orders through the latent stack and HiFi-GAN); the total is
  2 * codes * hop samples, the codes of the port's solo synthesis;
* ``pcm16`` pieces are the float pieces rounded to int16 (within one
  step);
* a sentence too long for the stream geometry takes the fused stream head
  in both packages, with the same pieces;
* near the end of the latent, where the port shifts the last vocode
  window left to keep one window width (the JAX stream cuts a shorter
  one), both routes still give the JAX pieces;
* flow noise is prefix-stable: two latent recomputes from one request's
  noise table agree on their common frames at noise_scale 0.5 (rtol/atol
  1e-5), while another table does not.
"""
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu.runtime.stream import synthesize_stream_segments as j_segments
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.models import sovits
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import stream
from genie_tts_tpu_torch.runtime.buckets import pick_bucket
from genie_tts_tpu_torch.runtime.engine import TTSEngine

from test_torch_pair import HOP, load_pair, make_refs, write_character

KW = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64), frame_buckets=(32, 64),
          vocode_chunk=16, vocode_halo=4, stream_seg_steps=4, stream_lookahead=2,
          stream_chunk=8, slot_phoneme_bucket=32, slot_prompt_bucket=32)
TEXT = np.array([5, 40, 17, 99, 230, 12, 8], np.int32)
BERT = np.zeros((len(TEXT), 1024), np.float32)
JGREEDY, GREEDY = JSampling(top_k=1), SamplingConfig(top_k=1)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    char_dir, _, _ = write_character(tmp_path_factory.mktemp("stream"))
    jchar, tchar = load_pair(char_dir)
    jeng, teng, jref, tref = make_refs(jchar, tchar, JRuntimeConfig(**KW),
                                       RuntimeConfig(**KW))
    return jchar, tchar, jeng, teng, jref, tref


def _same_pieces(tp, jp):
    assert [len(p) for p in tp] == [len(p) for p in jp]
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=2e-4, atol=2e-4)


def test_segmented_pieces_match_jax(setup):
    jchar, tchar, jeng, teng, jref, tref = setup
    assert stream.fits_stream(teng.cfg, tref, TEXT)
    kw = dict(seed=0, noise_scale=0.0, min_steps=18)
    jp = list(j_segments(jeng, jchar, jref, TEXT, BERT, sampling=JGREEDY, **kw))
    tp = list(stream.synthesize_stream_segments(teng, tchar, tref, TEXT, BERT,
                                                sampling=GREEDY, **kw))
    assert len(tp) >= 3, f"{len(tp)} pieces: want several segments' worth"
    _same_pieces(tp, jp)
    solo = teng.synthesize_utterance(tchar, tref, TEXT, BERT, sampling=GREEDY,
                                     noise_scale=0.0, min_steps=18)
    n = teng.last_stats["codes_len"]
    assert sum(len(p) for p in tp) == len(solo) == 2 * n * HOP
    # the engine's stream entry point takes the segmented route
    via = list(teng.synthesize_utterance_stream(tchar, tref, TEXT, BERT,
                                                sampling=GREEDY, **kw))
    _same_pieces(via, jp)


def test_segmented_pcm16(setup):
    _, tchar, _, teng, _, tref = setup
    kw = dict(sampling=GREEDY, seed=5, noise_scale=0.5, min_steps=10)
    fp = list(stream.synthesize_stream_segments(teng, tchar, tref, TEXT, BERT, **kw))
    pcm = list(stream.synthesize_stream_segments(teng, tchar, tref, TEXT, BERT,
                                                 pcm16=True, **kw))
    assert [len(p) for p in pcm] == [len(p) for p in fp]
    for p, f in zip(pcm, fp):
        assert p.dtype == np.int16
        want = np.round(np.clip(f, -1, 1) * 32767.0)
        assert np.abs(p.astype(np.int64) - want).max() <= 1


def test_oversize_takes_the_fused_head(setup):
    """Packed phonemes over slot_phoneme_bucket: the fused head, in both
    packages (the JAX engine routes the same way)."""
    jchar, tchar, _, _, jref, tref = setup
    kw = dict(KW, slot_phoneme_bucket=16)
    from genie_tts_tpu.runtime.engine import TTSEngine as JEngine

    jeng, teng = JEngine(JRuntimeConfig(**kw)), TTSEngine(RuntimeConfig(**kw))
    assert not stream.fits_stream(teng.cfg, tref, TEXT)
    args = dict(seed=0, noise_scale=0.0, min_steps=20)
    jp = list(jeng.synthesize_utterance_stream(jchar, jref, TEXT, BERT,
                                               sampling=JGREEDY, **args))
    tp = list(teng.synthesize_utterance_stream(tchar, tref, TEXT, BERT,
                                               sampling=GREEDY, **args))
    assert len(tp) >= 2
    _same_pieces(tp, jp)
    n = teng.last_stats["codes_len"]
    assert sum(len(p) for p in tp) == 2 * n * HOP


def test_noise_prefix_stable(setup):
    """Two recomputes of one request's latent (the same 20 codes in a
    32-frame bucket, and in a 64-frame bucket beside another row) read the
    same noise on their 40 common frames."""
    _, tchar, _, teng, _, _ = setup
    vcfg, p = tchar.sovits_cfg, tchar.sovits_params
    table = stream.noise_table(teng.cfg, vcfg, torch.Generator().manual_seed(7))
    other = stream.noise_table(teng.cfg, vcfg, torch.Generator().manual_seed(8))
    assert table.shape == (2 * max(KW["frame_buckets"]), vcfg.inter_channels)
    rng = np.random.default_rng(0)
    codes = torch.as_tensor(rng.integers(0, vcfg.vq_codes, 20))
    text = torch.as_tensor(rng.integers(1, 700, (1, 8)))
    ge = torch.as_tensor(rng.standard_normal((1, vcfg.gin_channels, 1)), dtype=torch.float32)

    def latent(noise, codes_b, lens):
        B = codes_b.shape[0]
        return sovits.synthesize_latent_rows(
            p, vcfg, noise, codes_b, torch.tensor(lens), text.expand(B, -1),
            torch.full((B,), 8), ge.expand(B, -1, -1), ge[:, :16].expand(B, -1, -1), 0.5)

    a = latent(table[None], torch.nn.functional.pad(codes, (0, 12))[None], [20])
    b2 = torch.zeros((2, 32), dtype=torch.int64)
    b2[0, :9] = torch.as_tensor(rng.integers(0, vcfg.vq_codes, 9))
    b2[1, :20] = codes
    b = latent(torch.stack([other, table]), b2, [9, 20])
    np.testing.assert_allclose(a[0, :40].numpy(), b[1, :40].numpy(), rtol=1e-5, atol=1e-5)
    c = latent(other[None], torch.nn.functional.pad(codes, (0, 12))[None], [20])
    assert float((a[0, :40] - c[0, :40]).abs().max()) > 1e-2


@pytest.mark.parametrize("route", ["segmented", "fused_head"])
def test_shifted_last_window_matches_jax(setup, route):
    """The port places each later vocode window inside the latent's
    frames (one window width per frame bucket): a window that would reach
    past the last frame starts at ``F - win`` instead, where the JAX
    stream cuts a shorter one. Near the end of the bucket (the segmented
    stream at 28 codes in a 32-code bucket, the fused head at its 64-step
    cap) the last window is shifted, and its pieces still match the JAX
    package's."""
    jchar, tchar, jeng, teng, jref, tref = setup
    if route == "fused_head":
        from genie_tts_tpu.runtime.engine import TTSEngine as JEngine

        kw = dict(KW, slot_phoneme_bucket=16)
        jeng, teng = JEngine(JRuntimeConfig(**kw)), TTSEngine(RuntimeConfig(**kw))
        n_steps = min(teng.cfg.step_caps)
    else:
        n_steps = 28
    assert stream.fits_stream(teng.cfg, tref, TEXT) == (route == "segmented")
    args = dict(seed=0, noise_scale=0.0, min_steps=n_steps, max_steps=n_steps)
    jp = list(jeng.synthesize_utterance_stream(jchar, jref, TEXT, BERT,
                                               sampling=JGREEDY, **args))
    tp = list(teng.synthesize_utterance_stream(tchar, tref, TEXT, BERT,
                                               sampling=GREEDY, **args))
    _same_pieces(tp, jp)
    frames = sum(len(p) for p in tp) // HOP
    n = frames // 2
    F = 2 * (n_steps if route == "fused_head" else pick_bucket(n, KW["frame_buckets"]))
    win = KW["vocode_chunk"] + 2 * KW["vocode_halo"]
    last_start = frames - len(tp[-1]) // HOP
    assert last_start - KW["vocode_halo"] > F - win, (last_start, F, n)
