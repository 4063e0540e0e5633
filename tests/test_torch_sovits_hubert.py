"""Port SoVITS, spectrogram and HuBERT vs the JAX package (tiny configs).

fp32 weights from the JAX ``init_params``. The flow noise is drawn with
``jax.random.normal`` exactly as ``sovits.synthesize_latent`` draws it and
handed to the port, so waveforms compare directly. Tolerances: rtol/atol
1e-4 on latents, spectra and features (fp32 sums in other orders through
~20 conv/attention layers), 2e-4 on waveforms (HiFi-GAN's 3 upsample
stages stack more of them).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import HubertConfig as JHubertConfig
from genie_tts_tpu.config import SoVITSConfig as JSoVITSConfig
from genie_tts_tpu.models import hubert as jhubert
from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu.ops.audio import linear_spectrogram as j_spec
from genie_tts_tpu_torch.config import HubertConfig, SoVITSConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import hubert as thubert
from genie_tts_tpu_torch.models import sovits as tsovits
from genie_tts_tpu_torch.ops.audio import linear_spectrogram as t_spec

VKW = dict(spec_channels=33, inter_channels=16, hidden_channels=16,
           filter_channels=32, n_heads=2, n_layers=2, kernel_size=3,
           mrte_channels=16, ssl_dim=24, vq_codes=1024, vq_dim=24,
           gin_channels=16, flow_layers=2, wn_layers=2, wn_kernel=5,
           upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4),
           upsample_initial=32, resblock_kernels=(3,),
           resblock_dilations=((1, 3),), n_fft=64, hop_length=8, win_length=64)
JV, TV = JSoVITSConfig(**VKW), SoVITSConfig(**VKW)
HKW = dict(conv_dims=(32,) * 7, embed_dim=48, num_layers=2, num_heads=4,
           ffn_dim=64, conv_pos_kernel=16, conv_pos_groups=4)
JH, TH = JHubertConfig(**HKW), HubertConfig(**HKW)


@pytest.fixture(scope="module")
def vparams():
    j = jsovits.init_params(jax.random.PRNGKey(2), JV, dtype=jnp.float32)
    return j, params_from_numpy(j, torch.float32)


def _t(a):
    a = np.array(a)
    return torch.from_numpy(a).long() if a.dtype.kind == "i" else torch.from_numpy(a)


def _inputs(B=2, Ts=20, Tx=9, seed=0):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1024, (B, Ts)).astype(np.int32)
    codes_len = np.array([Ts, 13][:B], np.int32)
    text = rng.integers(1, 732, (B, Tx)).astype(np.int32)
    text_len = np.array([Tx, 6][:B], np.int32)
    ge = rng.standard_normal((B, 16, 1)).astype(np.float32)
    return codes, codes_len, text, text_len, ge


@pytest.mark.parametrize("noise_scale", [0.0, 0.5])
def test_synthesize_same_noise(vparams, noise_scale):
    jp, tp = vparams
    codes, codes_len, text, text_len, ge = _inputs()
    key = jax.random.PRNGKey(9)
    jw = jsovits.synthesize(jp, JV, key, *(jnp.asarray(a) for a in
                                           (codes, codes_len, text, text_len, ge, ge)),
                            noise_scale=noise_scale)
    noise = np.array(jax.random.normal(key, (2, 2 * codes.shape[1], JV.inter_channels),
                                       dtype=jnp.float32))
    tw = tsovits.synthesize(tp, TV, *(_t(a) for a in (codes, codes_len, text, text_len,
                                                       ge, ge)),
                            noise_scale=noise_scale, noise=_t(noise))
    assert tw.shape == jw.shape
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=2e-4, atol=2e-4)


def test_synthesize_latent(vparams):
    jp, tp = vparams
    codes, codes_len, text, text_len, ge = _inputs(seed=1)
    jz = jsovits.synthesize_latent(jp, JV, jax.random.PRNGKey(0),
                                   *(jnp.asarray(a) for a in
                                     (codes, codes_len, text, text_len, ge, ge)),
                                   noise_scale=0.0)
    tz = tsovits.synthesize_latent(tp, TV, *(_t(a) for a in (codes, codes_len, text,
                                                             text_len, ge, ge)),
                                   noise_scale=0.0, generator=torch.Generator())
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)


def test_vocode_chunked_matches_whole_away_from_halo(vparams):
    jp, tp = vparams
    rng = np.random.default_rng(3)
    F, chunk, halo = 64, 16, 16
    z = rng.standard_normal((1, F, 16)).astype(np.float32)
    ge = rng.standard_normal((1, 16, 1)).astype(np.float32)
    valid = np.array([54], np.int32)
    whole = tsovits.vocode_frames(tp, TV, _t(z), _t(ge), _t(valid))
    chunked = tsovits.vocode_frames_chunked(tp, TV, _t(z), _t(ge), _t(valid),
                                            chunk=chunk, halo=halo)
    hop = TV.hop_length
    n = 54 * hop
    # this generator's receptive field (~10 frames) fits inside the halo, so
    # chunking changes nothing inside the valid frames (up to fp32 sum order)
    np.testing.assert_allclose(chunked[:, :n].numpy(), whole[:, :n].numpy(),
                               rtol=1e-4, atol=1e-4)
    assert not chunked[:, 64 * hop:].any()
    jch = jsovits.vocode_frames_chunked(jp, JV, jnp.asarray(z), jnp.asarray(ge),
                                        jnp.asarray(valid), chunk=chunk, halo=halo)
    np.testing.assert_allclose(chunked[:, :n].numpy(), np.asarray(jch)[:, :n],
                               rtol=2e-4, atol=2e-4)


def test_linear_spectrogram_and_reference_embedding(vparams):
    jp, tp = vparams
    audio = (np.random.default_rng(4).standard_normal((1, 800)) * 0.1).astype(np.float32)
    js = j_spec(jnp.asarray(audio), n_fft=64, hop=8, win_length=64)
    ts = t_spec(_t(audio), n_fft=64, hop=8, win_length=64)
    assert ts.shape == js.shape == (1, 100, 33)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4, atol=1e-4)
    jge = jsovits.reference_embedding(jp, JV, js, jnp.array([100]))
    tge = tsovits.reference_embedding(tp, TV, ts, torch.tensor([100]))
    np.testing.assert_allclose(tge.numpy(), np.asarray(jge), rtol=1e-4, atol=1e-4)


def test_hubert_apply():
    jp = jhubert.init_params(jax.random.PRNGKey(5), JH, dtype=jnp.float32)
    audio = (np.random.default_rng(5).standard_normal((1, 6400)) * 0.1).astype(np.float32)
    jf = jhubert.apply(jp, jnp.asarray(audio), JH)
    tf = thubert.apply(params_from_numpy(jp, torch.float32), _t(audio), TH)
    assert tf.shape == jf.shape == (1, 19, 48)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-4, atol=1e-4)
