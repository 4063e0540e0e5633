"""The SoVITS latent and vocode programs over static buffers vs the JAX
package, on the CPU.

On the card each SoVITS stage of the port (``models/sovits.py``: the
latent, the per-row latent of the window pump, the whole, chunked and
per-row-window vocode) is a program over the static buffers of its
geometry, captured once per key as a CUDA graph in one pool per
parameter set (``runtime/graphs.py``); here the same programs run eagerly
on the same buffers, under the same keys. A tiny fp32 synthesizer from
the JAX ``init_params``, inputs from numpy seeds, the flow noise drawn on
the JAX side exactly as its functions draw it and passed in:

* the latent program at two (B, frames, text) keys against JAX
  ``synthesize_latent`` and the per-row-noise form against
  ``synthesize_latent_rows`` (rtol/atol 1e-4, as
  tests/test_torch_sovits_hubert.py), and equal to the port's eager
  ``synthesize_latent`` on the same noise;
* the whole vocode against JAX ``vocode_frames`` and the chunked one
  against ``vocode_frames_chunked`` (2e-4), the windows past the emitted
  length run (zeros) or skipped at a host bound, as JAX's ``lax.cond``
  skip leaves zeros; the per-row window vocode against JAX
  ``vocode_window_rows``; each equal to the port's eager function;
* the programs read nothing back to the host; their buffers keep their
  addresses from one run to the next; a parameter set's graphs share
  one lock.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu_torch.models import sovits as tsovits
from genie_tts_tpu_torch.runtime import graphs
from test_torch_graphs import _NoHostReads
from test_torch_sovits_hubert import JV, TV, _inputs, _t, vparams  # noqa: F401

C = TV.inter_channels
HOP = TV.hop_length


def _jax_noise(key, shape):
    return np.array(jax.random.normal(key, shape, dtype=jnp.float32))


@pytest.mark.parametrize("B,Ts,Tx", [(2, 20, 9), (1, 32, 16)])
def test_latent_program_matches_jax_and_eager(vparams, B, Ts, Tx):
    jp, tp = vparams
    codes, codes_len, text, text_len, ge = _inputs(B=B, Ts=Ts, Tx=Tx, seed=Ts)
    key = jax.random.PRNGKey(Ts)
    jz = jsovits.synthesize_latent(jp, JV, key, *(jnp.asarray(a) for a in
                                                  (codes, codes_len, text, text_len, ge, ge)),
                                   noise_scale=0.5)
    noise = _t(_jax_noise(key, (B, 2 * Ts, C)))
    args = [_t(a) for a in (codes, codes_len, text, text_len, ge, ge)]
    cache = graphs.cache_for(tp)
    misses = cache.stats["misses"]
    tz = tsovits.latent(tp, TV, *args, 0.5, noise=noise)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)
    ez = tsovits.synthesize_latent(tp, TV, *args, 0.5, noise=noise)
    assert torch.equal(tz, ez)
    assert ("latent", B, Ts, Tx) in cache.keys() and cache.stats["misses"] <= misses + 1


def test_latent_rows_program_matches_jax(vparams):
    """Per-row noise tables of N frames, read from their start, against
    JAX's per-row keys at ``noise_frames=N``."""
    jp, tp = vparams
    codes, codes_len, text, text_len, ge = _inputs(seed=5)
    N = 64
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    jz = jsovits.synthesize_latent_rows(jp, JV, keys, *(jnp.asarray(a) for a in
                                                        (codes, codes_len, text, text_len,
                                                         ge, ge)),
                                        noise_scale=0.5, noise_frames=N)
    tables = np.stack([_jax_noise(k, (N, C)) for k in keys])
    args = [_t(a) for a in (codes, codes_len, text, text_len, ge, ge)]
    tz = tsovits.latent(tp, TV, *args, 0.5, noise=_t(tables))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)
    assert torch.equal(tz, tsovits.synthesize_latent_rows(tp, TV, _t(tables), *args, 0.5))


def _latent_frames(B, F, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, F, C)).astype(np.float32),
            rng.standard_normal((B, TV.gin_channels, 1)).astype(np.float32))


def test_vocode_program_matches_jax_and_eager(vparams):
    jp, tp = vparams
    z, ge = _latent_frames(2, 24, 1)
    valid = np.array([24, 17], np.int32)
    ja = jsovits.vocode_frames(jp, JV, jnp.asarray(z), jnp.asarray(ge), jnp.asarray(valid))
    ta = tsovits.vocode(tp, TV, _t(z), _t(ge), _t(valid))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-4, atol=2e-4)
    assert torch.equal(ta, tsovits.vocode_frames(tp, TV, _t(z), _t(ge), _t(valid)))
    assert not ta[1, 17 * HOP:].any()


@pytest.mark.parametrize("bound", [None, 40, 20], ids=["all_windows", "bound_40", "bound_20"])
def test_chunked_vocode_matches_jax_skip(vparams, bound):
    """F=64 frames in windows of 16 (halo 8) at starts 0, 16, 32 and 48;
    rows valid for 20 and 13 frames, so JAX runs the windows at 0 and 16
    and skips the others. The port runs every window below ``bound`` (a
    host bound >= the longest row): those past the rows give zeros, so
    the output is JAX's whatever the bound."""
    jp, tp = vparams
    z, ge = _latent_frames(2, 64, 2)
    valid = np.array([20, 13], np.int32)
    jc = jsovits.vocode_frames_chunked(jp, JV, jnp.asarray(z), jnp.asarray(ge),
                                       jnp.asarray(valid), chunk=16, halo=8)
    tc = tsovits.vocode_frames_chunked(tp, TV, _t(z), _t(ge), _t(valid), chunk=16, halo=8,
                                       bound=bound)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=2e-4, atol=2e-4)
    for row, n in enumerate(valid):
        assert not tc[row, n * HOP:].any()
    # each window against the port's eager HiFi-GAN over the same frames
    whole = tsovits.vocode_frames(tp, TV, _t(z[:, :24]), _t(ge), _t(valid))
    assert torch.equal(tc[:, :16 * HOP], whole[:, :16 * HOP])
    cache = graphs.cache_for(tp)
    assert {("vocode", 2, 24), ("vocode", 2, 32)} <= set(cache.keys())


def test_window_rows_program_matches_jax_and_eager(vparams):
    jp, tp = vparams
    z, ge = _latent_frames(4, 40, 3)
    starts = np.array([0, 8, 16, 24], np.int32)
    valid = np.array([40, 30, 20, 36], np.int32)
    ja = jsovits.vocode_window_rows(jp, JV, jnp.asarray(z), jnp.asarray(ge),
                                    jnp.asarray(starts), jnp.asarray(valid), 16)
    ta = tsovits.vocode_rows(tp, TV, _t(z), _t(ge), _t(starts), _t(valid), 16)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=2e-4, atol=2e-4)
    assert torch.equal(ta, tsovits.vocode_window_rows(tp, TV, _t(z), _t(ge), _t(starts),
                                                      _t(valid), 16))
    assert not ta[2, 4 * HOP:].any()          # row 2: 20 - 16 = 4 valid frames


def test_programs_read_nothing_back_and_keep_their_buffers(vparams):
    _, tp = vparams
    codes, codes_len, text, text_len, ge = _inputs(seed=7)
    args = [_t(a) for a in (codes, codes_len, text, text_len, ge, ge)]
    lg, lfn = tsovits.latent_graph(tp, TV, 2, 20, 9)
    vg, vfn = tsovits.vocode_graph(tp, TV, 2, 40)
    ptrs = []
    for seed in range(2):
        z = tsovits.latent(tp, TV, *args, 0.5, generator=torch.Generator().manual_seed(seed))
        tsovits.vocode(tp, TV, z, _t(ge), 2 * _t(codes_len))
        ptrs.append([t.data_ptr() for g in (lg, vg) for t in graphs.tensors_of(g.static)])
    assert ptrs[0] == ptrs[1]
    for g, fn in ((lg, lfn), (vg, vfn)):
        with g.lock, _NoHostReads():
            fn(g.static)
    cache = graphs.cache_for(tp)
    assert cache.family and lg.lock is vg.lock is cache.family_lock
