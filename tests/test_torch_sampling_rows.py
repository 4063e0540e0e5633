"""The port's per-row sampler vs the JAX package's, with the same noise.

``sample_token_rows`` with mixed per-row top_k (0/1/15/200), top_p
(1/0.8), temperature and repetition penalty, a per-row forbid mask and the
same numpy Gumbel noise: the tokens must be IDENTICAL to
``genie_tts_tpu.ops.sampling.sample_token_rows``. With every row on one
config they must also equal ``sample_token`` (the port's and the JAX
package's).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.ops import sampling as js
from genie_tts_tpu_torch.ops import sampling as ts

B, V = 8, 300


def _inputs(seed):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((B, V)) * 3.0).astype(np.float32)
    hist = (rng.random((B, V)) < 0.1).astype(np.int32) * rng.integers(1, 4, (B, V))
    hist = hist.astype(np.int32)
    noise = rng.gumbel(size=(B, V)).astype(np.float32)
    forbid = np.zeros((B, V), bool)
    forbid[::3, V - 1] = True                   # a per-row EOS gate
    return logits, hist, noise, forbid


def _mixed_rows(with_top_p):
    top_p = np.array([1.0, 0.8] * (B // 2), np.float32) if with_top_p \
        else np.ones(B, np.float32)
    return ts.SamplingRows(
        top_k=np.array([0, 1, 15, 200, 15, 0, 200, 1], np.int32),
        top_p=top_p,
        temperature=np.array([1.0, 0.7, 1.3, 0.5, 1.0, 2.0, 1.0, 0.9], np.float32),
        repetition_penalty=np.array([1.35, 1.0, 1.2, 1.35, 1.0, 1.5, 1.35, 1.1],
                                    np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("with_top_p", [False, True])
def test_mixed_rows_identical_to_jax(seed, with_top_p):
    logits, hist, noise, forbid = _inputs(seed)
    rows = _mixed_rows(with_top_p)
    want = js.sample_token_rows(None, jnp.asarray(logits), jnp.asarray(hist),
                                js.SamplingRows(*(jnp.asarray(a) for a in rows)),
                                forbid=jnp.asarray(forbid), noise=jnp.asarray(noise))
    got = ts.sample_token_rows(None, torch.from_numpy(logits), torch.from_numpy(hist),
                               rows, forbid=torch.from_numpy(forbid),
                               noise=torch.from_numpy(noise))
    # device-tensor rows and a host top-p flag draw the same tokens
    got_t = ts.sample_token_rows(None, torch.from_numpy(logits), torch.from_numpy(hist),
                                 ts.SamplingRows(*(torch.from_numpy(a) for a in rows)),
                                 forbid=torch.from_numpy(forbid),
                                 noise=torch.from_numpy(noise), any_top_p=with_top_p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want))


@pytest.mark.parametrize("cfg", [
    dict(top_k=15, top_p=1.0, temperature=1.0, repetition_penalty=1.35),
    dict(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.0),
    dict(top_k=0, top_p=0.8, temperature=0.7, repetition_penalty=1.35),
    dict(top_k=200, top_p=0.9, temperature=1.3, repetition_penalty=1.2),
])
def test_equal_rows_equal_sample_token(cfg):
    logits, hist, noise, _ = _inputs(7)
    forbid = np.zeros(V, bool)
    forbid[V - 1] = True
    tl, th, tn, tf = (torch.from_numpy(a) for a in (logits, hist, noise, forbid))
    rows = ts.rows_from_config(ts.SamplingConfig(**cfg), B)
    got = ts.sample_token_rows(None, tl, th, rows, forbid=tf, noise=tn)
    solo = ts.sample_token(None, tl, th, ts.SamplingConfig(**cfg), forbid=tf, noise=tn)
    jsolo = js.sample_token(None, jnp.asarray(logits), jnp.asarray(hist),
                            js.SamplingConfig(**cfg), forbid=jnp.asarray(forbid),
                            noise=jnp.asarray(noise))
    np.testing.assert_array_equal(got.numpy(), solo.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsolo))


def test_noise_from_generator_when_not_given():
    logits, hist, _, _ = _inputs(9)
    rows = ts.rows_from_config(ts.SamplingConfig(), B)
    a = ts.sample_token_rows(torch.Generator().manual_seed(5), torch.from_numpy(logits),
                             torch.from_numpy(hist), rows)
    b = ts.sample_token_rows(torch.Generator().manual_seed(5), torch.from_numpy(logits),
                             torch.from_numpy(hist), rows)
    assert torch.equal(a, b) and a.shape == (B,)
