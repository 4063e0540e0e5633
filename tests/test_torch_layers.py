"""Port building blocks vs the JAX package on the same numpy inputs.

fp32 throughout; tolerances are rtol/atol 1e-5 (1e-4 for the convs and
products over >= 64 terms, where the two libraries sum in other orders).
Sampling runs with the same Gumbel noise on both sides, so the drawn
tokens must be identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.ops import layers as jl
from genie_tts_tpu.ops import sampling as js
from genie_tts_tpu_torch.ops import layers as tl
from genie_tts_tpu_torch.ops import sampling as ts


def _pair(tree):
    """numpy tree -> (jax tree, torch tree)."""
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree))


def _close(t, j, tol=1e-5):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol, atol=tol)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_linear_fp32(rng):
    p = {"w": rng.standard_normal((24, 40)).astype(np.float32),
         "b": rng.standard_normal(40).astype(np.float32)}
    x = rng.standard_normal((2, 5, 24)).astype(np.float32)
    jp, tp = _pair(p)
    _close(tl.linear(tp, torch.from_numpy(x)), jl.linear(jp, jnp.asarray(x)))


def test_linear_int8(rng):
    p = {"w": rng.integers(-127, 128, (24, 40)).astype(np.int8),
         "scale": (rng.random(40) * 0.02).astype(np.float32),
         "b": rng.standard_normal(40).astype(np.float32)}
    x = rng.standard_normal((3, 24)).astype(np.float32)
    jp, tp = _pair(p)
    _close(tl.linear(tp, torch.from_numpy(x)), jl.linear(jp, jnp.asarray(x)))


def test_layer_norm(rng):
    p = {"scale": rng.standard_normal(32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    x = (rng.standard_normal((2, 7, 32)) * 3 + 1).astype(np.float32)
    jp, tp = _pair(p)
    _close(tl.layer_norm(tp, torch.from_numpy(x)), jl.layer_norm(jp, jnp.asarray(x)))


@pytest.mark.parametrize("k,stride,pad,dil,groups", [
    (3, 1, 1, 1, 1), (5, 1, 6, 3, 1), (2, 2, 0, 1, 1), (4, 1, 2, 1, 4)])
def test_conv1d(rng, k, stride, pad, dil, groups):
    p = {"w": rng.standard_normal((k, 16 // groups, 12)).astype(np.float32),
         "b": rng.standard_normal(12).astype(np.float32)}
    x = rng.standard_normal((2, 21, 16)).astype(np.float32)
    jp, tp = _pair(p)
    _close(tl.conv1d(tp, torch.from_numpy(x), stride, pad, dil, groups),
           jl.conv1d(jp, jnp.asarray(x), stride, pad, dil, groups), 1e-4)
    xn = np.ascontiguousarray(x.transpose(0, 2, 1))
    _close(tl.conv1d_ncw(tp, torch.from_numpy(xn), stride, pad, dil, groups),
           jl.conv1d_ncw(jp, jnp.asarray(xn), stride, pad, dil, groups), 1e-4)


@pytest.mark.parametrize("u,k", [(10, 16), (8, 16), (2, 8), (2, 2)])
def test_conv_transpose1d_hifigan_strides(rng, u, k):
    """HiFi-GAN's upsample stages: stride u, kernel k, padding (k-u)//2."""
    p = {"w": rng.standard_normal((k, 8, 6)).astype(np.float32),
         "b": rng.standard_normal(6).astype(np.float32)}
    x = rng.standard_normal((2, 9, 8)).astype(np.float32)
    jp, tp = _pair(p)
    _close(tl.conv_transpose1d(tp, torch.from_numpy(x), u, (k - u) // 2),
           jl.conv_transpose1d(jp, jnp.asarray(x), u, (k - u) // 2), 1e-4)
    xn = np.ascontiguousarray(x.transpose(0, 2, 1))
    _close(tl.conv_transpose1d_ncw(tp, torch.from_numpy(xn), u, (k - u) // 2),
           jl.conv_transpose1d_ncw(jp, jnp.asarray(xn), u, (k - u) // 2), 1e-4)


def test_sine_position_table():
    _close(tl.sine_position_table(50, 32), jl.sine_position_table(50, 32))


def test_attention_masked(rng):
    q, k, v = (rng.standard_normal((2, 3, 6, 8)).astype(np.float32) for _ in range(3))
    mask = rng.random((2, 1, 6, 6)) > 0.3
    mask[..., 0] = True
    _close(tl.attention(*(torch.from_numpy(a) for a in (q, k, v)), torch.from_numpy(mask)),
           jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask)))


@pytest.mark.parametrize("top_k,top_p,penalty", [
    (15, 1.0, 1.35), (1, 1.0, 1.35), (5, 0.8, 1.2), (0, 0.6, 1.0)])
def test_top_k_top_p_filter(rng, top_k, top_p, penalty):
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    counts = rng.integers(0, 3, (3, 64)).astype(np.int32)
    jpen = js.apply_repetition_penalty(jnp.asarray(logits), jnp.asarray(counts), penalty)
    tpen = ts.apply_repetition_penalty(torch.from_numpy(logits),
                                       torch.from_numpy(counts), penalty)
    _close(tpen, jpen)
    _close(ts.top_k_top_p_filter(tpen, top_k, top_p),
           js.top_k_top_p_filter(jpen, top_k, top_p))


@pytest.mark.parametrize("cfg", [
    js.SamplingConfig(), js.SamplingConfig(top_k=3, top_p=0.9, temperature=0.7),
    js.SamplingConfig(top_k=1)])
def test_sample_token_same_noise(rng, cfg):
    """Same Gumbel noise in -> same tokens out (incl. the EOS forbid)."""
    B, V = 4, 65
    logits = (rng.standard_normal((B, V)) * 3).astype(np.float32)
    counts = rng.integers(0, 2, (B, V)).astype(np.int32)
    noise = np.array(jax.random.gumbel(jax.random.PRNGKey(3), (B, V)))
    forbid = np.zeros(V, bool)
    forbid[V - 1] = True
    tcfg = ts.SamplingConfig(cfg.top_k, cfg.top_p, cfg.temperature,
                             cfg.repetition_penalty)
    for fb in (None, forbid):
        j = js.sample_token(None, jnp.asarray(logits), jnp.asarray(counts), cfg,
                            forbid=None if fb is None else jnp.asarray(fb),
                            noise=jnp.asarray(noise))
        t = ts.sample_token(None, torch.from_numpy(logits), torch.from_numpy(counts),
                            tcfg, forbid=None if fb is None else torch.from_numpy(fb),
                            noise=torch.from_numpy(noise))
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_gumbel_noise_from_generator():
    g1 = torch.Generator().manual_seed(7)
    g2 = torch.Generator().manual_seed(7)
    a, b = ts.gumbel_noise((4, 100), g1), ts.gumbel_noise((4, 100), g2)
    assert torch.equal(a, b) and torch.isfinite(a).all()
    assert abs(float(a.mean()) - 0.5772) < 0.2      # Euler-Mascheroni mean
