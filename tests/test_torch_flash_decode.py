"""Port flash-decode attention vs the JAX package.

The plain version (what CPU tensors run) is held against the Pallas
kernel in interpret mode and against ``xla_decode_attention``, at the
shapes of tests/test_flash_decode.py, rtol/atol 1e-5 in fp32. The CUDA
kernel itself is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.ops.flash_decode import (flash_decode_attention as j_flash,
                                            xla_decode_attention as j_xla)
from genie_tts_tpu_torch.ops import flash_decode as tf


def _inputs(B, H, S, Dh, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    k = rng.standard_normal((B, H, S, Dh)).astype(np.float32)
    v = rng.standard_normal((B, H, S, Dh)).astype(np.float32)
    lens = rng.integers(5, S, B)
    mask = np.arange(S)[None, :] < lens[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("B,H,S,Dh", [(1, 4, 64, 32), (2, 2, 128, 32), (4, 16, 96, 32)])
def test_plain_matches_pallas_and_xla(B, H, S, Dh):
    q, k, v, mask = _inputs(B, H, S, Dh)
    out = tf.flash_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    for ref in (j_flash(*(jnp.asarray(a) for a in (q, k, v, mask)), interpret=True),
                j_xla(*(jnp.asarray(a) for a in (q, k, v, mask)))):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_all_masked_row_follows_xla():
    """A row with no visible key gets the mean of V, as xla_decode_attention
    gives (the Pallas kernel would compute 0/0 there)."""
    q, k, v, mask = _inputs(2, 3, 16, 32, seed=1)
    mask[1] = False
    out = tf.flash_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    ref = j_xla(*(jnp.asarray(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1].numpy(), v[1].mean(axis=1), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,S,Dh", [(2, 4, 100, 32), (3, 2, 77, 64)])
def test_visible_keys_only_in_the_last_group(B, H, S, Dh):
    """Only keys in the last 16-row group are visible (S not a multiple
    of 16 in one case): the groups a kernel skips for having no visible key
    must not change the result."""
    q, k, v, _ = _inputs(B, H, S, Dh, seed=2)
    mask = np.zeros((B, S), bool)
    last = (S - 1) // 16 * 16
    mask[:, last:] = np.random.default_rng(3).random((B, S - last)) < 0.5
    mask[:, -1] = True
    out = tf.flash_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    ref = j_xla(*(jnp.asarray(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S", [17, 100])
def test_all_masked_row_at_an_unaligned_length(S):
    """An all-masked row at an S that is not a multiple of 16 gets the mean
    of all S rows of V (no group may be skipped there), as
    xla_decode_attention gives."""
    q, k, v, mask = _inputs(3, 2, S, 32, seed=4)
    mask[0] = False
    out = tf.flash_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    ref = j_xla(*(jnp.asarray(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[0].numpy(), v[0].mean(axis=1), rtol=1e-5, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, mask = _inputs(1, 2, 8, 32)
    before = tf.flash_decode_attention.launches
    tf.flash_decode_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    assert tf.flash_decode_attention.launches == before
