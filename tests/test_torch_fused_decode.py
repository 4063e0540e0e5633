"""Port fused all-layer decode step vs the JAX package.

The plain version (what CPU tensors run) is held against the Pallas
kernel in interpret mode at pos 96 and 101 (aligned and unaligned, as
tests/test_fused_decode.py does) and at the cache's first and last rows
(0 and S-1), L=3, S=256: h_out, the written row, and
the neighbour rows left intact. Then the int8-weight form against stacked
JAX ``t2s._layer_decode`` on ``quantize_params`` weights. Biases and
LayerNorm affine are random per layer. fp32; rtol 1e-4
/ atol 1e-5 as the JAX test (sums in another order through post-LN
layers). The CUDA kernel is held against the plain version on the card by
tests/test_torch_kernels_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import T2SConfig
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops import fused_decode as jfd
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.ops import fused_decode as tfd

CFG = T2SConfig(num_layers=3)
S = 256


def _random_affine(params, seed):
    """Per-layer random linear biases and LayerNorm scales/biases, as a
    trained checkpoint has (init_params gives zeros and ones)."""
    rng = np.random.default_rng(seed)
    lp = dict(params["layers"])
    for k in ("qkv", "out", "ffn1", "ffn2"):
        b = lp[k]["b"]
        lp[k] = dict(lp[k], b=jnp.asarray(rng.standard_normal(b.shape) * 0.1, b.dtype))
    for k in ("norm1", "norm2"):
        s = lp[k]["scale"]
        lp[k] = {"scale": jnp.asarray(1 + rng.standard_normal(s.shape) * 0.1, s.dtype),
                 "bias": jnp.asarray(rng.standard_normal(s.shape) * 0.1, s.dtype)}
    return dict(params, layers=lp)


@pytest.fixture(scope="module")
def setup():
    params = _random_affine(jt2s.init_params(jax.random.PRNGKey(0), CFG, dtype=jnp.float32), 1)
    L, D, H = CFG.num_layers, CFG.embed_dim, CFG.num_heads
    rng = np.random.default_rng(0)
    h0 = (rng.standard_normal((1, D)) * 0.3).astype(np.float32)
    kc = (rng.standard_normal((L, S, D)) * 0.2).astype(np.float32)
    vc = (rng.standard_normal((L, S, D)) * 0.2).astype(np.float32)
    return params, h0, kc, vc


def _stacked_ref(jparams, h0, kc, vc, pos):
    """Stacked JAX _layer_decode (kv-major caches) -> (h, k rows at pos)."""
    L, D, H = CFG.num_layers, CFG.embed_dim, CFG.num_heads
    mask = jnp.asarray(np.arange(S) <= pos)[None]

    def kv_major(c):  # [S, D] -> [1, H, Dh, S]
        return jnp.asarray(c.reshape(S, H, D // H).transpose(1, 2, 0))[None]

    h = jnp.asarray(h0)[None]
    rows = []
    for layer in range(L):
        lp = jax.tree.map(lambda x: x[layer], jparams["layers"])
        h, kcl, _ = jt2s._layer_decode(lp, h, kv_major(kc[layer]),
                                       kv_major(vc[layer]), pos, mask, H)
        rows.append(np.asarray(kcl[0, :, :, pos]).reshape(-1))
    return np.asarray(h[0, 0]), rows


@pytest.mark.parametrize("pos", [0, 96, 101, S - 1])
def test_plain_matches_pallas_interpret(setup, pos):
    jparams, h0, kc, vc = setup
    mask = (np.arange(S) <= pos).astype(np.float32)
    jh, jk, jv = jfd.fused_decode_step(
        jfd.pack_decode_params(jparams, dtype=jnp.float32), jnp.asarray(h0),
        jnp.asarray(kc), jnp.asarray(vc), jnp.int32(pos), jnp.asarray(mask),
        num_heads=CFG.num_heads, interpret=True)
    tparams = params_from_numpy(jparams, torch.float32)
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    th, tk2, tv2 = tfd.fused_decode_step(
        tfd.pack_decode_params(tparams), torch.from_numpy(h0), tk, tv, pos,
        torch.from_numpy(mask), num_heads=CFG.num_heads)
    assert tk2 is tk and tv2 is tv                      # updated in place
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-5)
    for layer in range(CFG.num_layers):
        np.testing.assert_allclose(tk[layer, pos].numpy(), np.asarray(jk[layer, pos]),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(tv[layer, pos].numpy(), np.asarray(jv[layer, pos]),
                                   rtol=1e-4, atol=1e-5)
    # every other row intact
    others = np.arange(S) != pos
    np.testing.assert_array_equal(tk.numpy()[:, others], kc[:, others])
    np.testing.assert_array_equal(tv.numpy()[:, others], vc[:, others])


@pytest.mark.parametrize("pos", [96, 101])
def test_int8_matches_stacked_layer_decode(setup, pos):
    jparams, h0, kc, vc = setup
    jq = jt2s.quantize_params(jparams)
    ref_h, ref_rows = _stacked_ref(jq, h0, kc, vc, pos)
    tq = params_from_numpy(jq, torch.float32)
    packed = tfd.pack_decode_params(tq)
    assert packed["wqkv"].dtype == torch.int8 and "sqkv" in packed
    tk = torch.from_numpy(kc.copy())
    th, _, _ = tfd.fused_decode_step(
        packed, torch.from_numpy(h0), tk, torch.from_numpy(vc.copy()), pos,
        torch.from_numpy((np.arange(S) <= pos).astype(np.float32)),
        num_heads=CFG.num_heads)
    np.testing.assert_allclose(th[0].numpy(), ref_h, rtol=1e-4, atol=1e-5)
    for layer in range(CFG.num_layers):
        np.testing.assert_allclose(tk[layer, pos].numpy(), ref_rows[layer],
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("pos", [0, 101, S - 1])
def test_plain_takes_the_write_row_in_device_memory(setup, pos):
    """The decode graphs pass the write row as one int32 tensor (the
    kernel reads it from device memory): the plain version gives, bit for
    bit, what it gives with the row as an int."""
    jparams, h0, kc, vc = setup
    packed = tfd.pack_decode_params(params_from_numpy(jparams, torch.float32))
    mask = torch.from_numpy((np.arange(S) <= pos).astype(np.float32))
    out = []
    for p in (pos, torch.tensor([pos], dtype=torch.int32)):
        tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
        th, _, _ = tfd.fused_decode_step(packed, torch.from_numpy(h0), tk, tv, p, mask,
                                         num_heads=CFG.num_heads)
        out.append((th, tk, tv))
    for a, b in zip(*out):
        assert torch.equal(a, b)
