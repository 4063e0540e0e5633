"""Port checkpoint I/O: the JAX package's safetensors files read by the
port's own reader, and ``params_from_numpy``. Exact equality (no
tolerance): both sides round the same fp16/fp32 values."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import SoVITSConfig as JSoVITSConfig
from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.convert import io as jio
from genie_tts_tpu.models import sovits as jsovits
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu_torch.convert import io as tio

TINY_T2S = JT2SConfig(phoneme_vocab=40, semantic_vocab=33, embed_dim=32,
                      num_layers=2, num_heads=4, ffn_dim=64, bert_dim=16,
                      ssl_dim=8, eos_id=32)


def _flat_np(tree):
    return {k: np.asarray(v).astype(np.float32)
            for k, v in jio.flatten_tree(tree).items()}


@pytest.fixture(scope="module")
def jparams():
    return jt2s.init_params(jax.random.PRNGKey(0), TINY_T2S, dtype=jnp.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reader_matches_jax_load(tmp_path, jparams, dtype):
    path = tmp_path / "t2s.safetensors"
    jio.save_params(jparams, path)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = _flat_np(jio.load_params(path, compute_dtype=jdt))
    got = tio.flatten_tree(tio.load_params(path, compute_dtype=dtype))
    assert set(got) == set(ref)
    for k, v in got.items():
        # fp32-leaf rule: norms/alphas/codebook stay fp32, the rest follow dtype
        want = torch.float32 if tio._wants_fp32(k) else dtype
        assert v.dtype == want, k
        np.testing.assert_array_equal(v.float().numpy(), ref[k].astype(np.float32), k)


def test_params_from_numpy_matches_reader(tmp_path, jparams):
    path = tmp_path / "t2s.safetensors"
    jio.save_params(jparams, path)
    from_file = tio.flatten_tree(tio.load_params(path, compute_dtype=torch.float32))
    from_np = tio.flatten_tree(tio.params_from_numpy(
        jio.load_params(path, compute_dtype=jnp.float32), torch.float32))
    for k in from_file:
        assert torch.equal(from_file[k], from_np[k]), k


def test_quantized_tree_keeps_int8(jparams):
    q = tio.params_from_numpy(jt2s.quantize_params(jparams), torch.float32)
    assert q["layers"]["qkv"]["w"].dtype == torch.int8
    assert q["layers"]["qkv"]["scale"].dtype == torch.float32


def test_port_writer_round_trip_read_by_jax(tmp_path):
    """The port's writer emits files the JAX reader (safetensors) loads."""
    cfg = JSoVITSConfig(spec_channels=33, inter_channels=16, hidden_channels=16,
                        filter_channels=32, n_layers=2, mrte_channels=16,
                        ssl_dim=24, vq_codes=32, vq_dim=24, gin_channels=16,
                        flow_layers=2, wn_layers=2, upsample_rates=(2, 2),
                        upsample_kernels=(4, 4), upsample_initial=16,
                        resblock_kernels=(3,), resblock_dilations=((1, 3),))
    tree = tio.params_from_numpy(
        jsovits.init_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32),
        torch.float32)
    path = tmp_path / "vits.safetensors"
    tio.save_params(tree, path)
    back = _flat_np(jio.load_params(path, compute_dtype=jnp.float32))
    mine = tio.flatten_tree(tree)
    assert set(back) == set(mine)
    for k, v in mine.items():
        expect = v.numpy() if tio._wants_fp32(k) else v.numpy().astype(np.float16)
        np.testing.assert_array_equal(back[k], expect.astype(np.float32), k)
