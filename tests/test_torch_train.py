"""The port's T2S fine-tuning path vs the JAX package's, on one process.

The ``tests/test_train.py`` geometry (2 layers, d32, 4 heads, FFN 64), fp32,
weights from the JAX ``init_params`` with random biases and LayerNorm
parameters (numpy, from a seed), carried over by ``params_from_numpy``;
batches from ``make_batch`` with ragged ``x_len`` and ``sem_len``.
Tolerances (fp32, sums in other orders):

* ``forward_train`` logits: rtol 1e-5, atol 1e-5;
* ``train_loss``: rtol 1e-6;
* gradients of ``train_loss`` against ``jax.grad``, leaf by leaf:
  relative L2 <= 1e-5;
* 5 steps of the port's 1 x 1 ``make_train_step`` against
  ``optax.adamw`` on the JAX tree: losses rtol 1e-5, params relative L2
  <= 1e-5 per leaf;
* ``make_batch``: equal arrays.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.parallel.train import make_batch as j_make_batch
from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.config import SoVITSConfig, T2SConfig
from genie_tts_tpu_torch.convert.io import (flatten_tree, load_params,
                                            params_from_numpy, save_params)
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.parallel.mesh import make_mesh
from genie_tts_tpu_torch.parallel.train import make_batch, make_train_step
from genie_tts_tpu_torch.runtime.engine import make_random_character

KW = dict(phoneme_vocab=50, semantic_vocab=33, embed_dim=32, num_layers=2,
          num_heads=4, ffn_dim=64, bert_dim=16, ssl_dim=8, eos_id=32,
          max_decode_steps=8)
JCFG, CFG = JT2SConfig(**KW), T2SConfig(**KW)


def jax_params(seed=0):
    """The JAX init tree (numpy leaves) with random biases and norms."""
    p = jax.tree.map(np.asarray, jt2s.init_params(jax.random.PRNGKey(seed), JCFG,
                                                  dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    lp = p["layers"]
    for k in ("qkv", "out", "ffn1", "ffn2"):
        lp[k]["b"] = (rng.standard_normal(lp[k]["b"].shape) * 0.1).astype(np.float32)
    for k in ("norm1", "norm2"):
        s = lp[k]["scale"]
        lp[k] = {"scale": (1 + rng.standard_normal(s.shape) * 0.1).astype(np.float32),
                 "bias": (rng.standard_normal(s.shape) * 0.1).astype(np.float32)}
    p["bert_proj"]["b"] = (rng.standard_normal(p["bert_proj"]["b"].shape) * 0.1
                           ).astype(np.float32)
    return p


def ragged_batch(B=4, sx=8, sy=10, seed=0):
    b = make_batch(CFG, B, sx=sx, sy=sy, seed=seed)
    b["x_len"][:] = np.resize([sx, 5, sx, 3], B)
    b["sem_len"][:] = np.resize([sy, 7, 4, sy], B)
    return b


def to_torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def split_k_bias(flat):
    """(the tree without the K third of ``layers/qkv/b``, that third).

    A key bias adds ``q . b_k`` to every score of a query, which the
    softmax cancels: its gradient is zero up to rounding, so AdamW moves
    each of its entries by the sign of rounding noise, up to ``lr`` a
    step, and two libraries need not agree on those signs."""
    flat = dict(flat)
    b = np.asarray(flat["layers/qkv/b"])
    q, k, v = np.split(b, 3, axis=-1)
    flat["layers/qkv/b"] = np.concatenate([q, v], axis=-1)
    return flat, k


def assert_params_match(ours, ref, lr, steps, tol=1e-5):
    """Relative L2 <= ``tol`` per leaf; the K bias (see split_k_bias)
    within AdamW's largest move, ``lr`` a step (weight decay is far below
    it at these magnitudes), of the reference."""
    ours = {p: np.asarray(x.detach()) if isinstance(x, torch.Tensor) else x
            for p, x in ours.items()}
    ours, ko = split_k_bias(ours)
    ref, kr = split_k_bias(ref)
    assert set(ours) == set(ref)
    for path in ref:
        assert rel_l2(ours[path], ref[path]) <= tol, (path, rel_l2(ours[path], ref[path]))
    assert np.abs(ko - kr).max() <= 2 * lr * steps


@pytest.fixture(scope="module")
def jp():
    return jax_params()


def test_forward_train_logits_match_jax(jp):
    b = ragged_batch()
    ref = np.asarray(jt2s.forward_train(
        jax.tree.map(jnp.asarray, jp), JCFG, *(jnp.asarray(b[k]) for k in
                                               ("phones", "bert", "x_len", "semantic",
                                                "sem_len"))))
    tp = params_from_numpy(jp, torch.float32)
    out = t2s.forward_train(tp, CFG, *(torch.as_tensor(b[k]) for k in
                                       ("phones", "bert", "x_len", "semantic", "sem_len")))
    assert out.dtype == torch.float32 and out.shape == (4, 10, CFG.semantic_vocab)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


def test_train_loss_and_gradients_match_jax(jp):
    b = ragged_batch(seed=1)
    jl, jg = jax.value_and_grad(jt2s.train_loss)(jax.tree.map(jnp.asarray, jp),
                                                 JCFG, to_jax(b))
    tp = params_from_numpy(jp, torch.float32)
    leaves = flatten_tree(tp)
    for x in leaves.values():
        x.requires_grad_(True)
    loss = t2s.train_loss(tp, CFG, to_torch(b))
    assert loss.shape == ()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    assert set(jflat) == set(leaves)
    for (path, x), g in zip(leaves.items(), grads):
        g = np.zeros(x.shape, np.float32) if g is None else g.numpy()
        assert rel_l2(g, jflat[path]) <= 1e-5, (path, rel_l2(g, jflat[path]))
    # every trained leaf of the layer stack gets a gradient through the views
    assert all(g is not None for p, g in zip(leaves, grads) if p.startswith("layers/"))


def test_train_loss_masks_padding(jp):
    """Loss must ignore positions beyond sem_len."""
    tp = params_from_numpy(jp, torch.float32)
    b1 = make_batch(CFG, 2, sx=6, sy=8)
    b2 = {k: v.copy() for k, v in b1.items()}
    b2["semantic"][:, 6:] = 7
    b1["sem_len"][:] = 6
    b2["sem_len"][:] = 6
    l1 = float(t2s.train_loss(tp, CFG, to_torch(b1)))
    l2 = float(t2s.train_loss(tp, CFG, to_torch(b2)))
    np.testing.assert_allclose(l1, l2, rtol=1e-5)


@pytest.mark.parametrize("B,sx,sy,seed", [(4, 8, 10, 0), (8, 128, 384, 0), (3, 5, 7, 11)])
def test_make_batch_matches_jax(B, sx, sy, seed):
    ours = make_batch(CFG if sx < 100 else T2SConfig(), B, sx, sy, seed)
    ref = j_make_batch(JCFG if sx < 100 else JT2SConfig(), B, sx, sy, seed)
    assert set(ours) == set(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], k)


def test_adamw_steps_match_optax(jp):
    """5 steps of the 1 x 1 train step against optax.adamw's defaults."""
    b = ragged_batch(seed=2)
    tx = optax.adamw(1e-3)
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate = tx.init(jparams)
    jb = to_jax(b)

    @jax.jit
    def jstep(params, state):
        loss, grads = jax.value_and_grad(jt2s.train_loss)(params, JCFG, jb)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, loss

    init_fn, step_fn = make_train_step(CFG, make_mesh(1, 1, devices="cpu"),
                                       learning_rate=1e-3)
    params, opt = init_fn(params_from_numpy(jp, torch.float32))
    losses, jlosses = [], []
    for _ in range(5):
        params, opt, loss = step_fn(params, opt, b)
        jparams, jstate, jl = jstep(jparams, jstate)
        assert loss.shape == () and loss.device.type == "cpu"
        losses.append(float(loss))
        jlosses.append(float(jl))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert losses[-1] < losses[0]
    jflat = flatten_tree(jax.tree.map(np.asarray, jparams))
    assert_params_match(flatten_tree(params), jflat, lr=1e-3, steps=5)
    # every non-zero leaf moved, the unused encoder-side ones (codebook,
    # ssl_proj/w) by weight decay alone, as optax decays every leaf
    start = flatten_tree(jp)
    for path, x in flatten_tree(params).items():
        if np.any(start[path]):
            assert not np.array_equal(x.detach().numpy(), start[path]), path


def test_init_fn_rejects_int8_and_bad_tp(jp):
    init_fn, _ = make_train_step(CFG, make_mesh(1, 1, devices="cpu"))
    q = t2s.quantize_params(params_from_numpy(jp, torch.float32))
    with pytest.raises(ValueError, match=r"load_params\(path, torch.float32\)"):
        init_fn(q)
    with pytest.raises(ValueError, match="must divide num_heads"):
        make_train_step(T2SConfig(**dict(KW, num_heads=3)),
                        make_mesh(1, 1, devices="cpu")._replace(tp=2))


def test_step_fn_takes_the_params_init_fn_returned(jp):
    init_fn, step_fn = make_train_step(CFG, make_mesh(1, 1, devices="cpu"))
    _, opt = init_fn(params_from_numpy(jp, torch.float32))
    with pytest.raises(ValueError, match="init_fn returned"):
        step_fn(params_from_numpy(jp, torch.float32), opt, ragged_batch())


def test_trained_tree_serves_through_load_character(tmp_path):
    """A tree trained by the port, written with save_params as a
    character's t2s.safetensors, loads through load_character (int8 decode
    weights, the default) and decodes."""
    t2s_kw = dict(embed_dim=32, num_layers=2, num_heads=4, ffn_dim=64,
                  bert_dim=1024, ssl_dim=24, max_decode_steps=24)
    vits_kw = dict(inter_channels=16, hidden_channels=16, filter_channels=32,
                   n_layers=2, mrte_channels=16, ssl_dim=24, vq_dim=24,
                   gin_channels=16, flow_layers=2, wn_layers=2, upsample_initial=32,
                   resblock_kernels=(3,), resblock_dilations=((1, 3),))
    tcfg = T2SConfig(**t2s_kw)
    rc = make_random_character(t2s_cfg=tcfg, sovits_cfg=SoVITSConfig(**vits_kw),
                               dtype=torch.float32, device="cpu")
    init_fn, step_fn = make_train_step(tcfg, make_mesh(1, 1, devices="cpu"), 1e-3)
    params, opt = init_fn(rc.t2s_params)
    batch = make_batch(tcfg, 2, sx=8, sy=12)
    for _ in range(2):
        params, opt, _ = step_fn(params, opt, batch)
    char = tmp_path / "char"
    char.mkdir()
    save_params(params, char / "t2s.safetensors")
    save_params(rc.sovits_params, char / "vits.safetensors")
    (char / "config.json").write_text(json.dumps(
        {"version": "v2", "language": "ja", "t2s": t2s_kw, "sovits": vits_kw}))
    api.load_character("trained", char, "ja", device="cpu", dtype="float32")
    try:
        model = api.model_manager.get("trained")
        assert model.t2s_params["layers"]["qkv"]["w"].dtype == torch.int8
        on_disk = load_params(char / "t2s.safetensors", torch.float32)
        np.testing.assert_array_equal(model.t2s_params["audio_embed"].numpy(),
                                      on_disk["audio_embed"].numpy())
        np.testing.assert_allclose(on_disk["audio_embed"].numpy(),
                                   params["audio_embed"].detach().numpy(),
                                   rtol=1e-3, atol=1e-4)     # fp16 on disk
        from genie_tts_tpu_torch.ops.sampling import SamplingConfig

        phones = torch.randint(1, tcfg.phoneme_vocab, (1, 8),
                               generator=torch.Generator().manual_seed(0))
        codes, n = t2s.generate_e2e(
            model.t2s_params, tcfg, SamplingConfig(top_k=1), None, phones, None,
            torch.tensor([8]), torch.randint(0, 1024, (1, 6)), torch.tensor([6]),
            max_steps=8, cache_len=8 + 6 + 8)
        assert 0 < int(n[0]) <= 8
    finally:
        api.unload_character("trained")
