"""Port T2S vs the JAX package on the same weights and inputs.

fp32 weights (a tiny GPT-SoVITS-shaped model: d=64, 4 heads, full
1025-token semantic vocabulary). Greedy decoding (top_k=1) makes the
codes independent of the two libraries' random numbers, so the codes must
be IDENTICAL: B=1 runs the port's fused route, B=2 with ragged lengths its
flash route. Embeddings/logits: rtol/atol 1e-4. The int8-weight run is
held to the bounds of tests/test_e2e_parity.py's int8 gate (>= 0.95
positional agreement, length within 20%).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import T2SConfig as JT2SConfig
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu_torch.config import T2SConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops.sampling import SamplingConfig

KW = dict(embed_dim=64, num_layers=4, num_heads=4, ffn_dim=128, bert_dim=32,
          ssl_dim=48)
JCFG, TCFG = JT2SConfig(**KW), T2SConfig(**KW)
JGREEDY = JSampling(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35)
GREEDY = SamplingConfig(top_k=1, top_p=1.0, temperature=1.0, repetition_penalty=1.35)
SX, SP, STEPS = 16, 12, 24


def _lively(params, seed=0):
    """Random weights made to decode varied tokens (embeddings x10) and
    to stop on EOS inside the cap for some rows (EOS logit x3), with
    per-layer random linear biases and LayerNorm scales/biases, as a
    trained checkpoint has (init_params gives zeros and ones)."""
    params["audio_embed"] = params["audio_embed"] * 10.0
    params["text_embed"] = params["text_embed"] * 10.0
    w = params["predict"]["w"]
    params["predict"]["w"] = w.at[:, JCFG.eos_id].set(w[:, JCFG.eos_id] * 3.0)
    rng = np.random.default_rng(seed)
    lp = dict(params["layers"])
    for k in ("qkv", "out", "ffn1", "ffn2"):
        b = lp[k]["b"]
        lp[k] = dict(lp[k], b=jnp.asarray(rng.standard_normal(b.shape) * 0.1, b.dtype))
    for k in ("norm1", "norm2"):
        s = lp[k]["scale"]
        lp[k] = {"scale": jnp.asarray(1 + rng.standard_normal(s.shape) * 0.1, s.dtype),
                 "bias": jnp.asarray(rng.standard_normal(s.shape) * 0.1, s.dtype)}
    params["layers"] = lp
    return params


@pytest.fixture(scope="module")
def params():
    return _lively(jt2s.init_params(jax.random.PRNGKey(4), JCFG, dtype=jnp.float32), 5)


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    phones = rng.integers(1, 732, (B, SX)).astype(np.int32)
    bert = (rng.standard_normal((B, SX, KW["bert_dim"])) * 0.5).astype(np.float32)
    prompts = rng.integers(0, 1024, (B, SP)).astype(np.int32)
    x_len = np.array([SX, 11, 7, 14][:B], np.int32)
    p_len = np.array([SP, 9, 12, 5][:B], np.int32)
    return phones, bert, x_len, prompts, p_len


def _t(a):
    return torch.from_numpy(np.array(a)).long() if a.dtype.kind == "i" \
        else torch.from_numpy(np.array(a))


def test_embed_text(params):
    phones, bert, *_ = _inputs(2)
    j = jt2s.embed_text(params, jnp.asarray(phones), jnp.asarray(bert))
    t = tt2s.embed_text(params_from_numpy(params, torch.float32), _t(phones), _t(bert))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4, atol=1e-4)


def test_extract_prompt_tokens_identical(params):
    ssl = np.random.default_rng(1).standard_normal((2, 41, KW["ssl_dim"])).astype(np.float32)
    j = jt2s.extract_prompt_tokens(params, jnp.asarray(ssl))
    t = tt2s.extract_prompt_tokens(params_from_numpy(params, torch.float32), _t(ssl))
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_prefill_logits(params):
    phones, bert, x_len, prompts, p_len = _inputs(2)
    tp = params_from_numpy(params, torch.float32)
    jl, (jk, _) = jt2s.prefill(params, JCFG, jt2s.embed_text(params, jnp.asarray(phones),
                                                             jnp.asarray(bert)),
                               jnp.asarray(x_len), jnp.asarray(prompts),
                               jnp.asarray(p_len), cache_len=SX + SP + 8)
    tl, (tk, _) = tt2s.prefill(tp, TCFG, tt2s.embed_text(tp, _t(phones), _t(bert)),
                               _t(x_len), _t(prompts), _t(p_len), cache_len=SX + SP + 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-4, atol=1e-4)


def _codes(jparams, tparams, B, jcfg=JCFG, tcfg=TCFG, steps=STEPS):
    phones, bert, x_len, prompts, p_len = _inputs(B)
    jc, jn = jt2s.generate_e2e(jparams, jcfg, JGREEDY, jax.random.PRNGKey(0),
                               jnp.asarray(phones), jnp.asarray(bert), jnp.asarray(x_len),
                               jnp.asarray(prompts), jnp.asarray(p_len),
                               max_steps=steps, cache_len=SX + SP + steps)
    stats = {}
    tc, tn = tt2s.generate_e2e(tparams, tcfg, GREEDY, torch.Generator().manual_seed(0),
                               _t(phones), _t(bert), _t(x_len), _t(prompts), _t(p_len),
                               max_steps=steps, cache_len=SX + SP + steps, stats=stats)
    return (np.asarray(jc), np.asarray(jn)), (tc.numpy(), tn.numpy()), stats


@pytest.mark.parametrize("B", [1, 2])
def test_greedy_codes_identical_fp32(params, B):
    """B=1: the fused route; B=2 (ragged text and prompt lengths): the
    flash route. Codes must be identical to the JAX package's."""
    (jc, jn), (tc, tn), stats = _codes(params, params_from_numpy(params, torch.float32), B)
    assert stats["decode_steps"] >= 1
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)
    assert jn.min() > 3, "degenerate decode; reseed the fixture"
    if B == 2:
        assert jn.min() < STEPS, "no row met EOS; reseed the fixture"


def test_int8_weights_agree(params):
    """int8 decode weights (quantize_params on both sides): token agreement
    within the bounds of the JAX package's int8 quality gate."""
    jq = jt2s.quantize_params(params)
    tq = tt2s.quantize_params(params_from_numpy(params, torch.float32))
    assert tq["layers"]["ffn1"]["w"].dtype == torch.int8
    np.testing.assert_array_equal(tq["layers"]["ffn1"]["w"].numpy(),
                                  np.asarray(jq["layers"]["ffn1"]["w"]))
    (jc, jn), (tc, tn), _ = _codes(jq, tq, 1)
    n = int(min(jn[0], tn[0]))
    assert n > 3
    assert np.mean(tc[0, :n] == jc[0, :n]) >= 0.95
    assert abs(int(tn[0]) - int(jn[0])) <= 0.2 * int(jn[0])


def test_first_token_never_eos_and_min_steps(params):
    tp = params_from_numpy(params, torch.float32)
    phones, bert, x_len, prompts, p_len = _inputs(1)
    x = tt2s.embed_text(tp, _t(phones), _t(bert))
    res = tt2s.generate(tp, TCFG, SamplingConfig(), torch.Generator().manual_seed(1),
                        x, _t(x_len), _t(prompts), _t(p_len), max_steps=16,
                        cache_len=SX + SP + 16, min_steps=10)
    assert int(res.tokens[0, 0]) != TCFG.eos_id
    assert int(res.counts[0]) >= 10


@pytest.mark.slow
def test_greedy_codes_identical_24_layers():
    kw = dict(KW, num_layers=24)
    jcfg, tcfg = JT2SConfig(**kw), T2SConfig(**kw)
    p = _lively(jt2s.init_params(jax.random.PRNGKey(5), jcfg, dtype=jnp.float32))
    for B in (1, 2):
        (jc, jn), (tc, tn), _ = _codes(p, params_from_numpy(p, torch.float32), B,
                                       jcfg, tcfg)
        np.testing.assert_array_equal(tn, jn)
        np.testing.assert_array_equal(tc, jc)


@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_done_read_every_k_steps_keeps_tokens(params, monkeypatch, B):
    """``generate`` reads the finished flags every DONE_READ_EVERY steps.
    The steps it runs after every row has finished leave the tokens and
    the counts as they are: k=16 must give what k=1 (a read every step)
    gives, token for token, at B=1 (the fused route on its plain version)
    and B=4 (rows that end at different steps), with top-k sampling
    from one seeded noise table."""
    tp = params_from_numpy(params, torch.float32)
    phones, bert, x_len, prompts, p_len = _inputs(B)
    x = tt2s.embed_text(tp, _t(phones), _t(bert))
    cap = 64
    out = {}
    for k in (1, 16):
        monkeypatch.setattr(tt2s, "DONE_READ_EVERY", k)
        out[k] = tt2s.generate(tp, TCFG, SamplingConfig(), torch.Generator().manual_seed(4),
                               x, _t(x_len), _t(prompts), _t(p_len), max_steps=cap,
                               cache_len=SX + SP + cap)
    every, sparse = out[1], out[16]
    counts = every.counts.numpy()
    assert counts.max() < cap, "a row ran to the cap; reseed the fixture"
    if B == 4:
        assert len(set(counts.tolist())) > 1, "rows ended together; reseed the fixture"
    np.testing.assert_array_equal(sparse.counts.numpy(), counts)
    np.testing.assert_array_equal(sparse.tokens.numpy(), every.tokens.numpy())
    assert every.steps == counts.max()
    assert every.steps < sparse.steps < every.steps + 16
