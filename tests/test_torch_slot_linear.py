"""The slot decode layer's int8 linears (``ops/slot_linear.py``) on the CPU.

On CPU tensors the wrapper runs its plain version, the composition of
``ops/layers.py`` that ``models/t2s.py::_layer_decode_buffered`` ran
before the kernel existed. Here, at fp32 and bf16:

* the plain version equals that composition bit for bit, for each of the
  four tails (qkv: none, the output projection and ffn2: the residual add
  and the post-LN LayerNorm, ffn1: ReLU), and the wrapper runs it on CPU
  tensors without a launch;
* int8 weights take every linear of ``_layer_decode_buffered`` through the
  op, other weights keep the composition, and the layer through the op
  equals the JAX package's ``_layer_decode_buffered`` on the same int8
  weights;
* greedy slot segments with int8 weights (exact caches, rows joining in
  turn) equal the JAX package's ``decode_segment`` token for token and
  leaf for leaf;
* the benchmark's two readers of the kernel: the gauge's mean, and the
  roofline share from the least bytes of a slot step (counted here by
  hand at the narrate configuration's widths), None on a slice without
  the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu_torch.convert.io import params_from_numpy
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops import layers
from genie_tts_tpu_torch.ops.slot_linear import (launches_kernel, slot_linear,
                                                 slot_linear_plain, takes)
from perfbench.harness import spec
from test_torch_int8_decode import _layer_params, _tree
from test_torch_slot_attention import _case, _windows
from test_torch_slot_windows import _jt_segment
from test_torch_slots import RING, Pair, _request, assert_states_equal, params  # noqa: F401

TAILS = ("qkv", "out", "ffn1", "ffn2")


def _int8_layer(seed, D, dtype):
    """One decoder layer's params quantized by the JAX package (int8 codes,
    fp32 scales, the rest as drawn), as numpy and as torch in ``dtype``."""
    lp = _layer_params(np.random.default_rng(seed), D)
    q = jt2s.quantize_params({"layers": _tree(lp, jnp.asarray)})["layers"]
    nq = _tree(q, np.asarray)
    tq = _tree(nq, lambda a: torch.from_numpy(np.array(a)))
    for k in TAILS:
        tq[k]["b"] = tq[k]["b"].to(dtype)
    return nq, tq


def _tail_args(name, lp, res):
    return {"qkv": {}, "ffn1": dict(relu=True), "out": dict(res=res, norm=lp["norm1"]),
            "ffn2": dict(res=res, norm=lp["norm2"])}[name]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", TAILS)
def test_plain_version_is_the_composition(name, dtype):
    """Each tail op for op as the layer composed it: ``linear``, then
    ``torch.relu`` or ``layer_norm(norm, res + y)``; the CPU wrapper runs
    it with no launch."""
    D = 64
    _, lp = _int8_layer(1, D, dtype)
    K, N = lp[name]["w"].shape
    g = torch.Generator().manual_seed(2)
    x = torch.randn((3, 1, K), generator=g).to(dtype)
    res = torch.randn((3, 1, N), generator=g).to(dtype)
    y = layers.linear(lp[name], x)
    if name == "ffn1":
        want = torch.relu(y)
    elif name in ("out", "ffn2"):
        want = layers.layer_norm(lp["norm1" if name == "out" else "norm2"], res + y)
    else:
        want = y
    got = slot_linear_plain(lp[name], x, **_tail_args(name, lp, res))
    before = slot_linear.launches
    wrapped = slot_linear(lp[name], x, **_tail_args(name, lp, res))
    assert slot_linear.launches == before
    assert got.dtype == wrapped.dtype == dtype and got.shape == (3, 1, N)
    assert torch.equal(got, want) and torch.equal(wrapped, want)


@pytest.fixture
def count_routes(monkeypatch):
    """Counts of the calls ``_layer_decode_buffered`` makes to the op and to
    its plain version."""
    calls = {"op": 0, "plain": 0}

    def op(*a, **k):
        calls["op"] += 1
        return slot_linear(*a, **k)

    def plain(*a, **k):
        calls["plain"] += 1
        return slot_linear_plain(*a, **k)

    monkeypatch.setattr(t2s, "slot_linear", op)
    monkeypatch.setattr(t2s, "slot_linear_plain", plain)
    return calls


def _layer_call(c, lp, h, H, route=t2s._layer_decode_buffered):
    g = c["geom"]
    S = sum(g.values())
    return route(lp, h, c["k_big"][..., :S], c["v_big"][..., :S], c["k_buf"], c["v_buf"],
                 torch.arange(c["k_buf"].shape[-1]) < c["col"], None, H,
                 kv_kernel_ctx=(c["x_len"], c["p_len"], c["keys_written"], c["ring_head"],
                                g["sx"], g["sp"], g["ring"]), col=c["col"])


@pytest.mark.parametrize("name", ["partial_ring", "wrapped_ring", "one_row"])
def test_int8_layer_through_the_op_equals_jax(name, count_routes):
    """A buffered decode layer with int8 weights (fp32 rows): the port's,
    each linear through the op, against the JAX package's on the same
    codes and scales over its windows."""
    c = _case(name)
    B, H, Dh, W = c["k_buf"].shape
    D = H * Dh
    nq, tq = _int8_layer(7, D, torch.float32)
    h = (np.random.default_rng(8).standard_normal((B, 1, D)) * 0.3).astype(np.float32)
    k_reg, v_reg, kv_mask = _windows(c)
    j = lambda t: jnp.asarray(t.numpy())                     # noqa: E731
    want = jt2s._layer_decode_buffered(
        _tree(nq, jnp.asarray), jnp.asarray(h), tuple(map(j, k_reg)), tuple(map(j, v_reg)),
        j(c["k_buf"]), j(c["v_buf"]), j(torch.arange(W) < c["col"]), tuple(map(j, kv_mask)), H)
    got = _layer_call(c, tq, torch.from_numpy(h), H)
    assert count_routes == {"op": 4, "plain": 0}
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5, atol=1e-5)
    for i in (1, 2):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_other_weights_keep_the_composition(wdtype, count_routes):
    """Float weights never reach the op: the layer runs the composition,
    and equals the int8 route's result shape and dtype at the rows' dtype."""
    c = _case("partial_ring", wdtype)
    B, H, Dh, W = c["k_buf"].shape
    D = H * Dh
    lp = _tree(_layer_params(np.random.default_rng(9), D),
               lambda a: torch.from_numpy(a).to(wdtype))
    for k in ("norm1", "norm2"):
        lp[k] = {n: v.float() for n, v in lp[k].items()}
    h = torch.randn((B, 1, D), generator=torch.Generator().manual_seed(3)).to(wdtype)
    got = _layer_call(c, lp, h, H)
    assert count_routes == {"op": 0, "plain": 4}
    assert got[0].shape == (B, 1, D) and got[0].dtype == wdtype


@pytest.mark.parametrize("wdtype,route", [(torch.int8, True), (torch.bfloat16, False),
                                          (torch.float32, False)])
def test_the_route_is_one_predicate(wdtype, route):
    """``takes`` is the layer's route (int8 codes), ``launches_kernel`` the
    slot machine's gauge: the route on the card only, so CPU codes read 0."""
    lp = {"w": torch.zeros((16, 128), dtype=wdtype), "scale": torch.ones(128),
          "b": torch.zeros(128)}
    assert takes(lp) is route
    assert launches_kernel(lp) is False


@pytest.fixture
def int8_params(params):                                    # noqa: F811
    jp, _ = params
    jq = jt2s.quantize_params(jp)
    return jq, params_from_numpy(jq, torch.float32)


def test_int8_segments_through_the_op_equal_jax(int8_params, count_routes):
    """Three greedy rows join in turn, one a segment, and decode across six
    segments with int8 weights: the port's segments (every linear through
    the op) equal the JAX package's full-read ``decode_segment``."""
    assert int8_params[1]["layers"]["qkv"]["w"].dtype == torch.int8
    pair = Pair(int8_params)
    for seg in range(6):
        if seg < 3:
            pair.join(seg, _request(10 + seg, 4 + 3 * seg, 2 + 2 * seg), RING, RING,
                      same_ctx=True)
        jtok, ttok = _jt_segment(pair, None, None)
        np.testing.assert_array_equal(ttok, jtok)
        assert_states_equal(pair.j, pair.t)
    assert pair.t.counts[:3].tolist() == [RING] * 3
    assert count_routes["op"] > 0 and count_routes["plain"] == 0


# ---------------------------------------------------------------------------
# the benchmark's readers of the kernel
# ---------------------------------------------------------------------------

def test_the_gauge_reader_reads_the_mean_over_segments():
    mod = spec.reader("slot_linear_kernel.narrate")
    rec = {"metrics": {"gauges": {"slot_linear_kernel": {"count": 12, "mean": 1.0}}}}
    assert mod.read(rec) == 1.0
    assert mod.read({"metrics": {"gauges": {}}}) is None


def test_the_roofline_reader_counts_a_steps_least_bytes():
    """A slot step of the narrate configuration (24 layers, D 512, F 2048,
    8 slots, bf16 rows) must move 75.5 MB of codes, the columns' fp32
    scales and bf16 biases, the norms' fp32 parameters and each launch's
    rows; the slice's launches over 96 a step give the least time."""
    mod = spec.reader("slot_linear_roofline.narrate")
    cfg = spec.config("gsv-v2pp-zh")
    D, F, L, B = 512, 2048, 24, 8
    per_layer = (4 * D * D + 2 * D * F                       # int8 codes
                 + (3 * D + D + F + D) * (4 + 2)             # scales, biases
                 + 2 * 2 * D * 4                             # two norms
                 + B * 2 * (4 * D + 3 * D + (D + F) + (F + 2 * D)))  # rows
    assert mod.step_bytes(cfg) == L * per_layer == 79_896_576
    least = 3 * L * per_layer / 3.35e12                      # three steps' launches
    rec = {"config": cfg, "trace": {"kernels": {
        "void (anonymous namespace)::slot_linear_kernel<__nv_bfloat16>(...)":
            [least / (3 * 4 * L) * 20] * (3 * 4 * L),
        "slot_attn_kernel": [1.0] * (3 * L)}}}
    assert mod.read(rec) == pytest.approx(5.0)
    assert mod.read({"config": cfg, "trace": {"kernels": {"slot_attn_kernel": [1.0]}}}) is None
    assert mod.read({"config": cfg, "trace": None}) is None
