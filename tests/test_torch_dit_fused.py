"""The V4 DiT block's glue (``ops/dit_glue.py``) on the CPU: the plain
versions the kernels are held to, against the composition they replace
and against the benchmark's plain reference; the block's new call sites;
the wrappers' argument checks; the ``dit_fused`` gauge.

The plain versions ARE the composition (``torch.addcmul``, ``F.layer_norm``
with weight ``1 + scale``, the float32 rotary), so against it they are
held to equality; against a float64 computation and the reference's own
formulas (``perfbench/reference/sovits_v4.py``: the LayerNorm then the
modulation, the rotary from its own angles) in float32 to 1e-5 (the order
of float32 sums). The kernels themselves run on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py --dit``).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from genie_tts_tpu_torch.config import SoVITSConfig, V4Config
from genie_tts_tpu_torch.models import sovits_v4
from genie_tts_tpu_torch.ops import dit_glue as dg
from genie_tts_tpu_torch.ops.layers import unstack
from genie_tts_tpu_torch.utils.metrics import metrics
from perfbench.reference import sovits_v4 as ref

D, ROT = 64, 16
# every (rows, frames) bucket the CFM program is captured at
SHAPES = [(R, T) for R in (1, 2, 4, 8) for T in sovits_v4.CFM_FRAME_BUCKETS]


def _inputs(R, T, seed=0, dtype=torch.float32):
    """h, y [R, T, D] with rows past their length zeroed (a padded batch),
    an ``ada`` row read as (shift, scale, gate) chunks, q, k [R, T, D]."""
    g = torch.Generator().manual_seed(seed)
    lens = torch.randint(T // 2, T + 1, (R,), generator=g)
    lens[0] = T
    mask = (torch.arange(T)[None] < lens[:, None])[..., None]
    h = torch.randn((R, T, D), generator=g) * mask
    y = torch.randn((R, T, D), generator=g) / 3 * mask
    ada = torch.randn((1, 6 * D), generator=g) * 0.3
    sh, sc, gate = ada.chunk(6, dim=-1)[:3]
    q, k = torch.randn((R, T, D), generator=g), torch.randn((R, T, D), generator=g)
    return [t.to(dtype) for t in (h, y, sh, sc, gate, q, k)]


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm() / b.double().norm())


# -- dit_adanorm --------------------------------------------------------------

@pytest.mark.parametrize("R,T", SHAPES)
def test_adanorm_plain_is_the_composition_and_the_reference_on_every_bucket(R, T):
    h, y, sh, sc, gate = _inputs(R, T, seed=R * T)[:5]
    h2, n = dg.dit_adanorm_plain(h, sc, sh, y=y, g=gate)
    # the composition the block ran, op for op
    want_h = torch.addcmul(h, gate, y)
    want_n = F.layer_norm(want_h, (D,), (1 + sc).reshape(-1), sh.reshape(-1), eps=1e-6)
    assert torch.equal(h2, want_h) and torch.equal(n, want_n)
    # the reference's form: LayerNorm, then the modulation; and float64
    assert _rel(n, F.layer_norm(h + gate * y, (D,), eps=1e-6) * (1 + sc) + sh) < 1e-5
    x = (h.double() + gate.double() * y.double())
    x = (x - x.mean(-1, keepdim=True)) / torch.sqrt(x.var(-1, unbiased=False, keepdim=True)
                                                    + 1e-6)
    assert _rel(n, x * (1 + sc.double()) + sh.double()) < 1e-5


def test_adanorm_rows_of_a_padded_batch_are_each_alone():
    h, y, sh, sc, gate = _inputs(8, 1000, seed=3)[:5]
    hb, nb = dg.dit_adanorm_plain(h, sc, sh, y=y, g=gate)
    for r in range(8):
        ha, na = dg.dit_adanorm_plain(h[r:r + 1], sc, sh, y=y[r:r + 1], g=gate)
        assert torch.equal(ha, hb[r:r + 1]) and torch.equal(na, nb[r:r + 1])


def test_a_zero_gate_leaves_h_and_a_nonzero_gate_adds_its_share():
    h, y, sh, sc, gate = _inputs(2, 768, seed=5)[:5]
    h0, n0 = dg.dit_adanorm_plain(h, sc, sh, y=y, g=torch.zeros_like(gate))
    assert torch.equal(h0, h)
    assert torch.equal(n0, F.layer_norm(h, (D,), (1 + sc).reshape(-1), sh.reshape(-1),
                                        eps=1e-6))
    h1, _ = dg.dit_adanorm_plain(h, sc, sh, y=y, g=gate)
    assert not torch.equal(h1, h)
    assert torch.allclose(h1 - h, gate * y, atol=1e-6)
    # the ungated form is the input's h + conv_pos(h)
    assert torch.equal(dg.dit_adanorm_plain(h, sc, sh, y=y)[0], h + y)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_adanorm_rounds_where_the_composition_rounds(dtype):
    """In bf16: h' rounded once, ``1 + scale`` rounded before the
    LayerNorm reads it, n rounded once."""
    h, y, sh, sc, gate = _inputs(2, 896, seed=7, dtype=dtype)[:5]
    h2, n = dg.dit_adanorm_plain(h, sc, sh, y=y, g=gate)
    assert h2.dtype == n.dtype == dtype
    x = (h.float() + gate.float() * y.float()).to(dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(h2, x)      # bf16 products are exact in float32
    else:
        assert torch.allclose(h2, x, rtol=1e-6, atol=1e-6)
    w = (1 + sc).to(dtype).float()
    m = F.layer_norm(x.float(), (D,), eps=1e-6) * w + sh.float()
    assert torch.allclose(n.float(), m, rtol=2 ** -7, atol=1e-5)


# -- dit_rope ------------------------------------------------------------------

@pytest.mark.parametrize("R,T", SHAPES)
def test_rope_plain_is_the_references_rotary_and_leaves_the_other_channels(R, T):
    q, k = _inputs(R, T, seed=R + T)[5:]
    cos, sin = sovits_v4._rope(T, ROT, q.device)
    q2, k2 = q.clone(), k.clone()
    dg.dit_rope_plain(q2, k2, cos, sin)
    assert torch.equal(q2[..., ROT:], q[..., ROT:]) and torch.equal(k2[..., ROT:], k[..., ROT:])
    for r in (0, R - 1):
        assert _rel(q2[r], ref._rope(q[r], ROT)) < 1e-5
        assert _rel(k2[r], ref._rope(k[r], ROT)) < 1e-5
    # a rotation: each pair keeps its length
    pairs = q2[..., :ROT].unflatten(-1, (ROT // 2, 2)).norm(dim=-1)
    assert torch.allclose(pairs, q[..., :ROT].unflatten(-1, (ROT // 2, 2)).norm(dim=-1),
                          rtol=1e-5)


def test_rope_in_bf16_rounds_once_after_float32_products_and_sum():
    q, k = _inputs(2, 768, seed=11, dtype=torch.bfloat16)[5:]
    cos, sin = sovits_v4._rope(768, ROT, q.device)
    q2, k2 = q.clone(), k.clone()
    dg.dit_rope_plain(q2, k2, cos, sin)
    x = q[..., :ROT].float()
    x0, x1 = x[..., 0::2], x[..., 1::2]
    want = torch.stack([x0 * cos[:, 0::2] + (-x1) * sin[:, 0::2],
                        x1 * cos[:, 1::2] + x0 * sin[:, 1::2]], dim=-1).flatten(-2)
    assert torch.equal(q2[..., :ROT], want.to(torch.bfloat16))
    assert torch.equal(q2[..., ROT:], q[..., ROT:])


# -- the wrappers ------------------------------------------------------------

def test_on_the_cpu_the_wrappers_are_the_plain_versions():
    h, y, sh, sc, gate, q, k = _inputs(2, 768, seed=13)
    before = (dg.dit_adanorm.launches, dg.dit_rope.launches)
    a = dg.dit_adanorm(h, sc, sh, y=y, g=gate)
    b = dg.dit_adanorm_plain(h, sc, sh, y=y, g=gate)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    c, d = dg.dit_adanorm(h, sc, sh, y=y), dg.dit_adanorm_plain(h, sc, sh, y=y)
    assert torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    cos, sin = sovits_v4._rope(768, ROT, q.device)
    q1, k1, q2, k2 = q.clone(), k.clone(), q.clone(), k.clone()
    dg.dit_rope(q1, k1, cos, sin)
    dg.dit_rope_plain(q2, k2, cos, sin)
    assert torch.equal(q1, q2) and torch.equal(k1, k2)
    assert (dg.dit_adanorm.launches, dg.dit_rope.launches) == before


def test_the_wrappers_check_what_the_kernels_take():
    h, y, sh, sc, gate, q, k = _inputs(2, 768, seed=17)
    cos, sin = sovits_v4._rope(768, ROT, q.device)
    args = dg.adanorm_args(h, sc, sh, y=y, g=gate)
    assert args[5:] == (2 * 768, D, 0) and args[2] == gate.data_ptr()
    hb, yb, sb, bb = (t.bfloat16() for t in (h, y, sc, sh))
    assert dg.adanorm_args(hb, sb, bb, y=yb)[1:3] == (yb.data_ptr(), None)
    wide = torch.zeros((2, 3, 1028))
    bad = [
        (TypeError, lambda: dg.adanorm_args(h.half(), sc, sh, y=y.half())),     # dtype
        (ValueError, lambda: dg.adanorm_args(h[..., :62].contiguous(), sc, sh,
                                             y=y[..., :62].contiguous())),      # 248 bytes
        (ValueError, lambda: dg.adanorm_args(wide, sc, sh, y=wide)),            # > 4 KB
        (TypeError, lambda: dg.adanorm_args(h, sc, sh, y=y[:1])),               # y's shape
        (TypeError, lambda: dg.adanorm_args(h, sc, sh, y=y.transpose(0, 1).contiguous()
                                            .transpose(0, 1))),                 # strided y
        (TypeError, lambda: dg.adanorm_args(h, sc, sh, y=y.bfloat16())),         # y's dtype
        (TypeError, lambda: dg.adanorm_args(h, sc[:, :32], sh, y=y)),           # scale's width
        (TypeError, lambda: dg.adanorm_args(h, torch.zeros((D, 2))[:, 0], sh,
                                            y=y)),                              # strided scale
        (TypeError, lambda: dg.rope_args(q.half(), k.half(), cos, sin)),         # dtype
        (ValueError, lambda: dg.rope_args(q[0], k[0], cos, sin)),               # not [R, T, C]
        (ValueError, lambda: dg.rope_args(q, k, cos[:, :15], sin[:, :15])),     # odd rotary
        (ValueError, lambda: dg.rope_args(q[..., :8], k[..., :8], cos, sin)),    # rot > C
        (TypeError, lambda: dg.rope_args(q, k[:, :700], cos, sin)),              # k's shape
        (TypeError, lambda: dg.rope_args(q, k, cos.double(), sin)),              # cos's dtype
        (TypeError, lambda: dg.rope_args(q, k, cos[:700], sin[:700])),           # frames
    ]
    for exc, call in bad:
        with pytest.raises(exc):
            call()
    assert dg.rope_args(q, k, cos, sin)[4:] == (2 * 768, 768, D, ROT, 0)


def test_the_kernels_engage_only_for_card_weights_in_a_dtype_they_take():
    assert not dg.engages(torch.zeros(4, dtype=torch.bfloat16))
    assert not dg.engages(torch.zeros(4, device="meta"))


# -- the block's call sites -----------------------------------------------------

V4 = V4Config(fea_channels=16, wn_layers=2, dit_dim=32, dit_depth=3, dit_heads=2,
              dit_head_dim=16, freq_embed_dim=16, sample_steps=2, T_ref=16, T_chunk=40,
              upsample_rates=(2, 2, 2), upsample_kernels=(4, 4, 4), upsample_initial=32,
              resblock_kernels=(3,), resblock_dilations=((1, 3),))
SCFG = SoVITSConfig(spec_channels=1025, inter_channels=16, hidden_channels=16,
                    filter_channels=32, n_heads=2, n_layers=2, kernel_size=3, mrte_channels=16,
                    ssl_dim=24, vq_codes=1024, vq_dim=24, gin_channels=16, version="v4")


def _dit_composition(p, cfg, x, cond, text, t_emb, mask, rope):
    """The DiT as it ran before its glue was fused: each block's norms,
    rotary and residuals as separate ops, the boolean key mask."""
    maskf = mask[..., None].to(x.dtype)
    h = sovits_v4._dense(p["input"]["proj"], torch.cat([x, cond, text], dim=-1))
    h = h + sovits_v4._conv_pos(p["input"]["conv_pos"], h, maskf, cfg.conv_pos_groups)
    cos, sin = rope
    H, Dh = cfg.dit_heads, cfg.dit_head_dim
    st = F.silu(t_emb)

    def modulate(h, scale, shift):
        return F.layer_norm(h, (h.shape[-1],), (1 + scale).reshape(-1), shift.reshape(-1),
                            eps=1e-6)

    for lp in unstack(p["blocks"]):
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = sovits_v4._dense(lp["ada"], st).chunk(6, dim=-1)
        n = modulate(h, sc_a, sh_a)
        q, k = sovits_v4._dense(lp["q"], n), sovits_v4._dense(lp["k"], n)
        dg.dit_rope_plain(q, k, cos, sin)
        v = sovits_v4._dense(lp["v"], n)
        q, k, v = (a.unflatten(-1, (H, Dh)).transpose(1, 2) for a in (q, k, v))
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=mask[:, None, None, :])
        h = torch.addcmul(h, g_a, sovits_v4._dense(lp["out"], a.transpose(1, 2).flatten(-2)))
        n = modulate(h, sc_f, sh_f)
        h = torch.addcmul(h, g_f, sovits_v4._dense(lp["ff2"], F.gelu(
            sovits_v4._dense(lp["ff1"], n), approximate="tanh")))
    scale, shift = sovits_v4._dense(p["norm_out"], st).chunk(2, dim=-1)
    return sovits_v4._dense(p["proj_out"], modulate(h, scale, shift))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [[40], [40, 31, 17]], ids=["alone", "padded"])
def test_the_fused_call_sites_give_the_compositions_dit(dtype, lens):
    """Three blocks: the input residual with block 0's norm, each
    attention residual with its FF norm, each FF residual with the next
    block's norm and, last, ``norm_out``'s; on the CPU the same ops in the
    same order, so the same bits (fp32 and bf16), and within float32 sums
    of the benchmark's reference, row by row."""
    params = sovits_v4.init_params(torch.Generator().manual_seed(29), SCFG, V4, dtype=dtype)
    p = params["cfm"]
    g = torch.Generator().manual_seed(31)
    R, T = len(lens), max(lens)
    x, cond = (torch.randn((R, T, 100), generator=g).to(dtype) for _ in range(2))
    mask = torch.arange(T)[None] < torch.tensor(lens)[:, None]
    text = sovits_v4.text_embed(p["text_blocks"], torch.randn((R, T, 16), generator=g).to(dtype),
                                mask[..., None].to(dtype))
    temb = sovits_v4.timestep_embed(p["time_embed"], 0.5, V4, dtype)
    rope = sovits_v4._rope(T, V4.dit_head_dim, x.device)
    got = sovits_v4.dit(p, V4, x, cond, text, temb, mask, rope)
    want = _dit_composition(p, V4, x, cond, text, temb, mask, rope)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    if dtype == torch.float32:
        for i, n in enumerate(lens):
            r = ref.dit(p, dict(vars(V4)), x[i, :n], cond[i, :n], text[i, :n], temb[0])
            assert _rel(got[i, :n], r) < 1e-5


def test_the_key_mask_is_what_sdpa_makes_of_the_boolean_one():
    mask = torch.arange(40)[None] < torch.tensor([40, 23])[:, None]
    m = sovits_v4._key_mask(mask, torch.bfloat16)
    assert m.shape == (2, 1, 1, 40) and m.dtype == torch.bfloat16
    assert bool((m[0] == 0).all()) and bool((m[1, ..., :23] == 0).all())
    assert bool(torch.isinf(m[1, ..., 23:]).all()) and bool((m[1, ..., 23:] < 0).all())


def test_cfm_rows_writes_the_dit_fused_gauge():
    """0 on the CPU (the plain versions run), once per batched launch:
    chunks of 24 new frames, so three launches (two rows, then one)."""
    params = sovits_v4.init_params(torch.Generator().manual_seed(37), SCFG, V4,
                                   dtype=torch.float32)
    g = torch.Generator().manual_seed(41)
    rows = [sovits_v4.Row(fea=torch.randn((n, 16), generator=g),
                          fea_ref=torch.randn((16, 16), generator=g),
                          mel2=torch.rand((16, 100), generator=g) * 2 - 1, seed=i)
            for i, n in enumerate((50, 20))]
    metrics.reset()
    sovits_v4.cfm_rows(params, dataclasses.replace(V4, sample_steps=1), rows, (1, 2))
    snap = metrics.snapshot()["gauges"]
    assert snap["dit_fused"]["count"] == snap["cfm_rows"]["count"] == 3
    assert snap["dit_fused"]["mean"] == 0
