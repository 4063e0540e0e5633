"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (as on the CPU test
machine) and run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which the card's
machine does not have; this file imports only torch and the port.)
Tolerances: fp32 kernels differ from the plain versions only in the order
of fp32 sums (1e-5 on attention outputs of order 1; 1e-4 through 3
post-LN layers); bf16 adds one output rounding (2^-8 relative) for the
attention and, for the fused step, bf16 operand roundings that a sum
order flips (2e-2 absolute at the LayerNorm scale). The int8 slot-cache
attention runs in fp32 in both versions: relative 1e-4 of each partial's
largest value, and rows that see nothing exactly.
"""

import pytest
import torch

from genie_tts_tpu_torch.config import T2SConfig
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops import fused_decode as fu
from genie_tts_tpu_torch.models import slots
from genie_tts_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                  flash_decode_attention_plain)
from genie_tts_tpu_torch.ops.int8_decode import (int8_big_attention,
                                                 int8_big_attention_plain)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,H,S,Dh", [(4, 16, 448, 32), (1, 4, 64, 32), (3, 2, 1000, 64)])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, H, S, Dh):
    q = torch.randn((B, H, Dh), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((B, H, S, Dh), generator=cuda, device="cuda").to(dtype)
            for _ in range(2))
    lens = torch.randint(1, S, (B,), generator=cuda, device="cuda")
    mask = torch.arange(S, device="cuda")[None] < lens[:, None]
    mask[-1] = False                      # a row with no visible key: mean of V
    before = flash_decode_attention.launches
    out = flash_decode_attention(q, k, v, mask)
    ref = flash_decode_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("wname", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pos", [96, 101])
def test_fused_kernel_matches_plain(cuda, wname, pos):
    cfg = T2SConfig(num_layers=3)
    L, D, H, S = cfg.num_layers, cfg.embed_dim, cfg.num_heads, 256
    cdt = torch.float32 if wname == "float32" else torch.bfloat16
    params = t2s.init_params(cuda, cfg, dtype=cdt)
    if wname == "int8":
        params = t2s.quantize_params(params)
    packed = fu.pack_decode_params(params)
    # init_params draws biases and norms per layer: a kernel that drops
    # them or reads layer 0's for every layer cannot pass
    for name in ("bqkv", "bout", "b1", "b2", "n1s", "n1b", "n2s", "n2b"):
        assert packed[name].std() > 0.05 and not torch.equal(packed[name][0], packed[name][1])
    h = torch.randn((1, D), generator=cuda, device="cuda") * 0.3
    kc = (torch.randn((L, S, D), generator=cuda, device="cuda") * 0.2).to(cdt)
    vc = (torch.randn((L, S, D), generator=cuda, device="cuda") * 0.2).to(cdt)
    mask = (torch.arange(S, device="cuda") <= pos).float()
    ka, va, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, ka2, _ = fu.fused_decode_step(packed, h, ka, va, pos, mask, num_heads=H)
    ref, _, _ = fu.fused_decode_step_plain(packed, h, kb, vb, pos, mask, num_heads=H)
    torch.cuda.synchronize()
    assert ka2 is ka
    tol = 1e-4 if wname == "float32" else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    torch.testing.assert_close(ka[:, pos].float(), kb[:, pos].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(va[:, pos].float(), vb[:, pos].float(), rtol=tol, atol=tol)
    others = torch.arange(S, device="cuda") != pos
    assert torch.equal(ka[:, others], kc[:, others])
    assert torch.equal(va[:, others], vc[:, others])


@pytest.mark.cuda
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.randn((2, 4, 32), device="cuda", dtype=torch.float16)
    k = torch.randn((2, 4, 16, 32), device="cuda", dtype=torch.float16)
    mask = torch.ones((2, 16), dtype=torch.bool, device="cuda")
    with pytest.raises(TypeError):
        flash_decode_attention(q, k, k, mask)
    with pytest.raises(ValueError):
        flash_decode_attention(q.float(), k.float().transpose(2, 3), k.float(), mask)
    # float weights must be in the cache dtype (only int8 takes either)
    cfg = T2SConfig(num_layers=1)
    packed = fu.pack_decode_params(t2s.init_params(cuda, cfg, dtype=torch.float32))
    kc = torch.zeros((1, 16, cfg.embed_dim), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(TypeError):
        fu.fused_decode_step(packed, torch.zeros((1, cfg.embed_dim), device="cuda"), kc,
                             kc.clone(), 0, torch.ones(16, device="cuda"),
                             num_heads=cfg.num_heads)


def _int8_case(gen, B, H, Dh, sx, sp, ring, kw, head, pad_cols, empty_row=False):
    """int8 codes + scales as the slot state holds them: rows of the doubled
    ring (``pad_cols`` wider than the S columns read), sliced to S."""
    S = sx + sp + ring
    kq, ks = slots.quantize_kv_columns(
        torch.randn((B, H, Dh, S + pad_cols), generator=gen, device="cuda"))
    vq, vs = slots.quantize_kv_columns(
        torch.randn((B, H, Dh, S + pad_cols), generator=gen, device="cuda"))
    x_len = torch.randint(1, sx + 1, (B,), generator=gen, device="cuda").int()
    p_len = torch.randint(1, sp + 1, (B,), generator=gen, device="cuda").int()
    kws = torch.tensor(kw, dtype=torch.int32, device="cuda")
    if empty_row:
        x_len[-1] = p_len[-1] = kws[-1] = 0
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").bfloat16()
    return (q, kq[..., :S], ks[..., :S], vq[..., :S], vs[..., :S], x_len, p_len, kws,
            head), dict(sx=sx, sp=sp, ring=ring)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, H, Dh, sx, sp, ring, keys_written, head, pad_cols, empty_row
    (8, 16, 32, 192, 192, 512, [64, 128, 200, 300, 17, 256, 0, 1], 300, 512, False),
    (8, 16, 32, 192, 192, 512, [512, 400, 300, 200, 150, 120, 101, 450], 100, 512, False),
    (8, 16, 32, 192, 192, 512, [64, 128, 200, 300, 17, 256, 32, 1], 300, 512, True),
    (2, 4, 32, 16, 8, 32, [32, 20], 4, 32, False),    # pitch 88: the byte-load route
    (3, 2, 64, 32, 64, 96, [5, 96, 0], 50, 0, True),  # Dh 64, a contiguous cache
], ids=["partial_ring", "wrapped_ring", "empty_row", "unaligned_pitch", "dh64"])
def test_int8_kernel_matches_plain(cuda, case):
    *shape, pad_cols, empty = case
    B, H, Dh, sx, sp, ring, kw, head = shape
    args, geom = _int8_case(cuda, B, H, Dh, sx, sp, ring, kw, head, pad_cols, empty)
    before = int8_big_attention.launches
    out = int8_big_attention(*args, **geom)
    ref = int8_big_attention_plain(*args, **geom)
    torch.cuda.synchronize()
    assert int8_big_attention.launches == before + 1
    seen = ref[1] > -1e30
    for a, b in zip(out, ref):
        # fp32 in both, sums in another order: relative 1e-4 of the largest value
        torch.testing.assert_close(a[seen], b[seen], rtol=1e-4,
                                   atol=1e-4 * float(b[seen].abs().max()))
        assert torch.equal(a[~seen], b[~seen])
    if empty:
        o, m, l = out
        assert bool((m[-1] == -1e30).all()) and not l[-1].any() and not o[-1].any()


@pytest.mark.cuda
def test_int8_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args, geom = _int8_case(cuda, 2, 4, 32, 16, 8, 32, [3, 4], 4, 0)
    q, kq, ks, vq, vs, x_len, p_len, kw, head = args
    with pytest.raises(TypeError):             # a device ring head would need a host read
        int8_big_attention(q, kq, ks, vq, vs, x_len, p_len, kw,
                           torch.tensor(head, device="cuda"), **geom)
    with pytest.raises(TypeError):
        int8_big_attention(q.half(), kq, ks, vq, vs, x_len, p_len, kw, head, **geom)
    with pytest.raises(TypeError):
        int8_big_attention(q, kq.float(), ks, vq, vs, x_len, p_len, kw, head, **geom)
    with pytest.raises(TypeError):
        int8_big_attention(q, kq, ks, vq, vs, x_len.long(), p_len, kw, head, **geom)
    with pytest.raises(ValueError):
        int8_big_attention(q, kq, ks, vq, vs, x_len, p_len, kw, head, sx=16, sp=8, ring=31)
    with pytest.raises(ValueError):            # columns not unit-stride
        int8_big_attention(q, kq.transpose(2, 3).contiguous().transpose(2, 3), ks, vq, vs,
                           x_len, p_len, kw, head, **geom)
