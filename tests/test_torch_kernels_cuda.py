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
order flips (2e-2 absolute at the LayerNorm scale).
"""

import pytest
import torch

from genie_tts_tpu_torch.config import T2SConfig
from genie_tts_tpu_torch.models import t2s
from genie_tts_tpu_torch.ops import fused_decode as fu
from genie_tts_tpu_torch.ops.flash_decode import (flash_decode_attention,
                                                  flash_decode_attention_plain)


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
