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
largest value, and rows that see nothing exactly. The exact-cache slot
attention is held to the flash kernel's tolerances (1e-5 fp32, 1e-2
bf16: the same one output rounding).
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
from genie_tts_tpu_torch.ops.slot_attention import slot_attention, slot_attention_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("B,H,S,Dh", [(4, 16, 448, 32), (1, 4, 64, 32), (3, 2, 1000, 64),
                                      (1, 1, 1, 32), (2, 16, 17, 32), (8, 16, 1024, 32),
                                      # a tp shard's heads: 16 heads over tp 2 and 4
                                      (1, 8, 448, 32), (2, 8, 448, 32), (1, 4, 448, 32)])
@pytest.mark.parametrize("visible", ["ragged", "last_row_only"])
def test_flash_kernel_matches_plain(cuda, dtype, tol, B, H, S, Dh, visible):
    """Ragged rows, with the last batch row all masked (mean of V), or one
    visible key per row, the last cache row: the split of S over the
    cluster's blocks and the skipping of 16-row groups with no visible key
    must not change the result."""
    q = torch.randn((B, H, Dh), generator=cuda, device="cuda").to(dtype)
    k, v = (torch.randn((B, H, S, Dh), generator=cuda, device="cuda").to(dtype)
            for _ in range(2))
    if visible == "ragged":
        lens = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda")
        mask = torch.arange(S, device="cuda")[None] < lens[:, None]
        mask[-1] = False                  # a row with no visible key: mean of V
    else:
        mask = torch.zeros((B, S), dtype=torch.bool, device="cuda")
        mask[:, -1] = True
    before = flash_decode_attention.launches
    out = flash_decode_attention(q, k, v, mask)
    ref = flash_decode_attention_plain(q, k, v, mask)
    torch.cuda.synchronize()
    assert flash_decode_attention.launches == before + 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)


def _fused_case(gen, wname, L, S):
    cfg = T2SConfig(num_layers=L)
    cdt = torch.bfloat16 if wname in ("bfloat16", "int8") else torch.float32
    params = t2s.init_params(gen, cfg, dtype=torch.float32 if wname == "int8_fp32_cache"
                             else cdt)
    if wname.startswith("int8"):
        params = t2s.quantize_params(params)
    packed = fu.pack_decode_params(params)
    D = cfg.embed_dim
    h = torch.randn((1, D), generator=gen, device="cuda") * 0.3
    kc = (torch.randn((L, S, D), generator=gen, device="cuda") * 0.2).to(cdt)
    vc = (torch.randn((L, S, D), generator=gen, device="cuda") * 0.2).to(cdt)
    return cfg, packed, h, kc, vc


@pytest.mark.cuda
@pytest.mark.parametrize("wname", ["float32", "bfloat16", "int8", "int8_fp32_cache"])
@pytest.mark.parametrize("pos", [0, 96, 101, -1])
@pytest.mark.parametrize("L", [1, 3])
@pytest.mark.parametrize("S", [256, 4096])
def test_fused_kernel_matches_plain(cuda, wname, pos, L, S):
    """pos -1 is the last cache row. Rows up to pos are visible, so at
    S=4096 most 16-row groups are skipped and at pos 0 only the new row
    counts."""
    pos = pos % S
    cfg, packed, h, kc, vc = _fused_case(cuda, wname, L, S)
    H = cfg.num_heads
    # init_params draws biases and norms per layer: a kernel that drops
    # them or reads layer 0's for every layer cannot pass
    for name in ("bqkv", "bout", "b1", "b2", "n1s", "n1b", "n2s", "n2b"):
        assert packed[name].std() > 0.05
        if L > 1:
            assert not torch.equal(packed[name][0], packed[name][1])
    mask = (torch.arange(S, device="cuda") <= pos).float()
    ka, va, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    out, ka2, _ = fu.fused_decode_step(packed, h, ka, va, pos, mask, num_heads=H)
    ref, _, _ = fu.fused_decode_step_plain(packed, h, kb, vb, pos, mask, num_heads=H)
    torch.cuda.synchronize()
    assert ka2 is ka
    tol = 1e-4 if kc.dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
    torch.testing.assert_close(ka[:, pos].float(), kb[:, pos].float(), rtol=tol, atol=tol)
    torch.testing.assert_close(va[:, pos].float(), vb[:, pos].float(), rtol=tol, atol=tol)
    others = torch.arange(S, device="cuda") != pos
    assert torch.equal(ka[:, others], kc[:, others])
    assert torch.equal(va[:, others], vc[:, others])


@pytest.mark.cuda
@pytest.mark.parametrize("wname", ["bfloat16", "int8"])
def test_fused_kernel_repeats_itself(cuda, wname):
    """Split-K partials are summed in a fixed order (no float atomics):
    two launches on the same inputs give the same bits."""
    cfg, packed, h, kc, vc = _fused_case(cuda, wname, 3, 448)
    mask = (torch.arange(448, device="cuda") <= 200).float()
    outs = []
    for _ in range(2):
        ka, va = kc.clone(), vc.clone()
        out, _, _ = fu.fused_decode_step(packed, h, ka, va, 200, mask,
                                         num_heads=cfg.num_heads)
        outs.append((out.clone(), ka[:, 200], va[:, 200]))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_first_launches_from_threads(cuda):
    """8 request threads launch the fused step on one fresh packing at
    once: the launch count is exact and ONE tiled copy of the weights is
    built (the first launch adds it to the packing under a lock:
    ``fused_decode.prepare``); each launch writes an output row and a
    scratch of its own."""
    import threading

    class Packing(dict):
        sets = 0

        def __setitem__(self, k, v):
            if k == "_prep":
                Packing.sets += 1
            super().__setitem__(k, v)

    cfg, packed, h, kc, vc = _fused_case(cuda, "int8", 3, 256)
    packed = Packing(packed)
    mask = (torch.arange(256, device="cuda") <= 100).float()
    torch.cuda.synchronize()
    before = fu.fused_decode_step.launches
    barrier = threading.Barrier(8)
    errors = []

    def launch():
        try:
            ka, va = kc.clone(), vc.clone()
            barrier.wait(timeout=60)
            for _ in range(4):
                fu.fused_decode_step(packed, h, ka, va, 100, mask, num_heads=cfg.num_heads)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=launch) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    assert fu.fused_decode_step.launches - before == 32
    assert Packing.sets == 1 and len(packed["_prep"]) == 1


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


def _int8_case(gen, B, H, Dh, sx, sp, ring, kw, head, pad_cols, rows="random"):
    """int8 codes + scales as the slot state holds them: rows of the doubled
    ring (``pad_cols`` wider than the S columns read), sliced to S. rows:
    "random" context lengths; "empty_last": the last row sees nothing;
    "full": every row's context is the whole sx + sp; "one_column": row 0
    sees only column 0, row 1 only the ring column before the head."""
    S = sx + sp + ring
    kq, ks = slots.quantize_kv_columns(
        torch.randn((B, H, Dh, S + pad_cols), generator=gen, device="cuda"))
    vq, vs = slots.quantize_kv_columns(
        torch.randn((B, H, Dh, S + pad_cols), generator=gen, device="cuda"))
    x_len = torch.randint(1, sx + 1, (B,), generator=gen, device="cuda").int()
    p_len = torch.randint(1, sp + 1, (B,), generator=gen, device="cuda").int()
    kws = torch.tensor(kw, dtype=torch.int32, device="cuda")
    if rows == "empty_last":
        x_len[-1] = p_len[-1] = kws[-1] = 0
    elif rows == "full":
        x_len[:], p_len[:] = sx, sp
    elif rows == "one_column":
        x_len[:], p_len[:] = torch.tensor([1, 0]), 0
        kws[:] = torch.tensor([0, 1])
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").bfloat16()
    return (q, kq[..., :S], ks[..., :S], vq[..., :S], vs[..., :S], x_len, p_len, kws,
            head), dict(sx=sx, sp=sp, ring=ring)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # B, H, Dh, sx, sp, ring, keys_written, head, pad_cols, rows
    (8, 16, 32, 192, 192, 512, [64, 128, 200, 300, 17, 256, 0, 1], 300, 512, "random"),
    (8, 16, 32, 192, 192, 512, [512, 400, 300, 200, 150, 120, 101, 450], 100, 512, "random"),
    (8, 16, 32, 192, 192, 512, [64, 128, 200, 300, 17, 256, 32, 1], 300, 512, "empty_last"),
    (2, 4, 32, 16, 8, 32, [32, 20], 4, 32, "random"),    # pitch 88: the byte-load route
    (3, 2, 64, 32, 64, 96, [5, 96, 0], 50, 0, "empty_last"),  # Dh 64, a contiguous cache
    # ring from column 33; head 37, kw 50 and 80 wrap: [33, 70) and [116 or 86, 129)
    (4, 8, 32, 20, 13, 96, [80, 96, 50, 37], 37, 31, "random"),
    (8, 16, 32, 192, 192, 512, [512] * 8, 416, 512, "full"),
    (2, 16, 32, 192, 192, 512, [0, 1], 300, 512, "one_column"),   # 3 of 4 ranks get nothing
    (1, 1, 32, 16, 8, 32, [20], 5, 8, "random"),
    (2, 4, 64, 512, 512, 1024, [1024, 700], 300, 0, "full"),     # a block's largest buffers
    # a tp shard's heads (16 over tp 2 and 4) at the slot geometry
    (8, 8, 32, 192, 192, 512, [64, 128, 200, 300, 17, 256, 0, 1], 300, 512, "random"),
    (8, 4, 32, 192, 192, 512, [512, 400, 300, 200, 150, 120, 101, 450], 100, 512, "random"),
], ids=["partial_ring", "wrapped_ring", "empty_row", "unaligned_pitch", "dh64",
        "wrapped_mid_chunk", "fully_visible", "one_column", "bh1", "dh64_s2048",
        "tp2_heads", "tp4_heads"])
def test_int8_kernel_matches_plain(cuda, case):
    *shape, pad_cols, rows = case
    B, H, Dh, sx, sp, ring, kw, head = shape
    args, geom = _int8_case(cuda, B, H, Dh, sx, sp, ring, kw, head, pad_cols, rows)
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
    if rows == "empty_last":
        o, m, l = out
        assert bool((m[-1] == -1e30).all()) and not l[-1].any() and not o[-1].any()


@pytest.mark.cuda
def test_int8_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args, geom = _int8_case(cuda, 2, 4, 32, 16, 8, 32, [3, 4], 4, 0)
    q, kq, ks, vq, vs, x_len, p_len, kw, head = args
    with pytest.raises(TypeError):             # the kernel reads one int32 ring head
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


def _slot_attn_case(gen, dtype, B, H, Dh, sx, sp, ring, W, kw, head, col, rows="random"):
    """Exact caches as the slot state holds them (the doubled ring, sliced
    to the first copy), a write buffer, q/k_new/v_new as views of one qkv
    output, and the segment-frozen scalars. rows: "random" lengths;
    "empty_last": the last row sees nothing of the cache; "full": every
    context column."""
    S = sx + sp + ring
    k_big, v_big = (torch.randn((B, H, Dh, S + ring), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
    k_buf, v_buf = (torch.randn((B, H, Dh, W), generator=gen, device="cuda").to(dtype)
                    for _ in range(2))
    qkv = torch.randn((B, 1, 3 * H * Dh), generator=gen, device="cuda").to(dtype)
    q, kn, vn = (t2s._split_heads(t, H)[:, :, 0] for t in qkv.chunk(3, dim=-1))
    x_len = torch.randint(0, sx + 1, (B,), generator=gen, device="cuda").int()
    p_len = torch.randint(0, sp + 1, (B,), generator=gen, device="cuda").int()
    kws = torch.tensor(kw, dtype=torch.int32, device="cuda")
    if rows == "empty_last":
        x_len[-1] = p_len[-1] = kws[-1] = 0
    elif rows == "full":
        x_len[:], p_len[:] = sx, sp
    head = torch.tensor(head, dtype=torch.int32, device="cuda")
    return (q, kn, vn, k_big[..., :S], v_big[..., :S], k_buf, v_buf, col, x_len, p_len, kws,
            head), dict(sx=sx, sp=sp, ring=ring)


SLOT_ATTN_CASES = {
    # B, H, Dh, sx, sp, ring, W, keys_written, head, col, rows
    # narrate's geometry: 8 slots, 384 context + 512 ring columns, W 32
    "narrate_partial": (8, 16, 32, 192, 192, 512, 32, [64, 128, 200, 300, 17, 256, 0, 1], 320,
                        17, "random"),
    "narrate_wrapped": (8, 16, 32, 192, 192, 512, 32, [512, 400, 300, 200, 150, 120, 101, 450],
                        96, 31, "random"),
    "narrate_full": (8, 16, 32, 192, 192, 512, 32, [512] * 8, 416, 5, "full"),
    "narrate_empty_row_col0": (8, 16, 32, 192, 192, 512, 32, [64, 128, 200, 300, 17, 256, 32,
                                                              1], 288, 0, "empty_last"),
    "solo_stream_b1": (1, 16, 32, 192, 192, 512, 32, [333], 352, 11, "random"),
    "tp2_heads": (8, 8, 32, 192, 192, 512, 32, [64, 128, 200, 300, 17, 256, 0, 1], 320, 9,
                  "random"),
    "tp4_heads": (8, 4, 32, 192, 192, 512, 16, [512, 400, 300, 200, 150, 120, 101, 450], 96,
                  15, "random"),
    "dh64": (3, 2, 64, 32, 64, 96, 8, [5, 96, 0], 50, 3, "empty_last"),
    # a row pitch of 98 columns, not a multiple of 16 bytes: element loads
    "unaligned_pitch": (2, 4, 32, 16, 8, 37, 8, [37, 20], 4, 6, "random"),
    # 16-byte rows, but S = 68 ends inside a bf16 load of 8 columns
    "vec_ragged_end": (4, 8, 32, 16, 16, 36, 8, [36, 30, 5, 12], 20, 4, "full"),
    "wrapped_mid_chunk": (4, 8, 32, 20, 13, 96, 16, [80, 96, 50, 37], 37, 12, "random"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("name", sorted(SLOT_ATTN_CASES))
def test_slot_attention_kernel_matches_plain(cuda, dtype, tol, name):
    """The exact-cache slot attention against its plain version on the card:
    the output row, and the step's own column written into the buffer."""
    *shape, rows = SLOT_ATTN_CASES[name]
    args, geom = _slot_attn_case(cuda, dtype, *shape, rows=rows)
    q, kn, vn, kb, vb, k_buf, v_buf, col = args[:8]
    plain_bufs = (k_buf.clone(), v_buf.clone())
    before = slot_attention.launches
    out = slot_attention(*args, **geom)
    ref = slot_attention_plain(*args[:5], *plain_bufs, *args[7:], **geom)
    torch.cuda.synchronize()
    assert slot_attention.launches == before + 1
    assert out.shape == ref.shape == (q.shape[0], 1, q.shape[1] * q.shape[2])
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    assert torch.equal(k_buf, plain_bufs[0]) and torch.equal(v_buf, plain_bufs[1])
    assert torch.equal(k_buf[..., col], kn) and torch.equal(v_buf[..., col], vn)


@pytest.mark.cuda
def test_slot_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args, geom = _slot_attn_case(cuda, torch.bfloat16, 2, 4, 32, 16, 8, 40, 8, [3, 4], 4, 2)
    q, kn, vn, kb, vb, k_buf, v_buf, col, x_len, p_len, kw, head = args
    with pytest.raises(TypeError):             # one dtype throughout
        slot_attention(q.float(), kn, vn, *args[3:], **geom)
    with pytest.raises(TypeError):             # the kernel reads one int32 ring head
        slot_attention(*args[:11], head.long(), **geom)
    with pytest.raises(TypeError):
        slot_attention(*args[:8], x_len.long(), *args[9:], **geom)
    with pytest.raises(ValueError):            # S == sx + sp + ring
        slot_attention(*args, sx=16, sp=8, ring=39)
    with pytest.raises(ValueError):            # buffer column inside the buffer
        slot_attention(*args[:7], 8, *args[8:], **geom)
    with pytest.raises(ValueError):            # heads dense in q
        slot_attention(q.transpose(1, 2).contiguous().transpose(1, 2), *args[1:], **geom)
    with pytest.raises(TypeError):             # a dense buffer
        slot_attention(*args[:5], k_buf[..., :4], v_buf[..., :4], *args[7:], **geom)


@pytest.mark.cuda
def test_exact_slot_segments_on_the_card_match_the_cpus_plain_route(cuda):
    """Greedy fp32 segments of a tiny character (2 layers at full widths):
    the card's kernel, captured and eager, gives the tokens of its plain
    version on the CPU, with one kernel launch a layer a step."""
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, rows_from_config

    cfg = T2SConfig(num_layers=2)
    cpu = t2s.init_params(torch.Generator().manual_seed(3), cfg, dtype=torch.float32)
    cpu["audio_embed"] *= 10.0
    Sx, Sp, ring, W, V = 32, 64, 64, 8, cfg.semantic_vocab
    g = torch.Generator().manual_seed(4)
    phones = torch.randint(1, cfg.phoneme_vocab, (3, Sx), generator=g)
    prompts = torch.randint(0, 1024, (3, Sp), generator=g)
    x_len, p_len = [27, 12, 32], [50, 33, 9]
    samp = rows_from_config(SamplingConfig(top_k=1), 1)
    toks, launches = {}, {}
    for run in ("cpu", "graph", "eager"):
        dev = "cpu" if run == "cpu" else "cuda"
        params = cpu if run == "cpu" else _tree_to(cpu, "cuda")
        before = slot_attention.launches
        with torch.inference_mode():
            st = slots.init_slots(cfg, 3, Sx, Sp, ring, torch.float32, device=dev)
            out = []
            for seg in range(6):
                if seg < 3:                      # a row joins in each of the first segments
                    k, v, tok0, hist = slots.prefill_join(
                        params, cfg, phones[seg:seg + 1].to(dev), None,
                        torch.tensor([x_len[seg]], device=dev), prompts[seg:seg + 1].to(dev),
                        torch.tensor([p_len[seg]], device=dev), samp,
                        noise=torch.zeros((1, V), device=dev))
                    st = slots.insert_slot(st, seg, k, v, tok0, hist, x_len[seg], p_len[seg],
                                           ring, ring, type(samp)(*(a[0] for a in samp)))
                st, tok = slots.decode_segment(params, st, cfg, W, Sx, Sp, ring,
                                               noise=torch.zeros((W, 3, V), device=dev),
                                               eager=run == "eager")
                out.append(tok.cpu())
        torch.cuda.synchronize()
        toks[run], launches[run] = torch.cat(out, 1), slot_attention.launches - before
    assert torch.equal(toks["graph"], toks["cpu"]) and torch.equal(toks["eager"], toks["cpu"])
    assert launches == {"cpu": 0, "graph": 6 * W * cfg.num_layers,
                        "eager": 6 * W * cfg.num_layers}


@pytest.mark.cuda
@pytest.mark.parametrize("seconds", [1.0, 5.3])
def test_sv_forward_on_the_card_matches_cpu(cuda, seconds):
    """V2ProPlus: Kaldi fbank -> the full ERes2NetV2 (random, fp32 weights)
    on the card against the CPU: relative L2 of the 20480-d embedding
    within 1e-3 (fp32 convolutions summed in other orders, TF32 off)."""
    import numpy as np

    from genie_tts_tpu_torch.models import eres2net
    from genie_tts_tpu_torch.ops.audio import kaldi_fbank

    params = eres2net.init_params(torch.Generator().manual_seed(1), torch.float32)
    t = np.arange(int(seconds * 16000)) / 16000.0
    wav = torch.from_numpy((0.3 * np.sin(2 * np.pi * 180 * t) + 0.02 * np.random.default_rng(
        2).standard_normal(t.size)).astype(np.float32))[None]
    with torch.inference_mode():
        ref = eres2net.apply(params, kaldi_fbank(wav))
        out = eres2net.apply(_tree_to(params, "cuda"), kaldi_fbank(wav.cuda())).cpu()
    assert out.shape == (1, eres2net.EMB_DIM) and bool(torch.isfinite(out).all())
    assert float((out - ref).norm() / ref.norm()) <= 1e-3


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items() if not k.startswith("_")}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 3])
def test_tp_sharded_generate_on_the_card(cuda, B):
    """A 1x2 serving mesh over one card repeated: the per-layer route with
    the flash kernel over 8 of 16 heads per shard gives the greedy fp32
    codes of the unsharded parameters (B=1: against the fused kernel)."""
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig
    from genie_tts_tpu_torch.parallel.mesh import shard_serving_params

    cfg = T2SConfig(num_layers=4)
    params = t2s.init_params(cuda, cfg, dtype=torch.float32)
    sharded = shard_serving_params(params, ["cuda:0"] * 2)
    Sx, Sp, cap = 32, 48, 24
    phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=cuda, device="cuda")
    prompts = torch.randint(0, 1024, (B, Sp), generator=cuda, device="cuda")
    x_len = torch.tensor([32, 19, 27][:B], device="cuda")
    p_len = torch.tensor([48, 30, 11][:B], device="cuda")
    greedy = SamplingConfig(top_k=1)
    out = []
    for p in (params, sharded):
        with torch.inference_mode():
            before = flash_decode_attention.launches
            codes, n = t2s.generate_e2e(p, cfg, greedy, None, phones, None, x_len, prompts,
                                        p_len, max_steps=cap, cache_len=Sx + Sp + cap,
                                        min_steps=cap)
        out.append((codes, n, flash_decode_attention.launches - before))
    (c1, n1, f1), (c2, n2, f2) = out
    assert f2 == 2 * cfg.num_layers * (cap - 1)
    assert f1 == (0 if B == 1 else cfg.num_layers * (cap - 1))
    assert torch.equal(n1, n2)
    assert float((c1 == c2).float().mean()) >= 0.9


@pytest.mark.cuda
@pytest.mark.parametrize("wname", ["bfloat16", "int8"])
def test_fused_kernel_reads_the_device_pos_under_replay(cuda, wname):
    """The fused step captured once in a CUDA graph with its write row in
    device memory: moving the row on the device and replaying writes the
    new row, as the plain version does at that row."""
    cfg, packed, h, kc, vc = _fused_case(cuda, wname, 3, 448)
    H = cfg.num_heads
    pos = torch.tensor([100], dtype=torch.int32, device="cuda")
    fu.prepare(packed, 448, H, "cuda")
    mask = torch.ones(448, device="cuda")
    ka, va = kc.clone(), vc.clone()
    out = torch.empty((1, cfg.embed_dim), device="cuda")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fu.fused_decode_step(packed, h, ka.clone(), va.clone(), pos, mask, num_heads=H)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out.copy_(fu.fused_decode_step(packed, h, ka, va, pos, mask, num_heads=H)[0])
    for row in (200, 447):
        pos.fill_(row)
        graph.replay()
        kb, vb = kc.clone(), vc.clone()
        kb[:, 100], vb[:, 100] = ka[:, 100], va[:, 100]     # an earlier replay's row
        if row == 447:
            kb[:, 200], vb[:, 200] = ka[:, 200], va[:, 200]
        ref, _, _ = fu.fused_decode_step_plain(packed, h, kb, vb, row, mask, num_heads=H)
        torch.cuda.synchronize()
        tol = 2e-2
        torch.testing.assert_close(out, ref, rtol=tol, atol=tol)
        torch.testing.assert_close(ka[:, row].float(), kb[:, row].float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_int8_kernel_reads_the_device_head_under_replay(cuda):
    """int8_big_attention captured once with the ring head in device
    memory: a new head on the device moves the visible ring window."""
    args, geom = _int8_case(cuda, 8, 16, 32, 192, 192, 512,
                            [64, 128, 200, 300, 17, 256, 0, 1], 300, 512)
    *rest, _ = args
    head = torch.tensor([300], dtype=torch.int32, device="cuda")
    outs = [torch.empty((8, 16, 32), device="cuda"), torch.empty((8, 16), device="cuda"),
            torch.empty((8, 16), device="cuda")]
    int8_big_attention(*rest, head, **geom)                # built outside the capture
    before = int8_big_attention.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for o, r in zip(outs, int8_big_attention(*rest, head, **geom)):
            o.copy_(r)
    for h in (5, 511):
        head.fill_(h)
        graph.replay()
        ref = int8_big_attention_plain(*rest, h, **geom)
        torch.cuda.synchronize()
        seen = ref[1] > -1e30
        for a, b in zip(outs, ref):
            torch.testing.assert_close(a[seen], b[seen], rtol=1e-4,
                                       atol=1e-4 * float(b[seen].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 4], ids=["fused_B1", "flash_B4"])
def test_generate_graph_replays_equal_eager_on_the_card(cuda, B):
    """``generate`` on its captured graphs (blocks of 16 steps and the 7
    single steps that end at a cap of 40) gives the eager route's codes
    on the same noise; a kernel's launches are counted per replayed
    execution (the capture and its warm-up count none)."""
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, gumbel_noise

    cfg = T2SConfig(num_layers=2)
    params = t2s.quantize_params(t2s.init_params(cuda, cfg, dtype=torch.bfloat16))
    Sx, Sp, cap = 32, 64, 40
    phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=cuda, device="cuda")
    prompts = torch.randint(0, 1024, (B, Sp), generator=cuda, device="cuda")
    x_len = torch.tensor([32, 19, 27, 8][:B], device="cuda")
    p_len = torch.tensor([64, 30, 11, 50][:B], device="cuda")
    noise = gumbel_noise((cap, B, cfg.semantic_vocab), cuda, "cuda")
    wrapper = fu.fused_decode_step if B == 1 else flash_decode_attention
    per = 1 if B == 1 else cfg.num_layers
    out = {}
    for eager in (False, True, False):
        with torch.inference_mode():
            x = t2s.embed_text(params, phones, torch.zeros((B, Sx, cfg.bert_dim), device="cuda"))
            before = wrapper.launches
            res = t2s.generate(params, cfg, SamplingConfig(), None, x, x_len, prompts, p_len,
                               max_steps=cap, cache_len=Sx + Sp + cap, min_steps=cap,
                               noise=noise, eager=eager)
            torch.cuda.synchronize()
        assert wrapper.launches - before == per * (cap - 1)
        out.setdefault(eager, []).append(res)
    g1, g2 = out[False]
    e = out[True][0]
    for r in (g1, g2):
        assert torch.equal(r.tokens, e.tokens) and torch.equal(r.counts, e.counts)
        assert r.steps == e.steps == cap


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["int8_kernel", "exact"])
def test_segment_graph_replays_equal_eager_on_the_card(cuda, route):
    """A slot segment at occupancy 4 on its captured graph (the state
    copied in and back, and a persistent state replayed in place) gives
    the eager segment's tokens and every state leaf, twice in a row."""
    import dataclasses

    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, gumbel_noise, rows_from_config

    cfg = T2SConfig(num_layers=2)
    params = t2s.quantize_params(t2s.init_params(cuda, cfg, dtype=torch.bfloat16))
    Sx, Sp, ring, W, V = 32, 64, 64, 16, cfg.semantic_vocab
    int8 = route == "int8_kernel"
    samp = rows_from_config(SamplingConfig(), 1)
    with torch.inference_mode():
        st = slots.init_slots(cfg, 4, Sx, Sp, ring, torch.bfloat16, kv_int8=int8,
                              device="cuda")
        for b in range(4):
            phones = torch.randint(1, cfg.phoneme_vocab, (1, Sx), generator=cuda,
                                   device="cuda")
            prompts = torch.randint(0, 1024, (1, Sp), generator=cuda, device="cuda")
            k, v, tok0, hist = slots.prefill_join(
                params, cfg, phones, None, torch.tensor([20 + b], device="cuda"), prompts,
                torch.tensor([40 + b], device="cuda"),
                type(samp)(*(torch.as_tensor(a, device="cuda") for a in samp)),
                noise=torch.zeros((1, V), device="cuda"))
            slots.insert_slot(st, b, k, v, tok0, hist, 20 + b, 40 + b, ring, ring,
                              type(samp)(*(a[0] for a in samp)))
        runs = {"copied": slots.clone_state(st), "eager": slots.clone_state(st),
                "persistent": dataclasses.replace(slots.clone_state(st), persistent=True)}
        for _ in range(2):
            noise = gumbel_noise((W, 4, V), cuda, "cuda")
            toks = {}
            for name, s in runs.items():
                _, toks[name] = slots.decode_segment(params, s, cfg, W, Sx, Sp, ring,
                                                     kv_kernel=int8, noise=noise,
                                                     eager=name == "eager")
            torch.cuda.synchronize()
            for name in ("copied", "persistent"):
                assert torch.equal(toks[name], toks["eager"]), name
                for f in dataclasses.fields(st):
                    x = getattr(runs[name], f.name)
                    if isinstance(x, torch.Tensor):
                        assert torch.equal(x, getattr(runs["eager"], f.name)), (name, f.name)


@pytest.mark.cuda
def test_capture_beside_replay_at_one_cache_length(cuda):
    """One thread replays a B=1 ``generate`` graph while another captures
    the programs of five decodes of the same cache length (other caps,
    top-p 0.8): each graph has the fused kernel's output row and scratch
    of its own, so every decode's codes are the eager route's on the same
    noise."""
    import threading

    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, gumbel_noise
    from genie_tts_tpu_torch.runtime import graphs

    cfg = T2SConfig(num_layers=2)
    params = t2s.quantize_params(t2s.init_params(cuda, cfg, dtype=torch.bfloat16))
    Sx, Sp = 32, 64
    phones = torch.randint(1, cfg.phoneme_vocab, (1, Sx), generator=cuda, device="cuda")
    prompts = torch.randint(0, 1024, (1, Sp), generator=cuda, device="cuda")
    noise = gumbel_noise((40, 1, cfg.semantic_vocab), cuda, "cuda")

    def decode(cap, top_p, eager=False):
        with torch.inference_mode():
            x = t2s.embed_text(params, phones, torch.zeros((1, Sx, cfg.bert_dim), device="cuda"))
            return t2s.generate(params, cfg, SamplingConfig(top_p=top_p), None, x,
                                torch.tensor([27], device="cuda"), prompts,
                                torch.tensor([50], device="cuda"), max_steps=cap,
                                cache_len=Sx + Sp + 40, min_steps=cap, noise=noise[:cap],
                                eager=eager).tokens.cpu()

    others = [(24, 1.0), (32, 1.0), (40, 0.8), (24, 0.8), (32, 0.8)]
    want = {k: decode(*k, eager=True) for k in [(40, 1.0)] + others}
    assert torch.equal(decode(40, 1.0), want[(40, 1.0)])       # captured here
    cache = graphs.cache_for(params)
    captures0, done, bad, runs = cache.stats["captures"], [], [], []

    def replayer():
        while not done:
            runs.append(1)
            if not torch.equal(decode(40, 1.0), want[(40, 1.0)]):
                bad.append("replayed key")

    def capturer():
        try:
            for k in others:
                if not torch.equal(decode(*k), want[k]):
                    bad.append(f"captured key {k}")
        finally:
            done.append(1)

    threads = [threading.Thread(target=replayer), threading.Thread(target=capturer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not bad and len(runs) > 1
    # each decode captures its prefill program, a 16-step block and the
    # one-step tail
    assert cache.stats["captures"] - captures0 == 3 * len(others)


@pytest.mark.cuda
def test_join_graphs_replay_equal_eager_on_the_card(cuda):
    """The slot join on its captured graphs (the prefill program, then the
    insert into slot 2 of a persistent int8 state, then a release) gives
    the eager programs' tok0, histogram, context columns and every state
    leaf, twice in a row (a capture, then a replay)."""
    import dataclasses

    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, gumbel_noise, rows_from_config
    from genie_tts_tpu_torch.runtime import graphs

    cfg = T2SConfig(num_layers=2)
    params = t2s.quantize_params(t2s.init_params(cuda, cfg, dtype=torch.bfloat16))
    cache = graphs.cache_for(params)
    Sx, Sp, ring = 32, 64, 64
    samp = rows_from_config(SamplingConfig(top_p=0.8), 1)
    samp_dev = type(samp)(*(torch.as_tensor(a, device="cuda") for a in samp))
    base = slots.init_slots(cfg, 4, Sx, Sp, ring, torch.bfloat16, kv_int8=True, device="cuda")
    states = {"graph": dataclasses.replace(slots.clone_state(base), persistent=True),
              "eager": dataclasses.replace(slots.clone_state(base), persistent=True)}
    for rep in range(2):
        phones = torch.randint(1, cfg.phoneme_vocab, (1, Sx), generator=cuda, device="cuda")
        prompts = torch.randint(0, 1024, (1, Sp), generator=cuda, device="cuda")
        bert = torch.randn((1, Sx, cfg.bert_dim), generator=cuda, device="cuda")
        noise = gumbel_noise((1, cfg.semantic_vocab), cuda, "cuda")
        outs = {}
        for name, st in states.items():
            cache.eager = name == "eager"
            try:
                with torch.inference_mode():
                    outs[name] = slots.prefill_join(
                        params, cfg, phones, bert, torch.tensor([20 + rep], device="cuda"),
                        prompts, torch.tensor([40 + rep], device="cuda"), samp_dev,
                        noise=noise)
                    # the same context columns into both: the insert compared alone
                    slots.insert_slot(st, 2, *outs["graph"], 20 + rep, 40 + rep, 4, ring,
                                      type(samp)(*(a[0] for a in samp)), params=params)
                    slots.release_slot(st, 1, params=params)
                torch.cuda.synchronize()
            finally:
                cache.eager = False
        (gk, gv, gt, gh), (ek, ev, et, eh) = outs["graph"], outs["eager"]
        assert torch.equal(gt, et) and torch.equal(gh, eh)
        for a, b in ((gk, ek), (gv, ev)):
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2, atol=2e-2)
        for f in dataclasses.fields(base):
            x = getattr(states["graph"], f.name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, getattr(states["eager"], f.name)), f.name
    assert bool(states["graph"].active[2]) and cache.stats["captures"] >= 3


@pytest.mark.cuda
def test_roberta_graph_replays_equal_exact_on_the_card(cuda):
    """RoBERTa's padded feature program on its captured graph (capture,
    then replays at two token buckets) gives the exact-length eager
    route's per-phoneme features in fp32: relative L2 <= 1e-5."""
    import numpy as np

    from genie_tts_tpu_torch.config import RobertaConfig
    from genie_tts_tpu_torch.models import roberta
    from genie_tts_tpu_torch.runtime import graphs

    cfg = RobertaConfig(num_layers=4, vocab_size=512)
    params = roberta.init_params(cuda, cfg, torch.float32)
    rng = np.random.default_rng(0)
    for n in (20, 25, 50):
        ids = rng.integers(0, cfg.vocab_size, n)
        reps = rng.integers(1, 4, n - 2)
        with torch.inference_mode():
            got = roberta.bucketed_features(params, cfg, ids, np.ones(n, np.int64), reps,
                                            (32, 64)).cpu()
            want = roberta.phone_features(params, torch.tensor(ids, device="cuda")[None],
                                          torch.ones((1, n), device="cuda"),
                                          torch.tensor(reps, device="cuda"), cfg).cpu()
        assert got.shape == want.shape == (int(reps.sum()), cfg.embed_dim)
        assert float((got - want).norm() / want.norm()) <= 1e-5
    assert graphs.cache_for(params).stats["captures"] == 2
