"""Operation and byte counts against hand counts at tiny sizes."""
import pytest

from perfbench.harness import spec

work = spec.work("gpt_sovits")

T2S = {"t2s": {"num_layers": 2, "embed_dim": 4, "ffn_dim": 8, "semantic_vocab": 10}}


def test_decoder_flops_by_hand():
    # per layer and token: qkv 4x12 + out 4x4 + ffn 4x8 + 8x4 = 128 MACs
    assert work.t2s_layer_macs(T2S) == 128
    ctx, codes = 3, 2
    pre = 2 * 2 * (128 * 3 + 2 * 3 * 3 * 4)              # 2 layers, 3 rows, 3 keys each
    dec = 2 * 2 * (128 * 2 + 2 * 4 * (2 * 3 + 1 + 2))     # keys 3+1 and 3+2
    head = 2 * 4 * 10 * 3                                  # the prefill's token and two steps
    assert work.t2s_flops(T2S, ctx, codes) == pre + dec + head


def test_fused_step_bytes_by_hand():
    L, D, F = 2, 4, 8
    weights = L * (4 * D * D + 2 * D * F)                  # int8
    cols = 3 * D + D + F + D
    per_col = L * cols * 6                                 # fp32 scale + bf16 bias
    norms = L * 2 * 2 * D * 4
    kv = L * 2 * (7 + 1) * D * 2                           # 7 rows read, 1 written
    assert work.fused_step_bytes(T2S, 7) == weights + per_col + norms + kv


def test_hifigan_flops_by_hand():
    cfg = {"sovits": {"upsample_initial": 8, "inter_channels": 2, "upsample_rates": [2],
                      "upsample_kernels": [4], "resblock_kernels": [3],
                      "resblock_dilations": [[1, 3]]}}
    T = 5
    macs = T * 7 * 2 * 8                  # conv_pre
    macs += T * 8 * 4 * 4                 # transposed conv 8 -> 4, width 4
    macs += 10 * 4 * 4 * 3 * 2 * 2        # one resblock: two convs per dilation, 10 frames
    macs += 10 * 7 * 4                    # conv_post
    assert work.hifigan_flops(cfg, T) == 2 * macs


def test_hifigan_at_published_widths_is_about_40_gflop_per_audio_second():
    cfg = spec.config("gsv-v2-ja")
    assert work.hifigan_flops(cfg, 50) == pytest.approx(40e9, rel=0.05)


def test_roberta_counts_its_feature_layers_only():
    cfg = {"roberta": {"num_layers": 4, "feature_layer": -3, "embed_dim": 2, "ffn_dim": 4}}
    # layer 2 of 5 states: two layers
    assert work.roberta_flops(cfg, 3) == 2.0 * 2 * 3 * (4 * 4 + 2 * 2 * 4 + 2 * 3 * 2)


def test_a_request_adds_its_parts():
    cfg = spec.config("gsv-v2pp-zh")
    f = work.request_flops(cfg, 150, 100, 30, tokens=12)
    assert f == pytest.approx(work.t2s_flops(cfg, 150, 100) + work.latent_flops(cfg, 100, 30)
                              + work.hifigan_flops(cfg, 200) + work.roberta_flops(cfg, 12))
    per_code = (work.t2s_flops(cfg, 150, 100) - work.t2s_flops(cfg, 150, 0)) / 100
    assert per_code == pytest.approx(0.16e9, rel=0.1)
