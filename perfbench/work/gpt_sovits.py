"""Operations and bytes of GPT-SoVITS work, from the configuration's shapes
and the positions the traffic reaches (the same whatever implements it).

Counts are of multiply-adds times two. Attention counts the keys each
query sees (the decoder: the text and prompt rows plus the tokens so
far). The peaks are one H100 SXM's (NVIDIA's data sheet, dense): 989
TFLOP/s in bfloat16, 3.35 TB/s of HBM."""
from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def _t2s(cfg: Dict):
    t = cfg["t2s"]
    return (int(t.get("num_layers", 24)), int(t.get("embed_dim", 512)),
            int(t.get("ffn_dim", 2048)), int(t.get("semantic_vocab", 1025)))


def t2s_layer_macs(cfg: Dict) -> int:
    """Multiply-adds of one decoder layer's matmuls for one token."""
    L, D, F, V = _t2s(cfg)
    return 4 * D * D + 2 * D * F


def t2s_flops(cfg: Dict, ctx: int, codes: int) -> float:
    """A request's decoder: the prefill over ``ctx`` text and prompt rows
    (each text row sees the text, each prompt row the text and the
    prompt before it: at most ``ctx`` keys), then ``codes`` tokens, the
    token at step s over ``ctx + s`` keys, each with the output head."""
    L, D, F, V = _t2s(cfg)
    pre = 2 * L * (t2s_layer_macs(cfg) * ctx + 2 * ctx * ctx * D)
    dec = 2 * L * (t2s_layer_macs(cfg) * codes + 2 * D * (codes * ctx + codes * (codes + 1) // 2))
    head = 2 * D * V * (codes + 1)
    return float(pre + dec + head)


def fused_step_bytes(cfg: Dict, rows: int) -> float:
    """Bytes one whole-decoder step must move at least, as the fused
    kernel runs it: the int8 layer weights once, their float32 scales,
    bfloat16 biases and float32 norm parameters, the ``rows`` cached K
    and V rows it attends over (bfloat16), and the new K/V row written."""
    L, D, F, V = _t2s(cfg)
    cols = 3 * D + D + F + D
    weights = L * (4 * D * D + 2 * D * F)
    per_col = L * cols * (4 + 2)
    norms = L * 2 * 2 * D * 4
    kv = L * 2 * (rows + 1) * D * 2
    return float(weights + per_col + norms + kv)


def hifigan_flops(cfg: Dict, frames: int) -> float:
    """HiFi-GAN over ``frames`` latent frames: conv_pre (width 7), each
    upsampling transposed conv, its three residual blocks (two convs per
    dilation), conv_post (width 7)."""
    s = cfg["sovits"]
    ch = int(s.get("upsample_initial", 512))
    inter = int(s.get("inter_channels", 192))
    rates = s.get("upsample_rates", [10, 8, 2, 2, 2])
    kups = s.get("upsample_kernels", [16, 16, 8, 2, 2])
    kres = s.get("resblock_kernels", [3, 7, 11])
    dils = s.get("resblock_dilations", [[1, 3, 5]] * 3)
    T = frames
    macs = T * 7 * inter * ch
    for u, ku in zip(rates, kups):
        T_out = T * u
        macs += T * ch * (ch // 2) * ku
        ch //= 2
        for k, d in zip(kres, dils):
            macs += T_out * ch * ch * k * 2 * len(d)
        T = T_out
    macs += T * 7 * ch
    return 2.0 * macs


def latent_flops(cfg: Dict, codes: int, text: int) -> float:
    """The SoVITS latent over ``codes`` semantic codes (two frames each)
    and ``text`` phonemes: the codes' projection, the three relative-
    attention encoders, MRTE and the reverse flow (four WaveNet stacks)."""
    s = cfg["sovits"]
    C = int(s.get("hidden_channels", 192))
    Fc = int(s.get("filter_channels", 768))
    k = int(s.get("kernel_size", 3))
    nl = int(s.get("n_layers", 6))
    mc = int(s.get("mrte_channels", 512))
    vq = int(s.get("vq_dim", 768))
    wl, wk = int(s.get("wn_layers", 4)), int(s.get("wn_kernel", 5))
    nf = int(s.get("flow_layers", 4))
    inter = int(s.get("inter_channels", 192))
    Ty = 2 * codes

    def enc(T, n):
        return n * T * (4 * C * C + 2 * T * C + 2 * k * C * Fc)

    macs = Ty * vq * C + enc(Ty, nl // 2) + enc(text, nl) + enc(Ty, nl // 2)
    macs += Ty * C * mc + text * C * mc + 4 * mc * mc * (Ty + text) // 2 + 2 * Ty * text * mc
    macs += Ty * mc * C + Ty * C * 2 * inter
    macs += nf * Ty * ((inter // 2) * C + wl * (wk * C * 2 * C + C * 2 * C) + C * (inter // 2))
    return 2.0 * macs


def roberta_flops(cfg: Dict, tokens: int) -> float:
    """RoBERTa up to its feature layer over ``tokens`` tokens."""
    r = cfg["roberta"]
    L = int(r.get("num_layers", 24))
    layers = int(r.get("feature_layer", -3)) % (L + 1)
    D, F = int(r.get("embed_dim", 1024)), int(r.get("ffn_dim", 4096))
    return 2.0 * layers * tokens * (4 * D * D + 2 * D * F + 2 * tokens * D)


def request_flops(cfg: Dict, ctx: int, codes: int, text: int, tokens: int = 0) -> float:
    """One request: decoder, latent, HiFi-GAN over its 2 x codes frames,
    and RoBERTa over its tokens (Chinese)."""
    f = t2s_flops(cfg, ctx, codes) + latent_flops(cfg, codes, text) \
        + hifigan_flops(cfg, 2 * codes)
    if cfg.get("roberta") and tokens:
        f += roberta_flops(cfg, tokens)
    return f
