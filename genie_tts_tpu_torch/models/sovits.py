"""SoVITS synthesizer (VITS flow + HiFi-GAN), V2 inference.

The port of ``genie_tts_tpu/models/sovits.py``: semantic codes + phonemes
+ speaker conditioning -> 32 kHz waveform.

  quantizer codebook decode (25 Hz) -> 2x frame upsample (50 Hz)
  -> enc_p: ssl_proj, rel-attn encoder_ssl | text embedding +
     encoder_text, MRTE cross-attention + speaker add, encoder2, proj
     -> (m, logs)
  -> z_p = m + noise * exp(logs) * noise_scale
  -> residual-coupling flow layers (reverse) with WaveNet conditioning
  -> HiFi-GAN generator (NCW inside): conv_pre + speaker cond, transposed
     conv upsample stages, MRF resblocks, conv_post.

Activations are [B, T, C] between the public functions; HiFi-GAN runs in
[B, C, T]. As in the JAX package, every conv casts its weight to the
activation's dtype, and the quantizer codebook is an fp32 leaf, so the
whole synthesizer computes in fp32.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..config import SoVITSConfig
from ..ops.layers import (conv1d, conv1d_ncw, conv_transpose1d_ncw, layer_norm,
                          matmul, unstack)

Params = Dict

LRELU_SLOPE = 0.1


# ---------------------------------------------------------------------------
# VITS-style relative-position attention encoder
# ---------------------------------------------------------------------------

def _vits_layer_norm(p, x):
    """LayerNorm over channels under VITS's names (gamma/beta)."""
    return layer_norm({"scale": p["gamma"], "bias": p["beta"]}, x)


def _rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """[B,H,T,2T-1] relative logits -> [B,H,T,T] absolute (VITS trick)."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, 1))
    x = x.reshape(b, h, t * 2 * t)
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, h, t + 1, 2 * t - 1)
    return x[:, :, :t, t - 1:]


def _abs_to_rel(x: torch.Tensor) -> torch.Tensor:
    """[B,H,T,T] absolute weights -> [B,H,T,2T-1] relative."""
    b, h, t, _ = x.shape
    x = F.pad(x, (0, t - 1))
    x = x.reshape(b, h, t * (2 * t - 1))
    x = F.pad(x, (t, 0))
    x = x.reshape(b, h, t, 2 * t)
    return x[:, :, :, 1:]


def _get_rel_embeddings(emb: torch.Tensor, t: int, window: int) -> torch.Tensor:
    """Slice/pad the [1, 2*window+1, Dh] table to [1, 2t-1, Dh]."""
    pad = max(t - window - 1, 0)
    start = max(window + 1 - t, 0)
    emb = F.pad(emb, (0, 0, pad, pad))
    return emb[:, start: start + 2 * t - 1]


def _heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, T, C = x.shape
    return x.reshape(B, T, n_heads, C // n_heads).transpose(1, 2)


def rel_attention(p, x: torch.Tensor, mask: torch.Tensor, n_heads: int,
                  window: int = 4) -> torch.Tensor:
    """Self-attention with VITS relative position embeddings.

    x: [B, T, C]; mask: [B, T, T] bool (True = attend)."""
    B, T, C = x.shape
    Dh = C // n_heads
    q = _heads(conv1d(p["q"], x), n_heads)
    k = _heads(conv1d(p["k"], x), n_heads)
    v = _heads(conv1d(p["v"], x), n_heads)
    scale = Dh ** -0.5
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    rel_k = _get_rel_embeddings(p["emb_rel_k"].to(q.dtype), T, window)
    rel_logits = torch.einsum("bhqd,mrd->bhqr", q.float(), rel_k.float())
    scores = scores + _rel_to_abs(rel_logits) * scale
    scores = torch.where(mask[:, None], scores, torch.full_like(scores, -1e4))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    rel_v = _get_rel_embeddings(p["emb_rel_v"].to(v.dtype), T, window)
    rel_w = _abs_to_rel(probs).to(v.dtype)
    out = out + torch.einsum("bhqr,mrd->bhqd", rel_w, rel_v)
    out = out.transpose(1, 2).reshape(B, T, C)
    return conv1d(p["o"], out)


def _enc_ffn(p, x, mask_t):
    h = conv1d(p["conv1"], x * mask_t, padding=(p["conv1"]["w"].shape[0] - 1) // 2)
    h = torch.relu(h)
    return conv1d(p["conv2"], h * mask_t, padding=(p["conv2"]["w"].shape[0] - 1) // 2)


def vits_encoder(p_stack, x: torch.Tensor, mask_t: torch.Tensor,
                 n_heads: int) -> torch.Tensor:
    """Stack of post-norm rel-attention blocks.

    x: [B, T, C]; mask_t: [B, T, 1] float validity mask."""
    attn_mask = (mask_t[:, :, 0:1] * mask_t[:, None, :, 0]) > 0   # [B,T,T]
    x = x * mask_t
    for lp in unstack(p_stack):
        y = rel_attention(lp["attn"], x * mask_t, attn_mask, n_heads)
        x = _vits_layer_norm(lp["norm1"], x + y)
        y = _enc_ffn(lp["ffn"], x, mask_t)
        x = _vits_layer_norm(lp["norm2"], x + y)
    return x * mask_t


# ---------------------------------------------------------------------------
# MRTE cross-attention (speaker/text -> content fusion)
# ---------------------------------------------------------------------------

def mrte(p, ssl_enc, ssl_mask_t, text_enc, text_mask_t, ge, n_heads: int = 4):
    """ssl_enc [B,Ty,192], text_enc [B,Tx,192], ge [B,C,1] -> [B,Ty,192]."""
    c = conv1d(p["c_pre"], ssl_enc * ssl_mask_t)          # [B,Ty,512]
    t = conv1d(p["text_pre"], text_enc * text_mask_t)     # [B,Tx,512]
    Dh = c.shape[-1] // n_heads
    q = _heads(conv1d(p["attn_q"], c), n_heads)
    k = _heads(conv1d(p["attn_k"], t), n_heads)
    v = _heads(conv1d(p["attn_v"], t), n_heads)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * (Dh ** -0.5)
    attn_mask = (ssl_mask_t[:, :, 0:1] * text_mask_t[:, None, :, 0]) > 0
    scores = torch.where(attn_mask[:, None], scores, torch.full_like(scores, -1e4))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    B, _, Ty, _ = o.shape
    o = o.transpose(1, 2).reshape(B, Ty, -1)
    x = conv1d(p["attn_o"], o) + c + ge[:, :, 0][:, None, :].to(c.dtype)
    return conv1d(p["c_post"], x * ssl_mask_t)


# ---------------------------------------------------------------------------
# WaveNet conditioning stack + residual coupling flow
# ---------------------------------------------------------------------------

def wavenet(p, x, mask_t, g, n_layers: int, hidden: int, kernel: int):
    """WN: gated dilated convs (dilation 1) with speaker conditioning.

    x: [B,T,hidden]; g: [B,C_gin,1]. cond_layer maps g once for all layers."""
    g_all = conv1d(p["cond_layer"], g.transpose(1, 2).to(x.dtype))
    out = torch.zeros_like(x)
    pad = (kernel - 1) // 2
    for i in range(n_layers):
        x_in = conv1d(p["in_layers"][i], x * mask_t, padding=pad)
        acts = x_in + g_all[:, :, i * 2 * hidden: (i + 1) * 2 * hidden]
        h = torch.tanh(acts[..., :hidden]) * torch.sigmoid(acts[..., hidden:])
        rs = conv1d(p["res_skip_layers"][i], h)
        if i < n_layers - 1:
            x = (x + rs[..., :hidden]) * mask_t
            out = out + rs[..., hidden:]
        else:
            out = out + rs
    return out * mask_t


def flow_reverse(p_stack, x, mask_t, g, cfg: SoVITSConfig):
    """Residual coupling block, reverse direction: for each coupling (last
    to first) undo the channel flip, then invert the coupling."""
    half = cfg.inter_channels // 2
    for lp in reversed(unstack(p_stack)):
        x = torch.flip(x, dims=(-1,))
        x0, x1 = x[..., :half], x[..., half:]
        h = conv1d(lp["pre"], x0) * mask_t
        h = wavenet(lp["enc"], h, mask_t, g, cfg.wn_layers,
                    cfg.hidden_channels, cfg.wn_kernel)
        m = conv1d(lp["post"], h) * mask_t
        x = torch.cat([x0, (x1 - m) * mask_t], dim=-1)
    return x


# ---------------------------------------------------------------------------
# HiFi-GAN generator (MRF), NCW inside
# ---------------------------------------------------------------------------

def _resblock(p, x, kernel: int, dilations: Tuple[int, ...], mask_t):
    """MRF residual block on [B, C, T]; ``mask_t`` [B, 1, T] zeroes pad
    positions after every conv."""
    for d, c1, c2 in zip(dilations, p["convs1"], p["convs2"]):
        h = F.leaky_relu(x, LRELU_SLOPE)
        h = conv1d_ncw(c1, h, padding=(kernel * d - d) // 2, dilation=d) * mask_t
        h = F.leaky_relu(h, LRELU_SLOPE)
        h = conv1d_ncw(c2, h, padding=(kernel - 1) // 2) * mask_t
        x = x + h
    return x


def hifigan(p, x, ge, cfg: SoVITSConfig, frames_len=None):
    """z [B,T,192] + ge [B,C_gin,1] -> waveform [B, T*hop] fp32.

    ``frames_len`` [B]: valid latent frames per row; positions beyond are
    masked at every stage so biases in the pad region cannot bleed into
    valid samples."""
    B, T, _ = x.shape
    if frames_len is None:
        frames_len = torch.full((B,), T, dtype=torch.int64, device=x.device)

    def make_mask(length_scale):
        return (torch.arange(T * length_scale, device=x.device)[None, None, :]
                < frames_len[:, None, None] * length_scale).to(x.dtype)

    x = x.transpose(1, 2)                          # [B, 192, T]
    mask = make_mask(1)
    x = conv1d_ncw(p["conv_pre"], x, padding=3)
    x = (x + conv1d_ncw(p["cond"], ge.to(x.dtype))) * mask
    n_k = len(cfg.resblock_kernels)
    scale = 1
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernels)):
        x = F.leaky_relu(x, LRELU_SLOPE)
        x = conv_transpose1d_ncw(p["ups"][i], x, stride=u, padding=(k - u) // 2)
        scale *= u
        mask = make_mask(scale)
        x = x * mask
        acc = None
        for j in range(n_k):
            r = _resblock(p["resblocks"][i * n_k + j], x, cfg.resblock_kernels[j],
                          cfg.resblock_dilations[j], mask)
            acc = r if acc is None else acc + r
        x = acc / n_k
    # the final activation uses torch's default slope 0.01, not LRELU_SLOPE
    x = F.leaky_relu(x, 0.01)
    x = conv1d_ncw(p["conv_post"], x, padding=3) * mask
    return torch.tanh(x.float())[:, 0, :]


# ---------------------------------------------------------------------------
# MelStyleEncoder (V2 in-model reference encoder)
# ---------------------------------------------------------------------------

def _mish(x):
    return x * torch.tanh(F.softplus(x))


def _dense(p, x):
    return matmul(x, p["w"]) + p["b"]


def mel_style_encode(p, spec: torch.Tensor, mask_t: torch.Tensor,
                     n_heads: int = 2):
    """Linear spectrogram [B,T,spec_channels] -> style vector [B,gin,1]."""
    x = _mish(_dense(p["spectral0"], spec))
    x = _mish(_dense(p["spectral3"], x))
    x = x * mask_t  # pad positions stay zero so the temporal convs match
    for glu in p["temporal"]:
        h = conv1d(glu, x, padding=(glu["w"].shape[0] - 1) // 2)
        a, b = h.chunk(2, dim=-1)
        x = (x + a * torch.sigmoid(b)) * mask_t
    q = _heads(_dense(p["w_qs"], x), n_heads)
    k = _heads(_dense(p["w_ks"], x), n_heads)
    v = _heads(_dense(p["w_vs"], x), n_heads)
    Dh = q.shape[-1]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / (Dh ** 0.5)
    amask = (mask_t[:, :, 0:1] * mask_t[:, None, :, 0]) > 0
    scores = torch.where(amask[:, None], scores, torch.full_like(scores, -1e4))
    o = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, -1).to(v.dtype), v)
    B, _, T, _ = o.shape
    o = o.transpose(1, 2).reshape(B, T, -1)
    x = x + _dense(p["attn_fc"], o)
    x = _dense(p["fc"], x)                                # [B,T,gin]
    w = (x * mask_t).sum(1) / torch.clamp(mask_t.sum(1), min=1.0)
    return w[:, :, None]                                  # [B,gin,1]


# ---------------------------------------------------------------------------
# Full synthesis
# ---------------------------------------------------------------------------

def quantizer_decode(params, codes: torch.Tensor) -> torch.Tensor:
    """Semantic codes [B,Ts] -> latent [B, 2*Ts, 768] (25 Hz -> 50 Hz)."""
    return params["quantizer_embed"][codes].repeat_interleave(2, dim=1)


def text_encode(params, cfg: SoVITSConfig, ssl_latent, y_mask_t, text_ids,
                text_mask_t, ge_mrte):
    """enc_p: latent+text+speaker -> (m, logs). All [B,T,*]."""
    p = params["enc_p"]
    y = conv1d(p["ssl_proj"], ssl_latent * y_mask_t) * y_mask_t
    y = vits_encoder(p["encoder_ssl"], y, y_mask_t, cfg.n_heads)
    t = p["text_embed"][text_ids].to(ssl_latent.dtype)
    t = vits_encoder(p["encoder_text"], t * text_mask_t, text_mask_t, cfg.n_heads)
    y = mrte(p["mrte"], y, y_mask_t, t, text_mask_t, ge_mrte)
    y = vits_encoder(p["encoder2"], y, y_mask_t, cfg.n_heads)
    stats = conv1d(p["proj"], y) * y_mask_t
    m, logs = stats.chunk(2, dim=-1)
    return m, logs


def synthesize_latent(params: Params, cfg: SoVITSConfig, codes: torch.Tensor,
                      codes_len: torch.Tensor, text_ids: torch.Tensor,
                      text_len: torch.Tensor, ge: torch.Tensor,
                      ge_mrte: torch.Tensor, noise_scale: float = 0.5,
                      noise: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Codes -> pre-vocoder latent z [B, 2*Ts, 192] (masked).

    ``noise``: the flow's standard-normal noise [B, 2*Ts, 192] fp32; drawn
    from ``generator`` when not given."""
    latent = quantizer_decode(params, codes)              # [B, T50, 768]
    B, T50, _ = latent.shape
    dev = latent.device
    y_mask_t = (torch.arange(T50, device=dev)[None, :]
                < 2 * codes_len[:, None]).to(latent.dtype)[..., None]
    text_mask_t = (torch.arange(text_ids.shape[1], device=dev)[None, :]
                   < text_len[:, None]).to(latent.dtype)[..., None]
    m, logs = text_encode(params, cfg, latent, y_mask_t, text_ids, text_mask_t,
                          ge_mrte)
    if noise is None:
        noise = torch.randn(m.shape, generator=generator, device=dev,
                            dtype=torch.float32)
    z_p = (m.float() + noise * torch.exp(logs.float()) * noise_scale).to(latent.dtype)
    z = flow_reverse(params["flow"], z_p * y_mask_t, y_mask_t, ge, cfg)
    return z * y_mask_t


def vocode_frames(params: Params, cfg: SoVITSConfig, z: torch.Tensor,
                  ge: torch.Tensor, frames_valid: torch.Tensor) -> torch.Tensor:
    """HiFi-GAN over a latent window. z [B, Tc, 192] -> [B, Tc*hop]."""
    return hifigan(params["dec"], z, ge, cfg, frames_len=frames_valid)


def vocode_frames_chunked(params: Params, cfg: SoVITSConfig, z: torch.Tensor,
                          ge: torch.Tensor, frames_valid: torch.Tensor,
                          chunk: int, halo: int) -> torch.Tensor:
    """Chunked HiFi-GAN: halo-padded windows of ``chunk`` frames, the halo
    trimmed from each output, and windows past the longest valid row
    skipped. Equal to one whole-``F`` pass away from chunk edges, since
    the generator's receptive field (~14 frames) is inside the halo."""
    B, F_, _ = z.shape
    hop = cfg.hop_length
    if F_ <= chunk + 2 * halo:
        return vocode_frames(params, cfg, z, ge, frames_valid)
    out = torch.zeros((B, F_ * hop), dtype=torch.float32, device=z.device)
    fv = int(frames_valid.max())
    for start in range(0, F_, chunk):
        if fv <= start:
            break
        s0 = max(start - halo, 0)
        s1 = min(start + chunk + halo, F_)
        valid = torch.clamp(frames_valid - s0, 0, s1 - s0)
        n = min(chunk, F_ - start)
        a = vocode_frames(params, cfg, z[:, s0:s1], ge, valid)
        out[:, start * hop:(start + n) * hop] = a[:, (start - s0) * hop:
                                                 (start - s0 + n) * hop]
    return out


def synthesize(params: Params, cfg: SoVITSConfig, codes: torch.Tensor,
               codes_len: torch.Tensor, text_ids: torch.Tensor,
               text_len: torch.Tensor, ge: torch.Tensor, ge_mrte: torch.Tensor,
               noise_scale: float = 0.5, noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Full SoVITS decode -> waveform [B, 2*Ts*hop]. Frames beyond
    codes_len produce garbage; callers trim to 2*codes_len*hop samples."""
    z = synthesize_latent(params, cfg, codes, codes_len, text_ids, text_len,
                          ge, ge_mrte, noise_scale, noise, generator)
    return hifigan(params["dec"], z, ge, cfg, frames_len=2 * codes_len)


def reference_embedding(params, cfg: SoVITSConfig, spec: torch.Tensor,
                        spec_len: torch.Tensor):
    """V2 path: linear spectrogram of ref audio -> ge [B, gin, 1]."""
    mask_t = (torch.arange(spec.shape[1], device=spec.device)[None, :]
              < spec_len[:, None]).to(spec.dtype)[..., None]
    return mel_style_encode(params["ref_enc"], spec, mask_t)


# ---------------------------------------------------------------------------
# Random init (tests and the chip smoke run; real weights are converted)
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: SoVITSConfig,
                dtype=torch.bfloat16) -> Params:
    """Random V2 SoVITS weights on ``generator``'s device."""
    dev = generator.device
    C, Fc, H = cfg.hidden_channels, cfg.filter_channels, cfg.n_heads
    gin = cfg.gin_channels
    half = cfg.inter_channels // 2

    def randn(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dt)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def conv(width, i, o, bias=True, lead=()):
        p = {"w": randn(*lead, width, i, o, std=(i * width) ** -0.5)}
        if bias:
            p["b"] = zeros(*lead, o)
        return p

    def dense(i, o):
        return {"w": randn(i, o, std=i ** -0.5), "b": zeros(o)}

    def enc_stack(n_layers):
        Dh = C // H
        lead = (n_layers,)
        ones = torch.ones((n_layers, C), device=dev)
        nil = torch.zeros((n_layers, C), device=dev)
        return {
            "attn": {"q": conv(1, C, C, lead=lead), "k": conv(1, C, C, lead=lead),
                     "v": conv(1, C, C, lead=lead), "o": conv(1, C, C, lead=lead),
                     "emb_rel_k": randn(n_layers, 1, 9, Dh, std=Dh ** -0.5),
                     "emb_rel_v": randn(n_layers, 1, 9, Dh, std=Dh ** -0.5)},
            "norm1": {"gamma": ones, "beta": nil},
            "ffn": {"conv1": conv(cfg.kernel_size, C, Fc, lead=lead),
                    "conv2": conv(cfg.kernel_size, Fc, C, lead=lead)},
            "norm2": {"gamma": ones.clone(), "beta": nil.clone()},
        }

    nf, wl = cfg.flow_layers, cfg.wn_layers
    flow = {
        "pre": conv(1, half, C, lead=(nf,)),
        "post": conv(1, C, half, lead=(nf,)),
        "enc": {
            "cond_layer": conv(1, gin, 2 * C * wl, lead=(nf,)),
            "in_layers": [conv(cfg.wn_kernel, C, 2 * C, lead=(nf,)) for _ in range(wl)],
            "res_skip_layers": [conv(1, C, 2 * C if i < wl - 1 else C, lead=(nf,))
                                for i in range(wl)],
        },
    }

    ups, resblocks = [], []
    ch = cfg.upsample_initial
    for u, k_up in zip(cfg.upsample_rates, cfg.upsample_kernels):
        ups.append(conv(k_up, ch, ch // 2))
        ch //= 2
        for kern, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            resblocks.append({"convs1": [conv(kern, ch, ch) for _ in dils],
                              "convs2": [conv(kern, ch, ch) for _ in dils]})

    mc = cfg.mrte_channels
    return {
        "quantizer_embed": randn(cfg.vq_codes, cfg.vq_dim, dt=torch.float32),
        "enc_p": {
            "ssl_proj": conv(1, cfg.vq_dim, C),
            "text_embed": randn(732, C, std=0.02),
            "encoder_ssl": enc_stack(cfg.n_layers // 2),
            "encoder_text": enc_stack(cfg.n_layers),
            "encoder2": enc_stack(cfg.n_layers // 2),
            "mrte": {"c_pre": conv(1, C, mc), "text_pre": conv(1, C, mc),
                     "attn_q": conv(1, mc, mc), "attn_k": conv(1, mc, mc),
                     "attn_v": conv(1, mc, mc), "attn_o": conv(1, mc, mc),
                     "c_post": conv(1, mc, C)},
            "proj": conv(1, C, cfg.inter_channels * 2),
        },
        "flow": flow,
        "dec": {
            "conv_pre": conv(7, cfg.inter_channels, cfg.upsample_initial),
            "cond": conv(1, gin, cfg.upsample_initial),
            "ups": ups,
            "resblocks": resblocks,
            "conv_post": conv(7, ch, 1, bias=False),
        },
        "ref_enc": {
            "spectral0": dense(cfg.spec_channels, 128),
            "spectral3": dense(128, 128),
            "temporal": [conv(5, 128, 256) for _ in range(2)],
            "w_qs": dense(128, 128), "w_ks": dense(128, 128),
            "w_vs": dense(128, 128), "attn_fc": dense(128, 128),
            "fc": dense(128, gin),
        },
    }
