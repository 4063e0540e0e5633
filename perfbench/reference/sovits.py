"""GPT-SoVITS V2 synthesizer and its speaker conditioning, in plain PyTorch.

One utterance at a time, unpadded, channel-major ([C, T]):

- :func:`spectrogram`: the magnitude STFT of the 32 kHz clip (reflect
  padding of (n_fft - hop) / 2 a side, periodic Hann window, no centring);
- :func:`style`: the MelStyleEncoder (two Mish dense layers, two gated
  temporal convolutions, two-head self-attention, a dense layer, the mean
  over time): V2's speaker vector ``ge``;
- :func:`prompt_encoder`: V2ProPlus's ``ge`` (the style vector plus the
  SV embedding's projection, through a per-channel PReLU) and its MRTE
  conditioning ``ge_mrte``;
- :func:`latent`: the codebook rows of the codes at 50 Hz, the VITS text
  encoder (relative-position attention encoders, MRTE cross-attention),
  the prior's mean (no flow noise) and the residual-coupling flow in
  reverse;
- :func:`vocode`: the HiFi-GAN generator (transposed-conv upsampling,
  multi-receptive-field residual blocks, tanh).

Weights are read from the raw tree in a converted checkpoint's layout (a
conv's ``w`` as [width, in, out], a dense ``w`` as [in, out], encoder and
flow layers stacked on a leading axis). ``act`` is the dtype of every
convolution and matmul (float32 for the reference, the control's
bfloat16); everything between them is float32."""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

LRELU = 0.1
REL_WINDOW = 4


def _layer(tree, i: int):
    """Layer ``i`` of a tree whose leaves are stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items() if not k.startswith("_")}
    if isinstance(tree, (list, tuple)):
        return [_layer(v, i) for v in tree]
    return tree[i]


def conv(p: Dict, x: torch.Tensor, act=torch.float32, **kw) -> torch.Tensor:
    """[C_in, T] -> [C_out, T'] with the weight [width, in, out]."""
    w = p["w"].float().permute(2, 1, 0).to(act)
    y = F.conv1d(x.to(act)[None], w, **kw)[0].float()
    return y + p["b"].float()[:, None] if "b" in p else y


def conv_transpose(p: Dict, x: torch.Tensor, stride: int, padding: int,
                   act=torch.float32) -> torch.Tensor:
    w = p["w"].float().permute(1, 2, 0).to(act)                # [in, out, width]
    y = F.conv_transpose1d(x.to(act)[None], w, stride=stride, padding=padding)[0].float()
    return y + p["b"].float()[:, None] if "b" in p else y


def dense(p: Dict, x: torch.Tensor, act=torch.float32) -> torch.Tensor:
    """[T, in] -> [T, out]."""
    return (x.to(act) @ p["w"].float().to(act)).float() + p["b"].float()


def spectrogram(audio: torch.Tensor, n_fft: int, hop: int, win: int) -> torch.Tensor:
    """[S] float waveform -> [n_fft // 2 + 1, S // hop] magnitudes."""
    pad = (n_fft - hop) // 2
    x = F.pad(audio.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=audio.device)
    s = torch.stft(x, n_fft, hop_length=hop, win_length=win, window=window, center=False,
                   return_complex=True)
    return torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-6)


def _mish(x):
    return x * torch.tanh(F.softplus(x))


def style(p: Dict, spec: torch.Tensor, act=torch.float32, heads: int = 2) -> torch.Tensor:
    """[F, T] spectrogram -> [gin] style vector."""
    x = _mish(dense(p["spectral0"], spec.T, act))
    x = _mish(dense(p["spectral3"], x, act)).T                 # [128, T]
    for glu in p["temporal"]:
        a, b = conv(glu, x, act, padding=(glu["w"].shape[0] - 1) // 2).chunk(2, dim=0)
        x = x + a * torch.sigmoid(b)
    x = x.T                                                    # [T, 128]
    T, D = x.shape
    q, k, v = (dense(p[n], x, act).reshape(T, heads, D // heads).transpose(0, 1)
               for n in ("w_qs", "w_ks", "w_vs"))
    att = torch.softmax((q.to(act) @ k.to(act).transpose(1, 2)).float()
                        / math.sqrt(D // heads), -1)
    o = (att.to(act) @ v.to(act)).float().transpose(0, 1).reshape(T, D)
    x = dense(p["fc"], x + dense(p["attn_fc"], o, act), act)
    return x.mean(0)


def prompt_encoder(p: Dict, spec: torch.Tensor, sv_emb: torch.Tensor,
                   act=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """(spectrogram [F, T], SV embedding [20480]) -> (ge [gin], ge_mrte [512])."""
    ge = style(p["ref_enc"], spec, act) + dense(p["sv_emb"], sv_emb[None], act)[0]
    ge = torch.where(ge >= 0, ge, p["prelu_weight"].float() * ge)
    return ge, dense(p["ge_to512"], ge[None], act)[0]


def _ln(p: Dict, x: torch.Tensor) -> torch.Tensor:
    """LayerNorm over the channels of [C, T]."""
    return F.layer_norm(x.T, (x.shape[0],), p["gamma"].float(), p["beta"].float(), 1e-5).T


def _rel_attention(p: Dict, x: torch.Tensor, heads: int, act) -> torch.Tensor:
    """Self-attention with VITS's relative-position keys and values (shared
    by the heads, offsets -4..4, none beyond)."""
    C, T = x.shape
    Dh = C // heads
    q, k, v = (conv(p[n], x, act).reshape(heads, Dh, T).transpose(1, 2) for n in "qkv")
    q = q * Dh ** -0.5
    scores = (q.to(act) @ k.to(act).transpose(1, 2)).float()  # [H, T, T]
    ek, ev = p["emb_rel_k"][0].float(), p["emb_rel_v"][0].float()
    for d in range(-REL_WINDOW, REL_WINDOW + 1):
        if abs(d) >= T:
            continue
        rel = (q.to(act) @ ek[d + REL_WINDOW].to(act)).float()          # [H, T]
        rows = torch.arange(max(0, -d), T - max(0, d), device=x.device)
        scores[:, rows, rows + d] += rel[:, rows]
    probs = torch.softmax(scores, -1)
    out = (probs.to(act) @ v.to(act)).float()
    for d in range(-REL_WINDOW, REL_WINDOW + 1):
        if abs(d) >= T:
            continue
        rows = torch.arange(max(0, -d), T - max(0, d), device=x.device)
        out[:, rows] += probs[:, rows, rows + d][..., None] * ev[d + REL_WINDOW]
    return conv(p["o"], out.transpose(1, 2).reshape(C, T), act)


def encoder(stack: Dict, x: torch.Tensor, heads: int, act) -> torch.Tensor:
    """Post-LN relative-attention encoder layers over [C, T]."""
    for i in range(stack["norm1"]["gamma"].shape[0]):
        lay = _layer(stack, i)
        x = _ln(lay["norm1"], x + _rel_attention(lay["attn"], x, heads, act))
        c1, c2 = lay["ffn"]["conv1"], lay["ffn"]["conv2"]
        h = torch.relu(conv(c1, x, act, padding=(c1["w"].shape[0] - 1) // 2))
        x = _ln(lay["norm2"], x + conv(c2, h, act, padding=(c2["w"].shape[0] - 1) // 2))
    return x


def _mrte(p: Dict, ssl: torch.Tensor, text: torch.Tensor, ge_mrte: torch.Tensor,
          act, heads: int = 4) -> torch.Tensor:
    """Cross-attention of the content [C, Ty] over the text [C, Tx], plus
    the speaker."""
    c = conv(p["c_pre"], ssl, act)
    t = conv(p["text_pre"], text, act)
    D, Ty = c.shape
    Dh = D // heads
    q = conv(p["attn_q"], c, act).reshape(heads, Dh, Ty).transpose(1, 2)
    k = conv(p["attn_k"], t, act).reshape(heads, Dh, -1)
    v = conv(p["attn_v"], t, act).reshape(heads, Dh, -1).transpose(1, 2)
    att = torch.softmax((q.to(act) @ k.to(act)).float() * Dh ** -0.5, -1)
    o = (att.to(act) @ v.to(act)).float().transpose(1, 2).reshape(D, Ty)
    return conv(p["c_post"], conv(p["attn_o"], o, act) + c + ge_mrte.float()[:, None], act)


def _wavenet(p: Dict, x: torch.Tensor, ge: torch.Tensor, act) -> torch.Tensor:
    hidden = x.shape[0]
    n = len(p["in_layers"])
    g = conv(p["cond_layer"], ge.float()[:, None], act)         # [2 * hidden * n, 1]
    out = torch.zeros_like(x)
    for i in range(n):
        il = p["in_layers"][i]
        a = conv(il, x, act, padding=(il["w"].shape[0] - 1) // 2) \
            + g[i * 2 * hidden:(i + 1) * 2 * hidden]
        h = torch.tanh(a[:hidden]) * torch.sigmoid(a[hidden:])
        rs = conv(p["res_skip_layers"][i], h, act)
        if i < n - 1:
            x = x + rs[:hidden]
            out = out + rs[hidden:]
        else:
            out = out + rs
    return out


def latent(p: Dict, codes: torch.Tensor, phones: torch.Tensor, ge: torch.Tensor,
           ge_mrte: torch.Tensor, heads: int, act=torch.float32) -> torch.Tensor:
    """(codes [n], phonemes [Tx], ge [gin], ge_mrte [512]) -> the latent
    [inter, 2n] the vocoder takes, at the prior's mean."""
    e = p["enc_p"]
    y = p["quantizer_embed"].float()[codes.long()].repeat_interleave(2, dim=0).T
    y = encoder(e["encoder_ssl"], conv(e["ssl_proj"], y, act), heads, act)
    t = encoder(e["encoder_text"], e["text_embed"].float()[phones.long()].T, heads, act)
    y = encoder(e["encoder2"], _mrte(e["mrte"], y, t, ge_mrte, act), heads, act)
    stats = conv(e["proj"], y, act)
    x = stats[: stats.shape[0] // 2]                           # the prior's mean
    flow = p["flow"]
    half = x.shape[0] // 2
    for i in reversed(range(flow["pre"]["w"].shape[0])):
        lay = _layer(flow, i)
        x = torch.flip(x, dims=(0,))
        x0, x1 = x[:half], x[half:]
        h = _wavenet(lay["enc"], conv(lay["pre"], x0, act), ge, act)
        x = torch.cat([x0, x1 - conv(lay["post"], h, act)])
    return x


def vocode(p: Dict, z: torch.Tensor, ge: torch.Tensor, upsample_rates, upsample_kernels,
           resblock_kernels, resblock_dilations, act=torch.float32) -> torch.Tensor:
    """HiFi-GAN: latent [inter, F] -> waveform [F * prod(upsample_rates)]."""
    d = p["dec"]
    x = conv(d["conv_pre"], z, act, padding=3) + conv(d["cond"], ge.float()[:, None], act)
    nk = len(resblock_kernels)
    for i, (u, k) in enumerate(zip(upsample_rates, upsample_kernels)):
        x = conv_transpose(d["ups"][i], F.leaky_relu(x, LRELU), u, (k - u) // 2, act)
        acc = 0
        for j, (kern, dils) in enumerate(zip(resblock_kernels, resblock_dilations)):
            rb, r = d["resblocks"][i * nk + j], x
            for di, c1, c2 in zip(dils, rb["convs1"], rb["convs2"]):
                h = conv(c1, F.leaky_relu(r, LRELU), act, padding=(kern * di - di) // 2,
                         dilation=di)
                r = r + conv(c2, F.leaky_relu(h, LRELU), act, padding=(kern - 1) // 2)
            acc = acc + r
        x = acc / nk
    x = conv(d["conv_post"], F.leaky_relu(x, 0.01), act, padding=3)
    return torch.tanh(x[0])
