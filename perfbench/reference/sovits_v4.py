"""GPT-SoVITS V4's synthesizer, in plain PyTorch: one request at a time,
unpadded, every tensor of its own length.

- :func:`mel`: the 32 kHz clip's log-mel as ``inference_webui.py``'s
  ``mel_fn_v4`` makes it (n_fft and window 1280, hop 320, reflect padding
  of 480 a side, no centring, magnitude ``sqrt(re^2 + im^2 + 1e-9)``,
  librosa's Slaney filterbank of 100 bands over 0-16 kHz, built here,
  ``log(clamp(., 1e-5))``), normalised as ``norm_spec``;
- :func:`decode_encp`: V2's text side (``reference/sovits.py``'s
  encoders and MRTE) to its hidden output, the bridge (1x1 conv, LeakyReLU
  0.01), 2x nearest, ``wns1`` (1x1 conv, WaveNet on ``ge``, 1x1 conv):
  [C, 4n];
- :func:`cfm`: ``CFM.inference`` with ``inference_cfg_rate`` 0: Euler
  over ``steps``, the DiT (F5-TTS ``backbones/dit.py``) with full
  attention over the chunk, the text and ``d`` embeddings computed once;
- :func:`synthesize`: the chunk loop of ``inference_webui.py`` (slices
  of ``T_chunk - P`` frames after a P-frame prompt, the next prompt the
  last P output frames and the last P frames of the slice), then
  ``denorm_spec`` and the vocoder (:func:`vocode`: HiFi-GAN, no speaker
  input, a biased ``conv_post``).

Conventions this reference shares with the program by contract, not by
code: the CFM noise of chunk ``k`` of a request with seed ``s`` is
``torch.randn((frames, mel_dim))`` from a generator on the device seeded
with ``s x 1000003 + k`` (mod 2^63) (the program draws it the same way,
so the check can draw it again); the timestep sinusoid is computed in
float32 (upstream's half precision is exact at the Euler grid's times);
the rotary embedding is x-transformers' ``RotaryEmbedding(dim_head)``
applied, as F5-TTS's ``AttnProcessor`` applies it, to the projected rows
before the split into heads: only the first ``dim_head`` channels rotate
(interleaved pairs, base 10000). Departures from upstream: none in the
math; upstream runs in half precision, this in float32.

``act``: the dtype of every convolution's and matmul's operands (float32;
the control's bfloat16); ``fp8``: the DiT's linears take their weights
and inputs rounded to float8 e4m3 with a per-tensor scale (the
control)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from . import sovits as v2

LRELU = 0.1
E4M3_MAX = 448.0


def _mel_hz(m):
    """Slaney mel -> Hz (linear below 1 kHz, logarithmic above)."""
    f_sp, brk = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(m >= brk / f_sp, brk * np.exp(step * (m - brk / f_sp)), f_sp * m)


def _hz_mel(f):
    f_sp, brk = 200.0 / 3, 1000.0
    step = np.log(6.4) / 27.0
    return np.where(f >= brk, brk / f_sp + np.log(np.maximum(f, 1e-10) / brk) / step,
                    f / f_sp)


def filterbank(n_mels: int, n_fft: int, sr: int, fmin: float, fmax: float) -> np.ndarray:
    """librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax) (htk False, norm
    "slaney"): triangles between adjacent mel points, each scaled to unit
    area in Hz."""
    edges = _mel_hz(np.linspace(_hz_mel(fmin), _hz_mel(fmax), n_mels + 2))
    freqs = np.arange(n_fft // 2 + 1) * sr / n_fft
    fb = np.zeros((n_mels, len(freqs)))
    for i in range(n_mels):
        lo, mid, hi = edges[i], edges[i + 1], edges[i + 2]
        rise = (freqs - lo) / (mid - lo)
        fall = (hi - freqs) / (hi - mid)
        fb[i] = np.clip(np.minimum(rise, fall), 0.0, None) * 2.0 / (hi - lo)
    return fb


def mel(audio: torch.Tensor, v4: Dict) -> torch.Tensor:
    """[S] float waveform at 32 kHz -> the normalised log-mel [M, S // hop]."""
    n_fft, hop, win = v4["mel_n_fft"], v4["mel_hop"], v4["mel_win"]
    pad = (n_fft - hop) // 2
    x = F.pad(audio.float()[None, None], (pad, pad), mode="reflect")[0, 0]
    window = torch.hann_window(win, periodic=True, dtype=torch.float32, device=audio.device)
    s = torch.stft(x, n_fft, hop_length=hop, win_length=win, window=window, center=False,
                   return_complex=True)
    mag = torch.sqrt(s.real ** 2 + s.imag ** 2 + 1e-9)
    fb = torch.as_tensor(filterbank(v4["mel_dim"], n_fft, v4["mel_sample_rate"],
                                    v4["mel_fmin"], v4["mel_fmax"]),
                         dtype=torch.float32, device=audio.device)
    logmel = torch.log(torch.clamp(fb @ mag, min=1e-5))
    return (logmel + 12.0) / 14.0 * 2 - 1


def denorm(x: torch.Tensor) -> torch.Tensor:
    return (x + 1) / 2 * 14.0 - 12.0


def decode_encp(p: Dict, codes: torch.Tensor, phones: torch.Tensor, ge: torch.Tensor,
                heads: int, act=torch.float32) -> torch.Tensor:
    """(codes [n], phonemes [Tx], ge [gin]) -> fea [C, 4n]."""
    e = p["enc_p"]
    y = p["quantizer_embed"].float()[codes.long()].repeat_interleave(2, dim=0).T
    y = v2.encoder(e["encoder_ssl"], v2.conv(e["ssl_proj"], y, act), heads, act)
    t = v2.encoder(e["encoder_text"], e["text_embed"].float()[phones.long()].T, heads, act)
    y = v2.encoder(e["encoder2"], v2._mrte(e["mrte"], y, t, ge, act), heads, act)
    x = F.leaky_relu(v2.conv(p["bridge"], y, act), 0.01).repeat_interleave(2, dim=1)
    w = p["wns1"]
    return v2.conv(w["proj"], v2._wavenet(w["enc"], v2.conv(w["pre"], x, act), ge, act), act)


# -- the DiT, time-major [T, C] ---------------------------------------------

def _q8(x: torch.Tensor) -> torch.Tensor:
    s = x.float().abs().max().clamp(min=1e-12) / E4M3_MAX
    return (x.float() / s).to(torch.float8_e4m3fn).float() * s


def _lin(p: Dict, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    w = p["w"].float()
    if fp8:
        return _q8(x) @ _q8(w) + p["b"].float()
    return x.float() @ w + p["b"].float()


def _t_embed(p: Dict, t: float, dim: int) -> torch.Tensor:
    half = dim // 2
    dev = p["fc1"]["w"].device
    freqs = torch.exp(torch.arange(half, device=dev, dtype=torch.float32)
                      * -(math.log(10000.0) / (half - 1)))
    arg = 1000.0 * t * freqs
    h = torch.cat([torch.sin(arg), torch.cos(arg)])
    return _lin(p["fc2"], F.silu(_lin(p["fc1"], h)))


def _layer(tree, i):
    return v2._layer(tree, i)


def _text(p: Dict, mu: torch.Tensor, fp8: bool) -> torch.Tensor:
    """TextEmbedding: mu [T, C] + cat(cos, sin) positions, ConvNeXt-V2 blocks."""
    T, C = mu.shape
    inv = 10000.0 ** (-torch.arange(0, C, 2, device=mu.device).float() / C)
    ang = torch.arange(T, device=mu.device).float()[:, None] * inv[None]
    x = mu.float() + torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)
    for i in range(p["dw"]["w"].shape[0]):
        b = _layer(p, i)
        w = b["dw"]["w"].float().permute(2, 1, 0)                 # [C, 1, 7]
        y = F.conv1d(x.T[None], w, b["dw"]["b"].float(), padding=3, groups=C)[0].T
        y = F.layer_norm(y, (C,), b["norm"]["scale"].float(), b["norm"]["bias"].float(), 1e-6)
        y = F.gelu(_lin(b["pw1"], y, fp8))
        g = torch.sqrt((y * y).sum(dim=0, keepdim=True))
        y = b["grn"]["gamma"].float() * (y * (g / (g.mean() + 1e-6))) + b["grn"]["beta"].float() + y
        x = x + _lin(b["pw2"], y, fp8)
    return x


def _rope(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Rotate the first ``dim`` channels of [T, C] in interleaved pairs."""
    T = x.shape[0]
    inv = 10000.0 ** (-torch.arange(0, dim, 2, device=x.device).float() / dim)
    ang = torch.arange(T, device=x.device).float()[:, None] * inv[None]   # [T, dim/2]
    c, s = torch.cos(ang), torch.sin(ang)
    ev, od = x[:, 0:dim:2], x[:, 1:dim:2]
    rot = torch.stack([ev * c - od * s, od * c + ev * s], dim=-1).reshape(T, dim)
    return torch.cat([rot, x[:, dim:]], dim=1)


def dit(p: Dict, v4: Dict, x, cond, text, temb, fp8: bool = False) -> torch.Tensor:
    """The velocity [T, M] of the DiT."""
    D = p["proj_out"]["w"].shape[0]
    H, Dh = v4["dit_heads"], v4["dit_head_dim"]
    h = _lin(p["input"]["proj"], torch.cat([x, cond, text], dim=1), fp8)
    pos = h.T[None]
    for c in p["input"]["conv_pos"]:
        w = c["w"].float().permute(2, 1, 0)
        pos = F.mish(F.conv1d(pos, w, c["b"].float(), padding=w.shape[-1] // 2,
                              groups=v4["conv_pos_groups"]))
    h = h + pos[0].T
    st = F.silu(temb)
    T = h.shape[0]
    for i in range(p["blocks"]["q"]["w"].shape[0]):
        b = _layer(p["blocks"], i)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = _lin(b["ada"], st, fp8).chunk(6)
        n = F.layer_norm(h, (D,), eps=1e-6) * (1 + sc_a) + sh_a
        q = _rope(_lin(b["q"], n, fp8), Dh).reshape(T, H, Dh).transpose(0, 1)
        k = _rope(_lin(b["k"], n, fp8), Dh).reshape(T, H, Dh).transpose(0, 1)
        v = _lin(b["v"], n, fp8).reshape(T, H, Dh).transpose(0, 1)
        att = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(Dh), dim=-1)
        a = (att @ v).transpose(0, 1).reshape(T, H * Dh)
        h = h + g_a * _lin(b["out"], a, fp8)
        n = F.layer_norm(h, (D,), eps=1e-6) * (1 + sc_f) + sh_f
        h = h + g_f * _lin(b["ff2"], F.gelu(_lin(b["ff1"], n, fp8), approximate="tanh"), fp8)
    scale, shift = _lin(p["norm_out"], st, fp8).chunk(2)
    h = F.layer_norm(h, (D,), eps=1e-6) * (1 + scale) + shift
    return _lin(p["proj_out"], h, fp8)


def noise(seed: int, chunk: int, frames: int, mel_dim: int, device) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + int(chunk)) % 2 ** 63)
    return torch.randn((frames, mel_dim), generator=g, device=device, dtype=torch.float32)


def cfm(p: Dict, v4: Dict, mu: torch.Tensor, prompt: torch.Tensor, x0: torch.Tensor,
        steps: int, fp8: bool = False) -> torch.Tensor:
    """Euler from the noise ``x0`` [T, M] under the prompt [P, M] and the
    features ``mu`` [T, C] -> [T, M] (the prompt region zero)."""
    P = prompt.shape[0]
    x = x0.clone()
    x[:P] = 0
    cond = torch.zeros_like(x)
    cond[:P] = prompt
    text = _text(p["text_blocks"], mu, fp8)
    d = 1.0 / steps
    dim = v4["freq_embed_dim"]
    d_emb = _t_embed(p["d_embed"], d, dim)
    t = 0.0
    for _ in range(steps):
        v = dit(p, v4, x, cond, text, _t_embed(p["time_embed"], t, dim) + d_emb, fp8)
        x = x + d * v
        t = t + d
        x[:P] = 0
    return x


def prompt_cut(mel2: torch.Tensor, fea_ref: torch.Tensor, t_ref: int):
    """([M, Tm], [C, Tf]) -> ([P, M], [P, C]): the first min(Tm, Tf)
    frames of each, then their last ``t_ref`` if longer."""
    n = min(mel2.shape[1], fea_ref.shape[1])
    mel2, fea_ref = mel2[:, :n], fea_ref[:, :n]
    if n > t_ref:
        mel2, fea_ref = mel2[:, -t_ref:], fea_ref[:, -t_ref:]
    return mel2.T, fea_ref.T


def synthesize(p: Dict, v4: Dict, fea: torch.Tensor, fea_ref: torch.Tensor,
               mel2: torch.Tensor, seed: int, act=torch.float32, fp8: bool = False):
    """The chunk loop over ``fea`` [C, F] with the prompt (``fea_ref`` [P,
    C], ``mel2`` [P, M]) -> (the sampled mel [F, M], normalised; the
    waveform)."""
    fea = fea.T
    P = mel2.shape[0]
    step = v4["T_chunk"] - P
    outs = []
    for k, s in enumerate(range(0, fea.shape[0], step)):
        sl = fea[s:s + step]
        mu = torch.cat([fea_ref, sl])
        x = cfm(p["cfm"], v4, mu, mel2, noise(seed, k, mu.shape[0], v4["mel_dim"], fea.device),
                v4["sample_steps"], fp8)[P:]
        outs.append(x)
        mel2, fea_ref = x[-P:], sl[-P:]
    m = torch.cat(outs)
    return m, vocode(p["dec"], denorm(m).T, v4, act)


def vocode(d: Dict, m: torch.Tensor, v4: Dict, act=torch.float32) -> torch.Tensor:
    """HiFi-GAN without speaker input: mel [M, F] -> waveform [F x hop]."""
    x = v2.conv(d["conv_pre"], m, act, padding=3)
    kres, dils = v4["resblock_kernels"], v4["resblock_dilations"]
    nk = len(kres)
    for i, (u, k) in enumerate(zip(v4["upsample_rates"], v4["upsample_kernels"])):
        x = v2.conv_transpose(d["ups"][i], F.leaky_relu(x, LRELU), u, (k - u) // 2, act)
        acc = 0
        for j, (kern, dl) in enumerate(zip(kres, dils)):
            rb, r = d["resblocks"][i * nk + j], x
            for di, c1, c2 in zip(dl, rb["convs1"], rb["convs2"]):
                h = v2.conv(c1, F.leaky_relu(r, LRELU), act, padding=(kern * di - di) // 2,
                            dilation=di)
                r = r + v2.conv(c2, F.leaky_relu(h, LRELU), act, padding=(kern - 1) // 2)
            acc = acc + r
        x = acc / nk
    x = v2.conv(d["conv_post"], F.leaky_relu(x, 0.01), act, padding=3)
    return torch.tanh(x[0])
