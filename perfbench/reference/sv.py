"""The ERes2NetV2 speaker-verification embedding (V2ProPlus) in plain PyTorch.

A 16 kHz waveform -> the Kaldi log-mel fbank (80 bins, 25 ms frames every
10 ms with snip-edges framing, the input at int16 scale, each frame's mean
removed, pre-emphasis 0.97, the Povey window, the power spectrum of a
512-point FFT through HTK-mel triangles, log floored at 1e-10) -> the
3D-Speaker ERes2NetV2 recipe GPT-SoVITS V2ProPlus uses (64 channels,
base width 24, scale 4, expansion 4, blocks (3, 4, 6, 3); Res2Net
bottlenecks whose 3x3 stages are hierarchical, fused by attentional
feature fusion in layers 3 and 4 and on the layer3 -> layer4 skip) ->
2048 channels x 10 frequency bins, flattened channel-major, mean over
time: [20480].

Weights in the converted tree's layout: 2-D kernels HWIO, the batch
norms folded into the convolutions' biases. ``act`` is the dtype of
every convolution (float32 for the reference, the control's bfloat16)."""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

SCALE = 4
BLOCKS = (3, 4, 6, 3)


def fbank(audio: torch.Tensor, bins: int = 80, sr: int = 16000) -> torch.Tensor:
    """[S] waveform in [-1, 1] -> [T, bins]."""
    flen, shift = int(0.025 * sr), int(0.010 * sr)
    n_fft = 1 << (flen - 1).bit_length()
    frames = (audio.float() * 32768.0).unfold(0, flen, shift)
    frames = frames - frames.mean(-1, keepdim=True)
    frames = frames - 0.97 * torch.cat([frames[:, :1], frames[:, :-1]], -1)
    n = torch.arange(flen, dtype=torch.float64, device=audio.device)
    window = ((0.5 - 0.5 * torch.cos(2 * math.pi * n / (flen - 1))) ** 0.85).float()
    power = torch.fft.rfft(frames * window, n=n_fft).abs() ** 2

    def mel(f):
        return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)

    edges = np.linspace(mel(20.0), mel(sr / 2), bins + 2)
    m = mel(np.arange(n_fft // 2 + 1) * sr / n_fft)
    tri = np.maximum(0.0, np.minimum((m[None] - edges[:-2, None]) / (edges[1:-1, None] - edges[:-2, None]),
                                     (edges[2:, None] - m[None]) / (edges[2:, None] - edges[1:-1, None])))
    banks = torch.as_tensor(tri, dtype=torch.float32, device=audio.device)
    return torch.log(torch.clamp(power @ banks.T, min=1e-10))


def _conv(p: Dict, x: torch.Tensor, act, stride: int = 1, padding: int = 1) -> torch.Tensor:
    w = p["w"].float().permute(3, 2, 0, 1).to(act)            # HWIO -> OIHW
    y = F.conv2d(x.to(act), w, stride=stride, padding=padding).float()
    return y + p["b"].float()[None, :, None, None] if "b" in p else y


def _aff(p: Dict, x: torch.Tensor, y: torch.Tensor, act) -> torch.Tensor:
    h = F.silu(_conv(p["att1"], torch.cat([x, y], 1), act, padding=0))
    gate = 1.0 + torch.tanh(_conv(p["att2"], h, act, padding=0))
    return x * gate + y * (2.0 - gate)


def _block(p: Dict, x: torch.Tensor, stride: int, fuse: bool, act) -> torch.Tensor:
    h = F.relu(_conv(p["conv1"], x, act, stride=stride, padding=0))
    parts = torch.split(h, h.shape[1] // SCALE, dim=1)
    outs, sp = [], parts[0]
    for i in range(SCALE):
        if i:
            sp = _aff(p["fuse"][i - 1], sp, parts[i], act) if fuse else sp + parts[i]
        sp = F.relu(_conv(p["convs"][i], sp, act))
        outs.append(sp)
    h = _conv(p["conv3"], torch.cat(outs, 1), act, padding=0)
    skip = _conv(p["shortcut"], x, act, stride=stride, padding=0) if "shortcut" in p else x
    return F.relu(h + skip)


def embedding(p: Dict, audio_16k: torch.Tensor, act=torch.float32) -> torch.Tensor:
    """[S] waveform at 16 kHz -> [20480]."""
    x = F.relu(_conv(p["conv1"], fbank(audio_16k).T[None, None], act))    # [1, 64, 80, T]
    for li, (n, stride) in enumerate(zip(BLOCKS, (1, 2, 2, 2))):
        for bi in range(n):
            x = _block(p[f"layer{li + 1}"][bi], x, stride if bi == 0 else 1, li >= 2, act)
        if li == 2:
            out3 = x
    x = _aff(p["fuse34"], x, _conv(p["layer3_ds"], out3, act, stride=2), act)
    return x[0].reshape(-1, x.shape[-1]).mean(-1)
