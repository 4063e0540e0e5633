"""Audio signal processing: linear spectrogram and resampling.

The linear spectrogram matches torch.stft with ``center=False`` after
reflect padding of (n_fft - hop)/2 on both sides (the GPT-SoVITS
convention), as ``genie_tts_tpu/ops/audio.py`` does.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(win_length: int, dtype=torch.float32, device=None) -> torch.Tensor:
    n = torch.arange(win_length, dtype=torch.float32, device=device)
    w = 0.5 - 0.5 * torch.cos(2.0 * math.pi * n / win_length)
    return w.to(dtype)


def linear_spectrogram(audio: torch.Tensor, n_fft: int = 2048, hop: int = 640,
                       win_length: int = 2048) -> torch.Tensor:
    """Magnitude STFT. audio [B, S] -> [B, T, n_fft//2+1] fp32.

    T = S // hop (reflect-padded, center=False framing).
    """
    audio = audio.float()
    pad = (n_fft - hop) // 2
    x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)                    # [B, T, n_fft]
    frames = frames * hann_window(win_length, device=audio.device)[None, None, :]
    spec = torch.fft.rfft(frames, dim=-1)
    return torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-6)


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Host-side polyphase resampling (scipy), e.g. 32k <-> 16k."""
    if sr_in == sr_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    return _rp(audio, sr_out // g, sr_in // g).astype(np.float32)
