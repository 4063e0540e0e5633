"""Audio signal processing: linear spectrogram, Kaldi fbank, resampling.

The linear spectrogram matches torch.stft with ``center=False`` after
reflect padding of (n_fft - hop)/2 on both sides (the GPT-SoVITS
convention), as ``genie_tts_tpu/ops/audio.py`` does. The Kaldi fbank is
the front end of the ERes2NetV2 speaker encoder (``models/sv.py``).
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


def _hz_to_mel_htk(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def kaldi_mel_banks(num_bins: int, n_fft: int, sr: int,
                    low_freq: float = 20.0, high_freq: float = 0.0) -> np.ndarray:
    """Kaldi-style (HTK mel, unnormalised triangles) filterbank
    [num_bins, n_fft//2+1]."""
    if high_freq <= 0:
        high_freq = sr / 2 + high_freq
    mel_lo, mel_hi = _hz_to_mel_htk(low_freq), _hz_to_mel_htk(high_freq)
    centers = np.linspace(mel_lo, mel_hi, num_bins + 2)
    mel_of_bin = _hz_to_mel_htk(np.fft.rfftfreq(n_fft, 1.0 / sr))
    fb = np.zeros((num_bins, len(mel_of_bin)), np.float32)
    for i in range(num_bins):
        left, ctr, right = centers[i], centers[i + 1], centers[i + 2]
        up = (mel_of_bin - left) / (ctr - left)
        down = (right - mel_of_bin) / (right - ctr)
        fb[i] = np.maximum(0.0, np.minimum(up, down))
    return fb


def kaldi_fbank(audio: torch.Tensor, num_bins: int = 80, sr: int = 16000) -> torch.Tensor:
    """Kaldi-compatible log-mel fbank (dither 0): [B, S] -> [B, T, num_bins]
    fp32.

    Input scaled by 32768 (Kaldi's int16 range); 25 ms frames every 10 ms,
    ``snip_edges`` framing (T = 1 + (S - frame) // shift); each frame's
    mean removed, then pre-emphasis 0.97 with the first sample replicated;
    the Povey window (a Hann window over N-1, to the power 0.85); power
    spectrum of an rfft zero-padded to the next power of two; log with a
    1e-10 floor."""
    frame_len = int(0.025 * sr)
    frame_shift = int(0.010 * sr)
    n_fft = 1
    while n_fft < frame_len:
        n_fft *= 2
    frames = (audio.float() * 32768.0).unfold(-1, frame_len, frame_shift)  # [B,T,L]
    frames = frames - frames.mean(dim=-1, keepdim=True)
    pre = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - 0.97 * pre
    n = torch.arange(frame_len, dtype=torch.float32, device=audio.device)
    win = (0.5 - 0.5 * torch.cos(2.0 * math.pi * n / (frame_len - 1))) ** 0.85
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.as_tensor(kaldi_mel_banks(num_bins, n_fft, sr), device=audio.device)
    return torch.log(torch.clamp(power @ fb.T, min=1e-10))


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Host-side polyphase resampling (scipy), e.g. 32k <-> 16k."""
    if sr_in == sr_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    return _rp(audio, sr_out // g, sr_in // g).astype(np.float32)
