"""Audio signal processing: linear spectrogram, Kaldi fbank, the Slaney
log-mel of GPT-SoVITS V4's prompt, resampling.

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


def _hz_to_mel_slaney(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, math.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)),
                    f_sp * m)


def slaney_mel_banks(n_mels: int, n_fft: int, sr: int, fmin: float = 0.0,
                     fmax: float = 0.0) -> np.ndarray:
    """librosa's default mel filterbank (Slaney mel scale and area
    normalisation) [n_mels, n_fft//2+1]; ``fmax`` 0 is ``sr / 2``."""
    fmax = fmax or sr / 2
    fft_freqs = np.linspace(0.0, sr / 2, 1 + n_fft // 2)
    mel_f = _mel_to_hz_slaney(np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax),
                                          n_mels + 2))
    fdiff = np.diff(mel_f)
    ramps = mel_f[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (mel_f[2:n_mels + 2] - mel_f[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel_spectrogram(audio: torch.Tensor, n_fft: int, hop: int, win_length: int,
                        n_mels: int, sr: int, fmin: float = 0.0,
                        fmax: float = 0.0) -> torch.Tensor:
    """GPT-SoVITS's ``mel_spectrogram_torch`` (``center=False``): reflect
    padding of (n_fft - hop)/2 a side, a periodic Hann window, magnitude
    ``sqrt(re^2 + im^2 + 1e-9)``, the Slaney filterbank, ``log(clamp(.,
    1e-5))``. audio [B, S] -> [B, T, n_mels] fp32, T = S // hop."""
    audio = audio.float()
    pad = (n_fft - hop) // 2
    x = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    frames = x.unfold(-1, n_fft, hop)                    # [B, T, n_fft]
    frames = frames * hann_window(win_length, device=audio.device)[None, None, :]
    spec = torch.fft.rfft(frames, dim=-1)
    mag = torch.sqrt(spec.real ** 2 + spec.imag ** 2 + 1e-9)
    fb = torch.as_tensor(slaney_mel_banks(n_mels, n_fft, sr, fmin, fmax), device=audio.device)
    return torch.log(torch.clamp(mag @ fb.T, min=1e-5))


def resample_poly(audio: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """Host-side polyphase resampling (scipy), e.g. 32k <-> 16k."""
    if sr_in == sr_out:
        return audio
    from math import gcd

    from scipy.signal import resample_poly as _rp

    g = gcd(sr_in, sr_out)
    return _rp(audio, sr_out // g, sr_in // g).astype(np.float32)
