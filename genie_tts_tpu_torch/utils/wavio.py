"""Pure-Python WAV read/write (role of soundfile/libsndfile in the
reference, ``genie_tts/Audio/Audio.py:24``).

Supports PCM16/24/32 and IEEE float32 RIFF WAVE, mono/stereo; reads to
float32 mono in [-1, 1]; writes PCM16 or float32.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import Tuple, Union

import numpy as np


def read_wav(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Returns (mono float32 samples, sample_rate)."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from("<I", raw, pos + 4)[0]
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
        elif cid == b"data":
            data = body
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, channels, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE and len(data) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits in (16, 24, 32) else 3

    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(data, np.uint8).reshape(-1, 3)
            x = ((b[:, 0].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
                 | (b[:, 2].astype(np.int32) << 16))
            x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
        elif bits == 8:
            x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_fmt == 3:  # IEEE float
        x = np.frombuffer(data, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_fmt}")

    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x), sr


def read_aiff(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Pure-Python AIFF/AIFF-C reader (big-endian PCM only).

    AIFF is an IFF container: FORM/AIFF with a COMM chunk (channels,
    frames, bits, 80-bit extended-float sample rate) and an SSND chunk.
    Implemented natively because the stdlib ``aifc`` module is removed in
    Python 3.13."""
    raw = Path(path).read_bytes()
    if raw[:4] != b"FORM" or raw[8:12] not in (b"AIFF", b"AIFC"):
        raise ValueError(f"{path}: not an AIFF file")
    is_aifc = raw[8:12] == b"AIFC"
    pos = 12
    channels = bits = None
    sr = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos:pos + 4]
        size = struct.unpack_from(">I", raw, pos + 4)[0]
        body = raw[pos + 8: pos + 8 + size]
        if cid == b"COMM":
            channels, _frames, bits = struct.unpack_from(">hIh", body, 0)
            # 80-bit IEEE extended float: 1+15 bit exponent, 64-bit mantissa
            exp = struct.unpack_from(">H", body, 8)[0]
            mant = struct.unpack_from(">Q", body, 10)[0]
            sign = -1.0 if exp & 0x8000 else 1.0
            exp &= 0x7FFF
            sr = int(sign * mant * 2.0 ** (exp - 16383 - 63)) if mant else 0
            if is_aifc and size >= 22:
                comp = body[18:22]
                if comp not in (b"NONE", b"sowt"):
                    raise ValueError(f"{path}: compressed AIFF-C ({comp!r}) "
                                     "is not supported")
                if comp == b"sowt":
                    bits = -bits  # marker: little-endian PCM
        elif cid == b"SSND":
            offset = struct.unpack_from(">I", body, 0)[0]
            data = body[8 + offset:]
        pos += 8 + size + (size & 1)
    if channels is None or data is None or not sr:
        raise ValueError(f"{path}: missing COMM/SSND chunk")
    little = bits < 0
    bits = abs(bits)
    if bits == 16:
        x = np.frombuffer(data, "<i2" if little else ">i2").astype(np.float32) / 32768.0
    elif bits == 8:
        x = np.frombuffer(data, np.int8).astype(np.float32) / 128.0
    elif bits == 32:
        x = np.frombuffer(data, "<i4" if little else ">i4").astype(np.float32) / 2147483648.0
    elif bits == 24:
        b = np.frombuffer(data, np.uint8).reshape(-1, 3)
        if little:
            b = b[:, ::-1]
        x = ((b[:, 2].astype(np.int32)) | (b[:, 1].astype(np.int32) << 8)
             | (b[:, 0].astype(np.int32) << 16))
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    else:
        raise ValueError(f"unsupported AIFF bit depth: {bits}")
    if channels > 1:
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x), sr


def read_audio(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Format-dispatching reader -> (mono float32, sample_rate).

    WAV and AIFF decode natively; FLAC/OGG go through soundfile when
    installed and raise an actionable ValueError otherwise (the reference
    reads every format via libsndfile, ``Audio/Audio.py:24``)."""
    ext = Path(path).suffix.lower()
    if ext == ".wav":
        return read_wav(path)
    if ext in (".aiff", ".aif"):
        return read_aiff(path)
    try:
        import soundfile  # type: ignore
    except ImportError:
        raise ValueError(
            f"cannot decode {ext!r} reference audio: the optional "
            "'soundfile' package is not installed. Convert the clip to "
            ".wav (or .aiff), or pip install soundfile.") from None
    x, sr = soundfile.read(str(path), dtype="float32", always_2d=True)
    return np.ascontiguousarray(x.mean(axis=1), np.float32), int(sr)


def write_wav(path: Union[str, Path], audio: np.ndarray, sr: int,
              dtype: str = "int16") -> None:
    """Write mono float32 [-1,1] samples as PCM16 (default) or float32."""
    audio = np.asarray(audio, np.float32).reshape(-1)
    if dtype == "int16":
        payload = (np.clip(audio, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()
        audio_fmt, bits = 1, 16
    elif dtype == "float32":
        payload = audio.astype("<f4").tobytes()
        audio_fmt, bits = 3, 32
    else:
        raise ValueError(dtype)
    block = bits // 8
    hdr = b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, audio_fmt, 1, sr,
                                 sr * block, block, bits)
    hdr += b"data" + struct.pack("<I", len(payload))
    Path(path).write_bytes(hdr + payload)


def float_to_pcm16_bytes(audio: np.ndarray) -> bytes:
    """Streaming chunk conversion (reference:
    ``Core/TTSPlayer.py:51-53``)."""
    return (np.clip(np.asarray(audio, np.float32), -1.0, 1.0)
            * 32767.0).astype("<i2").tobytes()
