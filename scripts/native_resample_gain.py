"""How far the JAX package's native resampler moves a pure tone.

    python scripts/native_resample_gain.py [--build DIR]

Sends a 0.3-amplitude 440 Hz sine (1 s) through ``ga_resample`` of the
committed ``native/libgenie_audio.so`` (with ``--build DIR``, also of
``native/genie_audio.cpp`` compiled by ``g++`` into DIR) and through the
port's scipy resampler (``genie_tts_tpu_torch/ops/audio.py::resample_poly``,
the JAX package's own fallback), at the rates reference clips arrive in,
and prints each output's peak and its relative L2 distance from the true
sine at the new rate, away from the first and last tenth (the filters'
edge transients). Loads the library with ctypes; imports nothing of the
JAX package and edits nothing under ``native/``.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
CASES = ((48000, 32000), (44100, 32000), (16000, 32000), (32000, 16000))
AMP, FREQ = 0.3, 440.0


def _load(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.ga_resample.restype = ctypes.c_int64
    lib.ga_resample.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int,
                                ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int64]
    lib.ga_resample_out_len.restype = ctypes.c_int64
    lib.ga_resample_out_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]

    def resample(x, sr_in, sr_out):
        x = np.ascontiguousarray(x, np.float32)
        out = np.empty(lib.ga_resample_out_len(len(x), sr_in, sr_out), np.float32)
        ptr = ctypes.POINTER(ctypes.c_float)
        n = lib.ga_resample(x.ctypes.data_as(ptr), len(x), sr_in, sr_out,
                            out.ctypes.data_as(ptr), len(out))
        if n < 0:
            raise RuntimeError("ga_resample failed")
        return out[:n]

    return resample


def _sine(sr):
    t = np.arange(sr) / sr
    return AMP * np.sin(2 * np.pi * FREQ * t)


def _measure(y, sr_out):
    ref = _sine(sr_out)[:len(y)]
    mid = slice(len(y) // 10, len(y) - len(y) // 10)
    err = np.linalg.norm(y[mid] - ref[mid]) / np.linalg.norm(ref[mid])
    return float(np.abs(y[mid]).max()), float(err)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--build", type=Path, help="also compile native/genie_audio.cpp here")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    from genie_tts_tpu_torch.ops.audio import resample_poly

    libs = {"committed libgenie_audio.so": _load(REPO / "native" / "libgenie_audio.so")}
    if args.build:
        args.build.mkdir(parents=True, exist_ok=True)
        so = args.build / "libgenie_audio.so"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(so),
                        str(REPO / "native" / "genie_audio.cpp")], check=True)
        libs["genie_audio.cpp built here"] = _load(so)
    print(f"a {AMP} amplitude {FREQ:g} Hz sine; peak and relative L2 from the true sine")
    for sr_in, sr_out in CASES:
        x = _sine(sr_in).astype(np.float32)
        rows = [(name, fn(x, sr_in, sr_out)) for name, fn in libs.items()]
        rows.append(("scipy (the port)", resample_poly(x, sr_in, sr_out)))
        for name, y in rows:
            peak, err = _measure(y.astype(np.float64), sr_out)
            print(f"{sr_in:>6} -> {sr_out:>5} Hz  {name:<28} peak {peak:.3f} "
                  f"({peak / AMP:.2f}x)  relative L2 {err:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
