"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` is compiled on first use with::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/lib<name>_<hash>.so csrc/<name>.cu

into ``genie_tts_tpu_torch/build/`` (listed in ``.gitignore``) and loaded
with ``ctypes``. The library name carries a hash of the sources and the
flags, so a second process (or a second run) finds it built and does not
rebuild; a build goes to a temporary file that is renamed into place, so
two processes building at once never load a half-written library.

Each library exposes plain C functions that take device pointers and the
CUDA stream as ``void*`` and return ``cudaGetLastError()`` after the
launch; the wrappers raise when it is not 0. Nothing here runs at import.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    # PyTorch's CUDA_HOME: $CUDA_HOME or $CUDA_PATH, else the nvcc on PATH,
    # else /usr/local/cuda
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "") / "bin" / "nvcc"
    if not CUDA_HOME or not nvcc.is_file():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def _library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for ``csrc/<name>.cu`` unless the library exists."""
    so = _library_path(name)
    if so.is_file():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    proc.genie_paths = (tmp, so)          # type: ignore[attr-defined]
    return proc


def _finish_build(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    tmp, so = proc.genie_paths            # type: ignore[attr-defined]
    log = so.with_suffix(".log")
    log.write_text(out or "")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)


def build(names: Iterable[str]) -> Dict[str, str]:
    """Build the named kernels, one nvcc per source, all started together.
    Returns each kernel's ptxas report (registers, shared memory, spills)
    for the sources built by this call."""
    names = list(names)
    procs = {n: _start_build(n) for n in names}
    for n in names:
        _finish_build(n, procs[n])
    return {n: _library_path(n).with_suffix(".log").read_text()
            for n in names if procs[n] is not None}


def all_kernels():
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_library_path(name)))
            _libs[name] = lib
        return lib


_count_lock = threading.Lock()
_recording = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; request threads launch kernels
    concurrently, and a bare ``+=`` can lose counts. While this thread
    records (:func:`recording`: a graph capture, or the warm-up run
    before it), the launch goes to the record instead."""
    rec = getattr(_recording, "counts", None)
    if rec is not None:
        rec[wrapper] = rec.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def recording():
    """Count this thread's kernel launches into a dict {wrapper: n}
    instead of the wrappers' ``launches`` (what a captured CUDA graph
    launches on each replay; ``runtime/graphs.py``)."""
    prev = getattr(_recording, "counts", None)
    _recording.counts = {}
    try:
        yield _recording.counts
    finally:
        _recording.counts = prev


def add_launches(counts) -> None:
    """Add a record of :func:`recording` to the wrappers' counts (one
    replay of a captured graph runs its kernels once each)."""
    with _count_lock:
        for wrapper, n in counts.items():
            wrapper.launches += n


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
