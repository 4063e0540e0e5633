"""One whole B=1 T2S decode step over all layers: CUDA kernel + plain version.

The port of ``genie_tts_tpu/ops/fused_decode.py::fused_decode_step`` (the
Pallas TPU kernel ``_layer_kernel``). The kernel is ``csrc/fused_decode.cu``,
one cooperative launch per decode step; its source note says what bounds
it on the H100 and what its design does about that. ``models/t2s.py::
generate`` runs every B=1 decode step through it.

Weights are packed once per character by :func:`pack_decode_params`
(views of the stacked layer weights; small vectors in fp32), and
:func:`prepare` adds to the packing, for a cache length, the kernel's
per-block tiled copy of the weights (:func:`_prepared`, read-only; the
decode graphs prepare a configuration's bank, and :func:`refresh` redoes
its tiles in place when another character is bound). A
caller that launches inside a CUDA graph (``runtime/graphs.py``) also
owns the launch's output row and scratch (:func:`step_buffers`), so that
a launch allocates nothing and copies nothing from the host, and no two
graphs write the same buffers. The write row ``pos`` is an int32 in
device memory that the kernel reads. They are
bf16/fp32, or int8 codes with a per-output-channel fp32 scale (the default
``t2s_int8`` decode weights): the kernel reads the int8 bytes and computes
``(x . w_int8) * scale + b`` in fp32, the int8 path of ``ops/layers.py::
linear``.

:func:`fused_decode_step` launches the kernel for CUDA tensors (and raises
on what the kernel does not take) and runs :func:`fused_decode_step_plain`
for CPU tensors. ``fused_decode_step.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Dict, Optional

import torch

from . import _build
from .layers import layer_norm

_WTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_CTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MATS = (("qkv", "qkv"), ("out", "out"), ("1", "ffn1"), ("2", "ffn2"))


def pack_decode_params(t2s_params) -> Dict[str, torch.Tensor]:
    """T2S layer params -> the kernel's stacked layout.

    ``w*`` [L, in, out] (the stored weights: int8 codes, or floats in the
    compute dtype), ``s*`` [L, 1, out] fp32 scales for int8 weights,
    ``b*`` [L, 1, out] fp32 biases, norms ``n1s``, ``n1b``, ``n2s``,
    ``n2b`` [L, 1, D] fp32."""
    lp = t2s_params["layers"]
    out = {}
    for name, key in _MATS:
        p = lp[key]
        w = p["w"]
        out["w" + name] = w.contiguous()
        out["b" + name] = p["b"].float()[:, None, :].contiguous()
        if w.dtype == torch.int8:
            out["s" + name] = p["scale"].float()[:, None, :].contiguous()
    for n, key in (("1", "norm1"), ("2", "norm2")):
        out[f"n{n}s"] = lp[key]["scale"].float()[:, None, :].contiguous()
        out[f"n{n}b"] = lp[key]["bias"].float()[:, None, :].contiguous()
    return out


def _product(x: torch.Tensor, stacked, name: str, layer: int,
             cdt: torch.dtype) -> torch.Tensor:
    """x [1, in] fp32 -> [1, out] fp32: x rounded to the compute dtype,
    fp32 accumulation, then the int8 scale and the bias."""
    w = stacked["w" + name][layer]
    y = x.to(cdt).float() @ w.float()
    if ("s" + name) in stacked:
        y = y * stacked["s" + name][layer]
    return y + stacked["b" + name][layer]


def _pos_index(pos, device) -> torch.Tensor:
    """The write row as an int64 index [1]: ``pos`` is an int or a
    one-element int tensor (the device's step counter)."""
    if isinstance(pos, torch.Tensor):
        return pos.reshape(1).long()
    return torch.tensor([int(pos)], device=device)


def fused_decode_step_plain(stacked, h: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos, mask: torch.Tensor,
                            *, num_heads: int):
    """The kernel's function in plain PyTorch (same signature and effect;
    ``pos`` an int or a one-element int tensor)."""
    L, S, D = k_cache.shape
    H, Dh = num_heads, D // num_heads
    cdt = k_cache.dtype
    scale = 1.0 / math.sqrt(Dh)
    madd = (mask.float() - 1.0) * 1e10
    h = h.float().reshape(1, D)
    row = _pos_index(pos, k_cache.device)
    for l in range(L):
        qkv = _product(h, stacked, "qkv", l, cdt)[0]
        # in-place cache update at the row-uniform write position
        k_cache[l].index_copy_(0, row, qkv[None, D:2 * D].to(cdt))
        v_cache[l].index_copy_(0, row, qkv[None, 2 * D:].to(cdt))
        q = qkv[:D].to(cdt).float().view(H, Dh)
        keys = k_cache[l].float().view(S, H, Dh)
        vals = v_cache[l].float().view(S, H, Dh)
        scores = torch.einsum("hd,shd->hs", q, keys) * scale + madd
        probs = torch.softmax(scores, dim=-1).to(cdt).float()
        att = torch.einsum("hs,shd->hd", probs, vals).reshape(1, D)
        h = layer_norm({"scale": stacked["n1s"][l], "bias": stacked["n1b"][l]},
                       h + _product(att, stacked, "out", l, cdt))
        ff = torch.relu(_product(h, stacked, "1", l, cdt))
        h = layer_norm({"scale": stacked["n2s"][l], "bias": stacked["n2b"][l]},
                       h + _product(ff, stacked, "2", l, cdt))
    return h, k_cache, v_cache


_fn = None
_scratch_size = None
_tile_index = None
_scratch_floats: Dict[tuple, int] = {}
_tile_idx: Dict[tuple, torch.Tensor] = {}
_TILES = (("wqkv", "tqkv"), ("wout", "tout"), ("w1", "t1"), ("w2", "t2"))
# request threads may prepare one shared packing at once: one of them
# builds each piece, the others wait for it
_prep_lock = threading.Lock()


def _kernel():
    """The C entry point of csrc/fused_decode.cu (built on first use)."""
    global _fn, _scratch_size, _tile_index
    if _fn is None:
        lib = _build.load_library("fused_decode")
        size = lib.fused_decode_scratch_floats
        size.restype = ctypes.c_longlong
        size.argtypes = [ctypes.c_void_p, ctypes.c_int]
        tiles = lib.fused_decode_tile_index
        tiles.restype = ctypes.c_longlong
        tiles.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        _tile_index = tiles
        fn = lib.fused_decode_step
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                       ctypes.c_float, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_void_p]
        _fn, _scratch_size = fn, size
    return _fn


def _scratch_len(dev: torch.device, dims, wbytes: int) -> int:
    """Floats of scratch the kernel needs on ``dev`` (its split depends on
    the device's SM count), cached per device, shape and weight width."""
    key = (dev.index, *dims[1:5], wbytes)
    if key not in _scratch_floats:
        _kernel()
        with torch.cuda.device(dev):
            n = _scratch_size(ctypes.addressof(dims), wbytes)
        if n < 0:
            raise ValueError(f"fused_decode_step kernel does not take dims {list(dims)}")
        _scratch_floats[key] = n
    return _scratch_floats[key]


def _tiled_one(stacked, dev, dims, wbytes, L, G, phase, wname, tname):
    key = (dev.index, *dims[1:5], wbytes, phase)
    if key not in _tile_idx:
        _kernel()
        with torch.cuda.device(dev):
            T = _tile_index(ctypes.addressof(dims), wbytes, phase, None)
            if T < 0:
                raise ValueError(f"fused_decode_step kernel does not take dims {list(dims)}")
            idx = torch.empty(G * T, dtype=torch.int64)
            _tile_index(ctypes.addressof(dims), wbytes, phase, idx.data_ptr())
        _tile_idx[key] = idx.to(dev)
    idx = _tile_idx[key]
    shape = (L, G, idx.numel() // G * 16)
    w = stacked[wname]
    return w.view(torch.uint8).reshape(L, -1, 16)[:, idx].reshape(shape)


def _dims(stacked, S: int, num_heads: int):
    L, D = stacked["wqkv"].shape[:2]
    F = stacked["w1"].shape[-1]
    return (ctypes.c_int * 5)(L, S, D, num_heads, F)


def _prepared(stacked, dev: torch.device, S: int, num_heads: int) -> dict:
    """The weights re-laid per block for the kernel's bulk copies at cache
    length ``S`` on ``dev`` (one contiguous tile per block, phase and
    layer; csrc/fused_decode.cu::fused_decode_tile_index; [L, SMs, tile
    bytes] uint8 each, the gather indices cached per device, shape and
    weight width), made once and kept in the packing under ``_prep``.
    Launches only read them. Locked: concurrent first launches on one
    packing build one copy."""
    key = (dev.index, S, num_heads)
    prep = stacked.get("_prep", {}).get(key)
    if prep is not None:
        return prep
    with _prep_lock:
        if "_prep" not in stacked:
            stacked["_prep"] = {}
        prep = stacked["_prep"].get(key)
        if prep is None:
            dims = _dims(stacked, S, num_heads)
            wbytes = stacked["wqkv"].element_size()
            G = torch.cuda.get_device_properties(dev).multi_processor_count
            prep = {"tiles": [_tiled_one(stacked, dev, dims, wbytes, dims[0], G, phase,
                                         wname, tname)
                              for phase, (wname, tname) in enumerate(_TILES)]}
            stacked["_prep"][key] = prep
    return prep


def refresh(stacked) -> None:
    """Re-gather every tiled copy :func:`prepare` made in ``stacked``, in
    place, from its weights: after they were overwritten (a graph cache's
    bank, bound to another character: ``runtime/graphs.py``). Captured
    launches read the tiles by address, so they stay where they are."""
    for (index, S, num_heads), prep in stacked.get("_prep", {}).items():
        dims = _dims(stacked, S, num_heads)
        wbytes = stacked["wqkv"].element_size()
        for phase, ((wname, _), tile) in enumerate(zip(_TILES, prep["tiles"])):
            idx = _tile_idx[(index, *dims[1:5], wbytes, phase)]
            L = tile.shape[0]
            torch.index_select(stacked[wname].view(torch.uint8).reshape(L, -1, 16), 1, idx,
                               out=tile.view(L, -1, 16))


def prepare(stacked, S: int, num_heads: int, device) -> None:
    """Make the packing's tiled weights for cache length ``S`` on
    ``device`` ahead of any launch (no-op for CPU tensors): before a CUDA
    graph captures the step, since a capture may not allocate for later
    use or copy from the host."""
    device = torch.device(device)
    if device.type == "cuda":
        _prepared(stacked, device, S, num_heads)


def step_buffers(stacked, S: int, num_heads: int, device):
    """(h_out [1, D] fp32, scratch) for launches at cache length ``S`` on
    ``device``, for one caller alone (a decode graph's static buffers):
    the kernel writes both on every launch, and two launches that share
    them may not run at once. (None, None) for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None, None
    dims = _dims(stacked, S, num_heads)
    return (torch.empty((1, dims[2]), dtype=torch.float32, device=device),
            torch.empty(_scratch_len(device, dims, stacked["wqkv"].element_size()),
                        dtype=torch.float32, device=device))


def _launch(stacked, h, k_cache, v_cache, pos, mask, num_heads, trace=None,
            h_out=None, scratch=None):
    L, S, D = k_cache.shape
    dev = k_cache.device
    F = stacked["w1"].shape[-1]
    wdt, cdt = stacked["wqkv"].dtype, k_cache.dtype
    if wdt not in _WTYPES or cdt not in _CTYPES or wdt not in (torch.int8, cdt):
        raise TypeError(f"fused_decode_step kernel takes float32/bfloat16 "
                        f"caches with int8 weights or weights of the cache "
                        f"dtype, got {wdt} weights and {cdt} caches")
    # shared-memory sizes, 32-row GEMV groups and 16-byte vector loads
    # (csrc/fused_decode.cu)
    Dh = D // num_heads
    if (D > 1024 or F > 4096 or S > 4096 or D % num_heads or Dh not in (32, 64)
            or D % 32 or F % 256):
        raise ValueError(f"fused_decode_step kernel takes D <= 1024 (a multiple "
                         f"of 32), F <= 4096 (a multiple of 256), S <= 4096 and "
                         f"Dh in (32, 64); got D={D}, F={F}, S={S}, Dh={Dh}")
    shapes = {"wqkv": (L, D, 3 * D), "wout": (L, D, D), "w1": (L, D, F),
              "w2": (L, F, D), "bqkv": (L, 1, 3 * D), "bout": (L, 1, D),
              "b1": (L, 1, F), "b2": (L, 1, D), "n1s": (L, 1, D),
              "n1b": (L, 1, D), "n2s": (L, 1, D), "n2b": (L, 1, D)}
    if wdt == torch.int8:
        shapes.update({"sqkv": (L, 1, 3 * D), "sout": (L, 1, D),
                       "s1": (L, 1, F), "s2": (L, 1, D)})
    for name, shape in shapes.items():
        t = stacked[name]
        want = wdt if name.startswith("w") else torch.float32
        if (tuple(t.shape) != shape or t.dtype != want or t.device != dev
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"packed {name} must be a contiguous, 16-byte "
                             f"aligned {want} tensor of shape {shape} on {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != cdt or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{cdt} tensor")
    h = h.reshape(1, D)
    mask = mask.reshape(S)
    if h.dtype != torch.float32 or mask.dtype != torch.float32 \
            or h.device != dev or mask.device != dev:
        raise TypeError(f"h and mask must be float32 tensors on {dev}")
    if isinstance(pos, torch.Tensor):
        if pos.dtype != torch.int32 or pos.numel() != 1 or pos.device != dev:
            raise TypeError(f"pos must be one int32 on {dev} (or an int)")
    else:       # a host row: checked here, copied to the device (not capturable)
        if not 0 <= int(pos) < S:
            raise ValueError(f"pos {pos} outside the cache of {S} rows")
        pos = torch.tensor([int(pos)], dtype=torch.int32, device=dev)
    h = h.contiguous()
    mask = mask.contiguous()
    pos = pos.contiguous()
    prep = _prepared(stacked, dev, S, num_heads)
    dims = _dims(stacked, S, num_heads)
    if h_out is None:           # buffers of this launch alone
        h_out, scratch = step_buffers(stacked, S, num_heads, dev)
    elif (h_out.shape != (1, D) or h_out.dtype != torch.float32 or h_out.device != dev
          or scratch.dtype != torch.float32 or scratch.device != dev
          or scratch.numel() < _scratch_len(dev, dims, stacked["wqkv"].element_size())):
        raise ValueError("h_out and scratch must come from step_buffers at this "
                         "cache length and device")
    s = stacked.get
    ptrs = [stacked["wqkv"], stacked["wout"], stacked["w1"], stacked["w2"],
            s("sqkv"), s("sout"), s("s1"), s("s2"),
            stacked["bqkv"], stacked["bout"], stacked["b1"], stacked["b2"],
            stacked["n1s"], stacked["n1b"], stacked["n2s"], stacked["n2b"],
            k_cache, v_cache, mask, h, h_out, scratch, trace, *prep["tiles"], pos]
    arr = (ctypes.c_ulonglong * len(ptrs))(
        *[0 if t is None else t.data_ptr() for t in ptrs])
    with torch.cuda.device(dev):        # the kernel sizes its grid for it
        err = _kernel()(ctypes.addressof(arr), ctypes.addressof(dims),
                        1.0 / math.sqrt(D // num_heads), 1e-5, _WTYPES[wdt],
                        _CTYPES[cdt], scratch.numel(),
                        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "fused_decode_step")
    if trace is None:
        _build.count_launch(fused_decode_step)
    return h_out, k_cache, v_cache


PHASE_STAMPS = ("layer start", "LN2 done", "q ready", "A done", "A copies sent",
                "B done", "B copies sent", "C weights ready", "LN1 done", "C done",
                "C copies sent", "D inputs ready", "D done")


def phase_cycles(stacked, h, k_cache, v_cache, pos, mask, *, num_heads) -> torch.Tensor:
    """A probe, not part of the step: one launch of the step kernel that
    also stamps each block's clock64 at the points :data:`PHASE_STAMPS` of
    every layer, in program order (a block with no attention item leaves
    "q ready" at 0). Returns int64 [grid, L, len(PHASE_STAMPS)]. Not
    counted in ``fused_decode_step.launches``."""
    dev = k_cache.device
    grid = torch.cuda.get_device_properties(dev).multi_processor_count
    trace = torch.zeros((grid, k_cache.shape[0], len(PHASE_STAMPS)), dtype=torch.int64,
                        device=dev)
    _launch(stacked, h, k_cache, v_cache, pos, mask, num_heads, trace)
    return trace


def grid_barriers(n: int, device: torch.device) -> None:
    """A timing probe, not part of the step: one cooperative launch of
    ``n`` grid barriers and no work, on the step kernel's grid (what its
    barrier per layer costs alone). Not counted in ``launches``."""
    lib = _build.load_library("fused_decode")
    fn = lib.fused_decode_barriers
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    with torch.cuda.device(device):
        err = fn(n, torch.cuda.current_stream(device).cuda_stream)
    _build.check(err, "fused_decode_barriers")


def fused_decode_step(stacked, h: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, pos, mask: torch.Tensor,
                      *, num_heads: int, h_out: Optional[torch.Tensor] = None,
                      scratch: Optional[torch.Tensor] = None):
    """One decode step over all layers.

    stacked: see :func:`pack_decode_params`. h: [1, D] fp32 hidden (token +
    position embedding). k_cache / v_cache: [L, S, D] in the compute dtype
    (heads merged into D). pos: the write row, one int32 tensor on the
    caches' device (what a captured graph advances; an int is copied
    there first); mask: [S] fp32 (1 = attend). Returns (h_out [1, D] fp32,
    k_cache, v_cache); row ``pos`` of every layer's caches is written in
    place. ``h_out`` and ``scratch``: the caller's own buffers from
    :func:`step_buffers` (the returned ``h_out`` is then that buffer,
    rewritten by the caller's next launch); without them the launch
    allocates its own. The plain version ignores them."""
    if k_cache.is_cuda:
        return _launch(stacked, h, k_cache, v_cache, pos, mask, num_heads,
                       h_out=h_out, scratch=scratch)
    return fused_decode_step_plain(stacked, h, k_cache, v_cache, pos, mask,
                                   num_heads=num_heads)


fused_decode_step.launches = 0
