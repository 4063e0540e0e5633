"""Checkpoint I/O: flat safetensors files, fp16 on disk.

The same file format as ``genie_tts_tpu/convert/io.py``: '/'-joined tree
paths, fp16 on disk except the leaves that must stay fp32
(:data:`_FP32_SUFFIXES`), which load as fp32 while everything else loads
in the compute dtype.

The file format is read and written here by hand (little-endian u64
header length, a JSON header, then the raw buffers), so the port needs no
``safetensors`` package.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Union

import numpy as np
import torch

# Param-tree leaves that must stay fp32 on device for numerical parity.
_FP32_SUFFIXES = (
    "scale", "bias", "gamma", "beta", "alpha",
    "codebook", "quantizer_embed",
)

_ST_TO_NP = {
    "F16": np.float16, "F32": np.float32, "F64": np.float64,
    "I8": np.int8, "U8": np.uint8, "I16": np.int16, "I32": np.int32,
    "I64": np.int64, "BOOL": np.bool_,
}
_NP_TO_ST = {np.dtype(v): k for k, v in _ST_TO_NP.items()}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":       # ml_dtypes leaves of a JAX tree
        arr = arr.astype(np.float32)
    return arr


def flatten_tree(tree, prefix="") -> Dict[str, np.ndarray]:
    """Nested dicts/lists -> {'a/0/b': leaf}. Keys starting with '_' are
    derived caches (see ``ops/layers.py``) and are not part of the tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if not str(k).startswith("_"):
                out.update(flatten_tree(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_tree(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: Dict):
    root: Dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [listify(node[str(i)]) for i in range(len(keys))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _wants_fp32(path: str) -> bool:
    leaf = path.rsplit("/", 1)[-1]
    return leaf in _FP32_SUFFIXES or any(path.endswith(s) for s in _FP32_SUFFIXES)


# ---------------------------------------------------------------------------
# safetensors format
# ---------------------------------------------------------------------------

def write_safetensors(tensors: Dict[str, np.ndarray], path: Union[str, Path]) -> None:
    header, offset, bufs = {}, 0, []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if arr.dtype.byteorder == ">":
            arr = arr.astype(arr.dtype.newbyteorder("<"))
        raw = arr.tobytes()
        header[name] = {"dtype": _NP_TO_ST[np.dtype(arr.dtype)],
                        "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        bufs.append(raw)
        offset += len(raw)
    hdr = json.dumps(header, separators=(",", ":")).encode("utf-8")
    hdr += b" " * (-len(hdr) % 8)          # buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hdr)))
        f.write(hdr)
        for raw in bufs:
            f.write(raw)


def read_safetensors(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    data = Path(path).read_bytes()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    base = 8 + n
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if info["dtype"] == "BF16":        # bf16 = the top half of an fp32
            u16 = np.frombuffer(data, np.uint16, (end - start) // 2, base + start)
            arr = (u16.astype(np.uint32) << 16).view(np.float32)
        else:
            dt = np.dtype(_ST_TO_NP[info["dtype"]])
            arr = np.frombuffer(data, dt, (end - start) // dt.itemsize,
                                base + start)
        out[name] = arr.reshape(shape)
    return out


# ---------------------------------------------------------------------------
# Param trees
# ---------------------------------------------------------------------------

def params_from_numpy(tree, dtype: torch.dtype = torch.bfloat16,
                      device: Union[str, torch.device] = "cpu"):
    """A param tree with numpy leaves (or anything ``np.asarray`` takes,
    such as the JAX package's arrays) -> the same tree of torch tensors.

    Floating leaves become fp32 where :func:`_wants_fp32` says so and
    ``dtype`` elsewhere; integer leaves (int8 quantized weights) keep
    their type."""
    flat = flatten_tree(tree)
    out = {}
    for k, v in flat.items():
        arr = _to_numpy(v)
        t = torch.from_numpy(np.array(arr, copy=True))
        if t.is_floating_point():
            t = t.to(torch.float32 if _wants_fp32(k) else dtype)
        out[k] = t.to(device)
    return unflatten_tree(out)


def save_params(params, path: Union[str, Path]) -> None:
    """Save a param tree as fp16 safetensors (fp32 for sensitive leaves)."""
    out = {}
    for k, v in flatten_tree(params).items():
        out[k] = _to_numpy(v).astype(
            np.float32 if _wants_fp32(k) else np.float16, order="C")
    write_safetensors(out, path)


def load_params(path: Union[str, Path], compute_dtype: torch.dtype = torch.bfloat16,
                device: Union[str, torch.device] = "cpu"):
    """Load safetensors -> param tree (compute dtype, fp32 where needed).
    The file's flat '/'-joined names are already what ``flatten_tree``
    gives, so the flat dict goes to :func:`params_from_numpy` as it is."""
    return params_from_numpy(read_safetensors(path), compute_dtype, device)


def save_character_config(path: Union[str, Path], *, version: str,
                          language: str, extra: Dict = None) -> None:
    cfg = {"version": version, "language": language}
    if extra:
        cfg.update(extra)
    Path(path).write_text(json.dumps(cfg, indent=2))


def load_character_config(path: Union[str, Path]) -> Dict:
    return json.loads(Path(path).read_text())
