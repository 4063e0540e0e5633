"""Weights from the seed, made on the device in a few large calls.

Each model's tree has the layout of a converted checkpoint as the port
reads it (leaf paths, shapes and dtypes: the port's ``init_params``, as
the configuration's family names it (``port_init``), run under
``FakeTensorMode``, which allocates nothing and draws nothing). The
values are the benchmark's own: per dtype ONE normal draw over all
leaves from a ``torch.Generator`` on the device, scaled per leaf by the
family's rules (``init_rule``), cast once to the served dtype; every
leaf is a view into that buffer, each starting on a 256-byte boundary.
The same seed on the same device gives the same bits, so the reference
makes the same weights again after the program has let go of its own."""
from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

from . import spec

ALIGN = 128          # elements between leaf starts: 256 bytes of bf16

Leaf = Tuple[Tuple[str, ...], torch.Size, torch.dtype]


def _leaves(tree, path=()) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _leaves(v, path + (str(i),))]
    return [(path, tree)]


def layout(model: str, cfg: Dict) -> Tuple[object, List[Leaf]]:
    """(the tree's skeleton with fake leaves, [(path, shape, dtype)])."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = spec.family(cfg["family"]).port_init(model, cfg)(torch.Generator())
    return tree, [(p, t.shape, t.dtype) for p, t in _leaves(tree)]


def _seed(seed: int, name: str) -> int:
    h = hashlib.sha256(f"{int(seed)}:{name}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 63 - 1)


def _rebuild(skeleton, values: Dict[Tuple[str, ...], torch.Tensor], path=()):
    if isinstance(skeleton, dict):
        return {k: _rebuild(v, values, path + (str(k),)) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        return [_rebuild(v, values, path + (str(i),)) for i, v in enumerate(skeleton)]
    return values[path]


def make(model: str, cfg: Dict, seed: int, device) -> Dict:
    """The weight tree of ``model`` in ``cfg`` for ``seed`` on ``device``."""
    init_rule = spec.family(cfg["family"]).init_rule
    skeleton, leaves = layout(model, cfg)
    gen = torch.Generator(device=device).manual_seed(_seed(seed, model))
    values = {}
    for dtype in sorted({dt for _, _, dt in leaves}, key=str):
        group = [(p, s) for p, s, dt in leaves if dt == dtype]
        counts, means, stds, offsets, off = [], [], [], [], 0
        for p, s in group:
            n = math.prod(s)
            span = -(-max(n, 1) // ALIGN) * ALIGN
            mean, std = init_rule(model, p, s)
            offsets.append(off)
            counts.append(span)
            means.append(mean)
            stds.append(std)
            off += span
        counts_t = torch.tensor(counts, device=device)
        flat = torch.randn(off, generator=gen, device=device)
        flat.mul_(torch.repeat_interleave(torch.tensor(stds, device=device), counts_t))
        flat.add_(torch.repeat_interleave(torch.tensor(means, device=device), counts_t))
        buf = flat.to(dtype)
        del flat
        for (p, s), o in zip(group, offsets):
            values[p] = buf.narrow(0, o, math.prod(s)).view(s)
    tree = _rebuild(skeleton, values)
    if model == "t2s" and cfg.get("eos_logit_zero"):
        tree["predict"]["w"][:, cfg["t2s"].get("eos_id", 1024)] = 0
    return tree
