"""Device meshes and the T2S sharding rules (dp x tp).

The port of ``genie_tts_tpu/parallel/mesh.py``. The JAX package lays a
``jax.sharding.Mesh`` over (dp, tp) and lets the compiler insert the
collectives. The port has two meshes:

* :class:`Mesh` (training, ``make_mesh``): each rank is a process that
  holds its own shards and calls the collectives itself
  (``parallel/tp.py``, ``parallel/train.py``). A mesh of ``dp * tp > 1``
  ranks needs an initialised process group of that world size
  (``torchrun``, or ``torch.multiprocessing`` in the tests): backend
  ``nccl`` on cuda, ``gloo`` on the CPU. Rank ``r = dp_rank * tp +
  tp_rank``, as the JAX package reshapes its device list. A 1 x 1 mesh
  needs no process group.
* :class:`ServingMesh` (serving, ``make_serving_mesh``): one process
  drives a ``[dp][tp]`` grid of devices, as the JAX package's one
  controller drives its mesh. A character holds one replica per dp row
  (``runtime/engine.py::TTSEngine.shard_character``), whose T2S layers
  are split over the row's tp devices (:func:`shard_serving_params`); the
  tp reductions are device copies and adds in rank order onto the row's
  first device (``parallel/tp.py``). A replica past the first is marked
  with its row (``_dp_row``), so it has a configuration, a bank and
  graphs of its own (``runtime/graphs.py``): the rows decode at once.
  The server, its batchers and its streams stay one host program.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from ..config import indexed_device, resolve_device
from ..convert.io import flatten_tree, unflatten_tree

DP_AXIS = "dp"
TP_AXIS = "tp"

# {path: leaf} of a nested dict/list tree (keys starting with '_' are
# derived caches, not leaves)
tree_paths = flatten_tree


class Mesh(NamedTuple):
    """This rank's place in the (dp, tp) grid, its device and its groups
    (None on a 1 x 1 mesh)."""
    dp: int
    tp: int
    device: torch.device
    dp_rank: int = 0
    tp_rank: int = 0
    dp_group: Optional[object] = None
    tp_group: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Split:
    """A leaf split over ``tp`` along ``axis``. ``parts`` > 1: the axis
    holds that many blocks (the fused qkv's Q | K | V), and each is split
    over ``tp`` on its own, so a rank holds the Q, K and V of its heads."""
    axis: int
    parts: int = 1


def make_mesh(dp: int = 1, tp: int = 1, devices=None) -> Mesh:
    """The mesh of this rank. ``devices``: None (cuda: one card per rank,
    ``cuda:{rank % device_count}``), a device for every rank (``"cpu"``),
    or a sequence of ``dp * tp`` devices, one per rank."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if dp * tp > world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp*tp} devices, have {world}")
    if dp * tp < world:
        raise ValueError(f"mesh {dp}x{tp} covers {dp*tp} of the {world} ranks")
    rank = dist.get_rank() if world > 1 else 0
    if isinstance(devices, (list, tuple)):
        device = resolve_device(devices[rank])
    else:
        device = resolve_device(devices)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if world == 1:
        return Mesh(dp, tp, device)
    from torch.distributed.device_mesh import init_device_mesh

    grid = init_device_mesh(device.type, (dp, tp), mesh_dim_names=(DP_AXIS, TP_AXIS))
    return Mesh(dp, tp, device, rank // tp, rank % tp,
                grid.get_group(DP_AXIS), grid.get_group(TP_AXIS))


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A ``[dp][tp]`` grid of devices that one process serves on: dp row
    ``r`` holds a replica of each character, its T2S layers split over the
    row's ``tp`` devices. A device may repeat (several grid cells on one
    card, or ``"cpu"`` in the tests): every line of the dp and tp code
    runs, with no transfer between cards."""
    dp: int
    tp: int
    devices: Tuple[Tuple[torch.device, ...], ...]

    @property
    def lead(self) -> torch.device:
        """The first device of the first row: replica 0's."""
        return self.devices[0][0]


def make_serving_mesh(dp: int = 1, tp: int = 1, devices=None) -> ServingMesh:
    """The serving mesh over ``devices`` (default ``cuda:0 .. cuda:n-1``),
    row-major: row ``r`` takes ``devices[r*tp:(r+1)*tp]``. Raises when
    there are fewer than ``dp * tp`` devices; never serves on fewer."""
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh {dp}x{tp}: dp and tp must be >= 1")
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if dp * tp > len(devices):
        raise ValueError(f"mesh {dp}x{tp} needs {dp*tp} devices, have {len(devices)}")
    devs = [indexed_device(d) for d in devices[:dp * tp]]
    return ServingMesh(dp, tp, tuple(tuple(devs[r * tp:(r + 1) * tp])
                                     for r in range(dp)))


def place_tree(tree, device, copy: bool = False):
    """``tree`` (or a tensor) with every leaf on ``device``: the tree itself
    when it is there already (its derived caches kept) and ``copy`` is
    not set, else a copy."""
    dev = indexed_device(device)
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=copy)
    flat = tree_paths(tree)
    if not copy and all(x.device == dev for x in flat.values()):
        return tree
    return unflatten_tree({p: x.to(dev, copy=copy) for p, x in flat.items()})


def shard_serving_params(params, devices, copy: bool = False):
    """One replica's T2S parameters over its tp ``devices`` (``copy``: in
    tensors of its own, even where a leaf is on its device already).

    ``tp == 1``: the tree on ``devices[0]``. ``tp > 1``: the leaves outside
    ``layers`` on ``devices[0]``, and under ``layer_shards`` one stacked
    layers tree per device, rank ``i`` holding its split of each leaf
    (:func:`_t2s_param_spec`: the Q, K and V columns of its
    ``num_heads / tp`` heads, its ``ffn_dim / tp`` columns of ffn1 and
    rows of out and ffn2, the rest whole). There is no ``layers`` key, so
    code that knows no tp fails on such a tree rather than computing
    something else."""
    devices = [indexed_device(d) for d in devices]
    if len(devices) == 1:
        return place_tree(params, devices[0], copy)
    tp = len(devices)
    out = {k: place_tree(v, devices[0], copy)
           for k, v in params.items() if k != "layers" and not k.startswith("_")}
    layers = tree_paths(params["layers"])
    out["layer_shards"] = [
        unflatten_tree({p: shard_leaf(x, _t2s_param_spec(f"layers/{p}"), tp, i).to(d)
                        for p, x in layers.items()})
        for i, d in enumerate(devices)]
    return out


def _t2s_param_spec(path: str) -> Optional[Split]:
    """The split of a T2S parameter addressed by '/'-joined path, or None
    (replicated).

    Megatron-style layout: QKV/FFN-in column-parallel, Out/FFN-out
    row-parallel; embeddings and norms replicated. Stacked layer params
    carry a leading layer axis (never sharded)."""
    parts = 3 if "qkv/" in path else 1
    if path.startswith("layers/"):
        if "qkv/w" in path or "ffn1/w" in path:
            return Split(2, parts)             # [L, in, out]: shard out
        if "qkv/b" in path or "ffn1/b" in path:
            return Split(1, parts)
        if "qkv/scale" in path or "ffn1/scale" in path:
            return Split(1, parts)             # int8 per-out-channel scales
        if "out/w" in path or "ffn2/w" in path:
            return Split(1)                    # [L, in, out]: shard in
        return None                            # biases of row-parallel, norms
    return None                                # embeddings, predict, encoder


def t2s_param_shardings(params, mesh: Mesh):
    """A tree of per-leaf splits (``Split`` or None) matching the T2S
    param tree."""
    return unflatten_tree({p: _t2s_param_spec(p) for p in tree_paths(params)})


def shard_leaf(x: torch.Tensor, split: Optional[Split], tp: int,
               tp_rank: int) -> torch.Tensor:
    """Rank ``tp_rank``'s shard of a full leaf."""
    if split is None or tp == 1:
        return x
    n = x.shape[split.axis]
    if n % (split.parts * tp):
        raise ValueError(f"axis {split.axis} of a {tuple(x.shape)} leaf does "
                         f"not split into {split.parts} x {tp} blocks")
    blocks = x.chunk(split.parts, dim=split.axis)
    return torch.cat([b.chunk(tp, dim=split.axis)[tp_rank] for b in blocks],
                     dim=split.axis)


def merge_leaf(shards, split: Optional[Split]) -> torch.Tensor:
    """The full leaf from every tp rank's shard, in rank order."""
    if split is None:
        return shards[0]
    pieces = [s.chunk(split.parts, dim=split.axis) for s in shards]
    return torch.cat([p[i] for i in range(split.parts) for p in pieces],
                     dim=split.axis)


def shard_params(params, mesh: Mesh):
    """(this rank's shards on its device, the tree of splits)."""
    flat = tree_paths(params)
    local = {p: shard_leaf(x, _t2s_param_spec(p), mesh.tp, mesh.tp_rank)
             .to(mesh.device) for p, x in flat.items()}
    return unflatten_tree(local), t2s_param_shardings(params, mesh)


def gather_params(local, mesh: Mesh):
    """The unsharded tree from every tp rank's shards (an all-gather over
    the tp group; each rank gets the whole tree)."""
    out = {}
    for p, x in tree_paths(local).items():
        split = _t2s_param_spec(p)
        x = x.detach()
        if split is None or mesh.tp == 1:
            out[p] = x.clone()
            continue
        shards = [torch.empty_like(x) for _ in range(mesh.tp)]
        dist.all_gather(shards, x.contiguous(), group=mesh.tp_group)
        out[p] = merge_leaf(shards, split)
    return unflatten_tree(out)


def batch_sharding(mesh: Mesh):
    """``rows(x)``: this rank's rows of a global batch array (the dp
    rank's contiguous block, as ``P(dp)`` lays them out)."""
    def rows(x):
        B = x.shape[0]
        if B % mesh.dp:
            raise ValueError(f"batch of {B} rows does not split over dp={mesh.dp}")
        n = B // mesh.dp
        return x[mesh.dp_rank * n:(mesh.dp_rank + 1) * n]

    return rows
