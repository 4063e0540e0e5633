"""Sharded fine-tuning step for the T2S decoder (dp x tp).

The port of ``genie_tts_tpu/parallel/train.py``: GPT-SoVITS users
fine-tune the T2S GPT on character data. Parameters are sharded
Megatron-style over ``tp`` (``parallel/mesh.py``, ``parallel/tp.py``),
the batch over ``dp``; the optimizer is AdamW with ``optax.adamw``'s
defaults (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf,
moments in the params' dtype).

Every rank passes the same global batch; the step takes its dp rows. The
loss is the global masked mean: each rank's NLL sum over its rows is
divided by the count of valid positions of the whole batch (which every
rank reads from the batch it holds), and the gradients and the loss are
summed over dp, so ranks whose rows differ in length weigh as the
unsharded loss weighs them.
"""
from __future__ import annotations

from functools import partial
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from ..config import T2SConfig
from ..convert.io import unflatten_tree
from ..models import t2s
from . import tp as tp_ops
from .mesh import Mesh, batch_sharding, shard_params, tree_paths

def make_train_step(cfg: T2SConfig, mesh: Mesh, learning_rate: float = 1e-4):
    """Returns (init_fn, step_fn).

    init_fn(params) -> (this rank's params, opt_state)
    step_fn(params, opt_state, batch) -> (params, opt_state, loss)

    ``params`` are updated in place and returned; ``loss`` is the global
    loss, a 0-d tensor on the mesh's device (the step reads nothing back
    to the host)."""
    if cfg.num_heads % mesh.tp or cfg.ffn_dim % mesh.tp:
        raise ValueError(f"tp={mesh.tp} must divide num_heads={cfg.num_heads} "
                         f"and ffn_dim={cfg.ffn_dim}")
    rows = batch_sharding(mesh)
    layer = (t2s._layer_prefill if mesh.tp == 1
             else partial(tp_ops.layer_prefill, group=mesh.tp_group))

    def init_fn(params):
        int8 = [p for p, x in tree_paths(params).items() if x.dtype == torch.int8]
        if int8:
            raise ValueError(
                f"int8 leaves ({', '.join(int8[:3])}, ...) cannot be trained; "
                "load a trainable tree with convert/io.load_params(path, "
                "torch.float32)")
        local, _ = shard_params(params, mesh)
        leaves = tree_paths(local)
        for p, x in leaves.items():
            leaves[p] = x.detach().clone().requires_grad_(True)
        local = unflatten_tree(leaves)
        opt = torch.optim.AdamW(list(leaves.values()), lr=learning_rate,
                                betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
        return local, opt

    def step_fn(params, opt_state, batch):
        leaves = list(tree_paths(params).values())
        owned = opt_state.param_groups[0]["params"]
        if len(leaves) != len(owned) or any(a is not b for a, b in zip(leaves, owned)):
            raise ValueError("step_fn takes the params that init_fn returned")
        dev = mesh.device
        Sy = batch["semantic"].shape[1]
        # valid positions of the whole batch: the loss's denominator
        count = torch.as_tensor(batch["sem_len"], device=dev).clamp(0, Sy).sum()
        local = {k: torch.as_tensor(rows(batch[k]), device=dev)
                 for k in ("phones", "bert", "x_len", "semantic", "sem_len")}
        logits = t2s.forward_train(params, cfg, local["phones"], local["bert"],
                                   local["x_len"], local["semantic"],
                                   local["sem_len"], layer=layer)
        total, _ = t2s.masked_nll(logits, local["semantic"], local["sem_len"],
                                  cfg.eos_id)
        loss = total / count.clamp(min=1).float()
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        loss = loss.detach()
        if mesh.dp > 1:
            dist.all_reduce(loss, group=mesh.dp_group)
        for x, g in zip(leaves, grads):
            g = torch.zeros_like(x) if g is None else g
            if mesh.dp > 1:
                dist.all_reduce(g, group=mesh.dp_group)
            x.grad = g
        opt_state.step()
        return params, opt_state, loss

    return init_fn, step_fn


def make_batch(cfg: T2SConfig, batch_size: int, sx: int, sy: int, seed: int = 0) -> Dict:
    """Synthetic teacher-forcing batch (tests, the smoke run)."""
    rng = np.random.default_rng(seed)
    return {
        "phones": rng.integers(1, cfg.phoneme_vocab, (batch_size, sx)).astype(np.int32),
        "bert": rng.standard_normal((batch_size, sx, cfg.bert_dim)).astype(np.float32),
        "x_len": np.full((batch_size,), sx, np.int32),
        "semantic": rng.integers(0, cfg.semantic_vocab - 1, (batch_size, sy)).astype(np.int32),
        "sem_len": np.full((batch_size,), sy, np.int32),
    }
