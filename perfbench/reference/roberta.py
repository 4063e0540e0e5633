"""chinese-roberta-wwm-ext-large phone features in plain PyTorch.

BERT-large: word + position + token-type embeddings and LayerNorm, post-LN
layers (exact GELU, LayerNorm epsilon 1e-12), the third hidden state from
the end taken per character (CLS and SEP dropped) and repeated once per
phoneme of that character. Weights in the converted tree's layout
(dense ``w`` as [in, out], layers stacked on a leading axis)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
import torch.nn.functional as F


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(), p["bias"].float(), 1e-12)


def phone_features(p: Dict, ids: Sequence[int], repeats: Sequence[int],
                   num_heads: int = 16, feature_layer: int = -3,
                   weight: Callable[[torch.Tensor], torch.Tensor] = lambda w: w,
                   act=torch.float32) -> torch.Tensor:
    """Token ids [T] (with CLS and SEP) and phonemes per content token ->
    [sum(repeats), D] float32. ``weight`` maps each per-layer weight and
    ``act`` is the matmuls' dtype, as in :mod:`.t2s` (the control)."""
    dev = p["word_embed"].device
    ids_t = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    T = len(ids_t)
    max_pos = p["pos_embed"].shape[0]
    pos = torch.arange(T, device=dev).clamp(max=max_pos - 1)
    x = (p["word_embed"][ids_t].float() + p["pos_embed"][pos].float()
         + p["type_embed"][0].float())
    x = _ln(x, p["embed_norm"])
    L = p["layers"]["q"]["w"].shape[0]
    layer = feature_layer % (L + 1)
    D, H = x.shape[-1], num_heads
    for l in range(layer):
        lay = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in p["layers"].items()
               if not k.startswith("_")}

        def dense(name, t):
            w = weight(lay[name]["w"].float())
            return (t.to(act) @ w.to(act)).float() + lay[name]["b"].float()

        q, k, v = (dense(n, x).reshape(T, H, D // H).transpose(0, 1) for n in "qkv")
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(D // H), -1) @ v
        x = _ln(x + dense("out", att.transpose(0, 1).reshape(T, D)), lay["norm1"])
        x = _ln(x + dense("ffn2", F.gelu(dense("ffn1", x))), lay["norm2"])
    reps = torch.as_tensor(list(repeats), dtype=torch.long, device=dev)
    return torch.repeat_interleave(x[1: 1 + len(reps)], reps, dim=0)
