"""Weights from the seed, made on the device in a few large calls.

Each model's tree has the layout of a converted checkpoint as the port
reads it (leaf paths, shapes and dtypes: the port's ``init_params`` run
under ``FakeTensorMode``, which allocates nothing and draws nothing). The
values are the benchmark's own: per dtype ONE normal draw over all
leaves from a ``torch.Generator`` on the device, scaled per leaf by the
rules below (:func:`init_rule`), cast once to the served dtype; every
leaf is a view into that buffer, each starting on a 256-byte boundary.
The same seed on the same device gives the same bits, so the reference
makes the same weights again after the program has let go of its own."""
from __future__ import annotations

import hashlib
import math
import re
from typing import Dict, List, Tuple

import torch

ALIGN = 128          # elements between leaf starts: 256 bytes of bf16

Leaf = Tuple[Tuple[str, ...], torch.Size, torch.dtype]

# Gains on fan-in scaling. At plain fan-in scaling the 24 post-LN decoder
# layers collapse every position onto one vector (near-uniform attention
# over a few hundred keys adds the same average to every row, layer after
# layer): the logits no longer depend on the position or the text. Sharper
# attention (q, k and v at twice the scale) with a small output
# projection, and embeddings at unit scale, keep the rows apart.
GAINS = {("t2s", "layers/qkv/w"): 2.0, ("t2s", "layers/out/w"): 0.1}


def _port_init(model: str, cfg: Dict):
    """(init function taking a generator, dtype) of a model of the port."""
    from genie_tts_tpu_torch import config as pc
    from genie_tts_tpu_torch.models import (eres2net, hubert, prompt_encoder, roberta,
                                            sovits, t2s)

    dt = getattr(torch, cfg.get("dtype", "bfloat16"))
    if model == "t2s":
        return lambda g: t2s.init_params(g, pc.T2SConfig(**cfg["t2s"]), dtype=dt)
    if model == "sovits":
        vcfg = sovits_config(cfg)

        def init(g):
            p = sovits.init_params(g, vcfg, dtype=dt)
            if vcfg.version == "v2ProPlus":      # a converted V2ProPlus has no style encoder
                del p["ref_enc"]
            return p
        return init
    if model == "prompt_encoder":
        vcfg = sovits_config(cfg)
        return lambda g: prompt_encoder.init_params(g, vcfg, dtype=dt, gin=vcfg.gin_channels,
                                                    mrte_dim=vcfg.mrte_channels)
    if model == "hubert":
        return lambda g: hubert.init_params(g, pc.HubertConfig(**cfg["hubert"]), dtype=dt)
    if model == "roberta":
        return lambda g: roberta.init_params(g, pc.RobertaConfig(**cfg["roberta"]), dtype=dt)
    if model == "sv":
        return lambda g: eres2net.init_params(g, dtype=dt)
    raise ValueError(f"unknown model {model!r}")


def sovits_config(cfg: Dict):
    from genie_tts_tpu_torch.config import SoVITSConfig

    kw = {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
          if isinstance(v, list) else v for k, v in cfg["sovits"].items()}
    return SoVITSConfig(**kw)


def models(cfg: Dict) -> List[str]:
    """The models a configuration runs, in a fixed order."""
    out = ["t2s", "sovits", "hubert"]
    if cfg.get("version") == "v2ProPlus":
        out += ["prompt_encoder", "sv"]
    if cfg.get("roberta"):
        out.append("roberta")
    return out


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
        tree = _port_init(model, cfg)(torch.Generator())
    return tree, [(p, t.shape, t.dtype) for p, t in _leaves(tree)]


def init_rule(model: str, path: Tuple[str, ...], shape) -> Tuple[float, float]:
    """(mean, std) of a leaf: fan-in scaling for weights (a dense ``w`` is
    [in, out] behind any stacked layer axis, a conv's [width, in, out],
    a 2-D conv's [h, w, in, out]) times :data:`GAINS`, embeddings at 0.02
    (the decoder's at 1), norms at one and zero; in the decoder (``t2s``)
    biases and norms drawn around those values, so each layer's differ."""
    name = path[-1]
    joined = "/".join(path)
    stacked = model in ("t2s", "hubert", "roberta") and path[0] == "layers"
    if name in ("text_pos_alpha", "audio_pos_alpha"):
        return 1.0, 0.0
    if name == "prelu_weight":
        return 0.25, 0.0
    if name in ("scale", "gamma"):
        return 1.0, (0.1 if model == "t2s" else 0.0)
    if name in ("bias", "beta", "b"):
        return 0.0, (0.1 if model == "t2s" else 0.0)
    if name in ("codebook", "quantizer_embed"):
        return 0.0, 1.0
    if model == "t2s" and joined in ("text_embed", "audio_embed"):
        return 0.0, 1.0
    if re.search(r"(text_embed|audio_embed|word_embed|pos_embed|type_embed)$", joined):
        return 0.0, 0.02
    if name.startswith("emb_rel"):
        return 0.0, shape[-1] ** -0.5
    if model == "t2s" and joined == "ssl_proj/w":
        return 0.0, 0.03
    if model == "hubert" and joined == "pos_conv/w":
        return 0.0, 0.02
    if name == "w":
        if stacked or len(shape) == 2:
            fan = shape[-2]
        elif model == "sv":
            fan = shape[0] * shape[1] * shape[2]
        else:
            fan = shape[-3] * shape[-2]
        return 0.0, GAINS.get((model, joined), 0.3 if (model == "sv" and "conv3" in path)
                              else 1.0) * fan ** -0.5
    raise ValueError(f"no init rule for {model}:{joined} {tuple(shape)}")


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
