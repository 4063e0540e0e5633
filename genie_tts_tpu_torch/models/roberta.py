"""chinese-roberta-wwm-ext-large: per-phoneme BERT features for Chinese
text.

The port of ``genie_tts_tpu/models/roberta.py``: Chinese text -> 1024-d
features from the third-to-last hidden state, CLS/SEP stripped, repeated
per phoneme by ``word2ph``. Standard BERT-large geometry: embeddings
(word + position + type, LN), post-LN layers (16 heads, FFN 4096, exact
GELU), LayerNorm epsilon 1e-12.

:func:`phone_features` runs the exact token count, and only the layers
up to ``cfg.feature_layer``. The serving route, :func:`bucketed_features`,
is the JAX hook's jitted program (``runtime/model_manager.py:226-250``
there): the tokens padded to a bucket of the phoneme ladder, the feature
layer's rows captured as a CUDA graph per bucket (:func:`feature_graph`;
a parameter set's graphs form one family, ``runtime/graphs.py``), and the
per-phoneme repeat as one gather by an index the host builds. Masked
keys weigh exactly zero, so the padded route gives the exact route's
features. Position ids past ``max_position - 1`` take the last row, as
JAX's clamping gather does.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import RobertaConfig
from ..ops.layers import attention, linear, unstack
from ..ops.layers import layer_norm as _ln_base
from ..runtime import graphs
from ..runtime.buckets import pad_to, pick_bucket

Params = Dict


def layer_norm(p, x):
    return _ln_base(p, x, eps=1e-12)  # BERT-family epsilon


def encoder_layer(lp, x: torch.Tensor, mask: torch.Tensor,
                  cfg: RobertaConfig) -> torch.Tensor:
    B, T, D = x.shape
    H = cfg.num_heads

    def heads(t):
        return t.reshape(B, T, H, D // H).transpose(1, 2)

    att = attention(heads(linear(lp["q"], x)), heads(linear(lp["k"], x)),
                    heads(linear(lp["v"], x)), mask)
    att = att.transpose(1, 2).reshape(B, T, D)
    x = layer_norm(lp["norm1"], x + linear(lp["out"], att))
    ff = linear(lp["ffn2"], F.gelu(linear(lp["ffn1"], x), approximate="none"))
    return layer_norm(lp["norm2"], x + ff)


def hidden_states(params: Params, input_ids: torch.Tensor,
                  attention_mask: torch.Tensor, cfg: RobertaConfig,
                  num_layers: Optional[int] = None) -> torch.Tensor:
    """[B, T] ids -> the embedding output and the first ``num_layers``
    layer outputs (default all), stacked [num_layers + 1, B, T, D]."""
    B, T = input_ids.shape
    dev = input_ids.device
    pos = torch.arange(T, device=dev).clamp(max=cfg.max_position - 1)
    ids = input_ids.long()
    x = (params["word_embed"][ids] + params["pos_embed"][pos][None]
         + params["type_embed"][torch.zeros_like(ids)])
    x = layer_norm(params["embed_norm"], x)
    mask = (attention_mask[:, None, None, :] > 0)
    states = [x]
    layers = unstack(params["layers"])
    for lp in layers[: len(layers) if num_layers is None else num_layers]:
        x = encoder_layer(lp, x, mask, cfg)
        states.append(x)
    return torch.stack(states)


def phone_features(params: Params, input_ids: torch.Tensor,
                   attention_mask: torch.Tensor, repeats: torch.Tensor,
                   cfg: RobertaConfig) -> torch.Tensor:
    """Per-phoneme features [sum(repeats), D], fp32 (the JAX function's
    first sum(repeats) rows; it pads to a bucket with zero rows).

    input_ids/attention_mask: [1, T_tok]; repeats: [T_tok - 2] (per
    content token, CLS/SEP stripped)."""
    n_states = cfg.num_layers + 1
    layer = cfg.feature_layer % n_states     # -3 of 25 states: layer 22
    states = hidden_states(params, input_ids, attention_mask, cfg,
                           num_layers=layer)
    feats = states[layer][0, 1:-1].float()                   # [T_chars, D]
    reps = repeats.to(device=feats.device, dtype=torch.long)
    return torch.repeat_interleave(feats[: reps.shape[0]], reps, dim=0)


@dataclasses.dataclass
class FeatureBuffers:
    """The static buffers of the feature program: the padded token ids
    and attention mask [1, T] int64, and the feature layer's rows [T, D]
    fp32."""
    ids: torch.Tensor
    mask: torch.Tensor
    rows: torch.Tensor


def _feature_rows(params: Params, cfg: RobertaConfig, b: FeatureBuffers) -> None:
    layer = cfg.feature_layer % (cfg.num_layers + 1)
    states = hidden_states(params, b.ids, b.mask, cfg, num_layers=layer)
    b.rows.copy_(states[layer][0])


def token_bucket(n: int, buckets: Sequence[int]) -> int:
    """The padded token count of ``n`` tokens: a bucket of the ladder, or
    past its largest a multiple of it (the JAX hook truncates there)."""
    if n <= buckets[-1]:
        return pick_bucket(n, buckets)
    return -(-n // buckets[-1]) * buckets[-1]


def feature_graph(params: Params, cfg: RobertaConfig, T: int):
    """The feature program's graph at ``T`` padded tokens in the
    parameter set's cache (a family: one pool, one lock), and the
    program."""
    dev = params["word_embed"].device

    def make():
        return FeatureBuffers(torch.zeros((1, T), dtype=torch.int64, device=dev),
                              torch.ones((1, T), dtype=torch.int64, device=dev),
                              torch.zeros((T, cfg.embed_dim), device=dev))

    g = graphs.cache_for(params).graph(("roberta", T), make)
    return g, functools.partial(_feature_rows, params, cfg)


def prepare_features(params: Params, cfg: RobertaConfig, T: int) -> None:
    """Capture the feature program at ``T`` padded tokens (a warmup unit;
    on the CPU its key and buffers are made)."""
    g, fn = feature_graph(params, cfg, T)
    with g.lock:
        g.prepare(fn)


def bucketed_features(params: Params, cfg: RobertaConfig, ids: np.ndarray,
                      mask: np.ndarray, repeats: np.ndarray,
                      buckets: Sequence[int]) -> torch.Tensor:
    """Per-phoneme features [sum(repeats), D] fp32 on the weights' device:
    :func:`phone_features` through the feature program at the tokens'
    bucket (:func:`token_bucket`; on the card a graph replay). ``ids`` /
    ``mask``: [T_tok]; ``repeats``: [T_tok - 2] (CLS/SEP stripped)."""
    T = token_bucket(len(ids), buckets)
    dev = params["word_embed"].device
    index = torch.from_numpy(np.repeat(np.arange(1, len(repeats) + 1),
                                       np.asarray(repeats, np.int64))).to(dev)
    g, fn = feature_graph(params, cfg, T)
    with g.lock:
        b = g.static
        b.ids.copy_(torch.from_numpy(pad_to(np.asarray(ids, np.int64), T))[None])
        b.mask.copy_(torch.from_numpy(pad_to(np.asarray(mask, np.int64), T))[None])
        g.run(fn)
        return b.rows.index_select(0, index)


def init_params(generator: torch.Generator, cfg: RobertaConfig,
                dtype=torch.bfloat16) -> Params:
    """Random RoBERTa weights on ``generator``'s device, in the JAX
    layout (layers stacked on a leading axis)."""
    dev = generator.device
    D, Fd, L = cfg.embed_dim, cfg.ffn_dim, cfg.num_layers

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def dense(i, o):
        return {"w": randn(L, i, o, std=i ** -0.5),
                "b": torch.zeros((L, o), dtype=dtype, device=dev)}

    def ln(lead=()):
        return {"scale": torch.ones(lead + (D,), device=dev),
                "bias": torch.zeros(lead + (D,), device=dev)}

    return {
        "word_embed": randn(cfg.vocab_size, D, std=0.02),
        "pos_embed": randn(cfg.max_position, D, std=0.02),
        "type_embed": randn(cfg.type_vocab, D, std=0.02),
        "embed_norm": ln(),
        "layers": {"q": dense(D, D), "k": dense(D, D), "v": dense(D, D),
                   "out": dense(D, D), "norm1": ln((L,)),
                   "ffn1": dense(D, Fd), "ffn2": dense(Fd, D),
                   "norm2": ln((L,))},
    }
