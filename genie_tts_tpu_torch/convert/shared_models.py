"""Shared-model conversion: HF torch checkpoints -> GenieData safetensors.

A copy of ``genie_tts_tpu/convert/shared_models.py`` for the port,
changed only in its imports: the upstream torch checkpoints
(transformers ``HubertModel`` / ``BertModel`` state dicts) become the
schemas of ``models/hubert.py`` and ``models/roberta.py``, written with
the port's ``convert/io.py`` in the same file format both packages load:

    GenieData/chinese-hubert-base/hubert.safetensors
    GenieData/RoBERTa/roberta.safetensors + tokenizer.json
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Dict

import numpy as np

from ..config import HubertConfig, RobertaConfig

logger = logging.getLogger(__name__)


def _lin(sd, key):
    p = {"w": sd[f"{key}.weight"].T}
    if f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"]
    return p


def _ln(sd, key):
    return {"scale": sd[f"{key}.weight"].astype(np.float32),
            "bias": sd[f"{key}.bias"].astype(np.float32)}


def convert_hubert(sd: Dict[str, np.ndarray], cfg: HubertConfig = HubertConfig()) -> Dict:
    """transformers ``HubertModel`` state dict -> models/hubert.py schema."""
    sd = {k.removeprefix("hubert."): v for k, v in sd.items()}

    conv_layers = []
    for i in range(len(cfg.conv_kernels)):
        p = {"w": np.transpose(sd[f"feature_extractor.conv_layers.{i}.conv.weight"],
                               (2, 1, 0))}
        if i == 0:
            p["norm"] = _ln(sd, "feature_extractor.conv_layers.0.layer_norm")
        conv_layers.append(p)

    # fuse the weight-normed positional conv ([D, D/groups, k] torch layout);
    # both the legacy (weight_g/weight_v) and parametrized key layouts occur
    if "encoder.pos_conv_embed.conv.weight_g" in sd:
        g = sd["encoder.pos_conv_embed.conv.weight_g"]
        v = sd["encoder.pos_conv_embed.conv.weight_v"]
    else:
        g = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original0"]
        v = sd["encoder.pos_conv_embed.conv.parametrizations.weight.original1"]
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=(0, 1), keepdims=True))
    w = (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)  # norm over dim 2
    pos_w = np.transpose(w, (2, 1, 0))

    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.layers.{i}"
        layers.append({
            "q": _lin(sd, f"{pre}.attention.q_proj"),
            "k": _lin(sd, f"{pre}.attention.k_proj"),
            "v": _lin(sd, f"{pre}.attention.v_proj"),
            "out": _lin(sd, f"{pre}.attention.out_proj"),
            "norm1": _ln(sd, f"{pre}.layer_norm"),
            "ffn1": _lin(sd, f"{pre}.feed_forward.intermediate_dense"),
            "ffn2": _lin(sd, f"{pre}.feed_forward.output_dense"),
            "norm2": _ln(sd, f"{pre}.final_layer_norm"),
        })
    stacked = {k: {kk: np.stack([l[k][kk] for l in layers])
                   for kk in layers[0][k]} for k in layers[0]}

    return {
        "conv_layers": conv_layers,
        "fp_norm": _ln(sd, "feature_projection.layer_norm"),
        "fp_proj": _lin(sd, "feature_projection.projection"),
        "pos_conv": {"w": pos_w, "b": sd["encoder.pos_conv_embed.conv.bias"]},
        "enc_norm": _ln(sd, "encoder.layer_norm"),
        "layers": stacked,
    }


def convert_roberta(sd: Dict[str, np.ndarray],
                    cfg: RobertaConfig = RobertaConfig()) -> Dict:
    """transformers ``BertModel`` state dict -> models/roberta.py schema."""
    sd = {k.removeprefix("bert."): v for k, v in sd.items()}
    emb = "embeddings"
    layers = []
    for i in range(cfg.num_layers):
        pre = f"encoder.layer.{i}"
        layers.append({
            "q": _lin(sd, f"{pre}.attention.self.query"),
            "k": _lin(sd, f"{pre}.attention.self.key"),
            "v": _lin(sd, f"{pre}.attention.self.value"),
            "out": _lin(sd, f"{pre}.attention.output.dense"),
            "norm1": _ln(sd, f"{pre}.attention.output.LayerNorm"),
            "ffn1": _lin(sd, f"{pre}.intermediate.dense"),
            "ffn2": _lin(sd, f"{pre}.output.dense"),
            "norm2": _ln(sd, f"{pre}.output.LayerNorm"),
        })
    stacked = {k: {kk: np.stack([l[k][kk] for l in layers])
                   for kk in layers[0][k]} for k in layers[0]}
    return {
        "word_embed": sd[f"{emb}.word_embeddings.weight"],
        "pos_embed": sd[f"{emb}.position_embeddings.weight"],
        "type_embed": sd[f"{emb}.token_type_embeddings.weight"],
        "embed_norm": _ln(sd, f"{emb}.LayerNorm"),
        "layers": stacked,
    }


def convert_shared_models(hubert_dir_in=None, roberta_dir_in=None,
                          out_root=None) -> None:
    """Convert downloaded HF torch checkpoints into the GenieData layout.

    The outputs go to ``hubert_dir()`` and ``roberta_dir()`` (the
    ``GENIE_DATA_DIR`` layout, or ``GENIE_HUBERT_DIR`` /
    ``GENIE_ROBERTA_DIR``), whatever ``out_root`` says: the JAX package's
    function computes ``out_root`` and never uses it, and this one writes
    the same files for the same call."""
    import torch

    from ..config import genie_data_dir, hubert_dir, roberta_dir
    from .io import save_params

    out_root = Path(out_root) if out_root else genie_data_dir()

    if hubert_dir_in:
        sd = torch.load(Path(hubert_dir_in) / "pytorch_model.bin",
                        map_location="cpu", weights_only=True)
        sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
        out = hubert_dir()
        out.mkdir(parents=True, exist_ok=True)
        save_params(convert_hubert(sd), out / "hubert.safetensors")
        logger.info("HuBERT converted -> %s", out)

    if roberta_dir_in:
        src = Path(roberta_dir_in)
        sd = torch.load(src / "pytorch_model.bin", map_location="cpu",
                        weights_only=True)
        sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
        out = roberta_dir()
        out.mkdir(parents=True, exist_ok=True)
        save_params(convert_roberta(sd), out / "roberta.safetensors")
        for tok in ("tokenizer.json",):
            if (src / tok).exists():
                (out / tok).write_bytes((src / tok).read_bytes())
        logger.info("RoBERTa converted -> %s", out)
