"""Torch GPT-SoVITS checkpoint -> character checkpoint conversion.

A copy of ``genie_tts_tpu/convert/torch_convert.py`` for the port: read
the ``.ckpt`` (T2S GPT) / ``.pth`` (SoVITS) state dicts and write the same
safetensors checkpoints (with the port's ``convert/io.py``), which both
packages load. A V2ProPlus ``.pth`` (detected by its ``sv_emb``/
``ge_to512`` keys) also yields ``prompt_encoder.safetensors`` from the
same state dict, and its synthesizer binds no style encoder.

Layout transforms (torch -> ours):
  * Linear  [out, in]            -> w [in, out]           (transpose)
  * Conv1d  [out, in, k]         -> w [k, in, out]
  * ConvT1d [in, out, k]         -> w [k, in, out]
  * weight-norm (weight_g/weight_v) fused to plain kernels at convert time
  * packed in_proj qkv [3D, D]   -> w [D, 3D] (q|k|v column blocks)

Quirk parity: ``.pth`` files whose leading zip magic was stripped are
re-magicked before loading (reference behavior:
``Converter/load_state_dict.py:11-23``).
"""
from __future__ import annotations

import io
import logging
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np

from ..config import SoVITSConfig, T2SConfig

logger = logging.getLogger(__name__)

# size heuristic from the reference driver (Converter/Converter.py:7-11)
V2PP_PTH_THRESHOLD_BYTES = 150 * 1024 * 1024


# ---------------------------------------------------------------------------
# State-dict loading (torch, host-side only)
# ---------------------------------------------------------------------------

def load_torch_pth(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load a SoVITS ``.pth``; tolerates a stripped 'PK' zip header."""
    import torch

    raw = Path(path).read_bytes()
    if raw[:2] != b"PK":
        raw = b"PK" + raw
    obj = torch.load(io.BytesIO(raw), map_location="cpu", weights_only=True)
    sd = obj.get("weight", obj)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items() if hasattr(v, "shape")}


def load_torch_ckpt(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Load a T2S ``.ckpt`` state dict."""
    import torch

    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    sd = obj.get("weight", obj)
    if "state_dict" in sd and not hasattr(sd.get("state_dict"), "shape"):
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v)
            for k, v in sd.items() if hasattr(v, "shape")}


# ---------------------------------------------------------------------------
# Layout helpers
# ---------------------------------------------------------------------------

def _lin(sd, key):
    p = {"w": sd[f"{key}.weight"].T}
    if f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"]
    return p


def _conv(sd, key, bias=True):
    p = {"w": np.transpose(sd[f"{key}.weight"], (2, 1, 0))}
    if bias and f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"]
    return p


def _fuse_weight_norm(g: np.ndarray, v: np.ndarray, dim: int = 0) -> np.ndarray:
    axes = tuple(i for i in range(v.ndim) if i != dim)
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=axes, keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(v.dtype)


def _wn_conv(sd, key, transpose_conv=False):
    """Fused weight-normed conv; torch conv [out,in,k] / convT [in,out,k]."""
    w = _fuse_weight_norm(sd[f"{key}.weight_g"], sd[f"{key}.weight_v"], dim=0)
    if transpose_conv:
        w = np.transpose(w, (2, 0, 1))     # [in,out,k] -> [k,in,out]
    else:
        w = np.transpose(w, (2, 1, 0))     # [out,in,k] -> [k,in,out]
    p = {"w": w}
    if f"{key}.bias" in sd:
        p["b"] = sd[f"{key}.bias"]
    return p


def _ln(sd, key):
    return {"scale": sd[f"{key}.weight"].astype(np.float32),
            "bias": sd[f"{key}.bias"].astype(np.float32)}


def _vits_ln(sd, key):
    return {"gamma": sd[f"{key}.gamma"].astype(np.float32).reshape(-1),
            "beta": sd[f"{key}.beta"].astype(np.float32).reshape(-1)}


# ---------------------------------------------------------------------------
# T2S (.ckpt) conversion
# ---------------------------------------------------------------------------

def convert_t2s(ckpt_sd: Dict[str, np.ndarray], pth_sd: Dict[str, np.ndarray],
                cfg: Optional[T2SConfig] = None) -> Dict:
    """Build the t2s param tree. The encoder's ssl_proj + VQ codebook come
    from the SoVITS ``.pth`` (reference merges the same 7 tensors:
    ``Converter/v2/EncoderConverter.py:38-48``)."""
    cfg = cfg or T2SConfig()
    sd = {k.removeprefix("model."): v for k, v in ckpt_sd.items()}
    vd = {k.removeprefix("vq_model."): v for k, v in pth_sd.items()}

    layers = []
    for i in range(cfg.num_layers):
        pre = f"h.layers.{i}"
        layers.append({
            "qkv": {"w": sd[f"{pre}.self_attn.in_proj_weight"].T,
                    "b": sd[f"{pre}.self_attn.in_proj_bias"]},
            "out": _lin(sd, f"{pre}.self_attn.out_proj"),
            "ffn1": _lin(sd, f"{pre}.linear1"),
            "ffn2": _lin(sd, f"{pre}.linear2"),
            "norm1": _ln(sd, f"{pre}.norm1"),
            "norm2": _ln(sd, f"{pre}.norm2"),
        })
    stacked = {}
    for k in layers[0]:
        stacked[k] = {kk: np.stack([l[k][kk] for l in layers])
                      for kk in layers[0][k]}

    return {
        "text_embed": sd["ar_text_embedding.word_embeddings.weight"],
        "bert_proj": _lin(sd, "bert_proj"),
        "text_pos_alpha": sd["ar_text_position.alpha"].reshape(()).astype(np.float32),
        "audio_embed": sd["ar_audio_embedding.word_embeddings.weight"],
        "audio_pos_alpha": sd["ar_audio_position.alpha"].reshape(()).astype(np.float32),
        "layers": stacked,
        "predict": {"w": sd["ar_predict_layer.weight"].T},
        "ssl_proj": _conv(vd, "ssl_proj"),
        "codebook": vd["quantizer.vq.layers.0._codebook.embed"].astype(np.float32),
    }


# ---------------------------------------------------------------------------
# SoVITS (.pth) conversion
# ---------------------------------------------------------------------------

def _enc_stack_from(sd, prefix, n_layers):
    layers = []
    for i in range(n_layers):
        layers.append({
            "attn": {
                "q": _conv(sd, f"{prefix}.attn_layers.{i}.conv_q"),
                "k": _conv(sd, f"{prefix}.attn_layers.{i}.conv_k"),
                "v": _conv(sd, f"{prefix}.attn_layers.{i}.conv_v"),
                "o": _conv(sd, f"{prefix}.attn_layers.{i}.conv_o"),
                "emb_rel_k": sd[f"{prefix}.attn_layers.{i}.emb_rel_k"],
                "emb_rel_v": sd[f"{prefix}.attn_layers.{i}.emb_rel_v"],
            },
            "norm1": _vits_ln(sd, f"{prefix}.norm_layers_1.{i}"),
            "ffn": {"conv1": _conv(sd, f"{prefix}.ffn_layers.{i}.conv_1"),
                    "conv2": _conv(sd, f"{prefix}.ffn_layers.{i}.conv_2")},
            "norm2": _vits_ln(sd, f"{prefix}.norm_layers_2.{i}"),
        })
    out = {}
    def stack(path, node):
        if isinstance(node, dict):
            return {k: stack(path + [k], v) for k, v in node.items()}
        return np.stack([_get(l, path) for l in layers])
    def _get(tree, path):
        for p in path:
            tree = tree[p]
        return tree
    return stack([], layers[0])


def _stack_trees(trees):
    """Same-structure trees of arrays -> one tree of stacked arrays."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, list):
        return [_stack_trees([t[i] for t in trees]) for i in range(len(first))]
    return np.stack(trees)


def convert_sovits(pth_sd: Dict[str, np.ndarray],
                   cfg: Optional[SoVITSConfig] = None) -> Dict:
    cfg = cfg or SoVITSConfig()
    sd = {k.removeprefix("vq_model."): v for k, v in pth_sd.items()}

    flow_layers = []
    for i in (2 * j for j in range(cfg.flow_layers)):
        # couplings live at even indices (odd slots are Flip layers)
        pre = f"flow.flows.{i}"
        flow_layers.append({
            "pre": _conv(sd, f"{pre}.pre"),
            "post": _conv(sd, f"{pre}.post"),
            "enc": {
                "cond_layer": _wn_conv(sd, f"{pre}.enc.cond_layer"),
                "in_layers": [_wn_conv(sd, f"{pre}.enc.in_layers.{j}")
                              for j in range(cfg.wn_layers)],
                "res_skip_layers": [_wn_conv(sd, f"{pre}.enc.res_skip_layers.{j}")
                                    for j in range(cfg.wn_layers)],
            },
        })
    flow_stack = _stack_trees(flow_layers)

    n_k = len(cfg.resblock_kernels)
    ups, resblocks = [], []
    for i in range(len(cfg.upsample_rates)):
        ups.append(_wn_conv(sd, f"dec.ups.{i}", transpose_conv=True))
        for j in range(n_k):
            b = i * n_k + j
            resblocks.append({
                "convs1": [_wn_conv(sd, f"dec.resblocks.{b}.convs1.{d}")
                           for d in range(len(cfg.resblock_dilations[j]))],
                "convs2": [_wn_conv(sd, f"dec.resblocks.{b}.convs2.{d}")
                           for d in range(len(cfg.resblock_dilations[j]))],
            })

    params = {
        "quantizer_embed": sd["quantizer.vq.layers.0._codebook.embed"].astype(np.float32),
        "enc_p": {
            "ssl_proj": _conv(sd, "enc_p.ssl_proj"),
            "text_embed": sd["enc_p.text_embedding.weight"],
            "encoder_ssl": _enc_stack_from(sd, "enc_p.encoder_ssl", cfg.n_layers // 2),
            "encoder_text": _enc_stack_from(sd, "enc_p.encoder_text", cfg.n_layers),
            "encoder2": _enc_stack_from(sd, "enc_p.encoder2", cfg.n_layers // 2),
            "mrte": {
                "c_pre": _conv(sd, "enc_p.mrte.c_pre"),
                "text_pre": _conv(sd, "enc_p.mrte.text_pre"),
                "attn_q": _conv(sd, "enc_p.mrte.cross_attention.conv_q"),
                "attn_k": _conv(sd, "enc_p.mrte.cross_attention.conv_k"),
                "attn_v": _conv(sd, "enc_p.mrte.cross_attention.conv_v"),
                "attn_o": _conv(sd, "enc_p.mrte.cross_attention.conv_o"),
                "c_post": _conv(sd, "enc_p.mrte.c_post"),
            },
            "proj": _conv(sd, "enc_p.proj"),
        },
        "flow": flow_stack,
        "dec": {
            "conv_pre": _conv(sd, "dec.conv_pre"),
            "cond": _conv(sd, "dec.cond"),
            "ups": ups,
            "resblocks": resblocks,
            "conv_post": _conv(sd, "dec.conv_post", bias=False),
        },
    }
    # V2 carries the MelStyleEncoder inside the synthesizer; V2ProPlus
    # moves it to the external prompt encoder (same ref_enc.* keys in the
    # checkpoint), so only bind it into vits params for V2
    if cfg.version != "v2ProPlus" and "ref_enc.fc.fc.weight" in sd:
        params["ref_enc"] = {
            "spectral0": _lin(sd, "ref_enc.spectral.0.fc"),
            "spectral3": _lin(sd, "ref_enc.spectral.3.fc"),
            "temporal": [_conv(sd, f"ref_enc.temporal.{i}.conv1.conv")
                         for i in range(2)],
            "w_qs": _lin(sd, "ref_enc.slf_attn.w_qs"),
            "w_ks": _lin(sd, "ref_enc.slf_attn.w_ks"),
            "w_vs": _lin(sd, "ref_enc.slf_attn.w_vs"),
            "attn_fc": _lin(sd, "ref_enc.slf_attn.fc"),
            "fc": _lin(sd, "ref_enc.fc.fc"),
        }
    return params


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def find_checkpoints(directory: Union[str, Path]):
    """Pick the training outputs to convert from a folder (non-recursive).

    Capability of the reference GUI's batch converter
    (``Converter/v2/Converter.py:26-77``): the ``.ckpt`` and ``.pth``
    whose filename carries the highest ``e<epoch>`` number (0 when
    absent); ties broken by newest mtime. Returns (ckpt_path, pth_path),
    either possibly None.
    """
    import re as _re

    best = {".ckpt": (None, -1, -1.0), ".pth": (None, -1, -1.0)}
    for p in Path(directory).iterdir():
        if not p.is_file():
            continue
        ext = p.suffix.lower()
        if ext not in best:
            continue
        m = _re.search(r"e(\d+)", p.name, flags=_re.IGNORECASE)
        epoch = int(m.group(1)) if m else 0
        mtime = p.stat().st_mtime
        cur = best[ext]
        if epoch > cur[1] or (epoch == cur[1] and mtime > cur[2]):
            best[ext] = (p, epoch, mtime)
    return best[".ckpt"][0], best[".pth"][0]


def detect_version(pth_path: Union[str, Path]) -> str:
    """Reference size heuristic (Converter/Converter.py:7-11)."""
    size = Path(pth_path).stat().st_size
    return "v2ProPlus" if size > V2PP_PTH_THRESHOLD_BYTES else "v2"


def detect_version_from_keys(pth_sd: Dict[str, np.ndarray]) -> Optional[str]:
    """Key-based detection (robust to file-size variation): V4 checkpoints
    (``SynthesizerTrnV3``) carry the CFM's DiT, the bridge and ``wns1``
    (and a style encoder too, so they are told first); V2ProPlus ones the
    speaker-verification projection weights."""
    keys = {k.removeprefix("vq_model.") for k in pth_sd}
    if any(k.startswith(("cfm.", "bridge.", "wns1.")) for k in keys):
        return "v4"
    if any(k.startswith(("sv_emb.", "ge_to512.")) for k in keys):
        return "v2ProPlus"
    if any(k.startswith("ref_enc.") for k in keys):
        return "v2"
    return None


def convert_character(
    ckpt_path: Union[str, Path],
    pth_path: Union[str, Path],
    output_dir: Union[str, Path],
    language: str = "Japanese",
    version: Optional[str] = None,
    t2s_cfg: Optional[T2SConfig] = None,
    sovits_cfg: Optional[SoVITSConfig] = None,
) -> str:
    """Full conversion: (.ckpt, .pth) -> character checkpoint directory.

    Non-default model configs are recorded in config.json so the model
    manager reconstructs them.
    """
    import dataclasses

    from .io import save_character_config, save_params

    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    try:
        ckpt_sd = load_torch_ckpt(ckpt_path)
        pth_sd = load_torch_pth(pth_path)
        if version is None:
            version = (detect_version_from_keys(pth_sd)
                       or detect_version(pth_path))
        if version == "v4":
            raise NotImplementedError(
                f"{pth_path} is a GPT-SoVITS V4 checkpoint (SynthesizerTrnV3): converting "
                f"V4 is not supported yet; the port runs V4 characters from weights in "
                f"its own layout (models/sovits_v4.py)")
        tcfg = t2s_cfg or T2SConfig()
        vcfg = sovits_cfg or SoVITSConfig()
        if sovits_cfg is None and version == "v2ProPlus":
            vcfg = dataclasses.replace(vcfg, version=version, gin_channels=1024)
        save_params(convert_t2s(ckpt_sd, pth_sd, tcfg), out / "t2s.safetensors")
        save_params(convert_sovits(pth_sd, vcfg), out / "vits.safetensors")
        vd = {k.removeprefix("vq_model.").removeprefix("prompt_encoder."): v
              for k, v in pth_sd.items()}
        if version == "v2ProPlus" and any(
                k.startswith(("sv_emb.", "ge_to512.")) for k in vd):
            # V2ProPlus checkpoints carry the prompt encoder's tensors
            # (ref_enc, sv_emb, ge_to512, prelu) in the same state dict
            from ..models.prompt_encoder import convert_from_torch

            try:
                save_params(convert_from_torch(vd), out / "prompt_encoder.safetensors")
            except KeyError as e:
                logger.warning("prompt-encoder weights incomplete (%s); "
                               "convert them separately", e)
        extra = {}
        if t2s_cfg is not None:
            extra["t2s"] = dataclasses.asdict(t2s_cfg)
        if sovits_cfg is not None:
            extra["sovits"] = dataclasses.asdict(sovits_cfg)
        save_character_config(out / "config.json", version=version,
                              language=language, extra=extra)
    except Exception:
        # reference behavior: remove partial output on failure
        import shutil

        shutil.rmtree(out, ignore_errors=True)
        raise
    logger.info("converted %s character -> %s", version, out)
    return version
