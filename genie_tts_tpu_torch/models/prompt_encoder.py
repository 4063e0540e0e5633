"""V2ProPlus prompt encoder: speaker conditioning from the reference clip.

The port of ``genie_tts_tpu/models/prompt_encoder.py``:

  (linear spectrogram of the 32 kHz clip, sv_emb [20480]) ->
    MelStyleEncoder (``sovits.mel_style_encode``) + Linear(20480 -> gin)
    of sv_emb -> per-channel PReLU -> ge [B, gin, 1] (flow and HiFi-GAN
    conditioning); Linear(gin -> 512) of ge -> ge_mrte [B, 512, 1] (MRTE
    conditioning).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..config import SoVITSConfig
from ..ops.layers import matmul
from .sovits import mel_style_encode

Params = Dict


def apply(params: Params, spec: torch.Tensor, spec_len: torch.Tensor,
          sv_emb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """spec [B,T,1025], sv_emb [B,20480] -> (ge [B,gin,1], ge_mrte [B,512,1])."""
    mask_t = (torch.arange(spec.shape[1], device=spec.device)[None, :]
              < spec_len[:, None]).to(spec.dtype)[..., None]
    ge = mel_style_encode(params["ref_enc"], spec, mask_t)       # [B,gin,1]
    sv = matmul(sv_emb.to(ge.dtype), params["sv_emb"]["w"], ge.dtype) \
        + params["sv_emb"]["b"]
    ge = ge + sv[:, :, None]
    slope = params["prelu_weight"].reshape(1, -1, 1).to(ge.dtype)
    ge = torch.where(ge >= 0, ge, slope * ge)
    ge_mrte = (torch.einsum("bct,cd->bdt", ge, params["ge_to512"]["w"].to(ge.dtype))
               + params["ge_to512"]["b"][None, :, None])
    return ge, ge_mrte


def convert_from_torch(sd: Dict) -> Params:
    """Torch prompt-encoder state dict -> param tree (numpy leaves)."""
    def lin(key):
        return {"w": sd[f"{key}.weight"].T, "b": sd[f"{key}.bias"]}

    return {
        "ref_enc": {
            "spectral0": lin("ref_enc.spectral.0.fc"),
            "spectral3": lin("ref_enc.spectral.3.fc"),
            "temporal": [
                {"w": np.transpose(sd[f"ref_enc.temporal.{i}.conv1.conv.weight"], (2, 1, 0)),
                 "b": sd[f"ref_enc.temporal.{i}.conv1.conv.bias"]}
                for i in range(2)],
            "w_qs": lin("ref_enc.slf_attn.w_qs"),
            "w_ks": lin("ref_enc.slf_attn.w_ks"),
            "w_vs": lin("ref_enc.slf_attn.w_vs"),
            "attn_fc": lin("ref_enc.slf_attn.fc"),
            "fc": lin("ref_enc.fc.fc"),
        },
        "sv_emb": lin("sv_emb"),
        "ge_to512": lin("ge_to512"),
        "prelu_weight": sd["prelu.weight"],
    }


def init_params(generator: torch.Generator, cfg: SoVITSConfig, dtype=torch.bfloat16,
                gin: int = 1024, mrte_dim: int = 512) -> Params:
    """Random prompt-encoder weights on ``generator``'s device (the JAX
    package's tree; the PReLU slope is 0.25 in fp32)."""
    dev = generator.device

    def randn(*shape, std):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def dense(i, o):
        return {"w": randn(i, o, std=i ** -0.5),
                "b": torch.zeros((o,), dtype=dtype, device=dev)}

    return {
        "ref_enc": {
            "spectral0": dense(cfg.spec_channels, 128),
            "spectral3": dense(128, 128),
            "temporal": [{"w": randn(5, 128, 256, std=0.04),
                          "b": torch.zeros((256,), dtype=dtype, device=dev)}
                         for _ in range(2)],
            "w_qs": dense(128, 128), "w_ks": dense(128, 128),
            "w_vs": dense(128, 128), "attn_fc": dense(128, 128),
            "fc": dense(128, gin),
        },
        "sv_emb": dense(cfg.sv_dim, gin),
        "ge_to512": dense(gin, mrte_dim),
        "prelu_weight": torch.full((gin,), 0.25, dtype=torch.float32, device=dev),
    }
