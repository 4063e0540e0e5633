"""Categorical sampling for the AR semantic decoder.

The GPT-SoVITS sampling stack of ``genie_tts_tpu/ops/sampling.py``:
repetition penalty over previously emitted tokens, then top-p, then top-k,
then temperature, drawn with the Gumbel-max trick. The Gumbel noise comes
from a ``torch.Generator``, or is passed in (tests hand both packages the
same noise). :func:`sample_token` takes one config for the batch;
:func:`sample_token_rows` takes per-row parameters (the slot machine's).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SamplingConfig:
    top_k: int = 15
    top_p: float = 1.0
    temperature: float = 1.0
    repetition_penalty: float = 1.35


# sample_token_rows reads each row's top-k threshold out of one
# topk(TOP_K_CAP); rows asking for more than TOP_K_CAP keep the
# TOP_K_CAP-th value. The GPT-SoVITS webui exposes top_k 1..100, so the
# cap is not reachable from reference-shaped requests.
TOP_K_CAP = 128

Rows = Union[np.ndarray, torch.Tensor]


class SamplingRows(NamedTuple):
    """Per-row sampling parameters, shape [B] each (numpy on the host, or
    tensors: the slot machine keeps them in its state so rows with
    different configs share one decode loop)."""
    top_k: Rows               # int; <= 0 disables
    top_p: Rows               # float; >= 1 disables
    temperature: Rows
    repetition_penalty: Rows


def rows_from_config(cfg: SamplingConfig, batch: int) -> SamplingRows:
    """Broadcast one SamplingConfig to per-row host arrays."""
    return SamplingRows(
        top_k=np.full(batch, cfg.top_k, np.int32),
        top_p=np.full(batch, cfg.top_p, np.float32),
        temperature=np.full(batch, cfg.temperature, np.float32),
        repetition_penalty=np.full(batch, cfg.repetition_penalty, np.float32),
    )


def gumbel_noise(shape, generator: Optional[torch.Generator] = None,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise in fp32: -log(-log(U)), U ~ (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny, max=1.0 - 2 ** -24)))


def apply_repetition_penalty(logits: torch.Tensor, token_counts: torch.Tensor,
                             penalty: float) -> torch.Tensor:
    """Penalize every token already emitted (count > 0). [B, V] fp32."""
    if penalty == 1.0:
        return logits
    seen = token_counts > 0
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def top_k_top_p_filter(logits: torch.Tensor, top_k: int,
                       top_p: float) -> torch.Tensor:
    """Mask logits outside the nucleus / top-k set with -1e10. [B, V] fp32.

    Top-p runs FIRST on the full distribution (sorted descending; tokens
    whose inclusive cumulative probability exceeds ``top_p`` are removed,
    the argmax always kept), then top-k masks below the k-th remaining
    logit: the order of GPT-SoVITS ``logits_to_probs``.
    """
    neg = torch.tensor(-1e10, dtype=logits.dtype, device=logits.device)
    if top_p < 1.0:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum > top_p
        remove_sorted[..., 0] = False                      # keep argmax
        keep = torch.ones_like(remove_sorted)
        keep.scatter_(-1, sort_idx, ~remove_sorted)
        logits = torch.where(keep, logits, neg)
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    return logits


def sample_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 token_counts: torch.Tensor, cfg: SamplingConfig,
                 forbid: Optional[torch.Tensor] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One categorical draw per row. Returns [B] int64.

    ``forbid``: optional [V] (or per-row [B, V]) bool of tokens never
    sampled (EOS on the first decode step, and below ``min_steps``).
    ``noise``: optional pre-drawn [B, V] Gumbel noise; drawn from
    ``generator`` otherwise.
    """
    logits = logits.float()
    logits = apply_repetition_penalty(logits, token_counts,
                                      cfg.repetition_penalty)
    if forbid is not None:
        fb = forbid if forbid.dim() == logits.dim() else forbid[None, :]
        logits = logits.masked_fill(fb, -1e10)
    logits = top_k_top_p_filter(logits, cfg.top_k, cfg.top_p)
    temperature = max(cfg.temperature, 1e-5)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, logits.device)
    return torch.argmax(logits / temperature + noise, dim=-1)


def sample_token_rows(generator: Optional[torch.Generator], logits: torch.Tensor,
                      token_counts: torch.Tensor, rows: SamplingRows,
                      forbid: Optional[torch.Tensor] = None,
                      noise: Optional[torch.Tensor] = None,
                      any_top_p: Optional[bool] = None) -> torch.Tensor:
    """One categorical draw per row with PER-ROW sampling parameters.

    The order of :func:`sample_token` (penalty -> forbid mask -> top-p ->
    top-k -> temperature), so every-row-equal parameters draw the same
    tokens: each row's top-k threshold is its k-th value out of one
    ``topk(TOP_K_CAP)``. The sort-based top-p branch runs only when some
    row has top_p < 1. ``any_top_p`` states that from the caller's host
    bookkeeping; without it the rows are read, which for device tensors
    waits for the device. Returns [B] int64."""
    logits = logits.float()
    B, V = logits.shape
    dev = logits.device

    def col(a, dtype):
        return torch.as_tensor(a, device=dev).to(dtype)[:, None]

    neg = torch.tensor(-1e10, dtype=torch.float32, device=dev)
    pen = col(rows.repetition_penalty, torch.float32)
    seen = (token_counts > 0) & (pen != 1.0)
    penalized = torch.where(logits < 0, logits * pen, logits / pen)
    logits = torch.where(seen, penalized, logits)
    if forbid is not None:
        fb = forbid if forbid.dim() == logits.dim() else forbid[None, :]
        logits = logits.masked_fill(fb, -1e10)
    if any_top_p is None:
        any_top_p = bool((rows.top_p < 1.0).any())
    if any_top_p:
        sorted_logits, sort_idx = torch.sort(logits, dim=-1, descending=True,
                                             stable=True)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        remove_sorted = cum > col(rows.top_p, torch.float32)
        remove_sorted[..., 0] = False                      # keep argmax
        keep = torch.ones_like(remove_sorted)
        keep.scatter_(-1, sort_idx, ~remove_sorted)
        logits = torch.where(keep, logits, neg)
    cap = min(TOP_K_CAP, V)
    top_k = col(rows.top_k, torch.int64)
    vals = torch.topk(logits, cap, dim=-1).values               # [B, cap]
    kth = torch.gather(vals, -1, top_k.clamp(1, cap) - 1)
    apply_k = (top_k > 0) & (top_k < V)
    logits = torch.where(apply_k & (logits < kth), neg, logits)
    temperature = col(rows.temperature, torch.float32).clamp(min=1e-5)
    if noise is None:
        noise = gumbel_noise(logits.shape, generator, dev)
    return torch.argmax(logits / temperature + noise, dim=-1)
