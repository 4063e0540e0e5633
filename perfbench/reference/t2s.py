"""GPT-SoVITS text-to-semantic decoder, teacher-forced, in plain PyTorch.

One full pass over ``[text | prompt + served tokens]`` gives the logits
that predicted every served token: the decoder's published equations
(post-LN layers, 1-based sinusoidal positions scaled by a learned alpha,
text attending text both ways, audio attending the text and the audio
before it), read from the raw weight tree in the layout of a converted
checkpoint (``w`` as [in, out], layers stacked on a leading axis). No KV
cache, no batching, no kernels: a different algorithm from the program's
decode, computing the same function.

``weight`` maps each per-layer weight before use; the control passes a
coarser quantizer (:mod:`.quant`), the reference the identity. ``act``
is the activations' dtype (float32 for the reference)."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch


def sine_table(n: int, d: int, device) -> torch.Tensor:
    """Positions 1..n, sin on even and cos on odd columns."""
    pos = torch.arange(1, n + 1, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d))
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def _ln(x, scale, bias, eps=1e-5):
    return torch.nn.functional.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                                          bias.float(), eps)


def logits(p: Dict, phones: torch.Tensor, bert: Optional[torch.Tensor],
           prompts: torch.Tensor, tokens: torch.Tensor, num_heads: int,
           weight: Callable[[torch.Tensor], torch.Tensor] = lambda w: w,
           act=torch.float32) -> torch.Tensor:
    """Logits [len(tokens), V] in float32: row s scores the token served
    at step s (row 0 is read at the last prompt position).

    phones [Tx] int, bert [Tx, bert_dim] or None (zero features), prompts
    [Tp] int, tokens [n] int: the served tokens, of which all but the last
    are fed back."""
    dev = phones.device
    f = {k: v for k, v in p.items()}
    D = f["text_embed"].shape[1]
    Tx, Tp, n = len(phones), len(prompts), len(tokens)
    x = f["text_embed"][phones].float()
    b = (torch.zeros((Tx, f["bert_proj"]["w"].shape[0]), device=dev) if bert is None
         else bert.float())
    x = x + b @ f["bert_proj"]["w"].float() + f["bert_proj"]["b"].float()
    x = x + f["text_pos_alpha"].float() * sine_table(Tx, D, dev)
    y_ids = torch.cat([prompts.long(), tokens[:-1].long()])
    y = f["audio_embed"][y_ids].float()
    y = y + f["audio_pos_alpha"].float() * sine_table(len(y_ids), D, dev)
    h = torch.cat([x, y])[None]                              # [1, S, D]
    S = h.shape[1]
    i = torch.arange(S, device=dev)[:, None]
    j = torch.arange(S, device=dev)[None, :]
    allowed = torch.where(i < Tx, j < Tx, (j < Tx) | (j <= i))
    L = p["layers"]["qkv"]["w"].shape[0]
    H = num_heads
    for l in range(L):
        lay = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in p["layers"].items()
               if not k.startswith("_")}

        def dense(name, t):
            w = weight(lay[name]["w"].float())
            return (t.to(act) @ w.to(act)).float() + lay[name]["b"].float()

        q, k, v = dense("qkv", h).chunk(3, dim=-1)
        q, k, v = (t.reshape(1, S, H, D // H).transpose(1, 2) for t in (q, k, v))
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(D // H)
        scores = scores.masked_fill(~allowed, float("-inf"))
        att = (torch.softmax(scores, -1) @ v).transpose(1, 2).reshape(1, S, D)
        h = _ln(h + dense("out", att), lay["norm1"]["scale"], lay["norm1"]["bias"])
        ff = dense("ffn2", torch.relu(dense("ffn1", h)))
        h = _ln(h + ff, lay["norm2"]["scale"], lay["norm2"]["bias"])
    rows = h[0, Tx + Tp - 1: Tx + Tp - 1 + n]
    return rows.float() @ f["predict"]["w"].float()


def prompt_distances(p: Dict, ssl: torch.Tensor) -> torch.Tensor:
    """HuBERT features [T, C] -> squared Euclidean distances [T // 2, K]
    from the stride-2 width-2 projection of each frame pair to every
    codebook row."""
    w = p["ssl_proj"]["w"].float()                            # [2, C, C]
    T2 = ssl.shape[0] // 2
    x = ssl.float()[: 2 * T2].reshape(T2, -1) @ w.reshape(-1, w.shape[-1])
    x = x + p["ssl_proj"]["b"].float()
    cb = p["codebook"].float()
    return ((x[:, None, :] - cb[None]) ** 2).sum(-1)


def prompt_tokens(p: Dict, ssl: torch.Tensor) -> torch.Tensor:
    """HuBERT features [T, C] -> semantic ids [T // 2]: the nearest
    codebook row."""
    return prompt_distances(p, ssl).argmin(-1)


def prompt_gap(d: torch.Tensor, tokens: torch.Tensor) -> float:
    """How far the chosen codebook rows lie beyond the nearest, as a share
    of the nearest's distance, at the worst position (0 where every
    choice is the nearest)."""
    n = min(len(tokens), d.shape[0])
    best = d[:n].min(-1).values
    got = d[:n].gather(1, tokens[:n].long()[:, None])[:, 0]
    extra = float(((got - best) / best.clamp(min=1e-12)).max()) if n else 0.0
    return extra if len(tokens) == d.shape[0] else float("inf")


def greedy_gaps(z: torch.Tensor, tokens: torch.Tensor, prompts: torch.Tensor,
                penalty: float, eos: int, min_steps: int,
                choose: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per step s, how far the logit of the chosen token lies below the
    best under the greedy rule: the logits ``z`` [n, V] with the
    repetition penalty on every id seen before step s (the prompt and the
    tokens served before it) and EOS out of reach below ``min_steps`` and
    at step 0. The chosen token is the served one, or the argmax of
    ``choose`` (logits of the same shape scored by the same rule).
    Returns [n] float32."""
    n, V = z.shape
    dev = z.device
    seen = torch.zeros((n, V), dtype=torch.bool, device=dev)
    seen[:, prompts.long()] = True
    prev = torch.zeros((n, V), dtype=torch.int64, device=dev)
    if n > 1:
        prev[torch.arange(1, n, device=dev), tokens[:-1].long()] = 1
        seen |= prev.cumsum(0) > 0

    def rule(x):
        x = torch.where(seen, torch.where(x < 0, x * penalty, x / penalty), x)
        steps = torch.arange(n, device=dev)
        forbid = (steps < max(min_steps, 1))[:, None] & (
            torch.arange(V, device=dev)[None] == eos)
        return x.masked_fill(forbid, float("-inf"))

    zr = rule(z.float())
    pick = tokens.long() if choose is None else rule(choose.float()).argmax(-1)
    return zr.max(-1).values - zr.gather(1, pick[:, None])[:, 0]
