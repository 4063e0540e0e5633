"""Text-to-semantic (T2S) autoregressive GPT decoder.

The port of ``genie_tts_tpu/models/t2s.py``: phoneme + BERT embedding,
HuBERT -> VQ prompt extraction, a prefill over the packed
``[text | prompt]`` sequence, then the AR decode loop with a
pre-allocated KV cache.

Static-shape layout per batch row (cache length S):

    [ 0 .............. Sx )   text block (right-padded, len x_len[b])
    [ Sx ......... Sx+Sp )    semantic prompt block (right-padded, len p_len[b])
    [ Sx+Sp ............ )    decoded tokens, step t lives at Sx+Sp+t

Decode routes of :func:`generate`: B = 1 runs each step as ONE launch of
the fused all-layer kernel (``ops/fused_decode.py``) over ``[L, S, D]``
caches; B > 1 runs the per-layer :func:`_layer_decode` with the
flash-decode attention kernel (``ops/flash_decode.py``) over
``[B, H, S, Dh]`` caches. Both write each step's K/V row into the cache in
place (the JAX package's write-buffered ``generate`` exists only for the
TPU's tiling; it computes the same tokens). The slot machine
(``models/slots.py``) decodes through :func:`_layer_decode_buffered`,
whose read-only big cache may hold int8 codes (``ops/int8_decode.py``).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import T2SConfig
from ..ops.flash_decode import flash_decode_attention
from ..ops.fused_decode import fused_decode_step, pack_decode_params
from ..ops.int8_decode import int8_big_attention
from ..ops.layers import (attention, layer_norm, linear, sine_position_table,
                          unstack)
from ..ops.sampling import SamplingConfig, gumbel_noise, sample_token

Params = Dict


# ---------------------------------------------------------------------------
# Initialization (random weights for tests and the chip smoke run; real
# weights come from converted checkpoints)
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: T2SConfig,
                dtype=torch.bfloat16) -> Params:
    """Random T2S weights on ``generator``'s device.

    Biases and LayerNorm scales/biases are random too, and differ from
    layer to layer, as a trained checkpoint's do, so whatever reads them
    (the fused decode kernel's per-layer offsets) is exercised."""
    dev = generator.device
    d, f, v = cfg.embed_dim, cfg.ffn_dim, cfg.semantic_vocab
    L = cfg.num_layers

    def randn(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dt)

    def dense(i, o, lead=()):
        return {"w": randn(*lead, i, o, std=i ** -0.5),
                "b": randn(*lead, o, std=0.1)}

    def ln():
        return {"scale": 1.0 + randn(L, d, std=0.1, dt=torch.float32),
                "bias": randn(L, d, std=0.1, dt=torch.float32)}

    return {
        "text_embed": randn(cfg.phoneme_vocab, d, std=0.02),
        "bert_proj": dense(cfg.bert_dim, d),
        "text_pos_alpha": torch.ones((), device=dev),
        "audio_embed": randn(v, d, std=0.02),
        "audio_pos_alpha": torch.ones((), device=dev),
        "layers": {
            "qkv": dense(d, 3 * d, (L,)),
            "out": dense(d, d, (L,)),
            "ffn1": dense(d, f, (L,)),
            "ffn2": dense(f, d, (L,)),
            "norm1": ln(),
            "norm2": ln(),
        },
        "predict": {"w": randn(d, v, std=d ** -0.5)},
        "ssl_proj": {"w": randn(2, cfg.ssl_dim, cfg.ssl_dim, std=0.03),
                     "b": randn(cfg.ssl_dim, std=0.1)},
        "codebook": randn(1024, cfg.ssl_dim, dt=torch.float32),
    }


def _quantize_dense(p: Params) -> Params:
    """Symmetric per-output-channel int8 weight quantization.

    w [..., in, out] -> int8 w + fp32 scale [..., out]; bias untouched."""
    w = p["w"].float()
    s = torch.clamp(w.abs().amax(dim=-2) / 127.0, min=1e-8)
    wq = torch.round(w / s[..., None, :]).to(torch.int8)
    out = {"w": wq, "scale": s}
    if "b" in p:
        out["b"] = p["b"]
    return out


def quantize_params(params: Params) -> Params:
    """Weight-only int8 quantization of the per-layer matmuls (embeddings,
    norms, the predict head and the encoder-side tensors stay as they
    are)."""
    layers = {k: v for k, v in params["layers"].items() if not k.startswith("_")}
    for k in ("qkv", "out", "ffn1", "ffn2"):
        layers[k] = _quantize_dense(layers[k])
    out = dict(params)
    out["layers"] = layers
    return out


# ---------------------------------------------------------------------------
# Encoder: text embedding + prompt token extraction
# ---------------------------------------------------------------------------

def embed_text(params: Params, phoneme_ids: torch.Tensor,
               bert: torch.Tensor) -> torch.Tensor:
    """[B,Tx] ids + [B,Tx,1024] bert -> positioned text states [B,Tx,D]."""
    x = params["text_embed"][phoneme_ids]
    x = x + linear(params["bert_proj"], bert.to(x.dtype))
    pe = sine_position_table(x.shape[1], x.shape[2], device=x.device)
    return x + (params["text_pos_alpha"] * pe).to(x.dtype)[None]


def extract_prompt_tokens(params: Params, ssl_content: torch.Tensor) -> torch.Tensor:
    """HuBERT features [B,Ts,768] -> semantic prompt ids [B,Ts//2].

    Conv(768,768,k2,s2) projection then the nearest codebook row, all in
    fp32 (the assignment must be exact)."""
    w = params["ssl_proj"]["w"].float()                      # [2, C, C]
    B, T, C = ssl_content.shape
    T2 = T // 2
    x = ssl_content.float()[:, :2 * T2].reshape(B, T2, 2 * C)
    x = x @ w.reshape(2 * C, C) + params["ssl_proj"]["b"].float()
    cb = params["codebook"].float()                          # [1024, C]
    dots = torch.einsum("btc,kc->btk", x, cb)
    c2 = (cb * cb).sum(-1)
    return torch.argmin(c2[None, None, :] - 2.0 * dots, dim=-1)


# ---------------------------------------------------------------------------
# Transformer core
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, num_heads, d // num_heads).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _layer_prefill(lp: Params, h: torch.Tensor, mask: torch.Tensor,
                   num_heads: int):
    """Post-LN transformer layer over the prefill sequence.
    Returns (hidden, (k, v)) with k/v [B, H, T, Dh]."""
    q, k, v = linear(lp["qkv"], h).chunk(3, dim=-1)
    q, k, v = (_split_heads(t, num_heads) for t in (q, k, v))
    att = attention(q, k, v, mask)
    h = layer_norm(lp["norm1"], h + linear(lp["out"], _merge_heads(att)))
    ff = linear(lp["ffn2"], torch.relu(linear(lp["ffn1"], h)))
    h = layer_norm(lp["norm2"], h + ff)
    return h, (k, v)


def _layer_decode(lp: Params, h: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: int, kv_mask: torch.Tensor,
                  num_heads: int) -> torch.Tensor:
    """One-token decode layer (the batched route). h: [B,1,D]; caches
    [B,H,S,Dh]; ``pos`` is the row-uniform write position (static text and
    prompt buckets + step). The new K/V row is written into the caches IN
    PLACE; attention runs through the flash-decode kernel."""
    q, k_new, v_new = linear(lp["qkv"], h).chunk(3, dim=-1)
    q = _split_heads(q, num_heads)[:, :, 0]                  # [B,H,Dh]
    k_cache[:, :, pos] = _split_heads(k_new, num_heads)[:, :, 0]
    v_cache[:, :, pos] = _split_heads(v_new, num_heads)[:, :, 0]
    att = flash_decode_attention(q.contiguous(), k_cache, v_cache, kv_mask)
    h = layer_norm(lp["norm1"], h + linear(lp["out"], _merge_heads(att[:, :, None])))
    ff = linear(lp["ffn2"], torch.relu(linear(lp["ffn1"], h)))
    return layer_norm(lp["norm2"], h + ff)


def _layer_decode_buffered(lp: Params, h: torch.Tensor, k_big, v_big,
                           k_buf: torch.Tensor, v_buf: torch.Tensor,
                           buf_mask: torch.Tensor, kv_mask, num_heads: int,
                           k_scale=None, v_scale=None, kv_kernel_ctx=None):
    """One-token decode layer against a read-only big cache + write buffer
    (the slot machine's route, ``models/slots.py::decode_segment``).

    h [B,1,D]; big caches kv-major [B,H,Dh,S] (one region, or a tuple of
    regions with a tuple of [B,S] masks); the segment's own columns in
    k_buf/v_buf [B,H,Dh,W] with buf_mask [W]. Attention is one softmax over
    [big | buffer | self]. Returns (h, k_new [B,H,Dh], v_new [B,H,Dh]); the
    caller stacks the new columns into the buffer.

    ``k_scale``/``v_scale`` [B,H,S]: per-column fp32 scales when the big
    caches hold int8 codes. ``kv_kernel_ctx`` = (x_len, p_len,
    keys_written, ring_head, sx, sp, ring), all segment-frozen: the
    big-cache attention then runs through ``ops/int8_decode.py`` (which
    recomputes visibility from these and returns flash partials), merged
    with the exact buffer and self columns in one log-sum-exp step."""
    q, k_new, v_new = linear(lp["qkv"], h).chunk(3, dim=-1)
    q = _split_heads(q, num_heads)                           # [B,H,1,Dh]
    k_new = _split_heads(k_new, num_heads)[:, :, 0]          # [B,H,Dh]
    v_new = _split_heads(v_new, num_heads)[:, :, 0]
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q[:, :, 0].float()                                  # [B,H,Dh]
    W = k_buf.shape[-1]
    if k_scale is not None and kv_kernel_ctx is not None:
        x_len, p_len, keys_written, ring_head, sx, sp, ring = kv_kernel_ctx
        o1, m1, l1 = int8_big_attention(
            q[:, :, 0].contiguous(), k_big, k_scale, v_big, v_scale,
            x_len, p_len, keys_written, ring_head, sx=sx, sp=sp, ring=ring)
        s_buf = torch.einsum("bhd,bhdw->bhw", qf, k_buf.float()) * scale
        s_buf = s_buf.masked_fill(~buf_mask[None, None, :], -1e10)
        s_self = (qf * k_new.float()).sum(-1, keepdim=True) * scale   # [B,H,1]
        s_rest = torch.cat([s_buf, s_self], dim=-1)                   # [B,H,W+1]
        m_tot = torch.maximum(m1, s_rest.amax(dim=-1))
        a1 = torch.exp(m1 - m_tot)
        p_rest = torch.exp(s_rest - m_tot[..., None])
        l_tot = l1 * a1 + p_rest.sum(dim=-1)
        att_f = (o1 * a1[..., None]
                 + torch.einsum("bhw,bhdw->bhd", p_rest[..., :W].to(dt).float(),
                                v_buf.float())
                 + p_rest[..., W:] * v_new.float())
        att = (att_f / l_tot[..., None]).to(dt)[:, :, None]
    else:
        # regions concatenate in score space: one softmax over
        # [regions... | buffer | self]
        def parts(x, n):
            return tuple(x) if isinstance(x, (tuple, list)) else (x,) * n

        kb_parts = parts(k_big, 1)
        vb_parts = parts(v_big, 1)
        n = len(kb_parts)
        mask_parts = parts(kv_mask, n)
        ks_parts, vs_parts = parts(k_scale, n), parts(v_scale, n)
        s_parts, v_parts = [], []
        for kb, vb, msk, ks, vs in zip(kb_parts, vb_parts, mask_parts,
                                       ks_parts, vs_parts):
            if vs is not None:        # int8 codes: dequantize V in q's dtype
                vb = vb.to(dt) * vs[:, :, None, :].to(dt)
            s = torch.einsum("bhd,bhds->bhs", qf, kb.to(dt).float()) * scale
            if ks is not None:
                s = s * ks
            s_parts.append(s.masked_fill(~msk[:, None, :], -1e10))
            v_parts.append(vb)
        s_buf = torch.einsum("bhd,bhdw->bhw", qf, k_buf.float()) * scale
        s_buf = s_buf.masked_fill(~buf_mask[None, None, :], -1e10)
        s_self = (qf * k_new.float()).sum(-1, keepdim=True) * scale
        probs = torch.softmax(torch.cat(s_parts + [s_buf, s_self], dim=-1),
                              dim=-1).to(dt).float()
        att = torch.zeros_like(qf).to(dt)
        off = 0
        for s, vb in zip(s_parts, v_parts):
            w = s.shape[-1]
            att = att + torch.einsum("bhs,bhds->bhd", probs[..., off:off + w],
                                     vb.float()).to(dt)
            off += w
        att = (att
               + torch.einsum("bhw,bhdw->bhd", probs[..., off:off + W],
                              v_buf.float()).to(dt)
               + (probs[..., off + W:] * v_new.float()).to(dt))[:, :, None]
    h = layer_norm(lp["norm1"], h + linear(lp["out"], _merge_heads(att)))
    ff = linear(lp["ffn2"], torch.relu(linear(lp["ffn1"], h)))
    h = layer_norm(lp["norm2"], h + ff)
    return h, k_new, v_new


# ---------------------------------------------------------------------------
# Generate: prefill + AR decode
# ---------------------------------------------------------------------------

class GenerateResult(NamedTuple):
    tokens: torch.Tensor   # [B, max_steps] semantic tokens (incl. final EOS/0)
    counts: torch.Tensor   # [B] number of emitted tokens
    steps: int             # loop counter at exit (decode launches + 1)


def _prefill_mask(Sx: int, Sp: int, x_len: torch.Tensor,
                  p_len: torch.Tensor) -> torch.Tensor:
    """[B, S_pre, S_pre] bool attention mask for the packed prefill sequence."""
    S = Sx + Sp
    dev = x_len.device
    qi = torch.arange(S, device=dev)[None, :, None]
    kj = torch.arange(S, device=dev)[None, None, :]
    x_len = x_len[:, None, None]
    p_len = p_len[:, None, None]
    k_is_text = kj < x_len
    k_is_prompt = (kj >= Sx) & (kj < Sx + p_len)
    q_is_text = qi < Sx
    # text query: attends text block only; audio query: text + causal prompt
    causal = kj <= qi
    return torch.where(q_is_text, k_is_text, k_is_text | (k_is_prompt & causal))


def prefill(params: Params, cfg: T2SConfig, x: torch.Tensor, x_len: torch.Tensor,
            prompts: torch.Tensor, p_len: torch.Tensor, cache_len: int
            ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run the packed sequence through all layers and build the KV cache.

    Returns (logits_first [B, V] fp32, (k_cache, v_cache) each
    [L, B, H, cache_len, Dh], zero past the prefill)."""
    B, Sx, D = x.shape
    Sp = prompts.shape[1]
    H, L, Dh = cfg.num_heads, cfg.num_layers, cfg.head_dim
    y_emb = params["audio_embed"][prompts]
    pe = sine_position_table(Sp, D, device=x.device)
    y = y_emb + (params["audio_pos_alpha"] * pe).to(y_emb.dtype)[None]
    h = torch.cat([x, y], dim=1)                              # [B, S_pre, D]
    mask = _prefill_mask(Sx, Sp, x_len, p_len)[:, None]       # [B,1,S,S]
    k_cache = torch.zeros((L, B, H, cache_len, Dh), dtype=h.dtype, device=h.device)
    v_cache = torch.zeros_like(k_cache)
    for l, lp in enumerate(unstack(params["layers"])):
        h, (k, v) = _layer_prefill(lp, h, mask, H)
        k_cache[l, :, :, :Sx + Sp] = k
        v_cache[l, :, :, :Sx + Sp] = v
    last_idx = Sx + p_len - 1                                 # [B]
    h_last = h[torch.arange(B, device=h.device), last_idx]   # [B, D]
    logits = h_last.float() @ params["predict"]["w"].float()
    return logits, (k_cache, v_cache)


def generate(params: Params, cfg: T2SConfig, scfg: SamplingConfig,
             generator: Optional[torch.Generator], x: torch.Tensor,
             x_len: torch.Tensor, prompts: torch.Tensor, p_len: torch.Tensor,
             max_steps: int, cache_len: int, min_steps: int = 0,
             max_steps_dyn: Optional[int] = None) -> GenerateResult:
    """Prefill + sample + full AR decode.

    ``min_steps``: EOS may not fire before this many tokens. ``max_steps``:
    the static cap that sizes the token buffer and the Gumbel table (drawn
    from ``generator`` up front); ``max_steps_dyn``: an optional per-call
    cap <= max_steps.
    """
    ms_dyn = max_steps if max_steps_dyn is None else min(int(max_steps_dyn), max_steps)
    B, Sx, D = x.shape
    Sp = prompts.shape[1]
    H, L, V, eos = cfg.num_heads, cfg.num_layers, cfg.semantic_vocab, cfg.eos_id
    dev = x.device

    logits0, (k_cache, v_cache) = prefill(params, cfg, x, x_len, prompts,
                                          p_len, cache_len)

    # histogram of emitted tokens for the repetition penalty (prompt included)
    hist = torch.zeros((B, V), dtype=torch.int64, device=dev)
    prompt_valid = torch.arange(Sp, device=dev)[None, :] < p_len[:, None]
    hist.scatter_add_(1, prompts.long(), prompt_valid.long())

    noise = gumbel_noise((max_steps, B, V), generator, dev)

    # first token: EOS forbidden (GPT-SoVITS masks EOS on the first draw)
    forbid_eos = torch.zeros((V,), dtype=torch.bool, device=dev)
    forbid_eos[eos] = True
    tok0 = sample_token(None, logits0, hist, scfg, forbid=forbid_eos, noise=noise[0])
    tokens = torch.zeros((B, max_steps), dtype=torch.int64, device=dev)
    tokens[:, 0] = tok0
    hist += torch.nn.functional.one_hot(tok0, V)

    kv_positions = torch.arange(cache_len, device=dev)[None, :]
    pe_full = sine_position_table(cache_len, D, device=dev)
    predict_w = params["predict"]["w"].float()
    audio_embed, alpha = params["audio_embed"], params["audio_pos_alpha"]
    static_mask = ((kv_positions < x_len[:, None])
                   | ((kv_positions >= Sx) & (kv_positions < Sx + p_len[:, None])))

    if B == 1:
        # fused route: one kernel launch per step over [L, S, D] caches
        packed = pack_decode_params(params)
        kf = k_cache[:, 0].transpose(1, 2).reshape(L, cache_len, D).contiguous()
        vf = v_cache[:, 0].transpose(1, 2).reshape(L, cache_len, D).contiguous()
        del k_cache, v_cache
    else:
        layers = unstack(params["layers"])

    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    counts = torch.ones((B,), dtype=torch.int64, device=dev)
    step = 1
    while step < ms_dyn and not bool(done.all()):
        cur_tok = tokens[:, step - 1]
        emb = audio_embed[cur_tok]                              # [B, D]
        pos_emb = pe_full[p_len + step - 1]                     # [B, D]
        h = emb + (alpha * pos_emb).to(emb.dtype)
        # keys visible: valid text, valid prompt, decoded tokens so far
        kv_mask = static_mask | ((kv_positions >= Sx + Sp)
                                 & (kv_positions <= Sx + Sp + step - 1))
        pos = Sx + Sp + step - 1       # row-uniform write position
        if B == 1:
            h_last, _, _ = fused_decode_step(
                packed, h.float(), kf, vf, pos, kv_mask[0].float(), num_heads=H)
        else:
            hb = h[:, None]
            for l, lp in enumerate(layers):
                hb = _layer_decode(lp, hb, k_cache[l], v_cache[l], pos, kv_mask, H)
            h_last = hb[:, 0]
        logits = h_last.float() @ predict_w                     # [B, V]

        # below min_steps EOS is masked out of sampling entirely
        nxt = sample_token(None, logits, hist, scfg,
                           forbid=forbid_eos if step < min_steps else None,
                           noise=noise[min(step, max_steps - 1)])
        argmax_eos = torch.argmax(logits, dim=-1) == eos
        now_done = (argmax_eos | (nxt == eos)) & (step >= min_steps)
        active = ~done
        nxt = torch.where(active, nxt, torch.full_like(nxt, eos))  # freeze finished rows
        write = min(step, max_steps - 1)
        tokens[:, write] = torch.where(active, nxt, tokens[:, write])
        hist += torch.nn.functional.one_hot(nxt, V) * active[:, None]
        counts = torch.where(active, torch.full_like(counts, step + 1), counts)
        done = done | now_done | (step + 1 >= ms_dyn)
        step += 1
    return GenerateResult(tokens=tokens, counts=counts, steps=step)


def finalize_tokens_device(tokens: torch.Tensor, counts: torch.Tensor,
                           eos_id: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes [B, max_steps] zero-padded, codes_len [B]): the final emitted
    token becomes semantic code 0 (a reference quirk), then the codes end
    at the first remaining token >= EOS."""
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device)[None, :]
    in_range = pos < counts[:, None]
    tokens = torch.where(pos == counts[:, None] - 1, torch.zeros_like(tokens), tokens)
    bad = (tokens >= eos_id) & in_range
    first_bad = torch.where(bad, pos, torch.full_like(pos, S)).amin(dim=1)
    codes_len = torch.minimum(counts, first_bad)
    codes = torch.where(pos < codes_len[:, None], tokens, torch.zeros_like(tokens))
    return codes, codes_len


def generate_e2e(params: Params, cfg: T2SConfig, scfg: SamplingConfig,
                 generator: Optional[torch.Generator], phones: torch.Tensor,
                 bert: Optional[torch.Tensor], x_len: torch.Tensor,
                 prompts: torch.Tensor, p_len: torch.Tensor, max_steps: int,
                 cache_len: int, min_steps: int = 0,
                 max_steps_dyn: Optional[int] = None,
                 stats: Optional[dict] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embed + prefill + AR decode + EOS finalize.

    Returns (codes [B, max_steps], codes_len [B]). ``stats``: optional
    dict that receives ``decode_steps`` (loop iterations run) and
    ``cache_len``."""
    if bert is None:
        bert = torch.zeros(phones.shape + (cfg.bert_dim,), device=phones.device)
    x = embed_text(params, phones, bert)
    res = generate(params, cfg, scfg, generator, x, x_len, prompts, p_len,
                   max_steps=max_steps, cache_len=cache_len,
                   min_steps=min_steps, max_steps_dyn=max_steps_dyn)
    if stats is not None:
        stats["decode_steps"] = res.steps - 1
        stats["cache_len"] = cache_len
    return finalize_tokens_device(res.tokens, res.counts, cfg.eos_id)


def finalize_semantic_tokens(tokens, counts, eos_id: int = 1024):
    """Host-side post-processing matching the reference quirks: the final
    emitted token becomes semantic code 0, then anything >= ``eos_id``
    that remains ends the codes. Returns a list of 1-D numpy arrays."""
    tokens = np.asarray(tokens)
    counts = np.asarray(counts)
    out = []
    for row, cnt in zip(tokens, counts):
        seq = row[: int(cnt)].copy()
        if len(seq):
            seq[-1] = 0
        bad = np.nonzero(seq >= eos_id)[0]
        if len(bad):
            seq = seq[: bad[0]]
        out.append(seq)
    return out
