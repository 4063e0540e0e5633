"""GPT-SoVITS V4's synthesizer: codes -> mel by conditional flow matching
-> 48 kHz waveform.

``SynthesizerTrnV3`` with ``version="v4"`` (GPT-SoVITS
``module/models.py``; the DiT is F5-TTS's ``backbones/dit.py``). V4 keeps
V2's text side (``models/sovits.py``: quantizer, relative-attention
encoders, MRTE, the style encoder over the first 704 spectrogram bins)
and replaces the flow and the 32 kHz HiFi-GAN:

  :func:`decode_encp`: codes (25 Hz) -> 2x nearest (50 Hz) -> V2's text
  encoder up to its hidden output -> ``bridge`` (1x1 conv, LeakyReLU
  0.01) -> 2x nearest (100 Hz, 4 frames a code) -> ``wns1`` (1x1 conv,
  WaveNet conditioned on ``ge``, 1x1 conv) = ``fea`` [B, 4n, 512];

  the chunk loop (:func:`cfm_rows`): ``fea`` in slices of ``T_chunk -
  P`` frames, each CFM run on ``mu = cat(fea_ref, slice)`` prompted with
  ``mel2`` (P frames) and keeping the frames after the prompt; the next
  chunk's prompt is the last P output frames and the last P frames of
  the slice;

  CFM (Euler, ``sample_steps``, no CFG): ``x ~ N(0, 1)``, the prompt
  region zeroed; ``v = DiT(x, cond, mu, t, d)``, ``x += d v``, ``t +=
  d``, the prompt region zeroed again; the text and ``d`` embeddings are
  computed once a chunk (upstream's conditioner cache);

  the vocoder: V2's ``hifigan`` at V4's rates (``V4Config``), no speaker
  input, a biased ``conv_post``: 100 mel bands at 100 frames/s -> 48 kHz.

The DiT computes in its weights' dtype (the configuration's, bfloat16 on
the card); the Euler state, ``decode_encp``, the mels and the vocoder
are float32. Each row of a batch is masked so that it equals itself run
alone: keys past a row's length are masked in attention, and every
convolution over time (ConvNeXt's depthwise conv, the convolutional
position embedding) and GRN's norm over time read zeros there.

A row's CFM noise is a function of the request alone (:func:`cfm_noise`:
its ``cfm_seed`` and the chunk's index), never of its batch-mates or
its row.

The device programs (``runtime/graphs.py``, the SoVITS family of the
configuration): ``decode_encp`` at (B, codes, text) buckets, a chunk's
whole Euler loop at (rows, frames, steps), and the vocoder at (B,
window) widths, each captured once and replayed. Rotary: F5-TTS's
``AttnProcessor`` applies x-transformers' ``apply_rotary_pos_emb`` with
``RotaryEmbedding(dim_head)`` to the projected rows BEFORE the split
into heads, so only the first ``dim_head`` channels (the first head)
rotate, in interleaved pairs; the rest pass through.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from ..config import SoVITSConfig, V4Config
from ..ops import dit_glue
from ..ops.audio import log_mel_spectrogram
from ..ops.layers import conv1d, unstack
from ..runtime import graphs
from ..runtime.buckets import pick_bucket
from ..utils.metrics import metrics
from . import sovits

Params = Dict

# the style encoder reads the first 704 bins of the clip's linear spectrogram
REF_ENC_BINS = 704
# a chunk's frames (prompt + new) are padded to one of these (at most
# T_chunk): coarse, since each bucket's graph holds a whole Euler loop and
# is captured before traffic; the narration cell's chunks hold 662-1000
# frames but a short last one, so no lower bucket
CFM_FRAME_BUCKETS = (768, 896, 1000)
# norm_spec / denorm_spec: log-mel range [-12, 2] <-> [-1, 1]
SPEC_MIN, SPEC_MAX = -12.0, 2.0


def norm_spec(x: torch.Tensor) -> torch.Tensor:
    return (x - SPEC_MIN) / (SPEC_MAX - SPEC_MIN) * 2 - 1


def denorm_spec(x: torch.Tensor) -> torch.Tensor:
    return (x + 1) / 2 * (SPEC_MAX - SPEC_MIN) + SPEC_MIN


def reference_mel(audio_32k: torch.Tensor, cfg: V4Config) -> torch.Tensor:
    """The prompt mel of a clip (``inference_webui.py``'s ``mel_fn_v4``
    then ``norm_spec``): [S] at 32 kHz -> [S // hop, mel_dim] fp32."""
    mel = log_mel_spectrogram(audio_32k[None], cfg.mel_n_fft, cfg.mel_hop, cfg.mel_win,
                              cfg.mel_dim, cfg.mel_sample_rate, cfg.mel_fmin, cfg.mel_fmax)
    return norm_spec(mel[0])


def prompt_features(mel2: torch.Tensor, fea_ref: torch.Tensor, cfg: V4Config):
    """(mel2, fea_ref) cut to their common length, and to the last
    ``T_ref`` frames beyond it."""
    t_min = min(mel2.shape[0], fea_ref.shape[0])
    mel2, fea_ref = mel2[:t_min], fea_ref[:t_min]
    if t_min > cfg.T_ref:
        mel2, fea_ref = mel2[-cfg.T_ref:], fea_ref[-cfg.T_ref:]
    return mel2.contiguous(), fea_ref.contiguous()


# ---------------------------------------------------------------------------
# decode_encp: codes -> the mel-rate features
# ---------------------------------------------------------------------------

def decode_encp(params: Params, scfg: SoVITSConfig, cfg: V4Config, codes: torch.Tensor,
                codes_len: torch.Tensor, text_ids: torch.Tensor, text_len: torch.Tensor,
                ge: torch.Tensor) -> torch.Tensor:
    """Codes [B, n] -> ``fea`` [B, 4n, fea_channels] (masked past each
    row's 4 x codes_len frames). ``ge`` [B, gin, 1] is both the MRTE's
    and the WaveNet's speaker input (gin = mrte = 512)."""
    latent = sovits.quantizer_decode(params, codes)              # [B, 2n, vq]
    B, T50, _ = latent.shape
    dev = latent.device
    y_mask = (torch.arange(T50, device=dev)[None, :]
              < 2 * codes_len[:, None]).to(latent.dtype)[..., None]
    t_mask = (torch.arange(text_ids.shape[1], device=dev)[None, :]
              < text_len[:, None]).to(latent.dtype)[..., None]
    x = sovits.text_hidden(params, scfg, latent, y_mask, text_ids, t_mask, ge)
    fea = F.leaky_relu(conv1d(params["bridge"], x), 0.01)
    half = cfg.frames_per_code // 2
    fea = fea.repeat_interleave(half, dim=1)                      # 50 Hz -> 100 Hz
    T = fea.shape[1]
    mask = (torch.arange(T, device=dev)[None, :]
            < cfg.frames_per_code * codes_len[:, None]).to(fea.dtype)[..., None]
    w = params["wns1"]
    h = conv1d(w["pre"], fea) * mask
    h = sovits.wavenet(w["enc"], h, mask, ge, cfg.wn_layers, cfg.fea_channels, cfg.wn_kernel)
    return conv1d(w["proj"], h) * mask


# ---------------------------------------------------------------------------
# The DiT
# ---------------------------------------------------------------------------

def _dense(p, x):
    """``x @ w + b`` as one GEMM with its bias (x, w and b in one dtype)."""
    return F.linear(x, p["w"].t(), p["b"])


def timestep_embed(p, t: float, cfg: V4Config, dtype) -> torch.Tensor:
    """F5-TTS's ``TimestepEmbedding`` of the scalar ``t``: a sinusoid of
    ``freq_embed_dim`` (scale 1000, ``sin`` before ``cos``, computed in
    float32), then Linear, SiLU, Linear. -> [1, dim]."""
    dev = p["fc1"]["w"].device
    half = cfg.freq_embed_dim // 2
    k = torch.exp(torch.arange(half, device=dev, dtype=torch.float32)
                  * -(math.log(10000.0) / (half - 1)))
    e = 1000.0 * float(t) * k
    h = torch.cat([e.sin(), e.cos()])[None].to(dtype)
    return _dense(p["fc2"], F.silu(_dense(p["fc1"], h)))


def _freqs_cis(T: int, dim: int, device) -> torch.Tensor:
    """``precompute_freqs_cis(dim)[:T]``: cat(cos, sin) of pos x 10000^(-2i/dim)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)[: dim // 2].float() / dim))
    f = torch.outer(torch.arange(T, device=device, dtype=torch.float32), inv)
    return torch.cat([f.cos(), f.sin()], dim=-1)


def text_embed(p, mu: torch.Tensor, maskf: torch.Tensor) -> torch.Tensor:
    """F5-TTS's ``TextEmbedding`` over the mel-rate features: ``mu`` [R, T,
    C] plus the sinusoidal positions, then the ConvNeXt-V2 blocks
    (depthwise conv k7, LayerNorm, Linear, exact GELU, GRN over time,
    Linear, residual), each row masked to its length."""
    x = mu + _freqs_cis(mu.shape[1], mu.shape[2], mu.device).to(mu.dtype)
    C = x.shape[-1]
    for lp in unstack(p):
        r = x
        y = conv1d(lp["dw"], x * maskf, padding=(lp["dw"]["w"].shape[0] - 1) // 2, groups=C)
        y = F.layer_norm(y, (C,), lp["norm"]["scale"], lp["norm"]["bias"], eps=1e-6)
        y = F.gelu(_dense(lp["pw1"], y))
        g = torch.linalg.vector_norm((y * maskf).float(), dim=1, keepdim=True)
        n = (g / (g.mean(dim=-1, keepdim=True) + 1e-6)).to(y.dtype)
        y = lp["grn"]["gamma"].to(y.dtype) * (y * n) + lp["grn"]["beta"].to(y.dtype) + y
        x = r + _dense(lp["pw2"], y)
    return x


def _conv_pos(convs, h: torch.Tensor, maskf: torch.Tensor, groups: int) -> torch.Tensor:
    """``ConvPositionEmbedding``: two (grouped conv, Mish), each over zeros
    past the row's length."""
    for c in convs:
        h = F.mish(conv1d(c, h * maskf, padding=(c["w"].shape[0] - 1) // 2, groups=groups))
    return h * maskf


def _rope(T: int, dim: int, device):
    inv = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device).float() / dim))
    f = torch.outer(torch.arange(T, device=device, dtype=torch.float32), inv)
    f = torch.stack([f, f], dim=-1).flatten(-2)                 # [T, dim], pairs
    return f.cos(), f.sin()


def _key_mask(mask: torch.Tensor, dtype) -> torch.Tensor:
    """The attention's additive key mask [R, 1, 1, T] (0 where a key is
    valid, -inf past the row's length), as SDPA converts a boolean one:
    made once a forward instead of by each block's attention."""
    return torch.zeros(mask[:, None, None, :].shape, dtype=dtype, device=mask.device
                       ).masked_fill_(~mask[:, None, None, :], float("-inf"))


def dit(p, cfg: V4Config, x, cond, text, t_emb, mask, rope) -> torch.Tensor:
    """The DiT's velocity [R, T, mel_dim] (the DiT's dtype) for the noisy
    mel ``x``, the prompt ``cond`` and the text embedding ``text`` (all
    [R, T, *] in the DiT's dtype), the time embedding ``t_emb`` [1, dim];
    ``mask`` [R, T] bool, the rows' valid frames. Frames past a row's
    length feed only frames past it after the input embedding (keys there
    are masked), so the attention output is not zeroed there.

    Between the GEMMs and the attention a block runs two kernels of
    ``ops/dit_glue.py`` (their plain versions on the CPU): the rotary of q
    and k (``dit_rope``), and each gated residual with the
    adaLN-modulated LayerNorm after it (``dit_adanorm``): the input's
    ``h + conv_pos(h)`` with block 0's attention norm, each attention
    residual with its block's FF norm, each FF residual with the next
    block's attention norm or, after the last, ``norm_out``'s."""
    maskf = mask[..., None].to(x.dtype)
    h = _dense(p["input"]["proj"], torch.cat([x, cond, text], dim=-1))
    cos, sin = rope
    H, Dh = cfg.dit_heads, cfg.dit_head_dim
    attn_mask = _key_mask(mask, x.dtype)
    st = F.silu(t_emb)
    blocks = unstack(p["blocks"])
    # each block's (shift, scale, gate) of its attention, then of its FF;
    # the (scale, shift) of the norm after each block: the next block's
    # attention norm, after the last ``norm_out``'s
    mods = [_dense(lp["ada"], st).chunk(6, dim=-1) for lp in blocks]
    nexts = [(m[1], m[0]) for m in mods[1:]] + [_dense(p["norm_out"], st).chunk(2, dim=-1)]
    y = _conv_pos(p["input"]["conv_pos"], h, maskf, cfg.conv_pos_groups).contiguous()
    h, n = dit_glue.dit_adanorm(h, mods[0][1], mods[0][0], y=y)
    for lp, (_, _, g_a, sh_f, sc_f, g_f), (scale, shift) in zip(blocks, mods, nexts):
        q, k, v = _dense(lp["q"], n), _dense(lp["k"], n), _dense(lp["v"], n)
        dit_glue.dit_rope(q, k, cos, sin)
        q, k, v = (a.unflatten(-1, (H, Dh)).transpose(1, 2) for a in (q, k, v))
        a = F.scaled_dot_product_attention(q, k, v, attn_mask=attn_mask)
        y = _dense(lp["out"], a.transpose(1, 2).flatten(-2))
        h, n = dit_glue.dit_adanorm(h, sc_f, sh_f, y=y, g=g_a)
        y = _dense(lp["ff2"], F.gelu(_dense(lp["ff1"], n), approximate="tanh"))
        h, n = dit_glue.dit_adanorm(h, scale, shift, y=y, g=g_f)
    return _dense(p["proj_out"], n)


def euler_step(x: torch.Tensor, v: torch.Tensor, d: float) -> torch.Tensor:
    """One Euler step of the flow: ``x + d v`` (float32)."""
    return x + d * v.float()


def zero_prompt(x: torch.Tensor, pmask: torch.Tensor) -> torch.Tensor:
    """``x[..., :P] = 0``: the prompt region of each row."""
    return x.masked_fill(pmask[..., None], 0.0)


def cfm_sample(p, cfg: V4Config, mu, prompt, noise, lens, plens, steps: int) -> torch.Tensor:
    """``CFM.inference`` with ``inference_cfg_rate`` 0 over a batch of rows:
    ``mu`` [R, T, C], the prompt mel ``prompt`` [R, T, M] (read in each
    row's first ``plens`` frames), the standard-normal ``noise`` [R, T, M]
    (float32); ``lens`` [R] valid frames. Returns the sampled mel [R, T,
    M] float32 (the prompt region zero)."""
    dt = p["proj_out"]["w"].dtype
    R, T, _ = mu.shape
    ar = torch.arange(T, device=mu.device)[None, :]
    mask = ar < lens[:, None]
    pmask = ar < plens[:, None]
    cond = prompt.masked_fill(~pmask[..., None], 0.0).to(dt)
    maskf = mask[..., None].to(dt)
    text = text_embed(p["text_blocks"], mu.to(dt), maskf)      # once a chunk
    d = 1.0 / steps
    d_emb = timestep_embed(p["d_embed"], d, cfg, dt)           # once a chunk
    rope = _rope(T, cfg.dit_head_dim, mu.device)
    x = zero_prompt(noise.float(), pmask)
    t = 0.0
    for _ in range(steps):
        t_emb = timestep_embed(p["time_embed"], t, cfg, dt) + d_emb
        v = dit(p, cfg, x.to(dt), cond, text, t_emb, mask, rope)
        x = zero_prompt(euler_step(x, v, d), pmask)
        t = t + d
    return x


def cfm_noise(seed: int, chunk: int, frames: int, mel_dim: int, device) -> torch.Tensor:
    """The standard-normal noise [frames, mel_dim] float32 of chunk
    ``chunk`` of a request drawn with ``seed``: a generator on ``device``
    seeded with ``seed x 1000003 + chunk`` (mod 2^63)."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 1000003 + int(chunk)) % 2 ** 63)
    return torch.randn((frames, mel_dim), generator=g, device=device, dtype=torch.float32)


# ---------------------------------------------------------------------------
# The programs over static buffers (runtime/graphs.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class EncpBuffers:
    codes: torch.Tensor        # [B, n] int64
    codes_len: torch.Tensor    # [B] int64
    text: torch.Tensor         # [B, Tt] int64
    text_len: torch.Tensor     # [B] int64
    ge: torch.Tensor           # [B, gin, 1] fp32
    fea: torch.Tensor          # [B, 4n, C] fp32, the output


@dataclasses.dataclass
class CFMBuffers:
    mu: torch.Tensor           # [R, T, C] fp32
    prompt: torch.Tensor       # [R, T, M] fp32
    noise: torch.Tensor        # [R, T, M] fp32
    lens: torch.Tensor         # [R] int64
    plens: torch.Tensor        # [R] int64
    out: torch.Tensor          # [R, T, M] fp32, the output


@dataclasses.dataclass
class MelBuffers:
    mel: torch.Tensor          # [B, W, M] fp32 (denormalised)
    valid: torch.Tensor        # [B] int64
    audio: torch.Tensor        # [B, W * hop] fp32, the output


def _encp_program(params, scfg, cfg, b: EncpBuffers) -> None:
    b.fea.copy_(decode_encp(params, scfg, cfg, b.codes, b.codes_len, b.text, b.text_len, b.ge))


def _cfm_program(params, cfg, steps, b: CFMBuffers) -> None:
    b.out.copy_(cfm_sample(params["cfm"], cfg, b.mu, b.prompt, b.noise, b.lens, b.plens, steps))


def _vocode_program(params, cfg, b: MelBuffers) -> None:
    b.audio.copy_(sovits.hifigan(params["dec"], b.mel, None, cfg, frames_len=b.valid))


def _to_device(values, dev) -> torch.Tensor:
    """Host integers on ``dev`` without waiting for the device (a pinned,
    non-blocking copy)."""
    t = torch.tensor(values, dtype=torch.int64)
    return t.pin_memory().to(dev, non_blocking=True) if dev.type == "cuda" else t


def _zeros(dev, *shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=dev)


def encp_graph(params, scfg: SoVITSConfig, cfg: V4Config, B: int, n: int, Tt: int):
    dev = params["quantizer_embed"].device

    def make():
        ones = torch.ones((B,), dtype=torch.int64, device=dev)
        return EncpBuffers(codes=_zeros(dev, B, n, dtype=torch.int64), codes_len=ones.clone(),
                           text=_zeros(dev, B, Tt, dtype=torch.int64), text_len=ones.clone(),
                           ge=_zeros(dev, B, scfg.gin_channels, 1),
                           fea=_zeros(dev, B, cfg.frames_per_code * n, cfg.fea_channels))

    g = graphs.cache_for(params).graph(("v4_encp", B, n, Tt), make)
    return g, functools.partial(_encp_program, params, scfg, cfg)


def cfm_graph(params, cfg: V4Config, R: int, T: int, steps: int):
    dev = params["quantizer_embed"].device

    def make():
        ones = torch.ones((R,), dtype=torch.int64, device=dev)
        return CFMBuffers(mu=_zeros(dev, R, T, cfg.fea_channels),
                          prompt=_zeros(dev, R, T, cfg.mel_dim),
                          noise=_zeros(dev, R, T, cfg.mel_dim),
                          lens=ones * T, plens=ones.clone(),
                          out=_zeros(dev, R, T, cfg.mel_dim))

    g = graphs.cache_for(params).graph(("cfm", R, T, steps), make)
    return g, functools.partial(_cfm_program, params, cfg, steps)


def vocode_graph(params, cfg: V4Config, B: int, W: int):
    dev = params["quantizer_embed"].device

    def make():
        return MelBuffers(mel=_zeros(dev, B, W, cfg.mel_dim),
                          valid=torch.full((B,), W, dtype=torch.int64, device=dev),
                          audio=_zeros(dev, B, W * cfg.hop_length))

    g = graphs.cache_for(params).graph(("v4_vocode", B, W), make)
    return g, functools.partial(_vocode_program, params, cfg)


def prepare(params, cfg: V4Config, stage: str, key: tuple, scfg: SoVITSConfig) -> None:
    """Capture the ``decode_encp`` (``stage`` "v4_encp", ``key`` (B, n,
    Tt)), CFM ("cfm", (R, T, steps)) or vocoder ("v4_vocode", (B, W))
    program of the configuration of ``params`` with the set bound (a
    warmup unit)."""
    with graphs.cache_for(params).bind(params) as params:
        if stage == "v4_encp":
            g, fn = encp_graph(params, scfg, cfg, *key)
        elif stage == "cfm":
            g, fn = cfm_graph(params, cfg, *key)
        else:
            g, fn = vocode_graph(params, cfg, *key)
        with g.lock:
            g.prepare(fn)


def encp(params, scfg: SoVITSConfig, cfg: V4Config, codes, codes_len, text, text_len,
         ge) -> torch.Tensor:
    """:func:`decode_encp` as its program (a graph replay on the card).
    Returns ``fea`` [B, 4n, C] (the caller's copy)."""
    B, n = codes.shape
    with graphs.cache_for(params).bind(params) as params:
        g, fn = encp_graph(params, scfg, cfg, B, n, text.shape[1])
        with g.lock:
            b = g.static
            b.codes.copy_(codes)
            b.codes_len.copy_(codes_len)
            b.text.copy_(text)
            b.text_len.copy_(text_len)
            b.ge.copy_(ge)
            g.run(fn)
            return b.fea.clone()


@dataclasses.dataclass
class Row:
    """One request in the chunk loop: its ``fea`` [F, C] (its valid
    frames), the reference's prompt (``fea_ref`` [P, C], ``mel2`` [P, M],
    normalised) and its CFM seed."""
    fea: torch.Tensor
    fea_ref: torch.Tensor
    mel2: torch.Tensor
    seed: int


def cfm_buckets(cfg: V4Config) -> tuple:
    """The frame ladder of the CFM program: :data:`CFM_FRAME_BUCKETS` capped
    at ``T_chunk``, the most frames a chunk has, and ``T_chunk`` itself."""
    return tuple(sorted({min(b, cfg.T_chunk) for b in CFM_FRAME_BUCKETS} | {cfg.T_chunk}))


def _chunk_plan(row: Row, cfg: V4Config) -> list:
    """(start, stop) of each slice of the row's ``fea``."""
    step = cfg.T_chunk - row.fea_ref.shape[0]
    F_ = row.fea.shape[0]
    return [(s, min(s + step, F_)) for s in range(0, F_, step)]


def cfm_rows(params, cfg: V4Config, rows: List[Row], batch_buckets,
             events: Optional[list] = None) -> List[torch.Tensor]:
    """The chunk loop over ``rows``: the chunks of one index, across rows,
    share one launch of the CFM program at (rows bucket, frame bucket,
    ``sample_steps``), padded with copies of the first row. Returns each row's
    sampled mel [F, M] (normalised). Everything is enqueued; nothing is
    read back. ``events``: where each launch's (start, end) CUDA events
    go, on the card (the caller reads them once the work is done)."""
    dev = rows[0].fea.device
    steps = cfg.sample_steps
    plans = [_chunk_plan(r, cfg) for r in rows]
    state = [(r.fea_ref, r.mel2) for r in rows]
    outs: List[list] = [[] for _ in rows]
    for k in range(max(map(len, plans), default=0)):
        live = [i for i, p in enumerate(plans) if k < len(p)]
        R = len(live)
        R_pad = max(pick_bucket(R, batch_buckets), R)
        lens = [state[i][0].shape[0] + plans[i][k][1] - plans[i][k][0] for i in live]
        T = pick_bucket(max(lens), cfm_buckets(cfg))
        with metrics.timer("v4_cfm"):
            with graphs.cache_for(params).bind(params) as bank:
                g, fn = cfm_graph(bank, cfg, R_pad, T, steps)
                with g.lock:
                    b = g.static
                    for buf in (b.mu, b.prompt, b.noise):
                        buf.zero_()
                    order = live + [live[0]] * (R_pad - R)
                    for j, i in enumerate(order):
                        s0, s1 = plans[i][k]
                        fref, mel2 = state[i]
                        P = fref.shape[0]
                        n = P + s1 - s0
                        b.mu[j, :P].copy_(fref)
                        b.mu[j, P:n].copy_(rows[i].fea[s0:s1])
                        b.prompt[j, :P].copy_(mel2)
                        b.noise[j, :n].copy_(cfm_noise(rows[i].seed, k, n, cfg.mel_dim, dev))
                    b.lens.copy_(_to_device([state[i][0].shape[0] + plans[i][k][1]
                                             - plans[i][k][0] for i in order], dev))
                    b.plens.copy_(_to_device([state[i][0].shape[0] for i in order], dev))
                    ev = None
                    if dev.type == "cuda" and events is not None:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                    with metrics.device_span("cfm_device", dev, rows=R, frames=T, steps=steps):
                        g.run(fn)
                    if ev is not None:
                        ev[1].record()
                        events.append(ev)
                    for j, i in enumerate(live):
                        s0, s1 = plans[i][k]
                        P = state[i][0].shape[0]
                        new = b.out[j, P:P + s1 - s0].clone()
                        outs[i].append(new)
                        state[i] = (rows[i].fea[s0:s1][-P:], new[-P:])
        metrics.incr("cfm_forwards", steps)
        metrics.incr("cfm_frames", steps * sum(lens))
        metrics.incr("cfm_frames_sq", steps * sum(n * n for n in lens))
        metrics.gauge("cfm_rows", R)
        metrics.gauge("dit_fused", int(dit_glue.engages(params["cfm"]["proj_out"]["w"])))
    return [torch.cat(o) if o else torch.zeros((0, cfg.mel_dim), device=dev) for o in outs]


def vocode(params, cfg: V4Config, mel: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The vocoder program over ``mel`` [B, W, M] (denormalised). Returns
    [B, W * hop] (the caller's copy)."""
    B, W, _ = mel.shape
    with graphs.cache_for(params).bind(params) as params:
        g, fn = vocode_graph(params, cfg, B, W)
        with g.lock:
            b = g.static
            b.mel.copy_(mel)
            b.valid.copy_(valid)
            g.run(fn)
            return b.audio.clone()


def vocode_chunked(params, cfg: V4Config, mel: torch.Tensor, valid: torch.Tensor,
                   chunk: int, halo: int, bound: Optional[int] = None) -> torch.Tensor:
    """The vocoder over halo-padded windows of ``chunk`` frames, as
    ``sovits.vocode_frames_chunked`` runs V2's (``bound``: frames no row
    exceeds; windows from it on are skipped)."""
    B, F_, _ = mel.shape
    hop = cfg.hop_length
    if not chunk or F_ <= chunk + 2 * halo:
        return vocode(params, cfg, mel, valid)
    out = torch.zeros((B, F_ * hop), dtype=torch.float32, device=mel.device)
    for start, s0, s1, n in sovits.chunk_windows(F_, chunk, halo):
        if bound is not None and start >= bound:
            break
        a = vocode(params, cfg, mel[:, s0:s1], torch.clamp(valid - s0, 0, s1 - s0))
        out[:, start * hop:(start + n) * hop] = a[:, (start - s0) * hop:(start - s0 + n) * hop]
    return out


def synthesize_rows(params, scfg: SoVITSConfig, cfg: V4Config, codes, codes_len, text,
                    text_len, ge, refs, seeds, lens, *, batch_buckets, chunk: int,
                    halo: int, events: Optional[list] = None) -> torch.Tensor:
    """Codes -> 48 kHz waveform [B, 4 * n * hop] float32 for a batch:
    ``decode_encp`` over the padded batch, the chunk loop of each of the
    first ``len(lens)`` rows (``refs``: each row's (``fea_ref``,
    ``mel2``), ``seeds`` its CFM seed, ``lens`` its codes, on the host),
    then the vocoder over the denormalised mels. Rows past ``len(lens)``
    (batch padding) give silence."""
    with metrics.timer("v4_encp"):
        fea = encp(params, scfg, cfg, codes, codes_len, text, text_len, ge)
    fpc = cfg.frames_per_code
    rows = [Row(fea[i, :fpc * int(n)], fr, m2, int(s))
            for i, (n, (fr, m2), s) in enumerate(zip(lens, refs, seeds))]
    mels = cfm_rows(params, cfg, rows, batch_buckets, events)
    B, F_ = fea.shape[0], fea.shape[1]
    mel = torch.zeros((B, F_, cfg.mel_dim), dtype=torch.float32, device=fea.device)
    for i, m in enumerate(mels):
        mel[i, :m.shape[0]] = denorm_spec(m)
    with metrics.timer("v4_vocode"):
        return vocode_chunked(params, cfg, mel, fpc * codes_len, chunk, halo,
                              bound=fpc * int(max(lens)))


# ---------------------------------------------------------------------------
# Random init (tests and the chip smoke run; real weights are converted)
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, scfg: SoVITSConfig, cfg: V4Config,
                dtype=torch.bfloat16) -> Params:
    """Random V4 synthesizer weights on ``generator``'s device: V2's text
    side (its style encoder over 704 bins, no flow and no 32 kHz
    decoder), the bridge, ``wns1``, the DiT (``cfm``) and the 48 kHz
    vocoder (``dec``). The adaLN and output projections and GRN's gamma
    and beta are drawn non-zero (upstream zero-initialises them, which
    would leave every block a no-op)."""
    dev = generator.device
    base = sovits.init_params(
        generator, dataclasses.replace(scfg, spec_channels=min(REF_ENC_BINS, scfg.spec_channels)),
        dtype=dtype)
    del base["flow"], base["dec"]
    Cf, D, M = cfg.fea_channels, cfg.dit_dim, cfg.mel_dim
    inner = cfg.dit_heads * cfg.dit_head_dim

    def randn(*shape, std=1.0):
        return (torch.randn(shape, generator=generator, device=dev) * std).to(dtype)

    def conv(width, i, o, bias=True, lead=()):
        p = {"w": randn(*lead, width, i, o, std=(i * width) ** -0.5)}
        if bias:
            p["b"] = randn(*lead, o, std=0.02)
        return p

    def dense(i, o, lead=(), gain=1.0):
        return {"w": randn(*lead, i, o, std=gain * i ** -0.5), "b": randn(*lead, o, std=0.02)}

    wl = cfg.wn_layers
    wns1 = {"pre": conv(1, Cf, Cf), "proj": conv(1, Cf, Cf),
            "enc": {"cond_layer": conv(1, scfg.gin_channels, 2 * Cf * wl),
                    "in_layers": [conv(cfg.wn_kernel, Cf, 2 * Cf) for _ in range(wl)],
                    "res_skip_layers": [conv(1, Cf, 2 * Cf if i < wl - 1 else Cf)
                                        for i in range(wl)]}}
    L, nt = cfg.dit_depth, cfg.text_conv_layers
    Ct = Cf * cfg.text_conv_mult
    cfm = {
        "time_embed": {"fc1": dense(cfg.freq_embed_dim, D), "fc2": dense(D, D)},
        "d_embed": {"fc1": dense(cfg.freq_embed_dim, D), "fc2": dense(D, D)},
        "text_blocks": {
            "dw": conv(7, 1, Cf, lead=(nt,)),
            "norm": {"scale": torch.ones((nt, Cf), dtype=dtype, device=dev),
                     "bias": torch.zeros((nt, Cf), dtype=dtype, device=dev)},
            "pw1": dense(Cf, Ct, lead=(nt,)),
            "grn": {"gamma": randn(nt, Ct, std=0.1), "beta": randn(nt, Ct, std=0.1)},
            "pw2": dense(Ct, Cf, lead=(nt,))},
        "input": {"proj": dense(2 * M + Cf, D),
                  "conv_pos": [conv(cfg.conv_pos_kernel, D // cfg.conv_pos_groups, D)
                               for _ in range(2)]},
        "blocks": {"ada": dense(D, 6 * D, lead=(L,), gain=0.1),
                   "q": dense(D, inner, lead=(L,)), "k": dense(D, inner, lead=(L,)),
                   "v": dense(D, inner, lead=(L,)), "out": dense(inner, D, lead=(L,)),
                   "ff1": dense(D, D * cfg.dit_ff_mult, lead=(L,)),
                   "ff2": dense(D * cfg.dit_ff_mult, D, lead=(L,))},
        "norm_out": dense(D, 2 * D, gain=0.1),
        "proj_out": dense(D, M),
    }
    ups, resblocks = [], []
    ch = cfg.upsample_initial
    for u, k_up in zip(cfg.upsample_rates, cfg.upsample_kernels):
        ups.append(conv(k_up, ch, ch // 2))
        ch //= 2
        for kern, dils in zip(cfg.resblock_kernels, cfg.resblock_dilations):
            resblocks.append({"convs1": [conv(kern, ch, ch) for _ in dils],
                              "convs2": [conv(kern, ch, ch) for _ in dils]})
    dec = {"conv_pre": conv(7, M, cfg.upsample_initial), "ups": ups, "resblocks": resblocks,
           "conv_post": conv(7, ch, 1)}
    return {**base, "bridge": conv(1, scfg.hidden_channels, Cf), "wns1": wns1, "cfm": cfm,
            "dec": dec}


