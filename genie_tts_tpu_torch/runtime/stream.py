"""Segmented low-latency streaming: time to first audio independent of length.

The port of ``genie_tts_tpu/runtime/stream.py``. The fused stream head
(``engine._t2s_latent_first``) vocodes its first chunk only after the whole
decode. Here decode runs as W-step SEGMENTS on a solo (B=1) slot machine
(``models/slots.py``, exact KV, the plain full-read route: the same masks
and ring as the slot batcher, token for token the same as
``t2s.generate``), and audio is vocoded from the codes decoded SO FAR while
later segments run::

    prefill -> insert -> segment 1 -> latent(prefix) + first window
                      -> segment 2 ...
    the first host read returns the first ~0.3-0.6 s of audio after ~W
    decoded codes, however long the utterance will be.

Approximation (as in the JAX package): the latent stage is bidirectional
over the codes, so windows vocoded from a PREFIX differ slightly from
whole-utterance synthesis (the tokens are exact). Emission trails the
decode frontier by ``stream_lookahead`` codes, and every latent recompute
of a request reads ONE flow-noise table, drawn once at the largest frame
bucket, so overlapping frames see the same noise.

The loop is pipelined one segment deep: segment k's tokens, ``done`` and
``counts`` go to pinned host memory behind an event before segment k+1 is
dispatched (the state is updated in place). A request takes a
persistent machine state of its configuration for as long as it lasts
(:func:`take_stream_state`: the one a sweep or an earlier stream left;
concurrent streams take one each), and its join (``slots.prefill_join``,
``insert_slot``) and each segment replay the configuration's graphs on
its resident state, holding the request's (``models/slots.py``), as each
prefix latent and window vocode replays a SoVITS program
(``models/sovits.py``; one window width per frame bucket);
:func:`stream_warmup_units` captures them ahead of traffic. A tp-sharded
character's machine holds its caches per shard (``models/slots.py``), in
the same graphs, and gives the same chunks.
"""
from __future__ import annotations

import functools
import time
from typing import Optional

import numpy as np
import torch

from ..models import slots as slots_mod
from ..models import sovits
from ..models.t2s import finalize_semantic_tokens, shard_devices
from ..ops.sampling import SamplingConfig, SamplingRows, rows_from_config
from ..utils.host_copy import finish_host_copy, host_to_device, start_host_copy, to_pcm16
from ..utils.metrics import metrics
from .buckets import pad_to, pick_bucket
from .engine import CharacterModel, ReferenceFeatures, TTSEngine
from .synthesizers import sovits_warmup_units


def stream_geometry(cfg, tcfg) -> "tuple[int, int, int, int]":
    """(W, ring, sx, sp) of the solo streaming machine: the slot batcher's
    phoneme and prompt buckets, and a ring that covers the decode cap."""
    W = cfg.stream_seg_steps
    cap = pick_bucket(tcfg.max_decode_steps, cfg.step_caps)
    ring = -(-min(cap, tcfg.max_decode_steps + W) // W) * W
    return W, ring, cfg.slot_phoneme_bucket, cfg.slot_prompt_bucket


def fits_stream(cfg, ref: ReferenceFeatures, phones: np.ndarray) -> bool:
    return (len(ref.phones) + len(phones) <= cfg.slot_phoneme_bucket
            and len(ref.prompt_tokens) <= cfg.slot_prompt_bucket)


def _stream_state_key(char: CharacterModel, ring: int, sx: int, sp: int) -> tuple:
    return ("stream", sx, sp, ring, char.t2s_params["audio_embed"].dtype)


def take_stream_state(engine: TTSEngine, char: CharacterModel) -> slots_mod.SlotState:
    """An empty solo machine state of the character's configuration at the
    stream geometry for one request: a persistent one
    (``TTSEngine.take_slot_state``: one a sweep or an earlier stream
    left; the caller offers it back; a tp-sharded character's holds its
    caches per shard)."""
    tcfg = char.t2s_cfg
    _, ring, sx, sp = stream_geometry(engine.cfg, tcfg)
    params = char.t2s_params
    kw = dict(dtype=params["audio_embed"].dtype, device=char.device,
              tp_devices=shard_devices(params))
    state = engine.take_slot_state(char, _stream_state_key(char, ring, sx, sp),
                                   lambda: slots_mod.init_slots(tcfg, 1, sx, sp, ring, **kw))
    with slots_mod.holding(params, state) as st:
        slots_mod.reset_slots(st, ring)
    return state


def noise_table(cfg, vcfg, generator: torch.Generator) -> torch.Tensor:
    """A request's flow-noise table [2 * max(frame_buckets), C] fp32, drawn
    once; every latent recompute reads a prefix of it."""
    return torch.randn((2 * max(cfg.frame_buckets), vcfg.inter_channels),
                       generator=generator, device=generator.device)


def _stream_head(sovits_params, noise, tok0, seg_tok, counts, done, text, t_len,
                 ge, ge_mrte, noise_scale, *, vcfg, cb, first_window, lookahead,
                 pcm16):
    """Latent + first vocode window from the FIRST segment's tokens on the
    device (the latent and vocode programs of ``models/sovits.py``),
    dispatched before any host read. Returns (audio [1,
    first_window*hop], emit_frames [1]): the emitted frames trail the
    frontier by ``lookahead`` codes unless the row already finished (then
    all of it emits, the last code set to 0 as the reference does)."""
    toks = torch.cat([tok0.reshape(1, 1).long(), seg_tok.long()], dim=1)  # [1, 1+W]
    n = counts.long()
    pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
    codes = torch.where(pos < n[:, None], toks, torch.zeros_like(toks))
    codes = torch.where(done[:, None] & (pos == n[:, None] - 1),
                        torch.zeros_like(codes), codes)
    codes = torch.nn.functional.pad(torch.clamp(codes, 0, vcfg.vq_codes - 1),
                                    (0, cb - toks.shape[1]))
    z = sovits.latent(sovits_params, vcfg, codes, n, text, t_len, ge, ge_mrte, noise_scale,
                      noise=noise[None])
    audio = sovits.vocode(sovits_params, vcfg, z[:, :first_window], ge,
                          torch.clamp(2 * n, max=first_window))
    emit = torch.where(done, 2 * n, 2 * torch.clamp(n - lookahead, min=0))
    emit = torch.clamp(emit, max=first_window)
    return (to_pcm16(audio) if pcm16 else audio), emit


@torch.inference_mode()
def synthesize_stream_segments(engine: TTSEngine, char: CharacterModel,
                               ref: ReferenceFeatures, text_phones: np.ndarray,
                               text_bert: np.ndarray,
                               sampling: Optional[SamplingConfig] = None,
                               seed: Optional[int] = None, noise_scale: float = 0.5,
                               min_steps: int = 0, max_steps: Optional[int] = None,
                               pcm16: bool = False):
    """Generator of waveform chunks; the first after ~W decoded codes."""
    t_start = time.perf_counter()
    cfg, tcfg, vcfg = engine.cfg, char.t2s_cfg, char.sovits_cfg
    W, ring, sx, sp = stream_geometry(cfg, tcfg)
    dev = char.device
    hop, halo = vcfg.hop_length, cfg.vocode_halo
    chunk, lookahead = cfg.stream_chunk, cfg.stream_lookahead
    if seed is None:
        seed = engine._next_seed()
    max_steps = min(max_steps or tcfg.max_decode_steps, ring)
    min_steps = min(min_steps, max_steps)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    # ONE flow-noise table for every latent recompute of this request
    noise = noise_table(cfg, vcfg, torch.Generator(device=dev).manual_seed(
        int(seed) + 2_000_000))

    packed = np.concatenate([ref.phones, text_phones]).astype(np.int64)
    if np.any(ref.bert) or np.any(text_bert):
        bert = host_to_device(pad_to(np.concatenate([ref.bert, text_bert])
                                     .astype(np.float32), sx, axis=0)[None], dev)
    else:
        bert = None
    t_bucket = pick_bucket(len(text_phones), cfg.phoneme_buckets)
    text_b = host_to_device(pad_to(np.asarray(text_phones, np.int64), t_bucket)[None], dev)
    t_len = host_to_device(np.array([min(len(text_phones), t_bucket)]), dev)
    ge = host_to_device(np.asarray(ref.ge, np.float32)[None], dev)
    ge_mrte = host_to_device(np.asarray(ref.ge_mrte, np.float32)[None], dev)

    # the request's solo machine, exact KV (no int8 scales, no kernel): a
    # persistent state (its join and segment graphs captured on it) for
    # as long as the request lasts
    state = take_stream_state(engine, char)
    try:
        samp = rows_from_config(sampling or SamplingConfig(), 1)
        ctx_k, ctx_v, tok0, hist = slots_mod.prefill_join(
            char.t2s_params, tcfg, phones=host_to_device(pad_to(packed, sx)[None], dev),
            bert=bert, x_len=host_to_device(np.array([len(packed)]), dev),
            prompts=host_to_device(pad_to(np.asarray(ref.prompt_tokens, np.int64), sp)[None],
                                   dev),
            p_len=host_to_device(np.array([len(ref.prompt_tokens)]), dev),
            samp=SamplingRows(*(host_to_device(a, dev) for a in samp)), generator=gen,
            any_top_p=bool(samp.top_p[0] < 1.0))
        state = slots_mod.insert_slot(state, 0, ctx_k, ctx_v, tok0, hist,
                                      min(len(packed), sx), min(len(ref.prompt_tokens), sp),
                                      min_steps, max_steps, SamplingRows(*(a[0] for a in samp)),
                                      params=char.t2s_params)

        def segment(state):
            """Dispatch one segment and enqueue its tokens, done and counts
            for the host; returns the flags' device copy too."""
            with slots_mod.holding(char.t2s_params, state) as st:
                state, seg_tok = slots_mod.decode_segment(
                    char.t2s_params, state, tcfg, W, sx, sp, ring, generator=gen)
                flags = torch.cat([st.done.int(), st.counts])
            copy = start_host_copy(torch.cat([seg_tok.reshape(-1), flags]))
            return state, seg_tok, copy, flags

        def read(copy):
            flat = finish_host_copy(copy)
            return flat[:W], bool(flat[W]), int(flat[W + 1])

        # segment 1 + the stream head, all dispatched before any host read
        state, seg1, copy1, flags1 = segment(state)
        head_cb = pick_bucket(W + 1, cfg.frame_buckets)
        first_window = 2 * (W + 1)
        head_audio, head_emit = _stream_head(
            char.sovits_params, noise, tok0, seg1, flags1[1:], flags1[:1] != 0, text_b,
            t_len, ge, ge_mrte, noise_scale, vcfg=vcfg, cb=head_cb,
            first_window=first_window, lookahead=lookahead, pcm16=pcm16)
        head = start_host_copy(torch.cat([head_audio.reshape(-1).float(),
                                          head_emit.float(), tok0.float()]))
        # depth-1 pipeline: segment 2 runs while segment 1's outputs come home
        pending = segment(state) if 2 * W < ring else None
        seg_np, done, count = read(copy1)
        flat = finish_host_copy(head)
        emitted = int(flat[-2])
        toks_host = [np.array([int(flat[-1])]), seg_np]
        if emitted > 0:
            metrics.observe("ttfa", time.perf_counter() - t_start)
            piece = flat[:first_window * hop][:emitted * hop]
            yield piece.astype(np.int16) if pcm16 else piece
        ttfa_pending = emitted == 0

        def emit_windows(count, done):
            """Vocode every safe window [emitted, frontier) from a fresh prefix
            latent (the request's noise table), then read them in order."""
            nonlocal emitted, ttfa_pending
            codes_np = np.concatenate(toks_host)[:count]
            if done:
                codes_np = finalize_semantic_tokens(codes_np[None], np.array([count]),
                                                    tcfg.eos_id)[0]
                count = len(codes_np)
                frontier = 2 * count
            else:
                frontier = 2 * max(count - lookahead, 0)
            if frontier - emitted < (1 if done else chunk):
                return
            fb = pick_bucket(max(count, 1), cfg.frame_buckets)
            codes = pad_to(np.clip(codes_np, 0, vcfg.vq_codes - 1).astype(np.int64), fb)
            z = sovits.latent(
                char.sovits_params, vcfg, host_to_device(codes[None], dev),
                host_to_device(np.array([count]), dev), text_b, t_len, ge, ge_mrte,
                noise_scale, noise=noise[None])
            F = 2 * fb
            # one window width per frame bucket (one vocode graph), placed
            # inside the latent's frames with the halo on both sides of the
            # piece where the frames allow
            win = min(chunk + 2 * halo, F)
            jobs = []
            while frontier - emitted >= (1 if done else chunk):
                start = emitted
                w = min(chunk, frontier - start)
                s0 = min(max(start - halo, 0), F - win)
                valid = torch.tensor([min(max(2 * count - s0, 0), win)], device=dev)
                a = sovits.vocode(char.sovits_params, vcfg, z[:, s0:s0 + win], ge, valid)
                a = a[0, (start - s0) * hop:(start - s0 + w) * hop]
                jobs.append(start_host_copy(to_pcm16(a) if pcm16 else a))
                emitted += w
            for copy in jobs:
                piece = finish_host_copy(copy)
                if ttfa_pending:
                    metrics.observe("ttfa", time.perf_counter() - t_start)
                    ttfa_pending = False
                yield piece

        seg_idx = 2
        while not done and pending is not None:
            state, _, copy, _ = pending
            pending = None
            # dispatch segment k+1 before reading segment k
            if (seg_idx + 1) * W <= ring:
                pending = segment(state)
            seg_np, done, count = read(copy)
            toks_host.append(seg_np)
            yield from emit_windows(count, done)
            seg_idx += 1

        # final flush (also covers a head that emitted everything)
        yield from emit_windows(count, True)
        metrics.incr("utterances")
        metrics.observe("synthesize_utterance", time.perf_counter() - t_start)
        metrics.gauge("audio_seconds", emitted * hop / vcfg.sample_rate)
    finally:
        engine.offer_slot_state(char, _stream_state_key(char, ring, sx, sp), state)


def stream_warmup_units(engine: TTSEngine, char: CharacterModel) -> list:
    """Warmup thunks for the segmented stream: captures of the join
    program's variants at the stream geometry, and of the insert program
    and the segment graph (per top-p flag) on a persistent stream state
    that it leaves for the next stream (``TTSEngine.offer_slot_state``),
    and of its SoVITS programs: the stream head's latent at every text
    bucket and its first window, and the emitter's prefix latent at every
    (frame, text) bucket and its window over each. Returns thunks for
    ``engine._run_compile_units``."""
    from .slot_batcher import join_warmup_units, warmup_join

    cfg, tcfg = engine.cfg, char.t2s_cfg
    W, ring, sx, sp = stream_geometry(cfg, tcfg)
    params = char.t2s_params
    dev = char.device
    units = join_warmup_units(char, sx, sp)

    def segment(top_p):
        state = take_stream_state(engine, char)      # its first take resets it
        gen = torch.Generator(device=dev).manual_seed(0)
        warmup_join(char, state, sx, sp, W, gen)
        state.top_p_host[0] = 0.5 if top_p else 1.0
        slots_mod.decode_segment(params, state, tcfg, W, sx, sp, ring, generator=gen)
        engine.offer_slot_state(char, _stream_state_key(char, ring, sx, sp), state)

    units += [functools.partial(segment, top_p) for top_p in (False, True)]
    head_cb = pick_bucket(W + 1, cfg.frame_buckets)
    win = cfg.stream_chunk + 2 * cfg.vocode_halo
    latents = ({(1, head_cb, tb) for tb in cfg.phoneme_buckets}
               | {(1, fb, tb) for fb in cfg.frame_buckets for tb in cfg.phoneme_buckets})
    vocodes = {(1, 2 * (W + 1))} | {(1, min(win, 2 * fb)) for fb in cfg.frame_buckets}
    return units + sovits_warmup_units(char, latents, vocodes)
