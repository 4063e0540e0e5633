#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``genie_tts_tpu_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout; one card

Phases, each of which must pass:

1. device: needs CUDA; prints the card's name and power limit.
2. build: compiles every ``genie_tts_tpu_torch/csrc/*.cu`` (one nvcc per
   source, all started together) and prints the build time.
3. tts (the main path, full width): a random V2 character from the port's
   own ``init_params`` (24-layer T2S, full SoVITS and HuBERT, bf16, int8
   decode weights, a 128-step cap so decode stays bounded), written with the port's writer, then ``api.load_character``
   -> ``set_reference_audio`` (a synthetic 5 s wav) -> ``tts(...,
   save_path=...)``, twice. The wav must be finite and 2*codes*640 samples
   long, and the fused decode kernel must launch once per decode step.
4. generate at B=4 (the batched route, full width): the flash-decode
   kernel must launch 24 times per decode step.
5. slice check: greedy fp32 codes on the card vs the same model on the CPU.
6. slot serving (the second path, full width; ``GENIE_SLOT_KV_INT8=1`` is
   set before the port is imported, as a user would): a random V2
   character at ``T2SConfig()`` defaults (24 layers, 500-step cap, so a
   512-column ring) with int8 decode weights, bf16 and the EOS logit at 0,
   loaded through ``api``; 10 client threads call the synth function of
   ``api._make_synth_fn(name, use_batcher=True)``, 6 at once and 4 more
   after 2 segments. Every request must return finite PCM16 of
   2*codes*640 samples, the int8 attention kernel must launch 24 times per
   decode step dispatched (and neither earlier kernel), and 8 slots must
   be busy at once; the ``slot_join`` timer of the 10 joins (prefill and
   insert graphs, the first capturing them). Then decode ms per segment
   at occupancy 8, from CUDA events around ``decode_segment`` on the live
   state.
7. slot serving in the bf16 KV mode (the JAX package's default): 2
   requests through ``SlotBatcher.synthesize``; the int8 kernel must not
   launch, no segment reads windows, and the exact caches' slot attention
   kernel must launch 24 times per decode step. Then greedy fp32 slot
   codes on the card (the kernel) vs the CPU's plain route with the
   windows the scheduler picks and with the full read (identical), and a
   32-step segment at occupancy 8, bf16 KV, over the full 896-column
   read (CUDA events, and the device's busy time under torch.profiler).
8. slot slice check: greedy fp32 slot-machine codes with the int8 KV cache
   on the card (through the kernel) vs the CPU (plain version).
9. serve: the port's HTTP server in-process (127.0.0.1, port 0), phase
   3's character loaded under a new name through POST /load_character and
   /set_reference_audio, then in turn, with the kernel counts set to 0
   before each and read after: (1) 4 concurrent default /tts of short
   sentences take the slot route (int8 launches = 24 x slot decode steps,
   no flash or fused launch); (2) 2 concurrent default /tts of a sentence
   of 193-256 packed phonemes take the window batcher (one batch of 2,
   flash launches = 24 x decode steps); (3) one "stream": true short
   request on the idle machine takes the segmented stream (no kernel
   launch); (4) one "stream": true long request takes the fused stream
   head (fused launches = decode steps); (5) one "stream": true short
   request sent while 3 default requests occupy the slot machine joins it
   (the streams stat and the slot_utterances counter count it, int8
   launches follow). Every response must be 200 with 2 x 2*codes*640
   bytes of PCM holding more than 1000 distinct values; each route prints
   its latency, time to the first chunk, audio seconds and launches.
9a. graphs (every decode, prefill and SoVITS stage above runs as CUDA-graph
   replays, captured on first use): with ``serve --warmup``'s flag
   (``api.sweep_on_reference``), phase 3's character loaded as ``graphs``
   through the server and swept at its ``/set_reference_audio`` (units,
   graphs captured, client wall time, pool and static-buffer memory, the
   T2S and SoVITS families apart); solo ``tts()`` after the sweep (its
   stage split, and its embed, prefill, decode, latent and vocode as
   replays only: no miss, no capture); 4 concurrent ``/tts`` (int8 slot
   route), a short stream (segmented) and a long one (fused head) with no
   miss, no new variant and no capture in either cache, then a short
   stream sent while 3 default ``/tts`` occupy the slot machine (the
   slot-joined stream: its join and speculative codes replayed), with the
   ``slot_join`` timer of the 4 requests; the long stream again and top-p
   0.8 requests. Then ``graphs2``, a second random character of the same
   configuration (other weights), loaded after the sweep: its
   ``/set_reference_audio`` runs 0 sweep units and captures nothing (its
   wall time beside the sweep's, the ``memory_reserved`` it adds beside
   its weights), and the same routes serve it with no miss and no capture.
   The two interleaved (A, B, A): B=1 fused and B=4 flash ``generate`` and
   slot segments at occupancy 8 on two persistent int8 states in turn,
   each character's codes identical to its own eager run on one noise and
   the two characters' codes different; 2 ``/tts`` of each at once on
   their slot machines (no miss, no capture; ``binds``, ``bind_bytes``);
   a bind's device ms by CUDA events and the bank's MiB per family. The
   character cache cut to 1 evicts ``graphs2``: ``memory_allocated`` must
   fall by at least its weights and its slot machine's state, the
   configuration's graph keys stay, and the first ``/tts`` after it
   reloads ``graphs2`` with 0 sweep units and no miss (timed). Graph vs
   eager on the
   same noise: the prefill program and decode of B=1 fused and B=4 flash
   ``generate`` at a 40-step cap (codes identical, and identical to the
   embedded-input route), five B=1 decodes captured while another thread
   replays a sixth, a slot segment at occupancy 8 (int8 and exact KV,
   every state leaf equal), a stream segment, the slot join
   (``prefill_join`` with BERT rows, then ``insert_slot`` into slot 3 of an
   int8 state at occupancy 8: tok0 and the histogram identical, the
   context columns' max abs difference within one bf16 step, then the
   segment that follows with identical codes; the join's, the prefill's
   and the insert's device ms by CUDA events and wall ms, graph beside
   eager in turns), and the SoVITS
   stages (the latent at B=1 and B=8, the whole and the chunked vocode,
   the window rows: max abs difference, bound 1e-5 in fp32). Graph beside
   eager (the character's caches set ``eager``) in turns: solo ``tts()``
   decode ms/step and stage split, each stage's device ms by CUDA events
   (the prefill program and the SoVITS stages), a slot segment at
   occupancy 8 (CUDA events; device busy and kernels a step by
   torch.profiler), the segmented stream's first chunk and end, and 4
   concurrent slot requests.
9b. mesh (dp x tp serving, full width): ``make_serving_mesh(2, 2)`` over
   ``cuda:0`` four times (one card: every line of the dp and tp code runs,
   no transfer between cards). ``api.engine`` is swapped for a mesh
   engine on a shorter bucket ladder (batch buckets 1 and 4, frame buckets
   64-256: depth cut for time), phase 3's character loads tp-sharded (2
   replicas of 2 shards, each replica's weights its own) and (f)
   ``engine.warmup(sweep=True)`` captures every replica's graphs: its wall
   time, and per replica the graphs captured and the pool and buffer MiB
   by card. Then, warm, with the kernel counts set to 0 before each route
   and read after: (a) solo ``tts()`` takes the per-layer route as graph
   replays, 0 fused and 24 x tp x steps flash launches, ms/step beside the
   eager route's (the caches set ``eager``); (b) ``synthesize_batch`` of 4
   rows (2 per replica), 24 x dp x tp x steps flash launches; (c) 4
   concurrent default ``/tts`` through the port's server on the int8 slot
   route, 24 x tp int8 launches per slot step, PCM of more than 1000
   distinct values, and a short stream on the idle machine (the segmented
   stream, first chunk): no miss, no variant and no capture in any
   replica's T2S or SoVITS cache. (g) The tp route's graphs against its
   eager run on one noise: ``generate`` at B=1 and B=4 (cap 40: tokens,
   counts, histogram), a slot segment at occupancy 8 after graph joins
   (int8, every state leaf and each shard's caches) and a
   segmented-stream segment: identical, each one's device ms graph and
   eager. A second 2x2 character of the configuration (other weights)
   then loads on the swept engine: its sweep runs 0 units, and a solo
   ``tts()`` and a ``/tts`` serve it with no capture and no miss in any
   replica's cache; each unload frees every replica's weights and keeps
   the configurations' caches. (d) and (h) a dp-only 2x1 mesh, swept: solo ``tts()``, one fused
   launch per step; a B=4 ``synthesize_batch`` with no miss in replica 1's
   caches. (e) fp32 greedy parity of 2x2 against 1x1 at a 64-step cap:
   identical codes (else the first step that differs and 1x1's top-2 logit
   gap there, which must be under 1e-3 of the logits' RMS), and waveforms
   within relative L2 1e-3 where the codes agree; then the flash kernel at
   B=1, H=8 and the int8 kernel at H=8 (a shard's heads) against their
   plain versions, timed beside their bounds.
9c. cross-card mesh: (f) and (g) at 1x2 over ``cuda:0`` and ``cuda:1``
   where the machine has two cards, and at 2x2 over four where it has
   four; with one card one line says that the cross-card capture did not
   run, and on how many cards. ``python3 chip_smoke.py --cross-card`` runs
   the kernels' build, phase 3's character and this phase alone (a
   machine of several cards).
10. V2ProPlus (full width): a random V2ProPlus character (gin 1024, the
   full prompt encoder, int8 decode weights, bf16, a 128-step cap, EOS
   pinned) and a random full ERes2NetV2 as ``GENIE_SV_MODEL``, through
   ``load_character`` -> ``set_reference_audio`` (timed: HuBERT, Kaldi
   fbank, ERes2NetV2, prompt encoder) -> ``tts`` twice (fused launches =
   decode steps, ge [1024, 1], ge_mrte [512, 1]), the SV forward timed
   alone, the first ``set_reference_audio`` split by program (device ms
   of HuBERT, extract_prompt_tokens, the Kaldi fbank, ERes2NetV2, the
   linear spectrogram, the prompt encoder, and the V2
   ``reference_embedding`` on phase 3's character; eager, as the port runs
   them once per clip), then 2 concurrent requests on the int8 slot route
   (int8 launches = 24 x slot steps).
11. V2ProPlus slice check, card vs CPU on fp32 weights: the SV embedding
   (relative L2 <= 1e-3), ge / ge_mrte (within 1e-3), greedy fp32 codes
   (agreement >= 0.9).
12. zh (full size): a random ``RobertaConfig()`` RoBERTa (24 L x d1024,
   vocabulary 21128, bf16) from the port's ``init_params``, written with
   the port's writer under ``GENIE_ROBERTA_DIR`` beside a BERT-layout
   ``tokenizer.json`` covering the phase's text; phase 3's character
   loaded as ``zh`` (``load_character`` loads RoBERTa once on the card,
   timed); RoBERTa's feature program captured at every token bucket by
   the units a Chinese character's sweep runs (timed, pool and buffer
   MiB; run again as a second character's sweep: hits only), each
   bucket's device ms graph beside eager and beside its bound; a Chinese
   reference transcript (non-zero reference BERT
   rows); the exact-length eager RoBERTa forward of the sentence (CUDA
   events, beside its bound) and host G2P times; ``tts`` twice on a
   Chinese sentence, then
   four more with ``done`` read every step and every 16 steps in turns
   (decode ms/step); 2 concurrent Chinese requests on the int8 slot route
   (int8 launches = 24 x slot steps); card vs CPU: greedy fp32 codes of
   the Chinese sentence with its BERT rows (identical) and RoBERTa's
   ``phone_features`` in fp32 (relative L2 <= 1e-4), and on the card the
   padded graph route against the exact-length eager route (relative L2
   <= 1e-5); every RoBERTa call of the phase after the capture a replay
   (no miss, no capture); then the character
   as ``en`` (zero BERT rows, reference too) and as
   ``Hybrid-Chinese-English``, ``tts`` once each. Every ``tts`` wav is
   finite, 2*codes*640 samples of more than 1000 distinct values, with
   fused launches = decode steps.
13. train (full width): ``T2SConfig()`` fp32 params from the port's
   ``init_params``, ``make_mesh(1, 1)`` on cuda, ``make_train_step`` at lr
   1e-4, 10 steps on ``make_batch(cfg, 8, 128, 384)`` with rows 4-7 cut to
   x_len 96 and sem_len 256: finite losses, the last below the first; the
   step's ms (CUDA events, median of steps 3-10), positions and target
   tokens a second, peak memory and the step's operation bound; one step
   under torch.profiler (device busy, GEMM time). Card vs CPU on the
   initial params (B=2, Sx=64, Sy=128): loss relative difference <= 1e-5,
   every gradient relative L2 <= 1e-4 (row 1 alone at B=1 and the trained
   params printed beside it, with the CPU's own floor). The trained
   tree, written as a copy of phase 3's character, loads through
   ``api.load_character`` (int8 decode weights) and ``tts()`` speaks: a
   finite wav of 2*codes*640 samples, fused launches = decode steps. One
   card: no collective runs here.
14. shared convert (full size): a random chinese-hubert-base in the HF
   key layout as ``pytorch_model.bin``, through ``convert_shared_models``
   into a work-dir ``GENIE_DATA_DIR`` (timed); a new model manager's
   ``load_hubert`` serves it; in fp32 (``set_hubert``) it serves
   ``set_reference_audio`` on the card, its features of the clip within
   relative L2 1e-5 of the CPU's from the same file.
15. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths gave it (max error vs the stated tolerance),
   then its time, the plain version's, the library yardstick's and the
   least time the card could take (bound). Kernel times are device time
   per launch by CUDA-graph replay (the fused step too, falling back to
   labelled eager events if the card refused to capture its cooperative
   launch); the fused step also prints its time per layer (and the slope
   from an L=1 launch) beside the per-layer bound, its L grid barriers
   timed alone, and each phase's share of a layer from the kernel's
   clock64 stamps. The int8 attention is timed at three visibility levels
   (partial ring, wrapped ring, fully visible; each with its visible
   share, bytes, bound and the SDPA yardstick) and with nothing visible
   (the floor every launch pays), and split into spans from its clock64
   stamps (int8_decode.phase_cycles); the partial ring is its kernels row.
   The exact caches' slot attention is held to its plain version in bf16
   and fp32 at the serving geometry (B=8, H=16, S=896, W=32), at B=1 and
   at a shard's 8 heads, and timed at the same three visibility levels,
   at buffer columns 0, 16 and 31, and with nothing visible; the partial
   ring is its kernels row. ``python3 chip_smoke.py --slot-attention``
   runs the build and this kernel's part alone (~20 s).

The last two lines are the ``kernels`` JSON and, last,
``{"ok": true, "device": {...}}``. Any failed phase exits non-zero and
never prints that line. TF32 is off everywhere fp32 results are compared.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
DEV = "cuda"

# H100 SXM data sheet (dense): memory rate and peak rates by operand type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}

FLASH = {"name": "flash_decode_attention", "route": "cuda",
         "source": "genie_tts_tpu_torch/csrc/flash_decode.cu",
         "replaces": "genie_tts_tpu/ops/flash_decode.py:52"}
FUSED = {"name": "fused_decode_step", "route": "cuda",
         "source": "genie_tts_tpu_torch/csrc/fused_decode.cu",
         "replaces": "genie_tts_tpu/ops/fused_decode.py:184"}
INT8 = {"name": "int8_big_attention", "route": "cuda",
        "source": "genie_tts_tpu_torch/csrc/int8_decode.cu",
        "replaces": "genie_tts_tpu/ops/int8_decode.py:140"}
SLOT = {"name": "slot_attention", "route": "cuda",
        "source": "genie_tts_tpu_torch/csrc/slot_attention.cu",
        "replaces": "none (the JAX package's exact-KV slot route is XLA ops)"}

# ten Japanese sentences for the slot-serving clients
SENTENCES = (
    "きょうはいいてんきですね。", "あしたはあめがふるでしょう。",
    "えきまであるいてじゅっぷんです。", "このほんはとてもおもしろいです。",
    "わたしはまいあさこーひーをのみます。", "やまのうえからうみがみえます。",
    "ともだちといっしょにえいがをみました。", "らいしゅうきょうとへいきます。",
    "ねこがまどのそばでねています。", "よるになるとほしがきれいです。",
)


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def sync(torch):
    """Wait for every card (a mesh may span several)."""
    if DEV == "cuda":
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


def cuda_ms(torch, fn, iters, warmup=3):
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, calls, replays=10):
    """Device time per call in ms: the thunks in ``calls`` (one per layer,
    say) captured once into a CUDA graph and replayed, so the host's cost
    of launching (the Python wrapper, ctypes) is not in the time, which
    it is when eager back-to-back launches take longer to issue than to
    run."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):            # warm-up outside the capture
        for fn in calls:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * len(calls))


def device_ms(torch, calls, eager_iters):
    """(ms per call, how): CUDA-graph replay, or CUDA events over eager
    launches where the card refuses to capture the calls."""
    try:
        return graph_ms(torch, calls), "CUDA graph"
    except RuntimeError as e:
        torch.cuda.synchronize()
        print(f"[kernel] capture refused ({e!r}); timing eager launches")
        return cuda_ms(torch, lambda: [f() for f in calls], eager_iters) / len(calls), "eager"


def phase_split(torch, stamps, layer_ms):
    """Where a layer of the fused step goes, from the kernel's clock64
    stamps ([grid, L, 13], fused_decode.phase_cycles): each span's mean
    share of a layer over the blocks that hold an attention item and over
    layers (the last layer has no next start), scaled to the measured time
    per layer, and in brackets the same for the slowest block of each
    layer."""
    st = stamps.double()[stamps[:, 0, 2] > 0]
    layer = st[:, 1:, 0] - st[:, :-1, 0]                       # [blocks, L-1]
    spans = (("A LN2", 0, 1), ("A qkv, q ready", 1, 2), ("A attention", 2, 3),
             ("A prefetch", 3, 4), ("B partials+combine+out-proj", 4, 5), ("B prefetch", 5, 6),
             ("C weights", 6, 7), ("C partials+LN1", 7, 8), ("C ffn1", 8, 9),
             ("C prefetch", 9, 10), ("D ff+weights", 10, 11), ("D ffn2", 11, 12))
    out = []
    for name, i, j in spans + (("D barrier", 12, None),):
        sp = (st[:, 1:, 0] if j is None else st[:, :-1, j]) - st[:, :-1, i]
        share = sp / layer
        out.append(f"{name} {float(share.mean()) * layer_ms * 1e3:.2f} "
                   f"({float(share.max(dim=0).values.mean()) * layer_ms * 1e3:.2f})")
    return "; ".join(out)


def bound(bytes_moved, ops, op_type):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int8_split(torch, stamps, mhz):
    """Where a launch of the int8 kernel goes, from its clock64 stamps
    ([B*H, 4, 9], int8_decode.phase_cycles): each span's mean over the
    blocks that reach both ends, in us at ``mhz``, and in brackets the
    slowest block's."""
    from genie_tts_tpu_torch.ops.int8_decode import PHASE_STAMPS

    st = stamps.reshape(-1, len(PHASE_STAMPS)).double()
    out = []
    for i in range(len(PHASE_STAMPS) - 1):
        a, b = st[:, i], st[:, i + 1]
        ok = (a > 0) & (b > 0)
        if bool(ok.any()):
            us = (b - a)[ok] / mhz
            out.append(f"{PHASE_STAMPS[i]} -> {PHASE_STAMPS[i + 1]} {float(us.mean()):.2f} "
                       f"({float(us.max()):.2f})")
    last = torch.where(st[:, -1] > 0, st[:, -1], st[:, -2])
    total = (last - st[:, 0]) / mhz
    return "; ".join(out) + (f"; a block start to end {float(total.mean()):.2f} "
                             f"({float(total.max()):.2f})")


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_build():
    from genie_tts_tpu_torch.ops import _build

    t0 = time.perf_counter()
    reports = _build.build(_build.all_kernels())
    dt = time.perf_counter() - t0
    print(f"[build] {len(_build.all_kernels())} kernels in {dt:.1f} s "
          f"({'built' if reports else 'already built'})")
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def make_character(torch, root: Path, tcfg_over):
    """Full-width random V2 character + HuBERT, written with the port's writer.

    The T2S layers' biases and LayerNorm scales/biases are random and differ
    per layer (``t2s.init_params``), so the fused kernel's reads of them are
    checked here and in the kernels phase."""
    from genie_tts_tpu_torch.config import HubertConfig, T2SConfig
    from genie_tts_tpu_torch.convert.io import save_character_config, save_params
    from genie_tts_tpu_torch.models import hubert
    from genie_tts_tpu_torch.runtime.engine import make_random_character

    # EOS logit pinned at 0 (eos_boost=0): every decode runs the
    # character's 128-step cap (fixed, bounded)
    rc = make_random_character(t2s_cfg=T2SConfig(**tcfg_over), eos_boost=0.0,
                               device=DEV)
    char = root / "char"
    char.mkdir(parents=True)
    save_params(rc.t2s_params, char / "t2s.safetensors")
    save_params(rc.sovits_params, char / "vits.safetensors")
    save_character_config(char / "config.json", version="v2", language="ja",
                          extra={"t2s": tcfg_over})
    hub = root / "chinese-hubert-base"
    hub.mkdir()
    gen = torch.Generator(device=DEV).manual_seed(1)
    save_params(hubert.init_params(gen, HubertConfig(), dtype=torch.bfloat16),
                hub / "hubert.safetensors")
    import numpy as np

    from genie_tts_tpu_torch.utils.wavio import write_wav

    rng = np.random.default_rng(0)
    t = np.arange(5 * 32000) / 32000.0
    ref = 0.3 * np.sin(2 * np.pi * 180 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)) \
        + 0.02 * rng.standard_normal(t.size)
    write_wav(root / "ref.wav", ref.astype(np.float32), 32000)
    return char, hub, root / "ref.wav"


def make_second_character(torch, root: Path) -> Path:
    """Another random character of phase 3's configuration, with other
    weights (seed 1), written as phase 3's is (once); returns its dir."""
    from genie_tts_tpu_torch.config import T2SConfig
    from genie_tts_tpu_torch.convert.io import save_character_config, save_params
    from genie_tts_tpu_torch.runtime.engine import make_random_character

    d = root / "char2"
    if not d.exists():
        tcfg_over = {"max_decode_steps": 128}
        rc = make_random_character(t2s_cfg=T2SConfig(**tcfg_over), eos_boost=0.0, seed=1,
                                   device=DEV)
        d.mkdir(parents=True)
        save_params(rc.t2s_params, d / "t2s.safetensors")
        save_params(rc.sovits_params, d / "vits.safetensors")
        save_character_config(d / "config.json", version="v2", language="ja",
                              extra={"t2s": tcfg_over})
    return d


def tree_bytes(*trees) -> int:
    """Bytes of the device storages the tensors of parameter trees hold
    (each storage once; the fused packing included)."""
    from genie_tts_tpu_torch.runtime import graphs

    seen = {}
    for tree in trees:
        if tree is None:
            continue
        for _, t in graphs.tree_leaves(tree):
            if hasattr(t, "untyped_storage") and t.is_cuda:
                st = t.untyped_storage()
                seen[st.data_ptr()] = st.nbytes()
    return sum(seen.values())


def phase_tts(torch, root: Path):
    """The main path through the entry points a user calls."""
    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.utils.wavio import read_audio

    t0 = time.perf_counter()
    char_dir, hub, ref = make_character(torch, root, {"max_decode_steps": 128})
    os.environ["GENIE_HUBERT_DIR"] = str(hub)
    print(f"[tts] random full-width character written in "
          f"{time.perf_counter() - t0:.1f} s")

    api.engine.timing = True
    out = {}
    for call in (1, 2):
        fu.fused_decode_step.launches = 0
        fl.flash_decode_attention.launches = 0
        wav = root / f"tts{call}.wav"
        t0 = time.perf_counter()
        if call == 1:
            api.load_character("smoke", char_dir, "ja", device=DEV)
            api.set_reference_audio("smoke", ref, "こんにちは、てすとです", "ja")
        api.tts("smoke", "きょうはいいてんきですね。", save_path=wav)
        sync(torch)
        wall = time.perf_counter() - t0
        fused_launches = fu.fused_decode_step.launches
        flash_launches = fl.flash_decode_attention.launches
        st = api.engine.last_stats
        audio, sr = read_audio(wav)
        n = st["codes_len"]
        check(sr == 32000, f"wav sample rate {sr}")
        check(np.isfinite(audio).all() and len(audio) == 2 * n * 640 > 0,
              f"wav of {len(audio)} samples for {n} codes")
        check(fused_launches == st["decode_steps"] > 0,
              f"fused kernel launched {fused_launches} times for "
              f"{st['decode_steps']} decode steps")
        check(flash_launches == 0, "the B=1 path must not use the flash kernel")
        stages = st["stages"]
        print(f"[tts] call {call}: {wall * 1e3:.1f} ms wall "
              f"({'incl. load + reference' if call == 1 else 'cached reference'}), "
              f"{n} codes, {st['decode_steps']} decode steps, "
              f"{stages['decode'] * 1e3 / st['decode_steps']:.3f} ms/step, "
              f"cache_len {st['cache_len']}, stages ms "
              + json.dumps({k: round(v * 1e3, 3) for k, v in stages.items()}))
        out[call] = {"wall_s": wall, "launches": fused_launches, **st}
    return api.model_manager.get("smoke"), out


def phase_generate_b4(torch, char):
    """The batched route (B=4, ragged rows) at full width."""
    from genie_tts_tpu_torch.models import t2s
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig

    cfg = char.t2s_cfg
    B, Sx, Sp, cap = 4, 64, 256, 128
    g = torch.Generator(device=DEV).manual_seed(1)
    phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=g, device=DEV)
    prompts = torch.randint(0, 1024, (B, Sp), generator=g, device=DEV)
    x_len = torch.tensor([40, 64, 23, 51], device=DEV)
    p_len = torch.tensor([132, 256, 77, 190], device=DEV)
    steps = 48
    fu.fused_decode_step.launches = 0
    fl.flash_decode_attention.launches = 0
    sync(torch)
    t0 = time.perf_counter()
    with torch.inference_mode():
        x = t2s.embed_text(char.t2s_params, phones,
                           torch.zeros((B, Sx, cfg.bert_dim), device=DEV))
        res = t2s.generate(char.t2s_params, cfg, SamplingConfig(), g, x, x_len,
                           prompts, p_len, max_steps=cap, cache_len=Sx + Sp + cap,
                           min_steps=steps, max_steps_dyn=steps)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = fl.flash_decode_attention.launches
    decode_steps = res.steps - 1
    check(fu.fused_decode_step.launches == 0, "B=4 must not use the fused kernel")
    check(launches == cfg.num_layers * decode_steps > 0,
          f"flash kernel launched {launches} times for {decode_steps} steps")
    check(bool((res.counts == steps).all()), f"counts {res.counts.tolist()}")
    print(f"[generate B=4] {decode_steps} decode steps in {wall * 1e3:.1f} ms "
          f"(prefill included), {launches} flash launches, cache_len {Sx + Sp + cap}")
    return {"launches": launches, "S": Sx + Sp + cap, "x_len": x_len, "p_len": p_len,
            "Sx": Sx, "Sp": Sp, "B": B}


def phase_slice_check(torch, char):
    """Greedy fp32 codes on the card (fused and flash kernels) vs the CPU."""
    from genie_tts_tpu_torch.models import t2s
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig

    cfg = char.t2s_cfg
    greedy = SamplingConfig(top_k=1)
    g = torch.Generator().manual_seed(2)
    B, Sx, Sp, cap = 2, 32, 64, 16
    phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=g)
    prompts = torch.randint(0, 1024, (B, Sp), generator=g)
    x_len, p_len = torch.tensor([32, 19]), torch.tensor([64, 41])
    params = fp32_params(torch, char)
    results = {}
    for dev in (DEV, "cpu"):
        p = to_device(torch, params, dev)
        with torch.inference_mode():
            for b in (1, 2):
                codes, n = t2s.generate_e2e(
                    p, cfg, greedy, None, phones[:b].to(dev), None, x_len[:b].to(dev),
                    prompts[:b].to(dev), p_len[:b].to(dev), max_steps=cap,
                    cache_len=Sx + Sp + cap)
                results[dev, b] = (codes.cpu(), n.cpu())
    agree = []
    for b in (1, 2):
        (cc, cn), (rc, rn) = results[DEV, b], results["cpu", b]
        agree.append(float((cc == rc).float().mean()))
    print(f"[slice] greedy fp32 codes, card vs CPU: agreement B=1 {agree[0]:.3f}, "
          f"B=2 {agree[1]:.3f} (tolerance >= 0.9: fp32 sums in another order "
          f"can flip a near-tie)")
    check(min(agree) >= 0.9, f"card/CPU greedy agreement {agree}")


def phase_slots(torch, root: Path):
    """The slot-serving path through the entry points a user calls."""
    import threading

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.utils.metrics import metrics

    # the tts phase's weights (linked) under the default T2SConfig: 500 steps
    char_dir = root / "char_slots"
    char_dir.mkdir()
    for name in ("t2s.safetensors", "vits.safetensors"):
        os.link(root / "char" / name, char_dir / name)
    from genie_tts_tpu_torch.convert.io import save_character_config

    save_character_config(char_dir / "config.json", version="v2", language="ja")
    api.load_character("slots", char_dir, "ja", device=DEV)
    api.set_reference_audio("slots", root / "ref.wav", "こんにちは、てすとです", "ja")
    char = api.model_manager.get("slots")
    check(char.t2s_cfg.max_decode_steps == 500 and char.t2s_cfg.num_layers == 24
          and char.t2s_params["layers"]["qkv"]["w"].dtype == torch.int8,
          "slot character: default T2SConfig with int8 decode weights")
    synth, _ = api._make_synth_fn("slots", use_batcher=True)
    sb = api.get_slot_batcher(char)
    geom = (sb.n_slots, sb.W, sb.ring, sb.sx, sb.sp)
    check(sb.cfg.slot_kv_int8 and geom == (8, 32, 512, 192, 192),
          f"slot geometry {geom}, kv_int8 {sb.cfg.slot_kv_int8}")

    lat, out, errors = {}, {}, []

    def client(i):
        try:
            t0 = time.perf_counter()
            out[i] = synth(SENTENCES[i])
            lat[i] = time.perf_counter() - t0
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(10)]
    i8.int8_big_attention.launches = 0
    fl.flash_decode_attention.launches = 0
    fu.fused_decode_step.launches = 0
    sb.stats.update(segments=0, steps=0, peak_occupancy=0)
    metrics.reset()
    sync(torch)
    t0 = time.perf_counter()
    for t in threads[:6]:
        t.start()
    while sb.stats["segments"] < 2 and not errors and time.perf_counter() - t0 < 300:
        time.sleep(0.005)
    for t in threads[6:]:
        t.start()
    for t in threads:
        t.join(timeout=900)
    sync(torch)
    wall = time.perf_counter() - t0
    launches = i8.int8_big_attention.launches
    steps = sb.stats["steps"]
    check(not errors and len(out) == 10, f"slot clients failed: {errors}")
    check(fl.flash_decode_attention.launches == 0 and fu.fused_decode_step.launches == 0,
          "the slot path must not launch the flash or fused kernel")
    check(launches == char.t2s_cfg.num_layers * steps > 0,
          f"int8 kernel launched {launches} times for {steps} decode steps")
    check(sb.stats["peak_occupancy"] == 8, f"peak occupancy {sb.stats['peak_occupancy']}")
    n_codes = min(char.t2s_cfg.max_decode_steps, sb.ring)   # EOS pinned: every row decodes its cap
    for i, a in out.items():
        check(a.dtype == np.int16 and len(a) == 2 * n_codes * 640,
              f"request {i}: {a.dtype} PCM of {len(a)} samples, want {2 * n_codes * 640}")
    audio_s = sum(len(a) for a in out.values()) / 32000.0
    lats = sorted(lat.values())
    print(f"[slots] 10 requests in {wall:.3f} s wall: latency p50 {lats[4]:.3f} s, "
          f"max {lats[-1]:.3f} s; {10 / wall:.3f} utt/s, {audio_s / wall:.2f} audio s/s; "
          f"{sb.stats['segments']} segments, {steps} decode steps, {launches} int8 "
          f"launches, peak occupancy {sb.stats['peak_occupancy']}")
    joins = metrics.snapshot()["timers"]["slot_join"]
    check(joins["count"] == 10, f"slot_join timer: {joins}")
    print(f"[slots] slot_join timer (host clock: the join's prefill and insert graphs "
          f"dispatched, the first join capturing them: the machine was not swept): "
          f"{json.dumps(joins)}")

    # decode ms per segment at occupancy 8, on the live state
    sb.stop()
    sb._thread.join(timeout=120)
    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache

    feats = reference_audio_cache.get_features(
        api.engine, char, str(root / "ref.wav"), "こんにちは、てすとです", "Japanese")
    phones = np.concatenate([feats.phones, api.get_phones_and_bert("。" + SENTENCES[0],
                                                                   "ja")[0]])
    ctx, samp = _slot_rows(torch, char, feats, phones, sb.sx, sb.sp)
    state = sb._state
    with torch.inference_mode():
        for b in range(sb.n_slots):
            state = slots.insert_slot(state, b, *ctx, len(phones), len(feats.prompt_tokens),
                                      sb.ring, sb.ring, samp)
        seg_ms = []
        for _ in range(4):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, _ = sb._decode_seg(char.t2s_params, state, generator=sb._gen)
            e1.record()
            sync(torch)
            seg_ms.append(e0.elapsed_time(e1))
        # one more segment under torch.profiler: device busy time by kernel
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            state, _ = sb._decode_seg(char.t2s_params, state, generator=sb._gen)
            e1.record()
            sync(torch)
    check(bool(state.active.all()) and not bool(state.done.any()), "occupancy 8 in the timing")
    print(f"[slots] decode_segment at occupancy 8 (W={sb.W}, 24 layers): "
          + ", ".join(f"{m:.3f}" for m in seg_ms) + f" ms per segment "
          f"({seg_ms[-1] / sb.W:.3f} ms/step in the last)")
    kernels = [(getattr(a, "self_device_time_total", None)
                or getattr(a, "self_cuda_time_total", 0.0), a.count, a.key)
               for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_ms = sum(k[0] for k in kernels) / 1e3
    prof_ms = e0.elapsed_time(e1)
    if busy_ms > 0:
        top = "; ".join(f"{key[:48]} x{n} {us / 1e3:.2f} ms"
                        for us, n, key in sorted(kernels, reverse=True)[:6])
        print(f"[slots] profiled segment: {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({busy_ms / prof_ms:.1%}), {sum(k[1] for k in kernels)} kernel launches "
              f"({sum(k[1] for k in kernels) / sb.W:.0f} per step); top: {top}")
    else:
        print("[slots] profiled segment: the profiler shows no device time (not measured)")
    live = dict(state=state, head=state.ring_head)
    return {"launches": launches, "steps": steps, "wall_s": wall, "seg_ms": seg_ms,
            "sb": sb, "feats": feats, "phones": phones, "char": char, "live": live,
            "slot_join": joins}


def phase_slots_bf16(torch, char, feats, phones):
    """The bf16 KV mode of the slot machine (the JAX package's default):
    on the card its attention is the exact caches' kernel."""
    import threading

    import numpy as np

    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops import slot_attention as sa
    from genie_tts_tpu_torch.runtime.engine import TTSEngine
    from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher

    sb = SlotBatcher(TTSEngine(RuntimeConfig(slot_kv_int8=False)), char, pcm16=True)
    check(sb._state.k_cache.dtype == torch.bfloat16, "bf16 slot caches")
    text = phones[len(feats.phones):]
    bert = np.zeros((len(text), char.t2s_cfg.bert_dim), np.float32)
    out = {}
    i8.int8_big_attention.launches = 0
    sa.slot_attention.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda i=i: out.__setitem__(
        i, sb.synthesize(feats, text, bert, timeout=600, max_steps=64))) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sb.stop()
    wall = time.perf_counter() - t0
    check(len(out) == 2, "bf16 slot requests failed")
    for a in out.values():
        check(a.dtype == np.int16 and len(a) == 2 * 64 * 640, f"bf16 slot audio {len(a)}")
    check(i8.int8_big_attention.launches == 0, "the bf16 slot mode launched the int8 kernel")
    launches = sa.slot_attention.launches
    check(sb.attn_kernel == 1
          and launches == char.t2s_cfg.num_layers * sb.stats["steps"] > 0,
          f"the bf16 slot mode's attention: {launches} slot_attention launches, {sb.stats}")
    print(f"[slots bf16] 2 requests of 64 steps in {wall:.3f} s, {sb.stats['segments']} "
          f"segments, {launches} slot_attention launches (24 a step), no int8 launches")
    exact_slice_check(torch, char)
    return dict(segment_timing(torch, char, feats, phones), launches=launches)


def _slot_rows(torch, char, feats, phones, sx, sp):
    """The prefilled context of one request at the slot geometry."""
    import numpy as np

    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, SamplingRows, rows_from_config

    samp = rows_from_config(SamplingConfig(), 1)
    with torch.inference_mode():
        ctx = slots.prefill_join(
            char.t2s_params, char.t2s_cfg,
            torch.tensor(np.pad(phones, (0, sx - len(phones)))[None], device=DEV).long(),
            None, torch.tensor([len(phones)], device=DEV),
            torch.tensor(np.pad(feats.prompt_tokens, (0, sp - len(feats.prompt_tokens)))[None],
                         device=DEV).long(),
            torch.tensor([len(feats.prompt_tokens)], device=DEV),
            SamplingRows(*(torch.tensor(a, device=DEV) for a in samp)), any_top_p=False,
            generator=torch.Generator(device=DEV).manual_seed(7))
    return ctx, SamplingRows(*(a[0] for a in samp))


def exact_slice_check(torch, char):
    """Greedy fp32 slot codes with exact KV, two rows joining a segment
    apart: the card (the slot attention kernel over the first ring copy)
    vs the kernel's plain version on the CPU. Both must be identical."""
    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops import slot_attention as sa
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, rows_from_config

    cfg = char.t2s_cfg
    Sx, Sp, ring, W, V, steps = 32, 64, 64, 8, cfg.semantic_vocab, 40
    g = torch.Generator().manual_seed(6)
    phones = torch.randint(1, cfg.phoneme_vocab, (2, Sx), generator=g)
    prompts = torch.randint(0, 1024, (2, Sp), generator=g)
    x_len, p_len = [27, 12], [50, 33]
    samp = rows_from_config(SamplingConfig(top_k=1), 1)
    params = fp32_params(torch, char)
    toks = {}
    for run, dev in (("card", DEV), ("cpu", "cpu")):
        p = to_device(torch, params, dev)
        streams = [[], []]
        before = sa.slot_attention.launches
        with torch.inference_mode():
            st = slots.init_slots(cfg, 2, Sx, Sp, ring, torch.float32, device=dev)
            zeros = torch.zeros((W, 2, V), device=dev)
            for seg in range(6):
                if seg < 2:                      # row 0 joins, then row 1 a segment later
                    b = seg
                    k, v, tok0, hist = slots.prefill_join(
                        p, cfg, phones[b:b + 1].to(dev), None,
                        torch.tensor([x_len[b]], device=dev), prompts[b:b + 1].to(dev),
                        torch.tensor([p_len[b]], device=dev), samp,
                        noise=torch.zeros((1, V), device=dev))
                    st = slots.insert_slot(st, b, k, v, tok0, hist, x_len[b], p_len[b], steps,
                                           steps, type(samp)(*(a[0] for a in samp)))
                    streams[b].append(int(tok0[0]))
                st, seg_tok = slots.decode_segment(p, st, cfg, W, Sx, Sp, ring, noise=zeros)
                for r in range(min(seg + 1, 2)):
                    streams[r].extend(seg_tok[r].tolist())
        toks[run] = streams
        if dev == DEV:
            check(sa.slot_attention.launches - before == cfg.num_layers * 6 * W,
                  "the card's exact slot machine did not run the slot attention kernel")
    same = toks["cpu"] == toks["card"]
    print(f"[exact slice] greedy fp32 slot codes, exact KV: card (slot attention kernel) vs "
          f"CPU (its plain version): {'identical' if same else 'DIFFER'} "
          f"({len(toks['card'][0])} + {len(toks['card'][1])} tokens)")
    check(same, "card and CPU exact-KV slot codes differ")


def segment_timing(torch, char, feats, phones):
    """A 32-step segment with 8 rows occupied, bf16 KV at the default slot
    geometry (Sx=Sp=192, ring 512: 896 columns a row) through the slot
    attention kernel, by CUDA events; then one 8-step segment under
    torch.profiler for the device's busy time and launches a step (a
    32-step one takes the profiler about a minute to digest)."""
    import dataclasses

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from genie_tts_tpu_torch.models import slots

    cfg = char.t2s_cfg
    B, W, sx, sp, ring = 8, 32, 192, 192, 512
    ctx_cols = len(phones) + len(feats.prompt_tokens)
    (k, v, tok0, hist), samp = _slot_rows(torch, char, feats, phones, sx, sp)
    gen = torch.Generator(device=DEV).manual_seed(8)
    times = []
    with torch.inference_mode():
        # persistent: the segment graphs replay on it, with no copy in or out
        state = dataclasses.replace(
            slots.init_slots(cfg, B, sx, sp, ring, torch.bfloat16, device=DEV), persistent=True)
        for b in range(B):
            state = slots.insert_slot(state, b, k, v, tok0, hist, len(phones),
                                      len(feats.prompt_tokens), ring, ring, samp)

        def segment(w=W):
            nonlocal state
            state, _ = slots.decode_segment(char.t2s_params, state, cfg, w, sx, sp, ring,
                                            generator=gen)

        for _ in range(4):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            segment()
            e1.record()
            sync(torch)
            times.append(e0.elapsed_time(e1))
        segment(8)                              # the 8-step graph's capture, not profiled
        sync(torch)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            segment(8)
            sync(torch)
        acts = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
        busy = sum(getattr(a, "self_device_time_total", None)
                   or getattr(a, "self_cuda_time_total", 0.0) for a in acts) / 1e3
        n_kern = sum(a.count for a in acts)
    check(bool(state.active.all()) and not bool(state.done.any()),
          "occupancy 8 in the timing")
    print(f"[segment timing] exact bf16 KV, {ctx_cols} context columns a row, 32-step segment "
          f"at occupancy 8 through the slot attention kernel: "
          + ", ".join(f"{m:.3f}" for m in times)
          + f" ms (CUDA events, {times[-1] / W:.3f} ms a step in the last); device busy "
          f"{busy:.3f} ms in one profiled 8-step segment ({busy / 8:.3f} ms a step, "
          f"{n_kern / 8:.0f} device ops a step)")
    return {"ms": times, "device_busy_ms_per_step": busy / 8, "ops_per_step": n_kern / 8}


def phase_slot_slice_check(torch, char):
    """Greedy fp32 slot-machine codes with the int8 KV cache: the card
    (through the kernel) vs the CPU (plain version)."""
    import numpy as np

    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, rows_from_config

    cfg = char.t2s_cfg
    Sx, Sp, ring, W, V = 32, 64, 32, 8, cfg.semantic_vocab
    g = torch.Generator().manual_seed(4)
    phones = torch.randint(1, cfg.phoneme_vocab, (2, Sx), generator=g)
    prompts = torch.randint(0, 1024, (2, Sp), generator=g)
    x_len, p_len = [32, 21], [64, 37]
    samp = rows_from_config(SamplingConfig(top_k=1), 1)
    params = fp32_params(torch, char)
    toks = {}
    for dev in (DEV, "cpu"):
        p = to_device(torch, params, dev)
        before = i8.int8_big_attention.launches
        with torch.inference_mode():
            st = slots.init_slots(cfg, 2, Sx, Sp, ring, torch.float32, kv_int8=True,
                                  device=dev)
            streams = [[], []]
            zeros = torch.zeros((W, 2, V), device=dev)
            for seg in range(2):
                b = seg                          # row 0 joins, then row 1 a segment later
                k, v, tok0, hist = slots.prefill_join(
                    p, cfg, phones[b:b + 1].to(dev), None, torch.tensor([x_len[b]], device=dev),
                    prompts[b:b + 1].to(dev), torch.tensor([p_len[b]], device=dev), samp,
                    noise=torch.zeros((1, V), device=dev))
                st = slots.insert_slot(st, b, k, v, tok0, hist, x_len[b], p_len[b], ring, ring,
                                       type(samp)(*(a[0] for a in samp)))
                streams[b].append(int(tok0[0]))
                st, seg_tok = slots.decode_segment(p, st, cfg, W, Sx, Sp, ring,
                                                   kv_kernel=True, noise=zeros)
                for r in range(seg + 1):
                    streams[r].extend(seg_tok[r].tolist())
        toks[dev] = streams
        if dev == DEV:
            check(i8.int8_big_attention.launches - before == cfg.num_layers * 2 * W,
                  "the card's slot machine did not run the int8 kernel")
    a, b = toks[DEV], toks["cpu"]
    agree = [float(np.mean(np.array(x) == np.array(y))) for x, y in zip(a, b)]
    print(f"[slot slice] greedy fp32 slot codes, int8 KV, card (kernel) vs CPU (plain): "
          f"agreement row 0 {agree[0]:.3f} ({len(a[0])} tokens), row 1 (joined a "
          f"segment later) {agree[1]:.3f} ({len(a[1])} tokens) (tolerance >= 0.9)")
    check(min(agree) >= 0.9, f"slot card/CPU agreement {agree}")


def phase_v2pp(torch, root: Path, card: str):
    """V2ProPlus voice cloning through the entry points a user calls, at
    full width: a random V2ProPlus character from the port's own
    ``init_params`` (24-layer T2S with int8 decode weights, the full
    SoVITS with gin 1024, the full prompt encoder 20480 -> 1024 -> 512,
    bf16, a 128-step cap, EOS pinned) and a full random ERes2NetV2 written
    as ``speaker_encoder.safetensors`` (``GENIE_SV_MODEL``), then
    ``load_character`` -> ``set_reference_audio`` (HuBERT, Kaldi fbank ->
    ERes2NetV2 -> prompt encoder) -> ``tts(..., save_path=...)`` twice, then
    2 concurrent requests on the int8 slot route."""
    import threading

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import SoVITSConfig, T2SConfig
    from genie_tts_tpu_torch.convert.io import load_params, save_character_config, save_params
    from genie_tts_tpu_torch.models import eres2net
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops.audio import kaldi_fbank
    from genie_tts_tpu_torch.runtime.engine import make_random_character
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
    from genie_tts_tpu_torch.utils.wavio import read_audio

    t0 = time.perf_counter()
    rc = make_random_character(t2s_cfg=T2SConfig(max_decode_steps=128),
                               sovits_cfg=SoVITSConfig(version="v2ProPlus", gin_channels=1024),
                               seed=11, eos_boost=0.0, device=DEV)
    char_dir = root / "char_pp"
    char_dir.mkdir()
    save_params(rc.t2s_params, char_dir / "t2s.safetensors")
    save_params(rc.sovits_params, char_dir / "vits.safetensors")
    save_params(rc.prompt_encoder_params, char_dir / "prompt_encoder.safetensors")
    save_character_config(char_dir / "config.json", version="v2ProPlus", language="ja",
                          extra={"t2s": {"max_decode_steps": 128}})
    sv_path = root / "speaker_encoder.safetensors"
    save_params(eres2net.init_params(torch.Generator(device=DEV).manual_seed(12)), sv_path)
    os.environ["GENIE_SV_MODEL"] = str(sv_path)
    del rc
    print(f"[v2pp] random full-width V2ProPlus character and ERes2NetV2 written in "
          f"{time.perf_counter() - t0:.1f} s")

    ref, text = str(root / "ref.wav"), "こんにちは、てすとです"
    api.engine.timing = True
    out = {}
    api.load_character("pp", char_dir, "ja", device=DEV)
    char = api.model_manager.get("pp")
    check(char.version == "v2ProPlus" and char.sovits_cfg.gin_channels == 1024
          and char.prompt_encoder_params["sv_emb"]["w"].shape == (20480, 1024)
          and "ref_enc" not in char.sovits_params
          and char.t2s_params["layers"]["qkv"]["w"].dtype == torch.int8,
          "V2ProPlus character: gin 1024, prompt encoder, int8 decode weights")
    sync(torch)
    t0 = time.perf_counter()
    api.set_reference_audio("pp", ref, text, "ja")
    sync(torch)
    out["reference_s"] = time.perf_counter() - t0
    feats = reference_audio_cache.get_features(api.engine, char, ref, text, "Japanese")
    check(feats.ge.shape == (1024, 1) and feats.ge_mrte.shape == (512, 1)
          and np.isfinite(feats.ge).all() and np.isfinite(feats.ge_mrte).all(),
          f"V2ProPlus features ge {feats.ge.shape}, ge_mrte {feats.ge_mrte.shape}")

    # the SV forward alone: Kaldi fbank + ERes2NetV2 on the card (CUDA events)
    clip = reference_audio_cache.get_clip(ref, text, "Japanese")
    sv_params = load_params(sv_path, torch.bfloat16, DEV)
    audio16 = torch.as_tensor(clip.audio_16k, device=DEV)[None]
    with torch.inference_mode():
        fb = kaldi_fbank(audio16)
        out["fbank_ms"] = cuda_ms(torch, lambda: kaldi_fbank(audio16), 10)
        out["sv_ms"] = cuda_ms(torch, lambda: eres2net.apply(sv_params, fb), 5)
    print(f"[v2pp] reference features (first set_reference_audio: HuBERT, Kaldi fbank, "
          f"ERes2NetV2, prompt encoder, prompt tokens) {out['reference_s'] * 1e3:.1f} ms wall; "
          f"SV forward alone on {fb.shape[1]} frames: fbank {out['fbank_ms']:.3f} ms + "
          f"ERes2NetV2 {out['sv_ms']:.3f} ms (CUDA events); {card}")
    out["reference_split_ms"] = reference_split(torch, char, clip, audio16, fb, sv_params,
                                                out, card)

    for call in (1, 2):
        fu.fused_decode_step.launches = 0
        fl.flash_decode_attention.launches = 0
        wav = root / f"pp{call}.wav"
        sync(torch)
        t0 = time.perf_counter()
        api.tts("pp", "きょうはいいてんきですね。", save_path=wav)
        sync(torch)
        wall = time.perf_counter() - t0
        fused_launches = fu.fused_decode_step.launches
        st = api.engine.last_stats
        audio, sr = read_audio(wav)
        n = st["codes_len"]
        check(sr == 32000 and np.isfinite(audio).all() and len(audio) == 2 * n * 640 > 0,
              f"V2ProPlus wav of {len(audio)} samples for {n} codes")
        check(fused_launches == st["decode_steps"] > 0
              and fl.flash_decode_attention.launches == 0,
              f"V2ProPlus: fused kernel launched {fused_launches} times for "
              f"{st['decode_steps']} decode steps")
        stages = st["stages"]
        print(f"[v2pp] tts call {call}: {wall * 1e3:.1f} ms wall, {n} codes, "
              f"{st['decode_steps']} decode steps, "
              f"{stages['decode'] * 1e3 / st['decode_steps']:.3f} ms/step, {fused_launches} "
              f"fused launches, stages ms "
              + json.dumps({k: round(v * 1e3, 3) for k, v in stages.items()}) + f"; {card}")
        out[f"tts{call}"] = {"wall_s": wall, "launches": fused_launches, **st}

    # the int8 slot route: 2 concurrent requests
    synth, _ = api._make_synth_fn("pp", use_batcher=True)
    sb = api.get_slot_batcher(char)
    check(sb.cfg.slot_kv_int8 and not sb.attn_kernel, "V2ProPlus slot route: int8 KV kernel")
    res, errors = {}, []

    def client(i):
        try:
            res[i] = synth(SENTENCES[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    i8.int8_big_attention.launches = 0
    fu.fused_decode_step.launches = 0
    sb.stats.update(segments=0, steps=0)
    sync(torch)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sync(torch)
    wall = time.perf_counter() - t0
    launches, steps = i8.int8_big_attention.launches, sb.stats["steps"]
    check(not errors and len(res) == 2, f"V2ProPlus slot clients failed: {errors}")
    codes = min(char.t2s_cfg.max_decode_steps, sb.ring)
    for a in res.values():
        check(a.dtype == np.int16 and len(a) == 2 * codes * 640,
              f"V2ProPlus slot audio {a.dtype} {len(a)}")
    check(launches == char.t2s_cfg.num_layers * steps > 0
          and fu.fused_decode_step.launches == 0,
          f"V2ProPlus slot route: int8 kernel launched {launches} times for {steps} steps")
    print(f"[v2pp] slot route, 2 concurrent requests of {codes} codes: {wall:.3f} s wall, "
          f"{sb.stats['segments']} segments, {steps} decode steps, {launches} int8 launches; "
          f"{card}")
    out["slots"] = {"wall_s": wall, "steps": steps, "launches": launches}
    return out, clip, sv_path


def reference_split(torch, char, clip, audio16, fb, sv_params, out, card):
    """Where a first ``set_reference_audio`` spends its device time: each
    program of the reference features alone at this clip's length (CUDA
    events, eager, as the port runs them: once per clip), the V2
    ``reference_embedding`` on phase 3's character beside the V2ProPlus
    programs."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.models import hubert, prompt_encoder, sovits, t2s
    from genie_tts_tpu_torch.ops.audio import linear_spectrogram

    hparams, hcfg = api.model_manager.load_hubert(DEV)
    v2 = api.model_manager.get("smoke")
    vcfg = char.sovits_cfg
    with torch.inference_mode():
        audio32 = torch.as_tensor(clip.audio_32k, device=DEV)[None]
        ssl = hubert.apply(hparams, audio16, hcfg)
        spec = linear_spectrogram(audio32, n_fft=vcfg.n_fft, hop=vcfg.hop_length,
                                  win_length=vcfg.win_length)
        lens = torch.tensor([spec.shape[1]], device=DEV)
        sv = torch.randn((1, 20480), device=DEV)
        progs = {
            "HuBERT": lambda: hubert.apply(hparams, audio16, hcfg),
            "extract_prompt_tokens": lambda: t2s.extract_prompt_tokens(char.t2s_params, ssl),
            "Kaldi fbank": None, "ERes2NetV2": None,
            "linear spectrogram": lambda: linear_spectrogram(
                audio32, n_fft=vcfg.n_fft, hop=vcfg.hop_length, win_length=vcfg.win_length),
            "prompt encoder": lambda: prompt_encoder.apply(char.prompt_encoder_params, spec,
                                                           lens, sv),
            "reference_embedding (V2)": lambda: sovits.reference_embedding(
                v2.sovits_params, v2.sovits_cfg, spec, lens),
        }
        split = {k: (cuda_ms(torch, fn, 5) if fn is not None else None)
                 for k, fn in progs.items()}
    split["Kaldi fbank"], split["ERes2NetV2"] = out["fbank_ms"], out["sv_ms"]
    v2pp = sum(v for k, v in split.items() if k != "reference_embedding (V2)")
    print(f"[v2pp] a first set_reference_audio, split by program ({audio16.shape[1] / 16000:.2f} "
          f"s clip, {fb.shape[1]} fbank frames, {ssl.shape[1]} HuBERT frames; device ms by "
          f"CUDA events, eager): " + json.dumps({k: round(v, 3) for k, v in split.items()})
          + f"; V2ProPlus programs {v2pp:.3f} ms of the {out['reference_s'] * 1e3:.1f} ms wall; "
          f"{card}")
    return split


def phase_v2pp_slice_check(torch, clip, sv_path):
    """The V2ProPlus modules on the card against the CPU, fp32 weights on
    both: the SV embedding of the clip (relative L2 <= 1e-3), the prompt
    encoder's ge / ge_mrte from the same SV embedding (within 1e-3), and
    greedy fp32 codes of the character's T2S (agreement >= 0.9)."""
    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.convert.io import load_params
    from genie_tts_tpu_torch.models import eres2net, prompt_encoder, t2s
    from genie_tts_tpu_torch.ops.audio import kaldi_fbank, linear_spectrogram
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig

    char = api.model_manager.get("pp")
    cfg = char.sovits_cfg
    emb, ges = {}, {}
    pe32 = to_device(torch, char.prompt_encoder_params, "cpu")
    rng = np.random.default_rng(13)
    sv_emb = rng.standard_normal((1, cfg.sv_dim)).astype(np.float32)
    for dev in (DEV, "cpu"):
        params = load_params(sv_path, torch.float32, dev)
        pe = to_device(torch, pe32, dev)
        with torch.inference_mode():
            audio = torch.as_tensor(clip.audio_16k, device=dev)[None]
            emb[dev] = eres2net.apply(params, kaldi_fbank(audio))[0].cpu().numpy()
            a32 = torch.as_tensor(clip.audio_32k, device=dev)[None]
            spec = linear_spectrogram(a32, n_fft=cfg.n_fft, hop=cfg.hop_length,
                                      win_length=cfg.win_length)
            ge, gm = prompt_encoder.apply(pe, spec, torch.tensor([spec.shape[1]], device=dev),
                                          torch.as_tensor(sv_emb, device=dev))
            ges[dev] = (ge.cpu().numpy(), gm.cpu().numpy())
    rel = float(np.linalg.norm(emb[DEV] - emb["cpu"]) / np.linalg.norm(emb["cpu"]))
    d_ge = max(float(np.abs(a - b).max()) for a, b in zip(ges[DEV], ges["cpu"]))
    print(f"[v2pp slice] SV embedding card vs CPU (fp32 weights, TF32 off): relative L2 "
          f"{rel:.2e} (tolerance 1e-3); prompt encoder ge / ge_mrte max |card - CPU| "
          f"{d_ge:.2e} (tolerance 1e-3)")
    check(rel <= 1e-3 and d_ge <= 1e-3, f"V2ProPlus slice: SV {rel}, ge {d_ge}")

    tcfg = char.t2s_cfg
    g = torch.Generator().manual_seed(14)
    B, Sx, Sp, cap = 1, 32, 64, 16
    phones = torch.randint(1, tcfg.phoneme_vocab, (B, Sx), generator=g)
    prompts = torch.randint(0, 1024, (B, Sp), generator=g)
    params = fp32_params(torch, char)
    codes = {}
    for dev in (DEV, "cpu"):
        p = to_device(torch, params, dev)
        with torch.inference_mode():
            c, n = t2s.generate_e2e(p, tcfg, SamplingConfig(top_k=1), None, phones.to(dev),
                                    None, torch.tensor([29], device=dev), prompts.to(dev),
                                    torch.tensor([57], device=dev), max_steps=cap,
                                    cache_len=Sx + Sp + cap)
        codes[dev] = c.cpu()
    agree = float((codes[DEV] == codes["cpu"]).float().mean())
    print(f"[v2pp slice] greedy fp32 codes of the V2ProPlus T2S, card vs CPU: agreement "
          f"{agree:.3f} (tolerance >= 0.9)")
    check(agree >= 0.9, f"V2ProPlus card/CPU greedy agreement {agree}")
    api.unload_character("pp")


ZH_REF_TEXT = "你好，我是小明。"
ZH_SENTENCE = "今天天气很好，我们一起去北京。"
ZH_SLOT_SENTENCES = ("他说今天很热。", "我们一起去北京。")
EN_REF_TEXT = "Hello, this is a test."
EN_SENTENCE = "Hello world, this is a test of the new port."
HYBRID_SENTENCE = "我们用Python说中文。"


def write_roberta(torch, root: Path):
    """A random full-size RoBERTa (``RobertaConfig()``: 24 layers, d1024,
    vocabulary 21128, bf16) from the port's ``init_params``, written with
    the port's writer, and a BERT-layout ``tokenizer.json`` whose
    vocabulary covers the phase's Chinese text (each character a token,
    ids spread over the table)."""
    from genie_tts_tpu_torch.config import RobertaConfig
    from genie_tts_tpu_torch.convert.io import save_params
    from genie_tts_tpu_torch.frontend.g2p_zh import chinese_to_phones
    from genie_tts_tpu_torch.frontend.wordpiece import bert_layout
    from genie_tts_tpu_torch.models import roberta

    cfg = RobertaConfig()
    out = root / "RoBERTa"
    out.mkdir()
    params = roberta.init_params(torch.Generator(device=DEV).manual_seed(21), cfg,
                                 torch.bfloat16)
    save_params(params, out / "roberta.safetensors")
    del params
    vocab = {"[PAD]": 0, "[UNK]": 100, "[CLS]": 101, "[SEP]": 102, "[MASK]": 103}
    chars = sorted({c for s in (ZH_REF_TEXT, ZH_SENTENCE, HYBRID_SENTENCE) + ZH_SLOT_SENTENCES
                    for c in chinese_to_phones("。" + s)[0] + chinese_to_phones(s)[0]})
    for i, c in enumerate(chars):
        vocab[c] = 670 + i * (cfg.vocab_size - 700) // len(chars)
    (out / "tokenizer.json").write_text(json.dumps(bert_layout(vocab)), encoding="utf-8")
    return out


def phase_zh(torch, root: Path, card: str):
    """Chinese, English and hybrid text through the entry points a user
    calls, with RoBERTa BERT features at full size: a random RoBERTa under
    ``GENIE_ROBERTA_DIR``, the tts phase's V2 character loaded as ``zh``
    (``load_character`` loads RoBERTa on the card and installs the BERT
    hook) with a Chinese reference text, ``tts()`` twice on a Chinese
    sentence, 2 concurrent Chinese requests on the int8 slot route, then
    the same character as ``en`` and as ``Hybrid-Chinese-English``,
    ``tts()`` once each. Then the card against the port's own CPU run:
    RoBERTa's ``phone_features`` in fp32 (relative L2 <= 1e-4) and greedy
    fp32 codes of the Chinese sentence with its BERT rows (identical)."""
    import threading

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.convert.io import load_params
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert
    from genie_tts_tpu_torch.frontend.g2p_zh import chinese_to_phones
    from genie_tts_tpu_torch.models import roberta, t2s
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig
    from genie_tts_tpu_torch.runtime import graphs
    from genie_tts_tpu_torch.runtime.buckets import pick_bucket
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
    from genie_tts_tpu_torch.utils.wavio import read_audio

    t0 = time.perf_counter()
    rdir = write_roberta(torch, root)
    os.environ["GENIE_ROBERTA_DIR"] = str(rdir)
    size = (rdir / "roberta.safetensors").stat().st_size
    print(f"[zh] random full-size RoBERTa ({size / 1e6:.0f} MB on disk) and "
          f"tokenizer.json written in {time.perf_counter() - t0:.1f} s")
    out = {}

    sync(torch)
    t0 = time.perf_counter()
    loaded = api.model_manager.load_roberta(DEV)
    sync(torch)
    out["load_roberta_s"] = time.perf_counter() - t0
    check(loaded is not None, "RoBERTa did not load")
    rparams, rcfg, tok = loaded
    check(rcfg.num_layers == 24 and rcfg.vocab_size == 21128
          and rparams["word_embed"].dtype == torch.bfloat16
          and rparams["word_embed"].device.type == "cuda",
          "RoBERTa: full size, bf16, on the card")

    # RoBERTa's feature program per token bucket: captured once per device
    # by the units a Chinese character's sweep runs (the second run, as a
    # second character's sweep, finds them), then timed graph beside eager
    rcache = graphs.cache_for(rparams)
    buckets = api.model_manager.cfg.phoneme_buckets
    sweeps = []
    for _ in range(2):
        rcache.reset_stats()
        units = api.model_manager.roberta_warmup_units(DEV)
        sync(torch)
        t0 = time.perf_counter()
        for u in units:
            u()
        sync(torch)
        sweeps.append((time.perf_counter() - t0, dict(rcache.stats)))
    check(sweeps[0][1]["captures"] == len(buckets) == len(units)
          and sweeps[1][1] == {"hits": len(buckets), "misses": 0, "variants": 0,
                               "captures": 0}, f"RoBERTa sweep: {sweeps}")
    out["roberta_sweep"] = {"s": [w for w, _ in sweeps], "pool_mib": rcache.pool_bytes() / 2 ** 20,
                            "buffers_mib": rcache.buffer_bytes() / 2 ** 20}
    print(f"[zh] RoBERTa feature graphs at token buckets {list(buckets)}: captured in "
          f"{sweeps[0][0]:.2f} s (caches {json.dumps(sweeps[0][1])}); again (a second "
          f"Chinese character's sweep) {sweeps[1][0]:.3f} s (caches "
          f"{json.dumps(sweeps[1][1])}); pool {out['roberta_sweep']['pool_mib']:.1f} MiB, "
          f"static buffers {out['roberta_sweep']['buffers_mib']:.1f} MiB, once per device; "
          f"{card}")
    n_layers = rcfg.feature_layer % (rcfg.num_layers + 1)
    w_bytes = 2 * n_layers * (4 * rcfg.embed_dim ** 2 + 2 * rcfg.embed_dim * rcfg.ffn_dim)
    out["roberta_buckets"] = {}
    for T in buckets:
        fg, ffn = roberta.feature_graph(rparams, rcfg, T)
        with fg.lock:
            fg.static.ids.copy_(torch.randint(0, rcfg.vocab_size, (1, T), generator=torch.Generator(
                device=DEV).manual_seed(T), device=DEV))
            fg.static.mask.fill_(1)
        ms = {"graph": [], "eager": []}
        for eager in (False, True, True, False):
            rcache.eager = eager
            try:
                with torch.inference_mode(), fg.lock:
                    ms["eager" if eager else "graph"].append(
                        cuda_ms(torch, lambda: fg.run(ffn), 5, warmup=1))
            finally:
                rcache.eager = False
        flops = 2 * T * n_layers * (4 * rcfg.embed_dim ** 2 + 2 * rcfg.embed_dim * rcfg.ffn_dim
                                    + 2 * T * rcfg.embed_dim)
        b_ms, b_by = bound(w_bytes + T * rcfg.embed_dim * 4, flops, "bfloat16")
        out["roberta_buckets"][T] = {**ms, "bound_ms": b_ms, "bound_by": b_by}
        print(f"[zh] RoBERTa feature program, {T} tokens ({n_layers} layers, bf16): device ms "
              f"(CUDA events) graph " + ", ".join(f"{x:.3f}" for x in ms["graph"]) + "; eager "
              + ", ".join(f"{x:.3f}" for x in ms["eager"]) + f"; bound {b_ms:.4f} ms ({b_by}); "
              f"{card}")
    rcache.reset_stats()

    char_dir, ref = root / "char", str(root / "ref.wav")
    api.engine.timing = True
    api.load_character("zh", char_dir, "zh", device=DEV)
    check(api.model_manager.load_roberta(DEV) is loaded,
          "a second character on the card must not load RoBERTa again")
    char = api.model_manager.get("zh")
    api.set_reference_audio("zh", ref, ZH_REF_TEXT, "zh")
    feats = reference_audio_cache.get_features(api.engine, char, ref, ZH_REF_TEXT, "Chinese")
    check(len(feats.phones) > 0 and np.all(np.abs(feats.bert).sum(axis=1) > 0),
          "the Chinese reference text must give non-zero BERT rows")

    # host G2P times and the RoBERTa forward of the sentence
    norm, _, _, word2ph = chinese_to_phones(ZH_SENTENCE)
    t0 = time.perf_counter()
    for _ in range(10):
        chinese_to_phones(ZH_SENTENCE)
    out["zh_g2p_ms"] = (time.perf_counter() - t0) * 100
    t0 = time.perf_counter()
    for _ in range(10):
        get_phones_and_bert(EN_SENTENCE, "en")
    out["en_g2p_ms"] = (time.perf_counter() - t0) * 100
    zh_ids, zh_bert = get_phones_and_bert(ZH_SENTENCE, "zh")
    en_ids, en_bert = get_phones_and_bert(EN_SENTENCE, "en")
    check(len(zh_ids) == sum(word2ph) and np.all(np.abs(zh_bert).sum(axis=1) > 0),
          "Chinese BERT rows must be non-zero, one per phoneme")
    check(len(en_ids) > 0 and not np.any(en_bert), "English BERT rows must be zero")
    enc = tok.encode(norm)
    check(len(enc.ids) - 2 == len(word2ph) and 100 not in enc.ids,
          f"tokens {len(enc.ids)} for {len(word2ph)} characters")
    ids = torch.tensor(enc.ids, device=DEV)[None]
    mask = torch.tensor(enc.attention_mask, device=DEV)[None]
    reps = torch.tensor(word2ph, device=DEV)
    with torch.inference_mode():
        out["roberta_ms"] = cuda_ms(
            torch, lambda: roberta.phone_features(rparams, ids, mask, reps, rcfg), 10)
    t0 = time.perf_counter()
    for _ in range(10):
        get_phones_and_bert(ZH_SENTENCE, "zh")
    out["zh_g2p_bert_ms"] = (time.perf_counter() - t0) * 100
    flops = 2 * len(enc.ids) * n_layers * (4 * rcfg.embed_dim ** 2
                                           + 2 * rcfg.embed_dim * rcfg.ffn_dim)
    out["roberta_bound_ms"], _ = bound(w_bytes, flops, "bfloat16")
    print(f"[zh] first load_roberta {out['load_roberta_s'] * 1e3:.1f} ms wall; RoBERTa "
          f"exact-length eager forward of the sentence ({len(enc.ids)} tokens, {n_layers} "
          f"layers, bf16) "
          f"{out['roberta_ms']:.3f} ms (CUDA events; bound {out['roberta_bound_ms']:.4f} ms "
          f"for {w_bytes / 1e6:.0f} MB of weights); host G2P: zh {out['zh_g2p_ms']:.3f} ms, "
          f"en {out['en_g2p_ms']:.3f} ms, zh with the BERT hook {out['zh_g2p_bert_ms']:.3f} "
          f"ms; {card}")

    def run_tts(name, text, tag):
        fu.fused_decode_step.launches = 0
        fl.flash_decode_attention.launches = 0
        wav = root / f"{tag}.wav"
        sync(torch)
        t0 = time.perf_counter()
        api.tts(name, text, save_path=wav)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = fu.fused_decode_step.launches
        st = api.engine.last_stats
        audio, sr = read_audio(wav)
        n = st["codes_len"]
        check(sr == 32000 and np.isfinite(audio).all() and len(audio) == 2 * n * 640 > 0,
              f"{tag}: wav of {len(audio)} samples for {n} codes")
        check(len(np.unique(audio)) > 1000, f"{tag}: {len(np.unique(audio))} distinct values")
        check(launches == st["decode_steps"] > 0 and fl.flash_decode_attention.launches == 0,
              f"{tag}: fused kernel launched {launches} times for "
              f"{st['decode_steps']} decode steps")
        stages = st["stages"]
        print(f"[zh] {tag}: {wall * 1e3:.1f} ms wall, {n} codes, {st['decode_steps']} decode "
              f"steps, {stages['decode'] * 1e3 / st['decode_steps']:.3f} ms/step, {launches} "
              f"fused launches, stages ms "
              + json.dumps({k: round(v * 1e3, 3) for k, v in stages.items()}) + f"; {card}")
        return {"wall_s": wall, "launches": launches, **st}

    for call in (1, 2):
        out[f"zh{call}"] = run_tts("zh", ZH_SENTENCE, f"zh tts call {call}")
    # the host's read of `done` every step against every 16, in turns
    ms_step = {1: [], t2s.DONE_READ_EVERY: []}
    for k in (1, t2s.DONE_READ_EVERY, t2s.DONE_READ_EVERY, 1):
        default, t2s.DONE_READ_EVERY = t2s.DONE_READ_EVERY, k
        try:
            st = run_tts("zh", ZH_SENTENCE, f"zh tts, done read every {k} steps")
        finally:
            t2s.DONE_READ_EVERY = default
        ms_step[k].append(round(st["stages"]["decode"] * 1e3 / st["decode_steps"], 3))
    print(f"[zh] decode ms/step, done read every step: {ms_step[1]}; every "
          f"{t2s.DONE_READ_EVERY} steps: {ms_step[t2s.DONE_READ_EVERY]}; {card}")

    # the /tts route: 2 concurrent Chinese requests on the int8 slot machine
    synth, _ = api._make_synth_fn("zh", use_batcher=True)
    sb = api.get_slot_batcher(char)
    check(sb.cfg.slot_kv_int8 and not sb.attn_kernel, "zh slot route: int8 KV kernel")
    res, errors = {}, []

    def client(i):
        try:
            res[i] = synth(ZH_SLOT_SENTENCES[i])
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(f"client {i}: {e!r}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    i8.int8_big_attention.launches = 0
    fu.fused_decode_step.launches = 0
    sb.stats.update(segments=0, steps=0)
    sync(torch)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    sync(torch)
    wall = time.perf_counter() - t0
    launches, steps = i8.int8_big_attention.launches, sb.stats["steps"]
    check(not errors and len(res) == 2, f"zh slot clients failed: {errors}")
    codes = min(char.t2s_cfg.max_decode_steps, sb.ring)
    for a in res.values():
        check(a.dtype == np.int16 and len(a) == 2 * codes * 640
              and len(np.unique(a)) > 1000,
              f"zh slot audio {a.dtype} {len(a)}, {len(np.unique(a))} distinct values")
    check(launches == char.t2s_cfg.num_layers * steps > 0
          and fu.fused_decode_step.launches == 0,
          f"zh slot route: int8 kernel launched {launches} times for {steps} steps")
    print(f"[zh] slot route, 2 concurrent Chinese requests of {codes} codes: {wall:.3f} s "
          f"wall, {sb.stats['segments']} segments, {steps} decode steps, {launches} int8 "
          f"launches; {card}")
    out["slots"] = {"wall_s": wall, "steps": steps, "launches": launches}

    # greedy fp32 codes of the Chinese sentence, BERT rows included,
    # card vs CPU
    tcfg = char.t2s_cfg
    phones = np.concatenate([feats.phones, zh_ids]).astype(np.int64)
    bert = np.concatenate([feats.bert, zh_bert]).astype(np.float32)
    Sx = pick_bucket(len(phones), api.engine.cfg.phoneme_buckets)
    Sp = pick_bucket(len(feats.prompt_tokens), api.engine.cfg.prompt_buckets)
    cap = 16
    check(len(phones) <= Sx and len(feats.prompt_tokens) <= Sp,
          f"{len(phones)} phonemes, {len(feats.prompt_tokens)} prompts")
    ph = torch.zeros((1, Sx), dtype=torch.long)
    ph[0, :len(phones)] = torch.from_numpy(phones)
    bt = torch.zeros((1, Sx, bert.shape[1]))
    bt[0, :len(phones)] = torch.from_numpy(bert)
    pr = torch.zeros((1, Sp), dtype=torch.long)
    pr[0, :len(feats.prompt_tokens)] = torch.from_numpy(feats.prompt_tokens.astype(np.int64))
    params = fp32_params(torch, char)
    api.unload_character("zh")
    got = {}
    for dev in (DEV, "cpu"):
        p = to_device(torch, params, dev)
        with torch.inference_mode():
            c, n = t2s.generate_e2e(p, tcfg, SamplingConfig(top_k=1), None, ph.to(dev),
                                    bt.to(dev), torch.tensor([len(phones)], device=dev),
                                    pr.to(dev), torch.tensor([len(feats.prompt_tokens)],
                                                             device=dev),
                                    max_steps=cap, cache_len=Sx + Sp + cap)
        got[dev] = (c.cpu(), n.cpu())
    check(torch.equal(got[DEV][0], got["cpu"][0]) and torch.equal(got[DEV][1], got["cpu"][1]),
          "greedy fp32 Chinese codes differ between the card and the CPU")

    # serving Chinese text after the RoBERTa sweep: every hook call a
    # replay (the reference, the tts calls, the slot requests)
    rstats = dict(rcache.stats)
    print(f"[zh] RoBERTa caches while serving after its sweep: {json.dumps(rstats)}")
    check(rstats["hits"] > 0 and rstats["misses"] == rstats["captures"] == 0,
          f"RoBERTa missed while serving: {rstats}")

    # RoBERTa phone_features in fp32, card vs CPU; on the card the padded
    # graph route against the exact-length eager route
    feats32 = {}
    for dev in (DEV, "cpu"):
        p = load_params(rdir / "roberta.safetensors", torch.float32, dev)
        with torch.inference_mode():
            feats32[dev] = roberta.phone_features(p, ids.to(dev), mask.to(dev), reps.to(dev),
                                                  rcfg).cpu()
            if dev == DEV:
                padded = roberta.bucketed_features(
                    p, rcfg, np.asarray(enc.ids), np.asarray(enc.attention_mask),
                    np.asarray(word2ph), buckets).cpu()
                check(graphs.cache_for(p).stats["captures"] == 1,
                      "the padded fp32 route did not run as a captured graph")
        del p
    a, b = feats32[DEV], feats32["cpu"]
    rel = float((a - b).norm() / b.norm())
    rel_pad = float((padded - a).norm() / a.norm())
    out["roberta_padded_rel_l2"] = rel_pad
    print(f"[zh slice] RoBERTa phone_features fp32 card vs CPU (TF32 off): relative L2 "
          f"{rel:.2e} (tolerance 1e-4), max |card - CPU| {float((a - b).abs().max()):.2e}; "
          f"the padded graph route ({len(enc.ids)} tokens in the "
          f"{roberta.token_bucket(len(enc.ids), buckets)} bucket) vs the exact-length eager "
          f"route on the card: relative L2 {rel_pad:.2e} (tolerance 1e-5); greedy fp32 codes "
          f"of the Chinese sentence with its BERT rows: identical "
          f"({int(got['cpu'][1][0])} codes)")
    check(rel <= 1e-4, f"RoBERTa card/CPU relative L2 {rel}")
    check(rel_pad <= 1e-5, f"RoBERTa padded graph vs exact relative L2 {rel_pad}")

    # English and hybrid text through tts() on the same weights
    api.load_character("en", char_dir, "en", device=DEV)
    api.set_reference_audio("en", ref, EN_REF_TEXT, "en")
    en_feats = reference_audio_cache.get_features(
        api.engine, api.model_manager.get("en"), ref, EN_REF_TEXT, "English")
    check(not np.any(en_feats.bert), "English reference BERT rows must be zero")
    out["en"] = run_tts("en", EN_SENTENCE, "en tts")
    api.unload_character("en")
    api.load_character("hy", char_dir, "Hybrid-Chinese-English", device=DEV)
    api.set_reference_audio("hy", ref, ZH_REF_TEXT, "zh")
    hy_ids, hy_bert = get_phones_and_bert(HYBRID_SENTENCE, "Hybrid-Chinese-English")
    rows = np.abs(hy_bert).sum(axis=1) > 0
    check(rows.any() and not rows.all(), "hybrid BERT: non-zero Chinese rows, zero English rows")
    out["hybrid"] = run_tts("hy", HYBRID_SENTENCE, "hybrid tts")
    api.unload_character("hy")
    return out


LONG_SENTENCE = ("きょうはとてもいいてんきなので、ともだちといっしょにこうえんへいって、"
                 "ながいあいださんぽをしてから、えきのちかくのきっさてんでこーひーをのみました"
                 "、そのあとでほんやにより、あたらしいしょうせつをにさつかってかえりました")


def phase_serve(torch, root: Path, card: str):
    """The HTTP server through the routes a user reaches: the port's
    server in-process on 127.0.0.1 (port 0), phase 3's full-width
    character loaded under a new name by POST /load_character and
    /set_reference_audio, then five sub-steps in turn, each with the
    kernel counts set to 0 just before it and read just after."""
    import threading
    import urllib.request

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
    from genie_tts_tpu_torch.utils.metrics import metrics

    kernels = {"int8": i8.int8_big_attention, "flash": fl.flash_decode_attention,
               "fused": fu.fused_decode_step}
    from genie_tts_tpu_torch.runtime.batcher import ContinuousBatcher

    # the phase's own window batcher waits this long for a second request
    # (as the JAX package's serving test widens the window), so two
    # concurrent clients coalesce; the engine's config stays as it is
    prev_batcher = api._batcher
    api._batcher = ContinuousBatcher(api.engine, max_batch=api.engine.cfg.batch_max,
                                     window_ms=2000.0)
    srv = api.start_server(host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, payload, timeout=300.0):
        """(status, body, s to the first chunk, s to the end)."""
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout) as r:
            first = r.read1(1 << 16)
            t_first = time.perf_counter() - t0
            body = first + r.read()
            return r.status, body, t_first, time.perf_counter() - t0

    def reset():
        for k in kernels.values():
            k.launches = 0
        sync(torch)

    def counts():
        sync(torch)
        return {n: k.launches for n, k in kernels.items()}

    def run(payloads):
        """Concurrent requests, one thread each, every one with a timeout."""
        out, errors = {}, []

        def client(i, p):
            try:
                out[i] = post("/tts", p)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i, p)) for i, p in enumerate(payloads)]
        for t in threads:
            t.start()
        return threads, out, errors

    def join(threads, out, errors, what):
        for t in threads:
            t.join(timeout=600)
        check(not errors and not any(t.is_alive() for t in threads) and len(out) == len(threads),
              f"serve {what}: {errors or 'a request hung'}")
        return [out[i] for i in range(len(threads))]

    def check_audio(res, codes, what):
        for status, body, _, _ in res:
            pcm = np.frombuffer(body, "<i2")
            check(status == 200, f"serve {what}: HTTP {status}")
            check(len(body) == 2 * 2 * codes * 640,
                  f"serve {what}: {len(body)} bytes, want {2 * 2 * codes * 640}")
            levels = np.unique(pcm).size
            check(levels > 1000, f"serve {what}: PCM of {levels} distinct values")

    def report(what, res, launches):
        lat = [r[3] for r in res]
        ttfc = [r[2] for r in res]
        audio = sum(len(r[1]) for r in res) / 2 / 32000
        print(f"[serve] {what}: {len(res)} request(s), latency "
              + ", ".join(f"{x:.3f}" for x in lat) + " s; first chunk "
              + ", ".join(f"{x:.3f}" for x in ttfc) + f" s; {audio:.2f} s of audio; launches "
              + json.dumps(launches))
        return {"latency_s": lat, "first_chunk_s": ttfc, "audio_s": audio,
                "launches": launches}

    out = {}
    try:
        t0 = time.perf_counter()
        for path, payload in (
                ("/load_character", {"character_name": "serve", "model_dir": str(root / "char"),
                                     "language": "ja"}),
                ("/set_reference_audio", {"character_name": "serve",
                                          "audio_path": str(root / "ref.wav"),
                                          "audio_text": "こんにちは、てすとです",
                                          "language": "ja"})):
            status = post(path, payload)[0]
            check(status == 200, f"serve {path}: HTTP {status}")
        char = api.model_manager.get("serve")
        feats = reference_audio_cache.get_features(
            api.engine, char, str(root / "ref.wav"), "こんにちは、てすとです", "Japanese")
        sb = api.get_slot_batcher(char)
        codes = min(char.t2s_cfg.max_decode_steps, sb.ring)   # EOS pinned: every request hits its cap
        packed = len(feats.phones) + len(get_phones_and_bert("。" + LONG_SENTENCE, "ja")[0])
        check(192 < packed <= 256 and not sb.fits(feats, get_phones_and_bert(
            "。" + LONG_SENTENCE, "ja")[0]), f"the long sentence packs {packed} phonemes")
        print(f"[serve] server on {base}; character 'serve' loaded and its reference set "
              f"in {time.perf_counter() - t0:.1f} s; slot geometry {sb.n_slots} slots, W={sb.W}, "
              f"join W={sb.join_W}, ring {sb.ring}; long sentence {packed} packed phonemes")

        def short(i, **kw):
            return {"character_name": "serve", "text": SENTENCES[i], "split_sentence": False,
                    **kw}

        # 1. slot route: 4 concurrent default requests
        reset()
        s0 = dict(sb.stats)
        res = join(*run([short(i) for i in range(4)]), "slot route")
        c = counts()
        steps = sb.stats["steps"] - s0["steps"]
        check_audio(res, codes, "slot route")
        check(c["int8"] == char.t2s_cfg.num_layers * steps > 0 and c["flash"] == 0
              and c["fused"] == 0, f"serve slot route: launches {c} for {steps} steps")
        out["slots"] = report(f"slot route ({steps} slot decode steps)", res, c)

        # 2. window batcher: 2 concurrent requests too long for the slot buckets
        reset()
        res = join(*run([{"character_name": "serve", "text": LONG_SENTENCE,
                          "split_sentence": False}] * 2), "window batcher")
        c = counts()
        b = api._batcher
        check_audio(res, codes, "window batcher")
        check(b is not None and b.stats["last_batch"] == 2 and b.stats["batches"] == 1,
              f"serve window batcher: stats {b and b.stats}")
        steps = b.stats["decode_steps"]
        check(c["flash"] == char.t2s_cfg.num_layers * steps > 0 and c["int8"] == 0
              and c["fused"] == 0, f"serve window batcher: launches {c} for {steps} steps")
        out["window"] = report(f"window batcher (a batch of 2, {steps} decode steps)", res, c)

        # 3. segmented stream on an idle machine: the solo exact-KV machine
        check(not sb._occupied() and sb._q.empty(), "serve: slot machine busy before the stream")
        reset()
        s0 = dict(sb.stats)
        res = join(*run([short(4, stream=True)]), "segmented stream")
        c = counts()
        check_audio(res, codes, "segmented stream")
        check(c == {"int8": 0, "flash": 0, "fused": 0} and sb.stats["steps"] == s0["steps"],
              f"serve segmented stream: launches {c}")
        out["segmented"] = report("segmented stream", res, c)

        # 4. fused stream head: a streamed sentence too long for the stream geometry
        reset()
        res = join(*run([{"character_name": "serve", "text": LONG_SENTENCE,
                          "split_sentence": False, "stream": True}]), "fused head")
        c = counts()
        steps = api.engine.last_stats.get("decode_steps", 0)
        check_audio(res, codes, "fused head")
        check(c["fused"] == steps > 0 and c["flash"] == 0 and c["int8"] == 0,
              f"serve fused head: launches {c} for {steps} steps")
        out["fused_head"] = report(f"fused stream head ({steps} decode steps)", res, c)

        # 5. a stream sent while 3 default requests occupy the slot machine
        reset()
        s0 = dict(sb.stats)
        done0 = metrics.snapshot()["counters"].get("slot_utterances", 0)
        busy = run([short(5 + i) for i in range(3)])
        t_wait = time.perf_counter()
        while not sb._occupied() and time.perf_counter() - t_wait < 120:
            time.sleep(0.002)
        check(sb._occupied(), "serve: the 3 default requests never joined the slot machine")
        stream = run([short(8, stream=True)])
        res = join(*busy, "slot-joined stream (default requests)")
        sres = join(*stream, "slot-joined stream")
        c = counts()
        steps = sb.stats["steps"] - s0["steps"]
        done = metrics.snapshot()["counters"].get("slot_utterances", 0) - done0
        check_audio(res + sres, codes, "slot-joined stream")
        check(sb.stats["streams"] - s0["streams"] == 1 and done == 4,
              f"serve slot-joined stream: {sb.stats['streams'] - s0['streams']} streams "
              f"joined, {done} slot utterances")
        check(c["int8"] == char.t2s_cfg.num_layers * steps > 0 and c["flash"] == 0
              and c["fused"] == 0, f"serve slot-joined stream: launches {c} for {steps} steps")
        out["slot_stream"] = report(f"slot-joined stream ({steps} slot decode steps, "
                                    f"3 default requests beside it)", res + sres, c)
        out["slot_stream"]["stream_first_chunk_s"] = sres[0][2]
        print(f"[serve] slot-joined stream: first chunk {sres[0][2]:.3f} s, end "
              f"{sres[0][3]:.3f} s; {card}")
    finally:
        srv.shutdown()
        srv.server_close()
        api.unload_character("serve")
        api._batcher.stop(timeout=60)
        api._batcher = prev_batcher
    return out


def profiled(torch, fn):
    """(ms by CUDA events, device busy ms, kernels run) of one call of
    ``fn`` under torch.profiler; busy and kernels None where the profiler
    shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        sync(torch)
    ks = [(getattr(a, "self_device_time_total", None)
           or getattr(a, "self_cuda_time_total", 0.0), a.count)
          for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy = sum(k[0] for k in ks) / 1e3
    return e0.elapsed_time(e1), (busy if busy > 0 else None), (sum(k[1] for k in ks)
                                                              if busy > 0 else None)


def sovits_stages(torch, char, feats, g):
    """The SoVITS stages at the serving paths' shapes, each a thunk over
    fixed inputs from ``g`` (one noise table each) through the programs of
    ``models/sovits.py`` (graph replays, or eager runs on the same buffers
    when the character's SoVITS cache is set ``eager``): the solo latent
    (B=1, the 128-code cap, text bucket 64), the finisher's (B=8, 256
    codes), the solo whole vocode (256 frames), the finisher's chunked
    vocode (B=8, 1024 frames: windows of 280 and 304 frames) and the
    window pump's per-row windows (B=8, 304 of 512 frames)."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.models import sovits

    vp, vc = char.sovits_params, char.sovits_cfg
    C = vc.inter_channels
    ecfg = api.engine.cfg
    ge = torch.as_tensor(feats.ge, device=DEV)[None].float().expand(8, -1, -1)
    gm = torch.as_tensor(feats.ge_mrte, device=DEV)[None].float().expand(8, -1, -1)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=DEV)

    def latent_args(B, Ts, Tt):
        return ((ints(0, vc.vq_codes, (B, Ts)), ints(Ts // 2, Ts + 1, (B,)),
                 ints(1, 300, (B, Tt)), ints(Tt // 2, Tt + 1, (B,)), ge[:B], gm[:B]),
                torch.randn((B, 2 * Ts, C), generator=g, device=DEV))

    (l1, n1), (l8, n8) = latent_args(1, 128, 64), latent_args(8, 256, 64)
    z1, z8, zr = (torch.randn(shape, generator=g, device=DEV)
                  for shape in ((1, 256, C), (8, 1024, C), (8, 512, C)))
    v1, v8, vr = torch.tensor([200], device=DEV), ints(600, 1025, (8,)), ints(200, 513, (8,))
    starts = torch.tensor([0, 32, 64, 96, 128, 160, 192, 208], device=DEV)
    return {
        "latent B=1 (128 codes, text 64)": lambda: sovits.latent(vp, vc, *l1, 0.5, noise=n1),
        "latent B=8 (256 codes, text 64)": lambda: sovits.latent(vp, vc, *l8, 0.5, noise=n8),
        "vocode B=1 whole (256 frames)": lambda: sovits.vocode(vp, vc, z1, ge[:1], v1),
        "vocode B=8 chunked (1024 frames)": lambda: sovits.vocode_frames_chunked(
            vp, vc, z8, ge, v8, chunk=ecfg.vocode_chunk, halo=ecfg.vocode_halo),
        "window rows B=8 (304 of 512 frames)": lambda: sovits.vocode_rows(
            vp, vc, zr, ge, starts, vr, ecfg.vocode_chunk + 2 * ecfg.vocode_halo),
    }


def phase_graphs(torch, root: Path, card: str):
    """The sentence programs as captured CUDA graphs (``runtime/graphs.py``).

    (1) ``serve --warmup``'s semantics: phase 3's character loaded as
    ``graphs`` through the port's server and swept at its first
    /set_reference_audio (units, graphs captured, wall time, pool and
    buffer memory, the T2S and SoVITS families apart); solo ``tts()``
    (stage split, nothing captured), 4 concurrent /tts (the int8 slot
    route), one short stream (the segmented stream, idle machine) and one
    long stream (the fused head), the long stream again and top-p 0.8
    requests: no miss, no new variant, no capture. ``graphs2``, another
    random character of the configuration, loaded after: 0 sweep units,
    nothing captured, served by the same routes with no miss; the two
    interleaved (graph vs eager codes, each its own) and at once; a
    bind's device ms. Then the character cache cut to 1 evicts
    ``graphs2``: ``memory_allocated`` falls by at least its weights and
    state, the graphs stay, and the first /tts after it reloads
    ``graphs2`` with no sweep. (2)
    Graph vs eager on the same noise: codes identical for B=1 fused and
    B=4 flash ``generate`` with a 40-step cap (the prefill program, then
    blocks of 16, 16 and 7), one slot segment at occupancy 8 from the
    same state on the int8 kernel route and on the exact caches' slot
    attention kernel (every state leaf equal), one stream segment; five B=1
    decodes of one cache length captured while another thread replays a
    sixth, every decode's codes the eager route's; the SoVITS stages
    within 1e-5 (fp32). (3) Times, each beside its eager counterpart in
    the same run (the character's graph caches set ``eager``), in turns:
    solo decode ms/step and stage split, the prefill program's and each
    SoVITS stage's device ms, a slot segment at occupancy 8 (CUDA events;
    device busy and kernels a step by torch.profiler), the segmented
    stream's first chunk and latency on an idle machine, and 4
    concurrent requests on the int8 slot route."""
    import dataclasses
    import gc
    import threading
    import urllib.request

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert
    from genie_tts_tpu_torch.models import slots, t2s
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, gumbel_noise
    from genie_tts_tpu_torch.runtime import graphs, stream
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
    from genie_tts_tpu_torch.runtime.buckets import pick_bucket
    from genie_tts_tpu_torch.utils.metrics import metrics

    kernels = {"int8": i8.int8_big_attention, "flash": fl.flash_decode_attention,
               "fused": fu.fused_decode_step}
    srv = api.start_server(host="127.0.0.1", port=0, block=False)
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def post(path, payload, timeout=600.0):
        """(status, body, s to the first chunk, s to the end)."""
        req = urllib.request.Request(base + path, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=timeout) as r:
            first = r.read1(1 << 16)
            t_first = time.perf_counter() - t0
            body = first + r.read()
            return r.status, body, t_first, time.perf_counter() - t0

    def concurrent(fn, n):
        out, errors = {}, []

        def client(i):
            try:
                out[i] = fn(i)
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {e!r}")

        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        check(not errors and len(out) == n, f"graphs: {errors or 'a request hung'}")
        return [out[i] for i in range(n)]

    def mb(n):
        return n / 2 ** 20

    out = {}
    ref_text = "こんにちは、てすとです"
    # serve --warmup's semantics: every character swept at its first
    # /set_reference_audio; the sweep's units recorded per character
    api.sweep_on_reference = True
    cap_prev = api.model_manager._cache.capacity
    api.model_manager._cache.capacity = cap_prev + 2       # room for both characters
    units_of, split_of = {}, {}
    warmup = api.engine.warmup

    def recording_warmup(char, ref, sweep=False):
        n = warmup(char, ref, sweep=sweep)
        units_of.setdefault(char.name, []).append(n)
        return n

    def timed_units(units):
        """The sweep's units one after another, as the engine runs them,
        with each kind's wall time (module.function of the unit)."""
        split = {}
        for u in units:
            fn = getattr(u, "func", u)
            kind = f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}"
            t0 = time.perf_counter()
            u()
            split[kind] = split.get(kind, 0.0) + time.perf_counter() - t0
        split_of["last"] = split
        return len(units)

    api.engine.warmup = recording_warmup
    api.engine._run_compile_units = timed_units

    def caches_of(char):
        return {"T2S": graphs.cache_for(char.t2s_params),
                "SoVITS": graphs.cache_for(char.sovits_params)}

    def load_swept(name, ladder):
        """Load ``name`` over HTTP; its /set_reference_audio sweeps it.
        Prints the sweep per family and its wall time per kind of unit;
        returns the numbers."""
        t0 = time.perf_counter()
        for path, payload in (
                ("/load_character", {"character_name": name, "model_dir": str(root / "char"),
                                     "language": "ja"}),
                ("/set_reference_audio", {"character_name": name,
                                          "audio_path": str(root / "ref.wav"),
                                          "audio_text": ref_text, "language": "ja"})):
            check(post(path, payload)[0] == 200, f"graphs {path} ({name})")
        sync(torch)
        wall = time.perf_counter() - t0
        char = api.model_manager.get(name)
        check(units_of.get(name) and units_of[name][0] > 0,
              f"{name} was not swept at its /set_reference_audio")
        fam = {}
        for fname, c in caches_of(char).items():
            keys = c.keys()
            fam[fname] = dict(keys=len(keys), captured=captured_programs(c),
                              pool_mib=mb(c.pool_bytes()), buffers_mib=mb(c.buffer_bytes()),
                              by_kind={kind: sum(k[0] == kind for k in keys)
                                       for kind in sorted({k[0] for k in keys})})
            check(fam[fname]["captured"] >= len(keys) > 0,
                  f"{name} {fname}: {fam[fname]['captured']} graphs for {len(keys)} keys")
        total = sum(f["pool_mib"] + f["buffers_mib"] for f in fam.values())
        split = {k: round(v, 2) for k, v in split_of["last"].items()}
        print(f"[graphs] {name} ({ladder}): swept at its /set_reference_audio: "
              f"{units_of[name][-1]} units, load + reference + sweep {wall:.1f} s (client "
              f"clock; the units by kind, s: {json.dumps(split)}); "
              + "; ".join(f"{n}: {f['keys']} keys {json.dumps(f['by_kind'])}, {f['captured']} "
                          f"graphs captured, pool {f['pool_mib']:.1f} MiB, static buffers "
                          f"{f['buffers_mib']:.1f} MiB" for n, f in fam.items())
              + f"; {total / 1024:.2f} GiB in all; {card}")
        return dict(units=units_of[name][-1], wall_s=wall, split_s=split, families=fam,
                    gib=total / 1024)

    def serve_routes(name):
        """4 concurrent /tts (the int8 slot route: each joins through the
        join graphs; the slot_join timer), a short stream (the segmented
        stream, idle machine), a long one (the fused head) and a short
        stream sent while 3 default /tts occupy the slot machine (the
        slot-joined stream): audio checked, no miss, no new variant and no
        capture in either cache of ``name``."""
        char_n = api.model_manager.get(name)
        cs = caches_of(char_n)
        for c in cs.values():
            c.reset_stats()
        metrics.reset()
        tts4 = concurrent(lambda i: post("/tts", {"character_name": name, "text": SENTENCES[i],
                                                  "split_sentence": False}), 4)
        joins = metrics.snapshot()["timers"].get("slot_join", {"count": 0})
        short = post("/tts", {"character_name": name, "text": SENTENCES[4],
                              "split_sentence": False, "stream": True})
        long = post("/tts", {"character_name": name, "text": LONG_SENTENCE,
                             "split_sentence": False, "stream": True})
        sb_n = api.get_slot_batcher(char_n)
        streams0 = sb_n.stats["streams"]
        busy = {}

        def busy_req(i):
            busy[i] = post("/tts", {"character_name": name, "text": SENTENCES[5 + i],
                                    "split_sentence": False})

        threads = [threading.Thread(target=busy_req, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        t_wait = time.perf_counter()
        while not sb_n._occupied() and time.perf_counter() - t_wait < 120:
            time.sleep(0.002)
        check(sb_n._occupied(), f"{name}: the 3 default requests never joined the machine")
        joined = post("/tts", {"character_name": name, "text": SENTENCES[8],
                               "split_sentence": False, "stream": True})
        for t in threads:
            t.join(timeout=600)
        check(len(busy) == 3 and sb_n.stats["streams"] - streams0 == 1,
              f"{name}: slot-joined stream: {len(busy)} busy requests, "
              f"{sb_n.stats['streams'] - streams0} streams joined")
        for status, body, _, _ in tts4 + [short, long, joined] + list(busy.values()):
            check(status == 200 and len(body) == 2 * 2 * codes * 640
                  and np.unique(np.frombuffer(body, "<i2")).size > 1000,
                  f"graphs serving {name}: HTTP {status}, {len(body)} bytes")
        stats = {n: dict(c.stats) for n, c in cs.items()}
        print(f"[graphs] {name} served warm (its configuration swept): 4 x /tts latency "
              + ", ".join(f"{r[3]:.3f}" for r in tts4) + f" s (slot_join timer, host clock: "
              f"{json.dumps(joins)}); short stream (segmented) first chunk "
              f"{short[2]:.3f} s, end {short[3]:.3f} s; long stream (fused head) first chunk "
              f"{long[2]:.3f} s, end {long[3]:.3f} s; slot-joined stream beside 3 /tts: first "
              f"chunk {joined[2]:.3f} s, end {joined[3]:.3f} s; caches {json.dumps(stats)}; "
              f"{card}")
        check(all(st["misses"] == st["variants"] == st["captures"] == 0 and st["hits"] > 0
                  for st in stats.values()), f"serving {name} after its sweep missed: {stats}")
        return dict(tts4_s=[r[3] for r in tts4], short_stream=short[2:], long_stream=long[2:],
                    slot_stream=joined[2:], slot_join=joins, stats=stats)

    try:
        # ---- (1) two characters, each swept at its first reference, then
        # served with nothing captured; one evicted releases its graphs
        sweep = load_swept("graphs", "the full bucket ladder")
        char = api.model_manager.get("graphs")
        codes = min(char.t2s_cfg.max_decode_steps, 128)   # EOS pinned: every request hits it
        feats = reference_audio_cache.get_features(
            api.engine, char, str(root / "ref.wav"), ref_text, "Japanese")
        cache, vcache = caches_of(char).values()
        for c in (cache, vcache):
            c.reset_stats()
        eng = api.engine
        eng.timing = True
        t0 = time.perf_counter()
        api.tts("graphs", "きょうはいいてんきですね。", save_path=root / "graphs_tts.wav")
        solo_s = time.perf_counter() - t0
        eng.timing = False
        solo_stages = {k: v * 1e3 for k, v in eng.last_stats["stages"].items()}
        solo_stats = {n: dict(c.stats) for n, c in (("T2S", cache), ("SoVITS", vcache))}
        print(f"[graphs] solo tts() after the sweep: {solo_s:.3f} s, stages (ms, synced) "
              + json.dumps({k: round(v, 3) for k, v in solo_stages.items()})
              + f"; embed, prefill, decode, latent and vocode as graph replays only: caches "
              f"{json.dumps(solo_stats)}")
        check(all(st["misses"] == st["variants"] == st["captures"] == 0 and st["hits"] > 0
                  for st in solo_stats.values()), f"solo tts() after the sweep: {solo_stats}")
        served = serve_routes("graphs")
        # the long stream again, through the engine and through /tts
        long_ph = get_phones_and_bert("。" + LONG_SENTENCE, "ja")[0]
        again = []
        for _ in range(2):
            t0 = time.perf_counter()
            it = api.engine.synthesize_utterance_stream(
                char, feats, long_ph, np.zeros((len(long_ph), char.t2s_cfg.bert_dim),
                                               np.float32), pcm16=True)
            next(it)
            t1 = time.perf_counter() - t0
            for _ in it:
                pass
            again.append((t1, time.perf_counter() - t0))
        long2 = post("/tts", {"character_name": "graphs", "text": LONG_SENTENCE,
                              "split_sentence": False, "stream": True})
        print(f"[graphs] long stream again: engine first chunk / end "
              + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in again)
              + f" s; /tts {long2[2]:.3f} / {long2[3]:.3f} s")
        # top-p below 1 (a request's override): solo, the fused stream head
        # and the slot route
        top_p = SamplingConfig(top_p=0.8)
        solo_ph = get_phones_and_bert("。きょうはいいてんきですね。", "ja")[0]
        api.engine.synthesize_utterance(char, feats, solo_ph, np.zeros(
            (len(solo_ph), char.t2s_cfg.bert_dim), np.float32), sampling=top_p, pcm16=True)
        for _ in api.engine.synthesize_utterance_stream(
                char, feats, long_ph, np.zeros((len(long_ph), char.t2s_cfg.bert_dim),
                                               np.float32), sampling=top_p, pcm16=True):
            pass
        check(post("/tts", {"character_name": "graphs", "text": SENTENCES[0],
                            "split_sentence": False, "top_p": 0.8})[0] == 200,
              "graphs /tts with top_p")
        stats = {n: dict(c.stats) for n, c in (("T2S", cache), ("SoVITS", vcache))}
        print(f"[graphs] top-p 0.8 and the long stream again: caches {json.dumps(stats)}")
        check(all(st["misses"] == st["variants"] == st["captures"] == 0 and st["hits"] > 0
                  for st in stats.values()), f"serving after the sweep missed the cache: {stats}")
        # ---- the second character: another random character of this
        # configuration (other weights), loaded after the sweep: its
        # /set_reference_audio sweeps nothing and captures nothing, and it
        # binds the configuration's graphs as "graphs" does
        char2_dir = make_second_character(torch, root)
        for c in (cache, vcache):
            c.reset_stats()
        gc.collect()
        sync(torch)
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        for path, payload in (
                ("/load_character", {"character_name": "graphs2", "model_dir": str(char2_dir),
                                     "language": "ja"}),
                ("/set_reference_audio", {"character_name": "graphs2",
                                          "audio_path": str(root / "ref.wav"),
                                          "audio_text": ref_text, "language": "ja"})):
            check(post(path, payload)[0] == 200, f"graphs {path} (graphs2)")
        sync(torch)
        wall2 = time.perf_counter() - t0
        mem1 = torch.cuda.memory_reserved()
        char2 = api.model_manager.get("graphs2")
        weights2 = tree_bytes(char2.t2s_params, char2.sovits_params)
        ref_stats = {n: dict(c.stats) for n, c in caches_of(char2).items()}
        check(caches_of(char2) == caches_of(char) and not any(units_of.get("graphs2", []))
              and all(st["misses"] == st["captures"] == 0 for st in ref_stats.values()),
              f"graphs2's /set_reference_audio swept: units {units_of.get('graphs2')}, "
              f"caches {ref_stats}")
        print(f"[graphs] graphs2 (another random character of the configuration, other "
              f"weights) loaded after the sweep: load + reference {wall2:.2f} s (client "
              f"clock), {sum(units_of.get('graphs2', []))} sweep units, 0 graphs captured (caches "
              f"{json.dumps(ref_stats)}), beside graphs's load + reference + sweep "
              f"{sweep['wall_s']:.1f} s; memory_reserved +{mb(mem1 - mem0):.1f} MiB (its "
              f"weights {mb(weights2):.1f} MiB), beside the {sweep['gib']:.2f} GiB of graphs "
              f"graphs's sweep made (a character's sweep cost 6.33 GiB before: PERF.md); {card}")
        served2 = serve_routes("graphs2")

        # interleaved A, B, A: each character's codes identical to its own
        # eager run on one noise, the two characters' codes different
        # (B=1 fused: the bank's packing and tiles rebound; B=4 flash)
        tcfg = char.t2s_cfg
        gi = torch.Generator(device=DEV).manual_seed(11)
        Sx_i, Sp_i, cap_i = 64, 256, 40
        inter = {}
        for B in (1, 4):
            phones_i = torch.randint(1, tcfg.phoneme_vocab, (B, Sx_i), generator=gi, device=DEV)
            bert_i = torch.randn((B, Sx_i, tcfg.bert_dim), generator=gi, device=DEV)
            prompts_i = torch.randint(0, 1024, (B, Sp_i), generator=gi, device=DEV)
            lens_i = (torch.tensor([40, 64, 23, 51][:B], device=DEV),
                      torch.tensor([132, 256, 77, 190][:B], device=DEV))
            noise_i = gumbel_noise((cap_i, B, tcfg.semantic_vocab), gi, DEV)

            def codes_of(c, eager):
                with torch.inference_mode():
                    r = t2s.generate(c.t2s_params, tcfg, SamplingConfig(), None,
                                     (phones_i, bert_i), lens_i[0], prompts_i, lens_i[1],
                                     max_steps=cap_i, cache_len=Sx_i + Sp_i + cap_i,
                                     min_steps=cap_i, noise=noise_i, eager=eager)
                return r.tokens.cpu()

            got = [codes_of(c, False) for c in (char, char2, char)]
            eager_ab = [codes_of(c, True) for c in (char, char2)]
            ok = (torch.equal(got[0], eager_ab[0]) and torch.equal(got[2], eager_ab[0])
                  and torch.equal(got[1], eager_ab[1]) and not torch.equal(got[0], got[1]))
            inter[f"generate B={B}"] = ok
            check(ok, f"interleaved generate B={B}: graph codes not each character's own")
        # slot segments on two persistent int8 states at occupancy 8, one
        # per character, interleaved A, B, A, B (the resident state
        # switching at every segment), against each one's eager run
        Bs, Ws, sxs, sps, rings = 8, 32, 192, 192, 512
        fph = get_phones_and_bert("。" + SENTENCES[0], "ja")[0]
        bases = []
        for c in (char, char2):
            sph = np.concatenate([feats.phones, fph])
            ctx_c, samp_c = _slot_rows(torch, c, feats, sph, sxs, sps)
            with torch.inference_mode():
                st = slots.init_slots(tcfg, Bs, sxs, sps, rings, torch.bfloat16, kv_int8=True,
                                      device=DEV)
                for b in range(Bs):
                    slots.insert_slot(st, b, *ctx_c, len(sph), len(feats.prompt_tokens),
                                      rings, rings, samp_c)
            bases.append(st)
        seg_noise = [gumbel_noise((Ws, Bs, tcfg.semantic_vocab), gi, DEV) for _ in range(2)]
        graph_st = [dataclasses.replace(slots.clone_state(b), persistent=True) for b in bases]
        eager_st = [slots.clone_state(b) for b in bases]
        toks = {("graph", 0): [], ("graph", 1): [], ("eager", 0): [], ("eager", 1): []}
        with torch.inference_mode():
            for k in range(2):
                for i, c in enumerate((char, char2)):
                    toks["graph", i].append(slots.decode_segment(
                        c.t2s_params, graph_st[i], tcfg, Ws, sxs, sps, rings, kv_kernel=True,
                        noise=seg_noise[k])[1].cpu())
            for i, c in enumerate((char, char2)):
                for k in range(2):
                    toks["eager", i].append(slots.decode_segment(
                        c.t2s_params, eager_st[i], tcfg, Ws, sxs, sps, rings, kv_kernel=True,
                        noise=seg_noise[k], eager=True)[1].cpu())
        ok = (all(torch.equal(a_, b_) for i in range(2)
                  for a_, b_ in zip(toks["graph", i], toks["eager", i]))
              and not torch.equal(toks["graph", 0][0], toks["graph", 1][0]))
        inter["slot segments, int8 kernel, occupancy 8"] = ok
        check(ok, "interleaved slot segments: graph codes not each character's own")
        del graph_st, eager_st, bases
        # concurrent: 2 /tts of each character at once, each on its slot
        # machine (the resident state and the banks switching between them)
        for c in (cache, vcache):
            c.reset_stats()
        both = concurrent(lambda i: post("/tts", {
            "character_name": ("graphs", "graphs2")[i % 2], "text": SENTENCES[i],
            "split_sentence": False}), 4)
        for status, body, _, _ in both:
            check(status == 200 and len(body) == 2 * 2 * codes * 640
                  and np.unique(np.frombuffer(body, "<i2")).size > 1000,
                  f"graphs and graphs2 at once: HTTP {status}, {len(body)} bytes")
        both_stats = {n: dict(c.stats) for n, c in (("T2S", cache), ("SoVITS", vcache))}
        check(all(st["misses"] == st["variants"] == st["captures"] == 0
                  for st in both_stats.values()),
              f"graphs and graphs2 at once missed a cache: {both_stats}")
        # a bind's device time: the other character resident, then this
        # one's tensors copied in (CUDA events around the bind alone)
        bind_ms = {}
        for fam, c, pa, pb in (("T2S", cache, char.t2s_params, char2.t2s_params),
                               ("SoVITS", vcache, char.sovits_params, char2.sovits_params)):
            times = []
            for _ in range(3):
                with c.bind(pb):
                    pass
                sync(torch)
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                with c.bind(pa):
                    pass
                e1.record()
                sync(torch)
                times.append(e0.elapsed_time(e1))
            bind_ms[fam] = dict(ms=times, bank_mib=mb(c.bank_bytes()))
        state_switches = {str(k): v.residency.switches for k, v in cache._objects.items()
                          if k[0] == "slot_state"}
        print(f"[graphs] graphs and graphs2 interleaved (A, B, A) and at once: "
              f"{json.dumps(inter)}; 2 x /tts each at once: latency "
              + ", ".join(f"{r[3]:.3f}" for r in both) + f" s; caches while both served "
              f"(binds and bind_bytes among them) {json.dumps(both_stats)}; bank MiB and a "
              f"bind's device ms (CUDA events, the "
              f"other character resident): {json.dumps(bind_ms)}; resident slot state "
              f"switches by geometry {json.dumps(state_switches)}; {card}")
        # eviction: the character cache cut to 1 keeps the most recent
        # character ("graphs"); "graphs2" is evicted and its slot machine
        # comes to rest: its weights and its machine's state are freed, the
        # configuration's graphs stay
        sb2 = api._slot_batchers.get("graphs2")
        st2 = getattr(sb2._state, "_own", sb2._state) if sb2 is not None else None
        states2 = sum(t.numel() * t.element_size() for t in graphs.tensors_of(st2)
                      if t.is_cuda) if st2 is not None else 0
        del st2, char2
        keep = [api.model_manager.get(n) for n in ("smoke", "slots")]
        gc.collect()
        sync(torch)
        torch.cuda.empty_cache()
        before = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
        keys_before = len(cache.keys()) + len(vcache.keys())
        api.model_manager._cache.capacity = 1
        api.model_manager.register(api.model_manager.get("graphs"))
        check("graphs2" not in api.model_manager._cache, "graphs2 was not evicted")
        if sb2 is not None:
            check(sb2.join(60), "graphs2's slot machine did not come to rest")
        del sb2
        gc.collect()
        sync(torch)
        torch.cuda.empty_cache()
        after = (torch.cuda.memory_reserved(), torch.cuda.memory_allocated())
        api.model_manager._cache.capacity = cap_prev + 2
        for c in keep:                     # phase 3's and phase 6's characters stay loaded
            api.model_manager.register(c)
        del keep
        freed = before[1] - after[1]
        print(f"[graphs] max_cached_characters=1 evicted graphs2: memory_allocated "
              f"{mb(before[1]):.1f} -> {mb(after[1]):.1f} MiB ({mb(freed):.1f} MiB freed), "
              f"memory_reserved {mb(before[0]):.1f} -> {mb(after[0]):.1f} MiB after gc and "
              f"empty_cache; its weights {mb(weights2):.1f} MiB and its slot machine's state "
              f"{mb(states2):.1f} MiB; the configuration's {keys_before} graph keys kept; {card}")
        check(freed >= weights2 + states2 and len(cache.keys()) + len(vcache.keys())
              == keys_before, "evicting graphs2 did not free its weights and state")
        # the first request after the eviction reloads graphs2: no sweep
        for c in (cache, vcache):
            c.reset_stats()
        status, body, _, reload_s = post("/tts", {"character_name": "graphs2",
                                                  "text": SENTENCES[0],
                                                  "split_sentence": False})
        reload_stats = {n: dict(c.stats) for n, c in (("T2S", cache), ("SoVITS", vcache))}
        check(status == 200 and len(body) == 2 * 2 * codes * 640
              and not any(units_of.get("graphs2", []))
              and all(st["misses"] == st["captures"] == 0 for st in reload_stats.values()),
              f"graphs2's request after its eviction: HTTP {status}, sweeps "
              f"{units_of.get('graphs2')}, caches {reload_stats}")
        print(f"[graphs] the first /tts after the eviction reloads graphs2 (0 sweep units, "
              f"caches {json.dumps(reload_stats)}): {reload_s:.2f} s (client clock), beside "
              f"its first load + reference {wall2:.2f} s; {card}")
        api.unload_character("graphs2")
        out["sweep"] = dict(graphs=sweep, graphs2_s=wall2, graphs2_mib=mb(mem1 - mem0),
                            weights2_mib=mb(weights2), solo_s=solo_s,
                            solo_stages_ms=solo_stages, served=served, served2=served2,
                            interleaved=inter, bind_ms=bind_ms, freed_mib=mb(freed),
                            states2_mib=mb(states2), reload_s=reload_s)

        # ---- (2) graph vs eager, the same noise: identical codes
        cfg = char.t2s_cfg
        p = char.t2s_params
        g = torch.Generator(device=DEV).manual_seed(9)
        Sx, Sp = 64, 256
        scfg = SamplingConfig()
        for B, cap in ((1, 40), (4, 40)):
            phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=g, device=DEV)
            bert = torch.randn((B, Sx, cfg.bert_dim), generator=g, device=DEV)
            prompts = torch.randint(0, 1024, (B, Sp), generator=g, device=DEV)
            x_len = torch.tensor([40, 64, 23, 51][:B], device=DEV)
            p_len = torch.tensor([132, 256, 77, 190][:B], device=DEV)
            noise = gumbel_noise((cap, B, cfg.semantic_vocab), g, DEV)
            res = {}
            # the prefill program embeds (generate_e2e's route), graph and
            # eager; then the embedded-input route's graph
            for route in ("graph", "eager", "embedded"):
                for k in kernels.values():
                    k.launches = 0
                with torch.inference_mode():
                    x = ((phones, bert) if route != "embedded"
                         else t2s.embed_text(p, phones, bert))
                    r = t2s.generate(p, cfg, scfg, None, x, x_len, prompts, p_len,
                                     max_steps=cap, cache_len=Sx + Sp + cap, min_steps=cap,
                                     noise=noise, eager=route == "eager")
                sync(torch)
                n = kernels["fused" if B == 1 else "flash"].launches
                res[route] = (r.tokens.cpu(), r.counts.cpu(), r.steps, n)
            same = {rt: all(torch.equal(a, b) for a, b in zip(res["graph"][:2], res[rt][:2]))
                    for rt in ("eager", "embedded")}
            per = 1 if B == 1 else cfg.num_layers
            print(f"[graphs] generate B={B} ({'fused' if B == 1 else 'flash'}), cap {cap}, "
                  f"the prefill program (embed, prefill into the graph's caches, first token) "
                  f"and the decode: graph vs eager codes "
                  f"{'identical' if same['eager'] else 'DIFFER'}, vs the embedded-input route "
                  f"{'identical' if same['embedded'] else 'DIFFER'}; steps "
                  + " / ".join(str(v[2]) for v in res.values()) + "; launches "
                  + " / ".join(str(v[3]) for v in res.values()))
            check(all(same.values()) and all(v[2] == cap for v in res.values())
                  and all(v[3] == per * (cap - 1) for v in res.values()),
                  f"generate B={B} graph vs eager")

        # a capture beside replays: one thread replays the B=1 graph at a
        # 40-step cap while another captures the programs of five decodes
        # of the same cache length (caps 24 and 32, top-p 0.8); every
        # decode's codes must be the eager route's on the same noise
        phones = torch.randint(1, cfg.phoneme_vocab, (1, Sx), generator=g, device=DEV)
        prompts = torch.randint(0, 1024, (1, Sp), generator=g, device=DEV)
        lens = (torch.tensor([40], device=DEV), torch.tensor([132], device=DEV))
        noise = gumbel_noise((40, 1, cfg.semantic_vocab), g, DEV)

        def decode1(cap, top_p, eager=False):
            with torch.inference_mode():
                x = t2s.embed_text(p, phones, torch.zeros((1, Sx, cfg.bert_dim), device=DEV))
                return t2s.generate(p, cfg, SamplingConfig(top_p=top_p), None, x, lens[0],
                                    prompts, lens[1], max_steps=cap, cache_len=Sx + Sp + 40,
                                    min_steps=cap, noise=noise[:cap], eager=eager).tokens.cpu()

        others = [(24, 1.0), (32, 1.0), (40, 0.8), (24, 0.8), (32, 0.8)]
        want = {k: decode1(*k, eager=True) for k in [(40, 1.0)] + others}
        decode1(40, 1.0)                                    # captured in (2) already
        captures0, done, bad, runs = graphs.cache_for(p).stats["captures"], [], [], []

        def replayer():
            while not done:
                runs.append(1)
                if not torch.equal(decode1(40, 1.0), want[(40, 1.0)]):
                    bad.append("replayed key")

        def capturer():
            try:
                for k in others:
                    if not torch.equal(decode1(*k), want[k]):
                        bad.append(f"captured key {k}")
            finally:
                done.append(1)

        threads = [threading.Thread(target=replayer), threading.Thread(target=capturer)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        captured = graphs.cache_for(p).stats["captures"] - captures0
        print(f"[graphs] capture beside replay: {len(runs)} replayed decodes while "
              f"{captured} graphs were captured at the same cache length; codes "
              f"{'all equal to eager' if not bad else 'DIFFER: ' + ', '.join(bad)}")
        # each decode captures its prefill program, a 16-step block and the
        # one-step tail
        check(not bad and captured == 3 * len(others) and len(runs) > 1
              and not any(t.is_alive() for t in threads), "capture beside replay")

        def segment_pair(state, W, sx, sp, ring, kernel, what):
            """One segment from copies of ``state``: graph and eager."""
            noise = gumbel_noise((W, state.k_cache.shape[1], cfg.semantic_vocab), g, DEV)
            a, b = slots.clone_state(state), slots.clone_state(state)
            with torch.inference_mode():
                a, ta = slots.decode_segment(p, a, cfg, W, sx, sp, ring, kv_kernel=kernel,
                                             noise=noise)
                b, tb = slots.decode_segment(p, b, cfg, W, sx, sp, ring, kv_kernel=kernel,
                                             noise=noise, eager=True)
            sync(torch)
            leaves = [f.name for f in dataclasses.fields(a)
                      if isinstance(getattr(a, f.name), torch.Tensor)]
            diff = [n for n in leaves if not torch.equal(getattr(a, n), getattr(b, n))]
            print(f"[graphs] {what}: graph vs eager tokens "
                  f"{'identical' if torch.equal(ta, tb) else 'DIFFER'}, state leaves "
                  f"{'equal' if not diff else 'differ: ' + ', '.join(diff)}")
            check(torch.equal(ta, tb) and not diff, f"{what}: graph vs eager")

        slot_char = api.model_manager.get("slots")     # the default T2SConfig (500 steps)
        scfg_s = slot_char.t2s_cfg
        sfeats = reference_audio_cache.get_features(
            api.engine, slot_char, str(root / "ref.wav"), ref_text, "Japanese")
        sphones = np.concatenate([sfeats.phones, api.get_phones_and_bert(
            "。" + SENTENCES[0], "ja")[0]])
        B8, W, sx, sp, ring = 8, 32, 192, 192, 512
        ctx, samp = _slot_rows(torch, slot_char, sfeats, sphones, sx, sp)
        p = slot_char.t2s_params
        cfg = scfg_s
        for kv_int8 in (True, False):
            with torch.inference_mode():
                st = slots.init_slots(cfg, B8, sx, sp, ring, torch.bfloat16, kv_int8=kv_int8,
                                      device=DEV)
                for b in range(B8):
                    slots.insert_slot(st, b, *ctx, len(sphones), len(sfeats.prompt_tokens),
                                      ring, ring, samp)
            segment_pair(st, W, sx, sp, ring, kv_int8,
                         "slot segment, occupancy 8, "
                         + ("int8 kernel route" if kv_int8 else "exact KV, slot attention kernel"))
        Ws, rings, ssx, ssp = stream.stream_geometry(api.engine.cfg, cfg)
        with torch.inference_mode():
            st1 = slots.init_slots(cfg, 1, ssx, ssp, rings, torch.bfloat16, device=DEV)
            slots.insert_slot(st1, 0, *ctx, len(sphones), len(sfeats.prompt_tokens), rings,
                              rings, samp)
        segment_pair(st1, Ws, ssx, ssp, rings, False, "stream segment (B=1)")
        out["join"] = join_pair(torch, slot_char, sfeats, sphones, g, card)

        # the SoVITS programs, graph vs eager (the character's SoVITS cache
        # set eager: the same programs on the same buffers) on one noise
        # table; the synthesizer computes in fp32 whatever its weights'
        # dtype, so the fp32 bound holds
        stages = sovits_stages(torch, char, feats, g)
        for name, fn in stages.items():
            got = {}
            for eager in (False, True):
                vcache.eager = eager
                with torch.inference_mode():
                    got[eager] = fn()
                sync(torch)
            vcache.eager = False
            diff = float((got[False] - got[True]).abs().max())
            print(f"[graphs] SoVITS {name}: graph vs eager max abs difference {diff:.3g} "
                  f"(fp32, bound 1e-5); output {tuple(got[False].shape)}, finite "
                  f"{bool(torch.isfinite(got[False]).all())}")
            check(diff <= 1e-5 and bool(torch.isfinite(got[False]).all()),
                  f"SoVITS {name}: graph vs eager {diff}")

        # ---- (3) times, graph beside eager in turns
        eng = api.engine
        eng.timing = True
        text = get_phones_and_bert("。きょうはいいてんきですね。", "ja")[0]
        bert = np.zeros((len(text), char.t2s_cfg.bert_dim), np.float32)
        solo = {False: [], True: []}
        split = {False: [], True: []}
        # the eager baseline of the engine's routes: the character's graph
        # caches (T2S and SoVITS) set to run their programs without a graph

        def set_eager(eager):
            cache.eager = vcache.eager = eager

        for eager in (False, True, True, False):
            set_eager(eager)
            eng.synthesize_utterance(char, feats, text, bert, seed=1, pcm16=True)
            st = eng.last_stats
            solo[eager].append(st["stages"]["decode"] * 1e3 / st["decode_steps"])
            split[eager].append({k: round(v * 1e3, 3) for k, v in st["stages"].items()})
        prof = {}
        for eager in (False, True):
            set_eager(eager)
            ms, busy, n = profiled(torch, lambda: eng.synthesize_utterance(
                char, feats, text, bert, seed=1, pcm16=True))
            steps = eng.last_stats["decode_steps"]
            prof[eager] = (ms, busy, n, steps)
        set_eager(False)
        eng.timing = False
        print(f"[graphs] solo tts() stage split, ms (the device synced at each boundary; "
              f"host = inputs before and the copy out after): graph "
              + "; ".join(json.dumps(x) for x in split[False]) + "; eager "
              + "; ".join(json.dumps(x) for x in split[True]) + f"; {card}")
        out["solo_split_ms"] = {"graph": split[False], "eager": split[True]}

        # each stage's device time by CUDA events, graph beside eager in
        # turns: the prefill program at the solo key the sweep captured,
        # and the SoVITS stages of the comparison above
        xb = pick_bucket(len(feats.phones) + len(text), eng.cfg.phoneme_buckets)
        pb = pick_bucket(len(feats.prompt_tokens), eng.cfg.prompt_buckets)
        cap = pick_bucket(char.t2s_cfg.max_decode_steps, eng.cfg.step_caps)
        variant = ("prefill", True, False)

        def prefill_once():
            # with the character bound (its own set when the cache is eager)
            with cache.bind(char.t2s_params) as bp:
                g1, packed = t2s.decode_graph(bp, char.t2s_cfg, 1, xb, pb, xb + pb + cap,
                                              cap, bp["audio_embed"].dtype)
                pre = t2s.generate_programs(bp, char.t2s_cfg, xb, pb, packed)[variant]
                with g1.lock:
                    g1.run(pre, variant)

        timed_stages = {f"prefill program B=1 (text {xb}, prompt {pb})": prefill_once}
        timed_stages.update(stages)
        dev_ms = {}
        for name, fn in timed_stages.items():
            dev_ms[name] = {"graph": [], "eager": []}
            for eager in (False, True, True, False):
                set_eager(eager)
                with torch.inference_mode():
                    dev_ms[name]["eager" if eager else "graph"].append(
                        cuda_ms(torch, fn, 5, warmup=1))
        set_eager(False)
        for name, t in dev_ms.items():
            print(f"[graphs] {name}: device ms by CUDA events, graph "
                  + ", ".join(f"{x:.3f}" for x in t["graph"]) + "; eager "
                  + ", ".join(f"{x:.3f}" for x in t["eager"]) + f"; {card}")
        out["stage_ms"] = dev_ms

        def fmt(pr):
            ms, busy, n, steps = pr
            if busy is None:
                return f"{ms:.1f} ms, device busy not measured"
            return (f"{ms:.1f} ms, device busy {busy:.1f} ms ({busy / ms:.1%}), "
                    f"{n / steps:.0f} kernels a step")

        print(f"[graphs] solo tts() decode ms/step (stage time / steps): graph "
              + ", ".join(f"{x:.3f}" for x in solo[False]) + "; eager "
              + ", ".join(f"{x:.3f}" for x in solo[True]) + f"; a profiled call: graph "
              f"{fmt(prof[False])}; eager {fmt(prof[True])}; {card}")
        out["solo_ms_step"] = {"graph": solo[False], "eager": solo[True]}

        with torch.inference_mode():
            st = dataclasses.replace(slots.init_slots(cfg, B8, sx, sp, ring, torch.bfloat16,
                                                      kv_int8=True, device=DEV),
                                     persistent=True)
            for b in range(B8):
                slots.insert_slot(st, b, *ctx, len(sphones), len(sfeats.prompt_tokens), ring,
                                  ring, samp)
        seg = {False: [], True: []}
        gen = torch.Generator(device=DEV).manual_seed(3)

        def run_seg(eager):
            slots.decode_segment(p, st, cfg, W, sx, sp, ring, kv_kernel=True, generator=gen,
                                 eager=eager)

        with torch.inference_mode():
            run_seg(False)                            # the capture
            for eager in (False, True, True, False, False, True):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                run_seg(eager)
                e1.record()
                sync(torch)
                seg[eager].append(e0.elapsed_time(e1))
            sprof = {e: profiled(torch, lambda e=e: run_seg(e)) + (W,) for e in (False, True)}
        check(bool(st.active.all()) and not bool(st.done.any()), "occupancy 8 in the timing")
        print(f"[graphs] slot segment W={W} at occupancy 8 (int8 KV, kernel route), CUDA "
              f"events: graph " + ", ".join(f"{x:.3f}" for x in seg[False]) + " ms; eager "
              + ", ".join(f"{x:.3f}" for x in seg[True]) + f" ms; profiled: graph "
              f"{fmt(sprof[False])}; eager {fmt(sprof[True])}; {card}")
        out["slot_segment_ms"] = {"graph": seg[False], "eager": seg[True],
                                  "profiled": {str(k): v for k, v in sprof.items()}}

        # the segmented stream on an idle machine: first chunk and the end
        stext = get_phones_and_bert("。" + SENTENCES[4], "ja")[0]
        sbert = np.zeros((len(stext), cfg.bert_dim), np.float32)
        streams = {False: [], True: []}
        for eager in (False, True, True, False):
            cache.eager = eager
            t0 = time.perf_counter()
            first = None
            for _ in eng.synthesize_utterance_stream(char, feats, stext, sbert, seed=2,
                                                     pcm16=True):
                if first is None:
                    first = time.perf_counter() - t0
            streams[eager].append((first, time.perf_counter() - t0))
        cache.eager = False
        print(f"[graphs] segmented stream ({char.t2s_cfg.max_decode_steps}-step cap, idle "
              f"machine): "
              f"graph first chunk / end " + ", ".join(f"{a:.3f} / {b:.3f}"
                                                       for a, b in streams[False])
              + " s; eager " + ", ".join(f"{a:.3f} / {b:.3f}" for a, b in streams[True])
              + f" s; {card}")
        out["stream"] = {str(k): v for k, v in streams.items()}

        # 4 concurrent requests on the int8 slot route: the api's batcher,
        # its segments replayed (graph) or run without a graph (eager)
        sb = api.get_slot_batcher(char)
        lat = {False: [], True: []}

        def req(i):
            t0 = time.perf_counter()
            ph = get_phones_and_bert("。" + SENTENCES[i], "ja")[0]
            sb.synthesize(feats, ph, np.zeros((len(ph), cfg.bert_dim), np.float32),
                          timeout=600)
            return time.perf_counter() - t0

        try:
            for eager in (False, True, True, False):
                cache.eager = eager
                lat[eager].append(max(concurrent(req, 4)))
        finally:
            cache.eager = False
        print(f"[graphs] 4 concurrent requests on the int8 slot route ({codes} codes each), "
              f"the slowest one's latency: graph " + ", ".join(f"{x:.3f}" for x in lat[False])
              + " s; eager " + ", ".join(f"{x:.3f}" for x in lat[True]) + f" s; {card}")
        out["slot_route_s"] = {"graph": lat[False], "eager": lat[True]}
    finally:
        srv.shutdown()
        srv.server_close()
        del api.engine.warmup               # the engine's own methods again
        del api.engine._run_compile_units
        api.sweep_on_reference = False
        api.model_manager._cache.capacity = cap_prev
        for name in ("graphs", "graphs2"):
            api.unload_character(name)
    return out


def join_pair(torch, char, feats, phones, g, card):
    """The slot join (``slots.prefill_join`` then ``insert_slot``) at the
    slot geometry (Sx = Sp = 192, 24 layers), graph beside eager (the
    character's T2S cache set ``eager``) on the same inputs and noise: tok0
    and the histogram identical, the context columns' max abs difference,
    and the int8 slot segment that follows each (occupancy 8, the same
    noise) with identical codes and state; then each one's device ms
    (CUDA events) and wall ms (host clock to a sync), in turns."""
    import dataclasses

    import numpy as np

    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops.sampling import (SamplingConfig, SamplingRows, gumbel_noise,
                                                  rows_from_config)
    from genie_tts_tpu_torch.runtime import graphs

    cfg, p = char.t2s_cfg, char.t2s_params
    cache = graphs.cache_for(p)
    B8, W, sx, sp, ring = 8, 32, 192, 192, 512
    V = cfg.semantic_vocab
    phones_t = torch.tensor(np.pad(phones, (0, sx - len(phones)))[None], device=DEV).long()
    prompts = torch.tensor(np.pad(feats.prompt_tokens, (0, sp - len(feats.prompt_tokens)))[None],
                           device=DEV).long()
    x_len = torch.tensor([len(phones)], device=DEV)
    p_len = torch.tensor([len(feats.prompt_tokens)], device=DEV)
    bert = torch.randn((1, sx, cfg.bert_dim), generator=g, device=DEV)
    samp = rows_from_config(SamplingConfig(), 1)
    samp_dev = SamplingRows(*(torch.tensor(a, device=DEV) for a in samp))
    noise = gumbel_noise((1, V), g, DEV)
    seg_noise = gumbel_noise((W, B8, V), g, DEV)

    def join(state, with_bert=True):
        ck, cv, tok0, hist = slots.prefill_join(p, cfg, phones_t, bert if with_bert else None,
                                                x_len, prompts, p_len, samp_dev, noise=noise,
                                                any_top_p=False)
        if state is not None:
            slots.insert_slot(state, 3, ck, cv, tok0, hist, len(phones),
                              len(feats.prompt_tokens), 0, ring,
                              SamplingRows(*(a[0] for a in samp)), params=p)
        return ck, cv, tok0, hist

    with torch.inference_mode():
        # states copied into the graphs' buffers and back (the segment's
        # graph at this geometry is segment_pair's); the timing below runs
        # on a persistent state, as a slot machine's
        base = slots.init_slots(cfg, B8, sx, sp, ring, torch.bfloat16, kv_int8=True,
                                device=DEV)
        for b in range(B8):
            if b != 3:
                slots.insert_slot(base, b, *join(None), len(phones),
                                  len(feats.prompt_tokens), ring, ring,
                                  SamplingRows(*(a[0] for a in samp)))
        res = {}
        for eager in (False, True):
            cache.eager = eager
            try:
                st = slots.clone_state(base)
                outs = join(st)
                _, toks = slots.decode_segment(p, st, cfg, W, sx, sp, ring, kv_kernel=True,
                                               noise=seg_noise)
            finally:
                cache.eager = False
            sync(torch)
            res[eager] = (outs, toks, st)
    (gk, gv, gt, gh), g_toks, g_st = res[False]
    (ek, ev, et, eh), e_toks, e_st = res[True]
    ctx_diff = max(float((gk.float() - ek.float()).abs().max()),
                   float((gv.float() - ev.float()).abs().max()))
    leaves = [f.name for f in dataclasses.fields(g_st)
              if isinstance(getattr(g_st, f.name), torch.Tensor)]
    diff = [n for n in leaves if not torch.equal(getattr(g_st, n), getattr(e_st, n))]
    same = torch.equal(gt, et) and torch.equal(gh, eh) and torch.equal(g_toks, e_toks)
    scale = max(float(ek.float().abs().max()), float(ev.float().abs().max()))
    print(f"[graphs] slot join (prefill program with BERT rows, then insert into slot 3 of "
          f"an int8 state at occupancy 8): graph vs eager tok0 and hist "
          f"{'identical' if torch.equal(gt, et) and torch.equal(gh, eh) else 'DIFFER'}, "
          f"context columns max abs difference {ctx_diff:.3g} (largest |value| "
          f"{scale:.3g}, bf16); the segment that follows: "
          f"codes {'identical' if torch.equal(g_toks, e_toks) else 'DIFFER'}, state leaves "
          f"{'equal' if not diff else 'differ: ' + ', '.join(diff)}")
    # one bf16 step at the columns' magnitude bounds a GEMM that cuBLAS
    # ran by another algorithm under capture; the codes must not move
    check(same and ctx_diff <= scale * 2 ** -7, "slot join: graph vs eager")

    # device ms by CUDA events and wall ms by the host clock, in turns
    st = dataclasses.replace(slots.clone_state(base), persistent=True)
    times = {}

    def prefill_only(with_bert):
        with torch.inference_mode():
            join(None, with_bert)

    def insert_only():
        with torch.inference_mode():
            slots.insert_slot(st, 3, gk, gv, gt, gh, len(phones), len(feats.prompt_tokens),
                              0, ring, SamplingRows(*(a[0] for a in samp)), params=p)

    def join_both():
        with torch.inference_mode():
            join(st)

    for name, fn in (("prefill_join (BERT rows)", lambda: prefill_only(True)),
                     ("prefill_join (no BERT)", lambda: prefill_only(False)),
                     ("insert_slot (int8 columns)", insert_only),
                     ("the join (prefill_join + insert_slot)", join_both)):
        t = times[name] = {"graph_ms": [], "eager_ms": [], "graph_wall_ms": [],
                           "eager_wall_ms": []}
        for eager in (False, True, True, False):
            cache.eager = eager
            try:
                kind = "eager" if eager else "graph"
                t[f"{kind}_ms"].append(cuda_ms(torch, fn, 5, warmup=1))
                walls = []
                for _ in range(3):
                    sync(torch)
                    t0 = time.perf_counter()
                    fn()
                    sync(torch)
                    walls.append((time.perf_counter() - t0) * 1e3)
                t[f"{kind}_wall_ms"].append(min(walls))
            finally:
                cache.eager = False
        print(f"[graphs] {name} at Sx = Sp = 192, {cfg.num_layers} layers: device ms (CUDA events) graph "
              + ", ".join(f"{x:.3f}" for x in t["graph_ms"]) + "; eager "
              + ", ".join(f"{x:.3f}" for x in t["eager_ms"]) + "; wall ms (host clock to a "
              "sync, best of 3) graph " + ", ".join(f"{x:.3f}" for x in t["graph_wall_ms"])
              + "; eager " + ", ".join(f"{x:.3f}" for x in t["eager_wall_ms"]) + f"; {card}")
    return {"ctx_diff": ctx_diff, "times": times}


# fine-tuning geometry: B=8 clips of 128 phonemes and 384 semantic tokens
# (15 s at 25 Hz), rows 4-7 cut to 96 phonemes and 256 tokens
TRAIN_B, TRAIN_SX, TRAIN_SY, TRAIN_STEPS = 8, 128, 384, 10


def train_step_flops(cfg, B, Sx, Sy):
    """Operations of one train step by its shapes: forward + backward = 3x
    the forward's products (the layers' matmuls over every position, the
    attention scores and sums, BERT projection, the predict head over the
    audio block)."""
    S, D, L = Sx + Sy, cfg.embed_dim, cfg.num_layers
    layer = 2 * B * S * (4 * D * D + 2 * D * cfg.ffn_dim) + 4 * B * S * S * D
    fwd = (L * layer + 2 * B * Sx * cfg.bert_dim * D
           + 2 * B * Sy * D * cfg.semantic_vocab)
    return 3 * fwd


def rel_l2(torch, a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def phase_train(torch, root: Path, card: str):
    """T2S fine-tuning at full width through the entry points a user
    calls: ``T2SConfig()`` (24 L x d512 x 16 heads, FFN 2048) fp32 params
    from the port's ``init_params`` on a seeded cuda generator,
    ``make_mesh(1, 1)`` (cuda), ``make_train_step(cfg, mesh)`` at the
    default lr 1e-4, 10 steps on ``make_batch(cfg, 8, 128, 384)`` with
    rows 4-7 cut to x_len 96 and sem_len 256. The losses must be finite and
    the last below the first; the step's time (CUDA events, median of steps
    3-10), positions and target tokens a second, peak memory, beside the
    step's operation bound, and one profiled step. Then the card against
    the CPU at B=2, Sx=64, Sy=128 on the initial params: the loss (relative
    difference <= 1e-5) and every leaf's gradient (relative L2 <= 1e-4);
    printed beside it, row 1 alone (B=1), and the trained params with the
    CPU's own floor there (its rows one at a time against its batch: a few
    steps leave some leaves' gradients tiny residues of cancellation,
    which fp32 sums in another order do not reproduce). Then train then
    serve: the trained tree, written with ``save_params`` as the
    ``t2s.safetensors`` of a copy of the tts phase's character, loaded
    through ``api.load_character`` (int8 decode weights), cloned from the
    reference clip and spoken by ``tts()``: a finite wav of 2*codes*640
    samples, one fused launch per decode step."""
    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import T2SConfig
    from genie_tts_tpu_torch.convert.io import flatten_tree, save_params, unflatten_tree
    from genie_tts_tpu_torch.models import t2s
    from genie_tts_tpu_torch.ops import fused_decode as fu
    from genie_tts_tpu_torch.parallel.mesh import make_mesh
    from genie_tts_tpu_torch.parallel.train import make_batch, make_train_step
    from genie_tts_tpu_torch.utils.wavio import read_audio

    cfg = T2SConfig()
    mesh = make_mesh(1, 1)
    check(mesh.device.type == DEV, f"make_mesh(1, 1) on {mesh.device}")
    params = t2s.init_params(torch.Generator(device=DEV).manual_seed(8), cfg,
                             dtype=torch.float32)
    n_params = sum(x.numel() for x in flatten_tree(params).values())
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()      # earlier phases' graphs and states, the params
    init_fn, step_fn = make_train_step(cfg, mesh)
    p_init = params                     # init_fn trains a copy
    params, opt = init_fn(params)
    batch = make_batch(cfg, TRAIN_B, sx=TRAIN_SX, sy=TRAIN_SY)
    batch["x_len"][4:] = 96
    batch["sem_len"][4:] = 256
    events, losses = [], []
    for _ in range(TRAIN_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        params, opt, loss = step_fn(params, opt, batch)
        end.record()
        events.append((start, end))
        losses.append(loss)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    ms = [s.elapsed_time(e) for s, e in events]
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"train losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    check(all(x.device == mesh.device for x in flatten_tree(params).values()),
          "trained params left the card")
    step_ms = float(np.median(ms[2:]))
    # one more step under torch.profiler: the device's busy time by kernel
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        params, opt, _ = step_fn(params, opt, batch)
        e1.record()
        sync(torch)
    kernels = [(getattr(a, "self_device_time_total", None)
                or getattr(a, "self_cuda_time_total", 0.0), a.count, a.key)
               for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
    busy_ms = sum(k[0] for k in kernels) / 1e3
    prof_ms = e0.elapsed_time(e1)
    gemm_ms = sum(k[0] for k in kernels if "gemm" in k[2].lower()) / 1e3
    positions = TRAIN_B * (TRAIN_SX + TRAIN_SY)
    targets = int(batch["sem_len"].sum())
    flops = train_step_flops(cfg, TRAIN_B, TRAIN_SX, TRAIN_SY)
    p_bytes = 4 * n_params * 6          # params and both moments, read and written
    bound_ms, bound_by = bound(p_bytes, flops, "float32")
    print(f"[train] T2SConfig() {cfg.num_layers} L x d{cfg.embed_dim} x {cfg.num_heads} heads, "
          f"FFN {cfg.ffn_dim}, {n_params} fp32 params, AdamW lr 1e-4; "
          f"B={TRAIN_B} Sx={TRAIN_SX} Sy={TRAIN_SY} (rows 4-7: x_len 96, sem_len 256); "
          f"losses " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"[train] step {step_ms:.3f} ms (CUDA events, median of steps 3-{TRAIN_STEPS}; "
          f"all: {', '.join(f'{x:.2f}' for x in ms)}); {positions / step_ms * 1e3:.0f} "
          f"positions/s, {targets / step_ms * 1e3:.0f} target tokens/s; peak memory "
          f"{peak / 2**30:.2f} GiB (max_memory_allocated; {held / 2**30:.2f} GiB of it allocated "
          f"before the first step); bound {bound_ms:.3f} ms "
          f"({bound_by}: {flops:.4e} FLOP at {PEAK_OPS['float32'] / 1e12:.0f} TFLOP/s "
          f"fp32, TF32 off; {p_bytes / 1e9:.2f} GB at 3.35 TB/s), "
          f"{step_ms / bound_ms:.2f}x the bound, {flops / step_ms / 1e9:.2f} TFLOP/s; {card}")
    if busy_ms > 0:
        top = "; ".join(f"{key[:60]} x{n} {us / 1e3:.2f} ms"
                        for us, n, key in sorted(kernels, reverse=True)[:5])
        print(f"[train] profiled step: {prof_ms:.3f} ms, device busy {busy_ms:.3f} ms "
              f"({busy_ms / prof_ms:.1%}), GEMM kernels {gemm_ms:.3f} ms "
              f"({flops / gemm_ms / 1e9 if gemm_ms else 0:.1f} TFLOP/s if all the step's "
              f"FLOP were theirs), {sum(k[1] for k in kernels)} kernel launches; top: {top}")
    else:
        print("[train] profiled step: the profiler shows no device time (not measured)")

    # the card against the CPU: the loss and every leaf's gradient at B=2
    # on the initial params (held to the tolerances); the same on the
    # trained params beside the CPU's own floor there (its rows one at a
    # time against the batch), and each row alone at B=1 (printed)
    small = make_batch(cfg, 2, sx=64, sy=128, seed=1)
    small["x_len"][1] = 41
    small["sem_len"][1] = 90
    count = float(np.clip(small["sem_len"], 0, small["semantic"].shape[1]).sum())

    def grads_of(src, dev, rows):
        """(the rows' NLL sum / the batch's valid count, {leaf: gradient})."""
        leaves = {p: x.detach().to(dev).requires_grad_(True)
                  for p, x in flatten_tree(src).items()}
        b = {k: torch.as_tensor(v[rows], device=dev) for k, v in small.items()}
        logits = t2s.forward_train(unflatten_tree(leaves), cfg, b["phones"], b["bert"],
                                   b["x_len"], b["semantic"], b["sem_len"])
        total, _ = t2s.masked_nll(logits, b["semantic"], b["sem_len"], cfg.eos_id)
        loss = total / count
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return float(loss), {p: g.detach().cpu() for p, g in zip(leaves, grads)
                             if g is not None}

    def compare(a, b):
        check(set(a) == set(b), "the two runs differ in the leaves with a gradient")
        rels = {p: rel_l2(torch, a[p], b[p]) for p in b}
        worst = max(rels, key=rels.get)
        return rels[worst], worst, float(np.median(list(rels.values())))

    both = slice(0, 2)
    lc, gc = grads_of(p_init, DEV, both)
    lh, gh = grads_of(p_init, "cpu", both)
    loss_rel = abs(lc - lh) / abs(lh)
    worst, leaf, med = compare(gc, gh)
    print(f"[train] card vs CPU (B=2, Sx=64, Sy=128, initial params): loss {lc:.7f} vs "
          f"{lh:.7f}, relative {loss_rel:.3e} (tolerance 1e-5); gradients of {len(gh)} "
          f"leaves, worst relative L2 {worst:.3e} ({leaf}; tolerance 1e-4), median {med:.3e}")
    check(loss_rel <= 1e-5, f"card/CPU loss relative difference {loss_rel}")
    check(worst <= 1e-4, f"card/CPU gradient of {leaf}: {worst}")
    row_c = grads_of(p_init, DEV, slice(1, 2))[1]
    row_h = grads_of(p_init, "cpu", slice(1, 2))[1]
    worst, leaf, med = compare(row_c, row_h)
    print(f"[train] card vs CPU, row 1 alone (B=1), initial params: worst relative L2 "
          f"{worst:.3e} ({leaf}), median {med:.3e} (printed, not held)")
    lc, gc = grads_of(params, DEV, both)
    lh, gh = grads_of(params, "cpu", both)
    worst, leaf, med = compare(gc, gh)
    rows_h = [grads_of(params, "cpu", slice(r, r + 1))[1] for r in (0, 1)]
    split = {p: rows_h[0][p] + rows_h[1][p] for p in gh}
    fworst, fleaf, fmed = compare(split, gh)
    print(f"[train] card vs CPU (B=2), trained params: loss relative "
          f"{abs(lc - lh) / abs(lh):.3e}; gradients worst relative L2 {worst:.3e} ({leaf}), "
          f"median {med:.3e}; the CPU's rows one at a time against its batch: worst "
          f"{fworst:.3e} ({fleaf}), median {fmed:.3e} (printed, not held)")
    del gc, gh, row_c, row_h, rows_h, split, p_init

    # train then serve
    trained = root / "char_trained"
    shutil.copytree(root / "char", trained)
    save_params(params, trained / "t2s.safetensors")
    del params, opt
    torch.cuda.empty_cache()
    api.load_character("trained", trained, "ja", device=DEV)
    try:
        api.set_reference_audio("trained", root / "ref.wav", "こんにちは、てすとです", "ja")
        fu.fused_decode_step.launches = 0
        wav = root / "trained.wav"
        t0 = time.perf_counter()
        api.tts("trained", "きょうはいいてんきですね。", save_path=wav)
        sync(torch)
        wall = time.perf_counter() - t0
        launches = fu.fused_decode_step.launches
        st = api.engine.last_stats
        audio, sr = read_audio(wav)
        n = st["codes_len"]
        check(sr == 32000 and np.isfinite(audio).all() and len(audio) == 2 * n * 640 > 0,
              f"trained character: wav of {len(audio)} samples at {sr} Hz for {n} codes")
        check(launches == st["decode_steps"] > 0,
              f"trained character: {launches} fused launches for "
              f"{st['decode_steps']} decode steps")
        check(api.model_manager.get("trained").t2s_params["layers"]["qkv"]["w"].dtype
              == torch.int8, "the trained character did not load int8 decode weights")
    finally:
        api.unload_character("trained")
    print(f"[train] trained tree served: tts() {wall * 1e3:.1f} ms wall, {n} codes, "
          f"{st['decode_steps']} decode steps, {launches} fused launches")
    return {"step_ms": step_ms, "peak": peak, "bound_ms": bound_ms}


def hf_hubert_state_dict(cfg, seed: int, legacy: bool = True):
    """A random chinese-hubert-base checkpoint in the key layout of
    transformers' ``HubertModel`` (numpy fp32 from ``seed``): the conv
    frontend (no conv biases) with the first layer's GroupNorm, the
    feature projection, the weight-normed positional conv as
    ``weight_g``/``weight_v`` or, with ``legacy=False``, as
    ``parametrizations.weight.original0``/``original1``, the encoder
    layers and ``masked_spec_embed``. Weights scale with fan-in, so the
    features stay finite through every layer."""
    import numpy as np

    rng = np.random.default_rng(seed)

    def randn(*shape, std=1.0):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    sd = {}

    def ln(key, n):
        sd[f"{key}.weight"] = 1.0 + randn(n, std=0.1)
        sd[f"{key}.bias"] = randn(n, std=0.1)

    def lin(key, i, o):
        sd[f"{key}.weight"] = randn(o, i, std=i ** -0.5)
        sd[f"{key}.bias"] = randn(o, std=0.02)

    in_c = 1
    for i, (c, k) in enumerate(zip(cfg.conv_dims, cfg.conv_kernels)):
        sd[f"feature_extractor.conv_layers.{i}.conv.weight"] = randn(
            c, in_c, k, std=(in_c * k) ** -0.5)
        in_c = c
    ln("feature_extractor.conv_layers.0.layer_norm", cfg.conv_dims[0])
    D, G, K = cfg.embed_dim, cfg.conv_pos_groups, cfg.conv_pos_kernel
    ln("feature_projection.layer_norm", cfg.conv_dims[-1])
    lin("feature_projection.projection", cfg.conv_dims[-1], D)
    # w = g * v / |v| (norm over the first two axes): g = sqrt(D / K) gives
    # w the fan-in scale (D/G * K) ** -0.5
    pre = "encoder.pos_conv_embed.conv."
    g = (D / K) ** 0.5 * (1.0 + randn(1, 1, K, std=0.1))
    v = randn(D, D // G, K)
    if legacy:
        sd[pre + "weight_g"], sd[pre + "weight_v"] = g, v
    else:
        sd[pre + "parametrizations.weight.original0"] = g
        sd[pre + "parametrizations.weight.original1"] = v
    sd[pre + "bias"] = randn(D, std=0.02)
    ln("encoder.layer_norm", D)
    for i in range(cfg.num_layers):
        p = f"encoder.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            lin(f"{p}.attention.{name}", D, D)
        ln(f"{p}.layer_norm", D)
        lin(f"{p}.feed_forward.intermediate_dense", D, cfg.ffn_dim)
        lin(f"{p}.feed_forward.output_dense", cfg.ffn_dim, D)
        ln(f"{p}.final_layer_norm", D)
    sd["masked_spec_embed"] = rng.uniform(size=D).astype(np.float32)
    return sd


def phase_shared_convert(torch, root: Path, card: str):
    """Shared-model conversion at full size: a random chinese-hubert-base
    (``HubertConfig()``: 7 conv layers of 512, 12 L x d768, positional conv
    128 in 16 groups) in the HF key layout, ``torch.save``d as
    ``pytorch_model.bin``, through ``convert_shared_models(hubert_dir_in=
    ...)`` into a work-dir ``GENIE_DATA_DIR`` (timed). A new model
    manager's ``load_hubert`` serves the file; the converted HuBERT in fp32
    (``set_hubert``) serves ``set_reference_audio`` on the card, and its
    features of the clip match the CPU's from the same file (relative L2
    <= 1e-5)."""
    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import HubertConfig, hubert_dir
    from genie_tts_tpu_torch.convert.io import flatten_tree, load_params
    from genie_tts_tpu_torch.convert.shared_models import convert_shared_models
    from genie_tts_tpu_torch.models import hubert
    from genie_tts_tpu_torch.runtime.model_manager import ModelManager
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache

    hcfg = HubertConfig()
    src = root / "hf-chinese-hubert-base"
    src.mkdir()
    t0 = time.perf_counter()
    sd = hf_hubert_state_dict(hcfg, seed=31)
    n_params = sum(v.size for v in sd.values())
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, src / "pytorch_model.bin")
    del sd
    t_write = time.perf_counter() - t0
    env = {k: os.environ.get(k) for k in ("GENIE_HUBERT_DIR", "GENIE_DATA_DIR")}
    os.environ.pop("GENIE_HUBERT_DIR", None)
    os.environ["GENIE_DATA_DIR"] = str(root / "GenieData")
    try:
        t0 = time.perf_counter()
        convert_shared_models(hubert_dir_in=src)
        t_conv = time.perf_counter() - t0
        out = hubert_dir() / "hubert.safetensors"
        check(out == root / "GenieData" / "chinese-hubert-base" / "hubert.safetensors"
              and out.is_file(), f"converted HuBERT not at {out}")
        served = ModelManager().load_hubert(DEV)
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    D = hcfg.embed_dim
    check(served is not None
          and served[0]["layers"]["q"]["w"].shape == (hcfg.num_layers, D, D)
          and served[0]["pos_conv"]["w"].shape == (hcfg.conv_pos_kernel,
                                                   D // hcfg.conv_pos_groups, D),
          "load_hubert did not serve the converted file")
    print(f"[convert] chinese-hubert-base HF state dict ({n_params} params, "
          f"{(src / 'pytorch_model.bin').stat().st_size / 1e6:.1f} MB) written in "
          f"{t_write:.2f} s; convert_shared_models {t_conv:.2f} s -> {out.name} "
          f"({out.stat().st_size / 1e6:.1f} MB); load_hubert serves it ({len(flatten_tree(served[0]))} leaves, "
          f"{served[0]['fp_proj']['w'].dtype})")
    del served

    prev = api.model_manager.load_hubert(DEV)
    api.model_manager.set_hubert(load_params(out, torch.float32, DEV), hcfg)
    clip = root / "ref_convert.wav"
    shutil.copy(root / "ref.wav", clip)
    text = "こんにちは、てすとです"
    try:
        t0 = time.perf_counter()
        check(api.set_reference_audio("hubert_check", clip, text, "ja", device=DEV),
              "set_reference_audio refused the clip")
        sync(torch)
        wall = time.perf_counter() - t0
        ref = reference_audio_cache.get_clip(str(clip), text, "ja")
        card_feats = torch.as_tensor(ref.ssl_content)
    finally:
        api.model_manager.set_hubert(*prev)
    with torch.inference_mode():
        cpu_feats = hubert.apply(load_params(out, torch.float32, "cpu"),
                                 torch.as_tensor(ref.audio_16k, dtype=torch.float32)[None],
                                 hcfg)[0]
    rel = rel_l2(torch, card_feats, cpu_feats)
    check(card_feats.shape == cpu_feats.shape and card_feats.shape[1] == hcfg.embed_dim
          and bool(torch.isfinite(card_feats).all()),
          f"HuBERT features {tuple(card_feats.shape)} vs {tuple(cpu_feats.shape)}")
    print(f"[convert] set_reference_audio through the converted HuBERT (fp32): "
          f"{wall * 1e3:.1f} ms wall; features {tuple(card_feats.shape)}, card vs CPU "
          f"relative L2 {rel:.3e} (tolerance 1e-5); {card}")
    check(rel <= 1e-5, f"converted HuBERT card/CPU features relative L2 {rel}")
    api._reference_audios.pop("hubert_check", None)
    return {"convert_s": t_conv}


MESH_SENTENCES = SENTENCES[:4]
MESH_REF_TEXT = "こんにちは、てすとです"


MESH_LADDER = dict(batch_buckets=(1, 4), frame_buckets=(64, 128, 256))


def _mesh_kernels():
    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu
    from genie_tts_tpu_torch.ops import int8_decode as i8

    return {"int8": i8.int8_big_attention, "flash": fl.flash_decode_attention,
            "fused": fu.fused_decode_step}


def _reset_counts(torch):
    sync(torch)
    for k in _mesh_kernels().values():
        k.launches = 0


def _counts(torch):
    sync(torch)
    return {n: k.launches for n, k in _mesh_kernels().items()}


def captured_programs(cache) -> int:
    """The (key, variant) programs of a graph cache that hold a captured
    CUDA graph, whenever they were captured (a configuration's cache may
    have been filled before its stats were last reset)."""
    return sum(entry is not None for g in cache._graphs.values()
               for entry in g._graphs.values())


def mesh_memory(eng, char):
    """Per replica: graphs captured and pool / static-buffer MiB by card, of
    its T2S and SoVITS caches (replica 0's SoVITS configuration is a 1x1
    character's on the same card: its graphs may have been captured by an
    earlier phase)."""
    from genie_tts_tpu_torch.runtime import graphs

    out = []
    for rep in eng._replicas(char):
        row = {}
        for fam, params in (("T2S", rep.t2s_params), ("SoVITS", rep.sovits_params)):
            c = graphs.cache_for(params)
            pools, bufs = c.bytes_by_device()
            row[fam] = dict(keys=len(c.keys()), captured=captured_programs(c),
                            pool_mib={str(d): round(n / 2 ** 20, 1) for d, n in pools.items()},
                            buffers_mib={str(d): round(n / 2 ** 20, 1)
                                         for d, n in bufs.items()})
        out.append(row)
    return out


def mesh_load(torch, root: Path, name: str, mesh, cfg):
    """``api.engine`` swapped for a mesh engine over ``mesh`` with ``cfg``,
    phase 3's character loaded on it as ``name`` (placed by
    ``shard_character``) and its reference set; returns (character,
    reference features)."""
    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.runtime.engine import TTSEngine
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache

    api.engine = TTSEngine(cfg, timing=True, mesh=mesh)
    api._batcher = None
    t0 = time.perf_counter()
    api.load_character(name, root / "char", "ja")
    api.set_reference_audio(name, root / "ref.wav", MESH_REF_TEXT, "ja")
    c = api.model_manager.get(name)
    feats = reference_audio_cache.get_features(api.engine, c, str(root / "ref.wav"),
                                               MESH_REF_TEXT, "Japanese")
    print(f"[mesh] {mesh.dp}x{mesh.tp} over {[str(d) for row in mesh.devices for d in row]}: "
          f"'{name}' loaded, placed and its reference set in {time.perf_counter() - t0:.1f} s; "
          f"{len(c.replicas)} replicas, {len(c.t2s_params.get('layer_shards', [0]))} tp "
          f"shard(s) each")
    return c, feats


def mesh_unload(name: str) -> None:
    """``api.unload_character(name)`` (the caller holds the character no
    more; the unload waits for its retired slot machine to come to rest,
    so the process may end right after it), then check that every
    replica's weights are freed after ``gc.collect()`` while the graph
    caches of its configurations stay."""
    import gc
    import weakref

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.runtime import graphs

    char = api.model_manager.get(name)
    gone = [weakref.ref(graphs._anchor(params)) for rep in api.engine._replicas(char)
            for params in (rep.t2s_params, rep.sovits_params)]
    caches = api.engine.graph_caches(char)
    del char
    api.unload_character(name)
    gc.collect()
    alive = sum(r() is not None for r in gone)
    check(alive == 0, f"{name}: {alive} of {len(gone)} replica weight sets outlived the unload")
    check(all(c.keys() for c in caches), f"{name}: a configuration's graphs went with it")
    print(f"[mesh] '{name}' unloaded: its slot machine at rest, the weights of all "
          f"{len(caches) // 2} replicas freed, the {len(caches)} graph caches of their "
          f"configurations kept")


def mesh_second(torch, root: Path, card: str, first: str) -> dict:
    """A second character of the mesh character ``first``'s configuration
    (other weights: ``make_second_character``) loaded on the swept mesh
    engine: its sweep runs 0 units, and one solo ``tts()`` and one
    ``/tts`` (the int8 slot route) serve it with no capture and no miss in
    any replica's cache."""
    import urllib.request

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache
    from genie_tts_tpu_torch.utils.wavio import read_audio

    d = make_second_character(torch, root)
    t0 = time.perf_counter()
    api.load_character("mesh2", d, "ja")
    api.set_reference_audio("mesh2", root / "ref.wav", MESH_REF_TEXT, "ja")
    c2 = api.model_manager.get("mesh2")
    feats2 = reference_audio_cache.get_features(api.engine, c2, str(root / "ref.wav"),
                                                MESH_REF_TEXT, "Japanese")
    units = api.engine.warmup(c2, feats2, sweep=True)
    sync(torch)
    load_s = time.perf_counter() - t0
    caches = api.engine.graph_caches(c2)
    check(units == 0 and caches == api.engine.graph_caches(api.model_manager.get(first)),
          f"mesh2: the sweep ran {units} units or its caches are not {first}'s")
    for c in caches:
        c.reset_stats()
    t0 = time.perf_counter()
    api.tts("mesh2", "きょうはいいてんきですね。", save_path=root / "mesh2_tts.wav")
    sync(torch)
    solo_s = time.perf_counter() - t0
    audio, _ = read_audio(root / "mesh2_tts.wav")
    srv = api.start_server(host="127.0.0.1", port=0, block=False)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/tts",
            data=json.dumps({"character_name": "mesh2", "text": MESH_SENTENCES[0],
                             "split_sentence": False}).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            status, body = r.status, r.read()
        tts_s = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    stats = [dict(c.stats) for c in caches]
    codes = min(c2.t2s_cfg.max_decode_steps, api.get_slot_batcher(c2).ring)
    print(f"[mesh] mesh2 (a second 2x2 character of the configuration, other weights): load, "
          f"reference and sweep {load_s:.2f} s ({units} units); solo tts() {solo_s * 1e3:.1f} ms "
          f"wall, /tts {tts_s:.3f} s (HTTP {status}, {len(body)} bytes); every replica's "
          f"caches {json.dumps(stats)}; {card}")
    check(status == 200 and len(body) == 2 * 2 * codes * 640 and len(audio) > 0
          and bool(np.isfinite(audio).all()), f"mesh2: HTTP {status}, {len(body)} bytes")
    check(all(st["misses"] == st["variants"] == st["captures"] == 0 for st in stats)
          and all(st["hits"] > 0 for st in stats[:2]),
          f"mesh2: serving a second character of the configuration missed: {stats}")
    del c2
    mesh_unload("mesh2")
    return dict(units=units, load_s=load_s, solo_s=solo_s, tts_s=tts_s, stats=stats)


def mesh_sweep(torch, name, char, feats, card):
    """``engine.warmup(char, feats, sweep=True)`` on the mesh: every replica
    swept; prints the wall time and, per replica, the graphs captured and
    the pool and static-buffer MiB by card."""
    from genie_tts_tpu_torch import api

    sync(torch)
    t0 = time.perf_counter()
    units = api.engine.warmup(char, feats, sweep=True)
    sync(torch)
    wall = time.perf_counter() - t0
    mem = mesh_memory(api.engine, char)
    print(f"[mesh] {name}: the sweep ran {units} units over {len(mem)} replicas in {wall:.1f} s; "
          + "; ".join(f"replica {r}: " + ", ".join(
              f"{fam} {m['keys']} keys, {m['captured']} graphs, pool MiB "
              f"{json.dumps(m['pool_mib'])}, buffers MiB {json.dumps(m['buffers_mib'])}"
              for fam, m in row.items()) for r, row in enumerate(mem)) + f"; {card}")
    check(all(m["captured"] >= m["keys"] > 0 for row in mem for m in row.values()),
          f"mesh {name}: a replica's cache holds graphs not captured: {mem}")
    return dict(units=units, wall_s=wall, replicas=mem)


def mesh_serve(torch, root: Path, card: str, name: str, char, feats):
    """The swept mesh character served warm, the kernel counts set to 0
    before each route and read after: (a) solo ``tts()`` (graph; then the
    caches set ``eager`` for the eager ms/step beside it), (b)
    ``synthesize_batch`` of 4 rows, (c) 4 concurrent default ``/tts`` on the
    int8 slot route and a short stream on the idle machine (the segmented
    stream) through the port's server. No miss, no variant and no capture
    in any replica's T2S or SoVITS cache while (a)-(c) serve."""
    import threading
    import urllib.request

    import numpy as np

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert
    from genie_tts_tpu_torch.utils.wavio import read_audio

    eng = api.engine
    mesh = eng.mesh
    dp, tp, L = mesh.dp, mesh.tp, char.t2s_cfg.num_layers
    caches = eng.graph_caches(char)
    for c in caches:
        c.reset_stats()
    out = {}

    def solo(wav):
        _reset_counts(torch)
        t0 = time.perf_counter()
        api.tts(name, "きょうはいいてんきですね。", save_path=wav)
        sync(torch)
        wall = time.perf_counter() - t0
        c = _counts(torch)
        st = eng.last_stats
        audio, _ = read_audio(wav)
        n = st["codes_len"]
        check(np.isfinite(audio).all() and len(audio) == 2 * n * 640 > 0,
              f"mesh {name} tts: a wav of {len(audio)} samples for {n} codes")
        steps = st["decode_steps"]
        route = "flash" if tp > 1 else "fused"
        want = L * tp * steps if tp > 1 else steps
        check(c[route] == want > 0 and sum(c.values()) == c[route],
              f"mesh {name} solo tts: launches {c} for {steps} decode steps")
        return wall, c, steps, st["stages"]["decode"] * 1e3 / steps

    # (a) solo tts(), warm: graph replays only
    wall, c, steps, ms_step = solo(root / f"{name}_a.wav")
    print(f"[mesh] {name} (a) solo tts(), warm: {wall * 1e3:.1f} ms wall, {steps} decode steps, "
          f"{ms_step:.3f} ms/step (graph), launches {json.dumps(c)}")
    out["a"] = dict(wall_s=wall, steps=steps, launches=c, ms_step=ms_step)

    # (b) synthesize_batch, B = 4: 4 / dp rows per replica
    rows = [get_phones_and_bert("。" + s, "ja") for s in MESH_SENTENCES]
    items = [(feats, ph, bert) for ph, bert in rows]
    st = {}
    _reset_counts(torch)
    t0 = time.perf_counter()
    wavs = eng.synthesize_batch(char, items, seed=5, stats=st)
    sync(torch)
    wall = time.perf_counter() - t0
    c = _counts(torch)
    steps = st["decode_steps"]
    per_row = eng.batch_rows(4)[1]
    want = (L * dp * tp * steps if tp > 1 or per_row > 1 else dp * steps)
    route = "flash" if tp > 1 or per_row > 1 else "fused"
    check(c[route] == want > 0 and sum(c.values()) == c[route],
          f"mesh {name} (b) synthesize_batch: launches {c} for {steps} steps")
    check(all(np.isfinite(w).all() and len(w) > 0 for w in wavs), f"mesh {name} (b): waveforms")
    print(f"[mesh] {name} (b) synthesize_batch B=4 ({per_row} rows per replica), warm: "
          f"{wall * 1e3:.1f} ms wall, {steps} decode steps per replica, launches {json.dumps(c)}")
    out["b"] = dict(wall_s=wall, steps=steps, launches=c)

    # (c) 4 concurrent /tts on the int8 slot route, then a short stream on
    # the idle machine (the segmented stream), through the server
    srv = api.start_server(host="127.0.0.1", port=0, block=False)
    url = f"http://127.0.0.1:{srv.server_address[1]}/tts"

    def post(payload):
        req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            first = r.read1(1 << 16)
            t_first = time.perf_counter() - t0
            body = first + r.read()
            return r.status, body, t_first, time.perf_counter() - t0

    try:
        sb = api.get_slot_batcher(char)
        check(len(sb._state.tp_caches) == tp - 1 and sb._state.k_scale is not None
              and sb._state.persistent,
              f"mesh {name} (c): the slot state is not a persistent int8 state per tp shard")
        results, errors = {}, []

        def client(i):
            try:
                results[i] = post({"character_name": name, "text": MESH_SENTENCES[i],
                                   "split_sentence": False})
            except BaseException as e:  # noqa: BLE001 — reported below
                errors.append(repr(e))

        _reset_counts(torch)
        s0 = sb.stats["steps"]
        threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        c = _counts(torch)
        steps = sb.stats["steps"] - s0
        check(not errors and len(results) == 4, f"mesh {name} (c): {errors or 'a request hung'}")
        codes = min(char.t2s_cfg.max_decode_steps, sb.ring)
        for status, body, _, _ in results.values():
            levels = np.unique(np.frombuffer(body, "<i2")).size
            check(status == 200 and len(body) == 2 * 2 * codes * 640 and levels > 1000,
                  f"mesh {name} (c): HTTP {status}, {len(body)} bytes, {levels} PCM levels")
        check(c["int8"] == L * tp * steps > 0 and c["flash"] == 0 and c["fused"] == 0,
              f"mesh {name} (c) slot route: launches {c} for {steps} slot steps")
        lat = [r[3] for r in results.values()]
        stream = post({"character_name": name, "text": SENTENCES[4], "split_sentence": False,
                       "stream": True})
        check(stream[0] == 200 and len(stream[1]) == 2 * 2 * codes * 640,
              f"mesh {name} segmented stream: HTTP {stream[0]}, {len(stream[1])} bytes")
        print(f"[mesh] {name} (c) 4 x /tts on the int8 slot route, warm: latency "
              + ", ".join(f"{x:.3f}" for x in lat) + f" s, {steps} slot steps, launches "
              f"{json.dumps(c)} (24 x tp x steps = {L * tp * steps}); a short stream on the "
              f"idle machine (segmented): first chunk {stream[2]:.3f} s, end {stream[3]:.3f} s")
        out["c"] = dict(latency_s=lat, steps=steps, launches=c, stream=stream[2:],
                        live=dict(shape=(sb.n_slots, sb.sx, sb.sp, sb.ring), state=sb._state,
                                  head=int(sb._state.ring_head)))
    finally:
        srv.shutdown()
        srv.server_close()
    stats = [dict(c.stats) for c in caches]
    print(f"[mesh] {name}: every replica's caches (T2S, SoVITS by replica) while (a)-(c) "
          f"served: {json.dumps(stats)}")
    check(all(st["misses"] == st["variants"] == st["captures"] == 0 for st in stats)
          and all(st["hits"] > 0 for st in stats[:2]),
          f"mesh {name}: serving after the sweep missed a cache: {stats}")

    # (a) again with every replica's caches set eager: the eager ms/step
    for c in caches:
        c.eager = True
    try:
        wall_e, c, steps_e, ms_e = solo(root / f"{name}_a_eager.wav")
    finally:
        for c_ in caches:
            c_.eager = False
    print(f"[mesh] {name} (a) solo tts() ms/step: graph {out['a']['ms_step']:.3f}, eager "
          f"{ms_e:.3f} ({steps_e} steps, {wall_e * 1e3:.1f} ms wall eager); {card}")
    out["a"]["eager_ms_step"] = ms_e
    return out


def tp_graph_vs_eager(torch, char, card: str, name: str):
    """(g) The tp route's graphs against its eager run on one noise, on a
    sharded character: ``generate`` at B=1 and B=4 (cap 40: tokens, counts
    and the repetition histogram), one slot segment at occupancy 8 after
    graph joins (int8 KV, the kernel route: tokens and every state leaf,
    each shard's caches included) and one segmented-stream segment (exact
    KV). Each must be identical; prints each one's device ms (CUDA events
    around the call, the graph already captured), graph and eager."""
    import dataclasses

    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.models import slots, t2s
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, SamplingRows, gumbel_noise
    from genie_tts_tpu_torch.runtime.stream import stream_geometry

    cfg, p = char.t2s_cfg, char.t2s_params
    devs = t2s.shard_devices(p)
    g = torch.Generator(device=DEV).manual_seed(9)
    out = {}

    def timed(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        sync(torch)
        start.record()
        r = fn()
        end.record()
        sync(torch)
        return r, start.elapsed_time(end)

    Sx, Sp, cap = 64, 128, 40
    for B in (1, 4):
        phones = torch.randint(1, cfg.phoneme_vocab, (B, Sx), generator=g, device=DEV)
        bert = torch.randn((B, Sx, cfg.bert_dim), generator=g, device=DEV)
        prompts = torch.randint(0, 1024, (B, Sp), generator=g, device=DEV)
        x_len = torch.tensor([40, 64, 23, 51][:B], device=DEV)
        p_len = torch.tensor([100, 128, 77, 90][:B], device=DEV)
        noise = gumbel_noise((cap, B, cfg.semantic_vocab), g, DEV)
        graph, _ = t2s.decode_graph(p, cfg, B, Sx, Sp, Sx + Sp + cap, cap, p["audio_embed"].dtype)

        def run(eager):
            with torch.inference_mode():
                r = t2s.generate(p, cfg, SamplingConfig(), None, (phones, bert), x_len, prompts,
                                 p_len, max_steps=cap, cache_len=Sx + Sp + cap, min_steps=cap,
                                 noise=noise, eager=eager)
            return r.tokens.clone(), r.counts.clone(), graph.static.hist.clone(), r.steps

        res = {}
        for route in ("graph", "eager", "graph", "eager"):     # the first graph run captures
            _reset_counts(torch)
            r, ms = timed(lambda: run(route == "eager"))
            res.setdefault(route, []).append((r, ms, _counts(torch)["flash"]))
        (rg, _, ng), (re_, _, ne) = res["graph"][-1], res["eager"][-1]
        same = all(torch.equal(a, b) for a, b in zip(rg[:3], re_[:3])) and rg[3] == re_[3] == cap
        check(same and ng == ne == cfg.num_layers * len(devs) * (cap - 1),
              f"mesh {name} (g) generate B={B}: graph vs eager tokens, counts or histogram "
              f"differ, or launches {ng} / {ne}")
        ms_g, ms_e = res["graph"][-1][1], res["eager"][-1][1]
        print(f"[mesh] {name} (g) generate B={B}, cap {cap}: graph vs eager tokens, counts and "
              f"histogram identical; device ms (CUDA events, prefill + {cap - 1} steps): graph "
              f"{ms_g:.1f} ({ms_g / cap:.3f} a step), eager {ms_e:.1f} ({ms_e / cap:.3f}); "
              f"flash launches {ng} (24 x tp x steps)")
        out[f"generate_B{B}"] = dict(graph_ms=ms_g, eager_ms=ms_e)
        if B == 1:
            # one graph replay under torch.profiler: kernels a step and the
            # sum of their device times against the wall of the call
            ms, busy, n = profiled(torch, lambda: run(False))
            if busy is not None:
                print(f"[mesh] {name} (g) generate B=1 graph under torch.profiler: {ms:.1f} ms, "
                      f"kernels {n} ({n / cap:.0f} a step), their device time summed "
                      f"{busy:.1f} ms ({busy / ms:.1%} of the call; the shards' streams may "
                      f"overlap), {1e3 * busy / n:.2f} us a kernel")
                out["generate_B1"].update(profiled_ms=ms, busy_ms=busy, kernels=n)

    def join_rows(state, n, sx, sp):
        """``n`` requests joined into ``state`` through the join and insert
        graphs (their Gumbel rows from ``g``)."""
        for s in range(n):
            ph = torch.zeros((1, sx), dtype=torch.long, device=DEV)
            ph[0, :40 + 7 * s] = torch.randint(1, cfg.phoneme_vocab, (40 + 7 * s,),
                                               generator=g, device=DEV)
            pr = torch.zeros((1, sp), dtype=torch.long, device=DEV)
            pr[0, :90 + 5 * s] = torch.randint(0, 1024, (90 + 5 * s,), generator=g, device=DEV)
            samp = SamplingRows(*(torch.tensor([v], device=DEV) for v in (15, 1.0, 1.0, 1.35)))
            with torch.inference_mode():
                ck, cv, tok0, hist = slots.prefill_join(
                    p, cfg, ph, None, torch.tensor([40 + 7 * s], device=DEV), pr,
                    torch.tensor([90 + 5 * s], device=DEV), samp,
                    noise=gumbel_noise((1, cfg.semantic_vocab), g, DEV), any_top_p=False)
                slots.insert_slot(state, s, ck, cv, tok0, hist, 40 + 7 * s, 90 + 5 * s, 0,
                                  120, SamplingRows(15, 1.0, 1.0, 1.35), params=p)

    def segment_pair(state, W, sx, sp, ring, kernel, what):
        noise = gumbel_noise((W, state.k_cache.shape[1], cfg.semantic_vocab), g, DEV)
        res = {}
        for route in ("graph", "eager", "graph", "eager"):
            st = slots.clone_state(state)
            with torch.inference_mode():
                (_, toks), ms = timed(lambda: slots.decode_segment(
                    p, st, cfg, W, sx, sp, ring, kv_kernel=kernel, noise=noise,
                    eager=route == "eager"))
            res.setdefault(route, []).append((st, toks, ms))
        (a, ta, ms_g), (b, tb, ms_e) = res["graph"][-1], res["eager"][-1]
        leaves = [f.name for f in dataclasses.fields(a)
                  if isinstance(getattr(a, f.name), torch.Tensor)]
        diff = [n for n in leaves if not torch.equal(getattr(a, n), getattr(b, n))]
        diff += [f"shard {j + 1} cache {i}" for j, (x, y) in enumerate(zip(a.tp_caches,
                                                                           b.tp_caches))
                 for i, (u, v) in enumerate(zip(x, y)) if u is not None and not torch.equal(u, v)]
        check(torch.equal(ta, tb) and not diff and len(a.tp_caches) == len(devs) - 1,
              f"mesh {name} (g) {what}: graph vs eager differ: {diff}")
        print(f"[mesh] {name} (g) {what}: graph vs eager tokens and every state leaf (each "
              f"shard's caches included) identical; device ms (CUDA events): graph {ms_g:.1f}, "
              f"eager {ms_e:.1f}")
        return dict(graph_ms=ms_g, eager_ms=ms_e)

    rcfg = RuntimeConfig()
    B8, W, sx, sp, ring = 8, 32, 192, 192, 128
    st = dataclasses.replace(slots.init_slots(cfg, B8, sx, sp, ring, torch.bfloat16,
                                              kv_int8=True, device=DEV, tp_devices=devs),
                             persistent=True)
    join_rows(st, B8, sx, sp)
    out["slot_segment"] = segment_pair(st, W, sx, sp, ring, True,
                                       "slot segment, occupancy 8 after graph joins, int8 KV "
                                       f"(kernel route), W={W}")
    Ws, ring_s, sx_s, sp_s = stream_geometry(rcfg, cfg)
    st = dataclasses.replace(slots.init_slots(cfg, 1, sx_s, sp_s, ring_s, torch.bfloat16,
                                              device=DEV, tp_devices=devs), persistent=True)
    join_rows(st, 1, sx_s, sp_s)
    out["stream_segment"] = segment_pair(st, Ws, sx_s, sp_s, ring_s, False,
                                         f"segmented-stream segment, exact KV, W={Ws}")
    print(f"[mesh] {name} (g): {card}")
    return out


def phase_mesh(torch, root: Path, card: str, tts1, serve1):
    """dp x tp serving over ``make_serving_mesh(2, 2, ["cuda:0"] * 4)``: one
    card repeated, so every line of the dp and tp code runs on the card with
    no transfer between cards. ``api.engine`` is swapped for a mesh engine
    (as a test would) on a shorter bucket ladder (``MESH_LADDER``: depth
    cut for time), phase 3's character loads on it tp-sharded, and (f) the
    engine's sweep captures every replica's graphs (wall time, graphs and
    pool and buffer MiB per replica and card); then, warm, with the kernel
    counts set to 0 just before each route and read just after: (a) solo
    ``tts()`` (graph, then eager beside it); (b) ``synthesize_batch`` of 4
    rows (2 per replica); (c) 4 concurrent default ``/tts`` on the int8
    slot route through the port's server and a short stream on the idle
    machine (the segmented stream): no miss, no variant and no capture in
    any replica's cache. (g) The tp route's graphs against its eager run
    on one noise (``tp_graph_vs_eager``). (d) and (h) a dp-only 2x1 mesh:
    swept, solo ``tts()`` on replica 0 takes the fused kernel, and a B=4
    ``synthesize_batch`` misses nothing in replica 1's caches. (e) fp32
    greedy parity of 2x2 against 1x1 (a 64-step cap), and the kernels at a
    shard's heads against their plain versions. (i) the cross-card mesh
    (``phase_cross_card``). ``tts1``/``serve1``: the 1x1 results of the
    tts and serve phases, printed beside the mesh's."""
    import copy
    import dataclasses
    import inspect
    import threading

    import torch.nn.functional as F

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert
    from genie_tts_tpu_torch.models import slots, t2s
    from genie_tts_tpu_torch.ops import flash_decode as fl
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig
    from genie_tts_tpu_torch.parallel.mesh import make_serving_mesh
    from genie_tts_tpu_torch.runtime.engine import TTSEngine

    dp, tp = 2, 2
    prev = (api.engine, api._batcher)
    base = api.model_manager.get("smoke")          # phase 3's 1x1 character
    cfg = base.t2s_cfg
    L = cfg.num_layers
    ladder = dataclasses.replace(RuntimeConfig(), **MESH_LADDER)
    out = {}
    try:
        mesh = make_serving_mesh(dp, tp, devices=[DEV] * 4)
        char, feats = mesh_load(torch, root, "mesh", mesh, ladder)
        check(len(char.replicas) == dp and all(
            len(r.t2s_params["layer_shards"]) == tp for r in char.replicas),
            "mesh: the character is not placed as 2 replicas of 2 tp shards")
        out["f"] = mesh_sweep(torch, "mesh 2x2", char, feats, card)
        served = mesh_serve(torch, root, card, "mesh", char, feats)
        out.update(served)
        one = tts1[2]
        print(f"[mesh] 1x1 beside it (tts phase, call 2): {one['wall_s'] * 1e3:.1f} ms wall, "
              f"{one['decode_steps']} steps, fused launches {one['launches']}, "
              f"{one['stages']['decode'] * 1e3 / one['decode_steps']:.3f} ms/step; serve phase "
              f"slot route latency " + ", ".join(f"{x:.3f}" for x in serve1["slots"]["latency_s"])
              + f" s, launches {json.dumps(serve1['slots']['launches'])}")
        live = served["c"]["live"]
        rows = [get_phones_and_bert("。" + s, "ja") for s in MESH_SENTENCES]
        items = [(feats, ph, bert) for ph, bert in rows]
        out["g"] = tp_graph_vs_eager(torch, char, card, "mesh 2x2")
        out["second"] = mesh_second(torch, root, card, "mesh")
        del char
        mesh_unload("mesh")

        # (d) and (h): a dp-only 2x1 mesh, swept (slots and streams off:
        # depth cut, they run on replica 0 as on 1x1): solo on replica 0
        # takes the fused kernel, a B=4 batch misses nothing in replica 1
        ladder21 = dataclasses.replace(ladder, serve_slots=False, stream_segmented=False)
        c21, f21 = mesh_load(torch, root, "mesh21", make_serving_mesh(2, 1, devices=[DEV] * 2),
                             ladder21)
        out["h_sweep"] = mesh_sweep(torch, "mesh 2x1", c21, f21, card)
        caches = api.engine.graph_caches(c21)
        for c in caches:
            c.reset_stats()
        _reset_counts(torch)
        t0 = time.perf_counter()
        api.tts("mesh21", "きょうはいいてんきですね。", save_path=root / "mesh_d.wav")
        sync(torch)
        wall = time.perf_counter() - t0
        c = _counts(torch)
        steps = api.engine.last_stats["decode_steps"]
        check(c["fused"] == steps > 0 and c["flash"] == 0 and c["int8"] == 0,
              f"mesh (d) 2x1 solo tts: launches {c} for {steps} steps")
        print(f"[mesh] (d) solo tts() 2x1, swept: {wall * 1e3:.1f} ms wall, {steps} decode "
              f"steps, launches {json.dumps(c)}")
        out["d"] = dict(wall_s=wall, steps=steps, launches=c)
        st = {}
        t0 = time.perf_counter()
        api.engine.synthesize_batch(c21, [(f21, ph, bert) for ph, bert in rows], seed=5,
                                    stats=st)
        sync(torch)
        wall = time.perf_counter() - t0
        stats = [dict(c.stats) for c in caches]
        print(f"[mesh] (h) 2x1 after the sweep: synthesize_batch B=4 (2 rows per replica) "
              f"{wall * 1e3:.1f} ms wall; caches (T2S, SoVITS of replica 0, then of replica "
              f"1): {json.dumps(stats)}")
        check(all(s["misses"] == s["variants"] == s["captures"] == 0 for s in stats)
              and all(s["hits"] > 0 for s in stats[2:]),
              f"mesh (h): the batch missed a replica's cache after the sweep: {stats}")
        out["h"] = dict(wall_s=wall, stats=stats)
        del c21, caches
        mesh_unload("mesh21")
    finally:
        api.engine, api._batcher = prev

    # (e) fp32 greedy parity, 2x2 against 1x1 on the same card
    torch.backends.cuda.matmul.allow_tf32 = False
    f32 = dataclasses.replace(base, t2s_params=to_device(torch, fp32_params(torch, base), DEV),
                              sovits_params=to_device(torch, base.sovits_params, DEV),
                              replicas=None, placement=None)
    e11 = TTSEngine(RuntimeConfig())
    e22 = TTSEngine(RuntimeConfig(), mesh=mesh)
    f22 = e22.shard_character(copy.copy(f32))
    greedy = SamplingConfig(top_k=1, repetition_penalty=1.0)
    sig = inspect.signature(t2s.generate_e2e)
    real = t2s.generate_e2e
    seen, lock = [], threading.Lock()

    def spy(*a, **k):
        codes, n = real(*a, **k)
        b = sig.bind(*a, **k).arguments
        with lock:
            seen.append({key: b[key].cpu() for key in ("phones", "x_len", "prompts", "p_len")}
                        | {"codes": codes.cpu(), "n": n.cpu(), "sharded": "layer_shards"
                           in b["params"]})
        return codes, n

    def by_row(recs):
        """{phones row bytes: (codes row, n, inputs)} over the recorded calls."""
        rows = {}
        for r in recs:
            for i in range(r["phones"].shape[0]):
                rows[r["phones"][i].numpy().tobytes()] = (r["codes"][i], int(r["n"][i]), r, i)
        return rows

    def near_tie(row, t):
        """(top-2 gap, RMS) of 1x1's logits at step ``t``, where ``row``'s
        codes first differ: teacher-forced over the shared prefix
        (forward_train)."""
        codes, n, r, i = row
        pl = int(r["p_len"][i])
        sem = torch.cat([r["prompts"][i, :pl], codes[:t]]).to(DEV)[None]
        with torch.inference_mode():
            lg = t2s.forward_train(
                f32.t2s_params, cfg, r["phones"][i:i + 1].to(DEV),
                torch.zeros((1, r["phones"].shape[1], cfg.bert_dim), device=DEV),
                r["x_len"][i:i + 1].to(DEV), sem, torch.tensor([sem.shape[1]], device=DEV)
            )[0, -1].double()
            lg[cfg.eos_id] = -float("inf")
            top = lg.topk(2).values
            return float(top[0] - top[1]), float(lg[torch.isfinite(lg)].pow(2).mean().sqrt())

    def parity(what, wav11, wav22):
        recs11 = by_row([r for r in seen if not r["sharded"]])
        recs22 = by_row([r for r in seen if r["sharded"]])
        check(recs11.keys() == recs22.keys() and recs11, f"mesh (e) {what}: rows differ")
        worst = 0.0
        for j, key in enumerate(recs11):
            (c1, n1, *_), (c2, n2, *_) = recs11[key], recs22[key]
            diff = torch.nonzero(c1[:max(n1, n2)] != c2[:max(n1, n2)])
            if len(diff) or n1 != n2:
                t = int(diff[0]) if len(diff) else min(n1, n2)
                gap, rms = near_tie(recs11[key], t)
                print(f"[mesh] (e) {what} row {j}: codes differ first at step {t}; 1x1 "
                      f"top-2 logit gap there {gap:.3e}, logits RMS {rms:.3e} (a near-tie "
                      f"is a gap < 1e-3 x RMS)")
                check(gap < 1e-3 * rms, f"mesh (e) {what}: codes differ at step {t} "
                      f"with a top-2 gap of {gap:.3e} (RMS {rms:.3e})")
                continue
            err = rel_l2(torch, torch.as_tensor(wav22[j]), torch.as_tensor(wav11[j]))
            worst = max(worst, err)
            check(err <= 1e-3, f"mesh (e) {what} row {j}: waveform relative L2 {err:.3e}")
        print(f"[mesh] (e) {what}: fp32 greedy codes 2x2 vs 1x1 on one card: "
              f"{sum(bool(torch.equal(recs11[k][0], recs22[k][0])) for k in recs11)}/"
              f"{len(recs11)} rows identical; waveforms relative L2 {worst:.3e} "
              f"(tolerance 1e-3)")
        seen.clear()

    t2s.generate_e2e = spy
    try:
        # a 64-step cap keeps the parity runs short
        ph, bert = rows[0]
        kw = dict(sampling=greedy, seed=9, max_steps=64)
        a11 = e11.synthesize_utterance(f32, feats, ph, bert, **kw)
        a22 = e22.synthesize_utterance(f22, feats, ph, bert, **kw)
        parity("solo", [a11], [a22])
        b11 = e11.synthesize_batch(f32, items, **kw)
        b22 = e22.synthesize_batch(f22, items, **kw)
        parity("batch of 4", b11, b22)
    finally:
        t2s.generate_e2e = real

    # the kernels at a tp shard's heads (16 / tp = 8) against their plain versions
    H, Dh = cfg.num_heads // tp, cfg.head_dim
    S = tts1[2]["cache_len"]
    g = torch.Generator(device=DEV).manual_seed(7)
    kvp = torch.arange(S, device=DEV)[None]
    mask = ((kvp < 40) | ((kvp >= 64) & (kvp < 64 + 132))
            | ((kvp >= 320) & (kvp < 320 + 38))).contiguous()
    visible = int(mask.sum())
    rows_out = {}
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        es = torch.finfo(dt).bits // 8
        q = torch.randn((1, H, Dh), generator=g, device=DEV).to(dt)
        ks = [torch.randn((1, H, S, Dh), generator=g, device=DEV).to(dt) for _ in range(L)]
        vs = [torch.randn((1, H, S, Dh), generator=g, device=DEV).to(dt) for _ in range(L)]
        err = float((fl.flash_decode_attention(q, ks[0], vs[0], mask).float()
                     - fl.flash_decode_attention_plain(q, ks[0], vs[0], mask).float())
                    .abs().max())
        check(err <= tol, f"mesh flash B=1 H={H} {dt}: error {err}")
        ms = graph_ms(torch, [lambda l=l: fl.flash_decode_attention(q, ks[l], vs[l], mask)
                              for l in range(L)])
        plain_ms = graph_ms(torch, [lambda l=l: fl.flash_decode_attention_plain(
            q, ks[l], vs[l], mask) for l in range(L)])
        lib_ms = graph_ms(torch, [lambda l=l: F.scaled_dot_product_attention(
            q[:, :, None], ks[l], vs[l], attn_mask=mask[:, None, None, :]) for l in range(L)])
        moved = 2 * H * Dh * es * visible + S + 2 * H * Dh * es
        bms, by = bound(moved, 4 * H * Dh * visible, "float32" if dt == torch.float32
                        else "bfloat16")
        print(f"[mesh] kernel flash {dt} B=1 H={H} S={S}: max |kernel - plain| {err:.3e} "
              f"(tolerance {tol:g}); device time per launch (CUDA graph) kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; bound {bms:.5f} ms ({by}); "
              f"launches on the mesh paths: (a) {out['a']['launches']['flash']}, "
              f"(b) {out['b']['launches']['flash']}")
        rows_out["flash", dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                                     bound_by=by, library_ms=lib_ms)
        del ks, vs

    # int8_big_attention at the mesh slot route's shapes (8 of 16 heads): the
    # live shard-0 state of (c), then timed over 24 layers' random caches
    st = live["state"]
    B, sx, sp, ring = live["shape"]
    S8 = sx + sp + ring
    geom = dict(sx=sx, sp=sp, ring=ring)
    check(st.k_cache.shape[2] == H, f"mesh: slot shard of {st.k_cache.shape[2]} heads")
    q8 = torch.randn((B, H, Dh), generator=g, device=DEV).bfloat16()
    args = (q8, st.k_cache[0][..., :S8], st.k_scale[0][..., :S8], st.v_cache[0][..., :S8],
            st.v_scale[0][..., :S8], st.x_len, st.p_len, st.keys_written, live["head"])
    o, r = i8.int8_big_attention(*args, **geom), i8.int8_big_attention_plain(*args, **geom)
    sync(torch)
    seen8 = r[1] > -1e30
    err8 = max(float((a - b).abs().max()) for a, b in zip(o, r))
    rel8 = max(float((a - b)[seen8].abs().max()) / max(float(b[seen8].abs().max()), 1e-30)
               for a, b in zip(o, r)) if bool(seen8.any()) else 0.0
    check(rel8 <= 1e-4 and all(torch.equal(a[~seen8], b[~seen8]) for a, b in zip(o, r)),
          f"mesh int8_big_attention H={H}: relative error {rel8}")
    kw8 = torch.tensor([ring // 2 + 7 * b for b in range(B)], dtype=torch.int32, device=DEV)
    xl = torch.tensor([40 + 17 * b for b in range(B)], dtype=torch.int32, device=DEV)
    pl = torch.tensor([130 - 9 * b for b in range(B)], dtype=torch.int32, device=DEV)
    head = torch.tensor([ring // 4], dtype=torch.int32, device=DEV)
    caches = []
    for _ in range(L):
        kq, ks_ = slots.quantize_kv_columns(torch.randn((B, H, Dh, S8 + ring), generator=g,
                                                        device=DEV))
        vq, vs_ = slots.quantize_kv_columns(torch.randn((B, H, Dh, S8 + ring), generator=g,
                                                        device=DEV))
        caches.append([t[..., :S8] for t in (kq, ks_, vq, vs_)])
    vis = i8.visibility(S8, xl, pl, kw8, head, **geom)
    n_vis = int(vis.sum())
    ms8 = graph_ms(torch, [lambda c=c: i8.int8_big_attention(q8, *c, xl, pl, kw8, head, **geom)
                           for c in caches])
    plain8 = graph_ms(torch, [lambda c=c: i8.int8_big_attention_plain(
        q8, *c, xl, pl, kw8, head, **geom) for c in caches])
    deq = [((kq.float() * ks_[:, :, None]).transpose(2, 3).bfloat16().contiguous(),
            (vq.float() * vs_[:, :, None]).transpose(2, 3).bfloat16().contiguous())
           for kq, ks_, vq, vs_ in caches]
    sdpa8 = graph_ms(torch, [lambda d=d: F.scaled_dot_product_attention(
        q8[:, :, None], *d, attn_mask=vis[:, None, None, :]) for d in deq])
    moved = H * n_vis * (2 * Dh + 2 * 4) + B * H * Dh * 2 + B * H * (Dh + 2) * 4 + 3 * B * 4
    bms8, by8 = bound(moved, 4 * Dh * H * n_vis, "float32")
    print(f"[mesh] kernel int8 B={B} H={H} Dh={Dh} S={S8}: live shard-0 state max |kernel - "
          f"plain| {err8:.3e}, relative {rel8:.2e} (tolerance 1e-4); {n_vis / (B * S8):.1%} of "
          f"columns visible: kernel {ms8:.4f} ms (CUDA graph), plain {plain8:.4f} ms, bound "
          f"{bms8:.5f} ms ({by8}); library: none (yardstick SDPA {sdpa8:.4f} ms); launches "
          f"on the mesh slot route (c) {out['c']['launches']['int8']}; {card}")
    rows_out["int8"] = dict(max_abs_err=err8, ms=ms8, plain_ms=plain8, bound_ms=bms8,
                            bound_by=by8, library_ms=None)
    out["kernels"] = rows_out
    return out


def phase_cross_card(torch, root: Path, card: str):
    """(i) The mesh across cards, where the machine has them: (f) and (g)
    of the mesh phase (the sweep of every replica, warm serving with no
    miss, the tp route's graphs against its eager run) at 1x2 over
    ``cuda:0`` and ``cuda:1`` where there are two cards, and at 2x2 over
    four where there are four: the same graphs, captured with each shard's
    work on its own card (the partial sums copied between cards inside the
    capture, each card's memory in the graph's pool there). With one card
    it prints that the cross-card capture did not run, and on how many
    cards; nothing runs in its place."""
    import dataclasses

    from genie_tts_tpu_torch import api
    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.parallel.mesh import make_serving_mesh

    n = torch.cuda.device_count()
    meshes = [(dp, tp) for dp, tp in ((1, 2), (2, 2)) if dp * tp <= n]
    if not meshes:
        print(f"[mesh] (i) the cross-card capture did not run: this machine has {n} card(s), "
              f"a tp mesh across cards needs 2 or more; {card}")
        return {"ran": False, "cards": n}
    ladder = dataclasses.replace(RuntimeConfig(), **MESH_LADDER)
    prev = (api.engine, api._batcher)
    out = {"ran": True, "cards": n}
    try:
        for dp, tp in meshes:
            name = f"cross{dp}x{tp}"
            mesh = make_serving_mesh(dp, tp, devices=[f"cuda:{i}" for i in range(dp * tp)])
            char, feats = mesh_load(torch, root, name, mesh, ladder)
            out[name] = dict(f=mesh_sweep(torch, f"mesh {dp}x{tp} across cards", char, feats,
                                          card),
                             served=mesh_serve(torch, root, card, name, char, feats),
                             g=tp_graph_vs_eager(torch, char, card,
                                                 f"mesh {dp}x{tp} across cards"))
            del char
            mesh_unload(name)
    finally:
        api.engine, api._batcher = prev
    return out


def fp32_params(torch, char):
    """The character's T2S params with the int8 weights dequantized."""
    params = {k: v for k, v in char.t2s_params.items()}
    layers = {k: v for k, v in params["layers"].items() if not k.startswith("_")}
    for k in ("qkv", "out", "ffn1", "ffn2"):
        p = layers[k]
        layers[k] = {"w": p["w"].float() * p["scale"][..., None, :], "b": p["b"]}
    params["layers"] = layers
    return params


def to_device(torch, tree, dev):
    """A param tree on ``dev``, floating leaves in fp32."""
    if isinstance(tree, dict):
        return {k: to_device(torch, v, dev) for k, v in tree.items() if not k.startswith("_")}
    if isinstance(tree, list):
        return [to_device(torch, v, dev) for v in tree]
    return tree.to(dev, torch.float32 if tree.is_floating_point() else tree.dtype)


def phase_kernels(torch, char, S, b4):
    """Each kernel vs its plain version at the main path's shapes, then times."""
    import torch.nn.functional as F

    from genie_tts_tpu_torch.ops import flash_decode as fl, fused_decode as fu

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = char.t2s_cfg
    L, D, H = cfg.num_layers, cfg.embed_dim, cfg.num_heads
    Dh = D // H
    g = torch.Generator(device=DEV).manual_seed(3)
    results = {}

    # ---- flash: B=4 ragged rows, S rows, all 24 layers' caches (> L2)
    B, Sx, Sp = b4["B"], b4["Sx"], b4["Sp"]
    step = 38
    kvp = torch.arange(S, device=DEV)[None]
    mask = ((kvp < b4["x_len"][:, None])
            | ((kvp >= Sx) & (kvp < Sx + b4["p_len"][:, None]))
            | ((kvp >= Sx + Sp) & (kvp <= Sx + Sp + step - 1))).contiguous()
    visible = int(mask.sum())
    # outputs are softmax-weighted means of N(0, 1) values (|o| < ~1): fp32
    # differs only in sum order; bf16 adds at most an output ulp (2^-8)
    for dt, tol in ((torch.float32, 1e-5), (torch.bfloat16, 1e-2)):
        es = torch.finfo(dt).bits // 8
        q = torch.randn((B, H, Dh), generator=g, device=DEV).to(dt)
        ks = [torch.randn((B, H, S, Dh), generator=g, device=DEV).to(dt) for _ in range(L)]
        vs = [torch.randn((B, H, S, Dh), generator=g, device=DEV).to(dt) for _ in range(L)]
        out = fl.flash_decode_attention(q, ks[0], vs[0], mask)
        ref = fl.flash_decode_attention_plain(q, ks[0], vs[0], mask)
        sync(torch)
        err = float((out.float() - ref.float()).abs().max())
        print(f"[kernel] flash {dt}: max |kernel - plain| {err:.3e} (tolerance {tol:g})")
        check(err <= tol, f"flash_decode_attention {dt} error {err}")
        it = [0]

        def nxt():
            it[0] = (it[0] + 1) % L
            return it[0]

        eager_ms = cuda_ms(torch, lambda: fl.flash_decode_attention(
            q, ks[nxt()], vs[it[0]], mask), 240)
        amask = mask[:, None, None, :]
        # device times: one call per layer's caches, captured and replayed
        ms = graph_ms(torch, [lambda l=l: fl.flash_decode_attention(q, ks[l], vs[l], mask)
                              for l in range(L)])
        plain_ms = graph_ms(torch, [lambda l=l: fl.flash_decode_attention_plain(
            q, ks[l], vs[l], mask) for l in range(L)])
        lib_ms = graph_ms(torch, [lambda l=l: F.scaled_dot_product_attention(
            q[:, :, None], ks[l], vs[l], attn_mask=amask) for l in range(L)])
        moved = (2 * H * Dh * es) * visible + B * S + 2 * B * H * Dh * es
        bms, by = bound(moved, 4 * H * Dh * visible, "float32" if dt == torch.float32
                        else "bfloat16")
        print(f"[kernel] flash {dt} B={B} H={H} S={S}: device time per launch (CUDA "
              f"graph) kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms; "
              f"bound {bms:.5f} ms ({by}); eager back-to-back launches {eager_ms:.4f} ms")
        results["flash", dt] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                    bound_ms=bms, bound_by=by, library_ms=lib_ms)
        del ks, vs

    # ---- fused: the character's packed decode weights (int8) and bf16 ones
    x_len, p_len = 40, 132
    pos = Sx + Sp + step - 1
    # the write row in device memory, as the decode graphs pass it
    pos_d = torch.tensor([pos], dtype=torch.int32, device=DEV)
    fmask = ((kvp[0] < x_len) | ((kvp[0] >= Sx) & (kvp[0] < Sx + p_len))
             | ((kvp[0] >= Sx + Sp) & (kvp[0] <= pos))).float()
    vis = int(fmask.sum())
    h = torch.randn((1, D), generator=g, device=DEV)
    lp = char.t2s_params["layers"]
    packed8 = fu.pack_decode_params(char.t2s_params)
    # biases and norms random and different per layer: a kernel that drops
    # them, ignores the LayerNorm affine or reads layer 0's for every layer
    # disagrees with the plain version below
    for name in ("bqkv", "bout", "b1", "b2", "n1s", "n1b", "n2s", "n2b"):
        t = packed8[name]
        check(float(t.std()) > 0.05 and not torch.equal(t[0], t[1]),
              f"packed {name}: not random per layer")
    bf16_layers = {k: ({"w": (v["w"].float() * v["scale"][..., None, :]).bfloat16(),
                        "b": v["b"]} if k in ("qkv", "out", "ffn1", "ffn2") else v)
                   for k, v in lp.items() if not k.startswith("_")}
    for wname, packed in (("int8", packed8),
                          ("bfloat16", fu.pack_decode_params({"layers": bf16_layers}))):
        # the weights' bytes, before the first launch adds its tiled copy
        wbytes = sum(t.numel() * t.element_size() for t in packed.values())
        kc = (torch.randn((L, S, D), generator=g, device=DEV) * 0.5).bfloat16()
        vc = (torch.randn((L, S, D), generator=g, device=DEV) * 0.5).bfloat16()
        ka, va, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        k32, v32 = kc.float(), vc.float()
        out, _, _ = fu.fused_decode_step(packed, h, ka, va, pos_d, fmask, num_heads=H)
        out = out.clone()           # the packing's output row: the next launch rewrites it
        ref, _, _ = fu.fused_decode_step_plain(packed, h, kb, vb, pos_d, fmask, num_heads=H)
        # the same function with fp32 caches rounds no operand: the exact result
        ref32, _, _ = fu.fused_decode_step_plain(packed, h, k32, v32, pos_d, fmask,
                                                 num_heads=H)
        sync(torch)

        def dev(a, b):
            return float((a.float() - b.float()).abs().max())

        err = max(dev(out, ref), dev(ka[:, pos], kb[:, pos]), dev(va[:, pos], vb[:, pos]))
        d_kernel = max(dev(out, ref32), dev(ka[:, pos], k32[:, pos]),
                       dev(va[:, pos], v32[:, pos]))
        d_plain = max(dev(ref, ref32), dev(kb[:, pos], k32[:, pos]),
                      dev(vb[:, pos], v32[:, pos]))
        others = torch.ones(S, dtype=torch.bool, device=DEV)
        others[pos] = False
        intact = bool(torch.equal(ka[:, others], kc[:, others])
                      and torch.equal(va[:, others], vc[:, others]))
        # bf16 operands are rounded in both, and fp32 sums in another order
        # flip single roundings, which 24 post-LN layers carry on: the kernel
        # must be no further from the exact result than twice the plain bf16
        # version's own distance from it
        print(f"[kernel] fused {wname} weights: max |kernel - plain| {err:.3e} "
              f"(h_out and written rows); distance from the fp32 result: kernel "
              f"{d_kernel:.3e}, plain {d_plain:.3e} (tolerance 2 x plain); "
              f"other rows intact: {intact}")
        check(d_kernel <= 2 * d_plain and intact, f"fused_decode_step {wname}")

        def step(pk=packed, k=ka, v=va):
            return fu.fused_decode_step(pk, h, k, v, pos_d, fmask, num_heads=H)

        one = {n: t[:1] for n, t in packed.items()     # layer 0 alone: L=1
               if not n.startswith("_")}
        ms, how = device_ms(torch, [step] * 8, 100)
        ms1, _ = device_ms(torch, [lambda: step(one, ka[:1], va[:1])] * 8, 100)
        bar_ms, _ = device_ms(torch, [lambda: fu.grid_barriers(L, ka.device)] * 8, 100)
        plain_ms = cuda_ms(torch, lambda: fu.fused_decode_step_plain(
            packed, h, kb, vb, pos_d, fmask, num_heads=H), 10)
        moved = wbytes + 2 * L * vis * D * 2 + 2 * L * D * 2 + S * 4 + 2 * D * 4
        ops = 2 * sum(packed[f"w{m}"].numel() for m in ("qkv", "out", "1", "2")) \
            + 4 * L * vis * D
        bms, by = bound(moved, ops, wname)
        print(f"[kernel] fused {wname} L={L} D={D} S={S} pos={pos}: kernel {ms:.4f} ms "
              f"({how}), plain {plain_ms:.4f} ms (eager), bound {bms:.5f} ms ({by}); "
              f"{moved / 1e6:.1f} MB moved; per layer {ms / L:.4f} ms (slope from L=1, "
              f"{ms1:.4f} ms: {(ms - ms1) / (L - 1):.4f} ms) vs a per-layer bound of "
              f"{bms / L:.5f} ms; its {L} grid barriers alone {bar_ms:.4f} ms "
              f"({bar_ms / L * 1e3:.2f} us each)")
        stamps = fu.phase_cycles(packed, h, ka, va, pos_d, fmask, num_heads=H)
        print(f"[kernel] fused {wname} per-layer split in us (clock64 stamps in the "
              f"kernel, mean share of a layer scaled to {ms / L * 1e3:.2f} us; slowest "
              f"block in brackets): "
              + phase_split(torch, stamps.cpu(), ms / L))
        results["fused", wname] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                                       library_ms=None)
        del kc, vc, ka, va, kb, vb, k32, v32

    # ---- fused with fp32 weights and caches: no rounding, sum order only
    f32_layers = {k: ({"w": v["w"].float() * v["scale"][..., None, :], "b": v["b"]}
                      if k in ("qkv", "out", "ffn1", "ffn2") else v)
                  for k, v in lp.items() if not k.startswith("_")}
    packed = fu.pack_decode_params({"layers": f32_layers})
    kc = torch.randn((L, S, D), generator=g, device=DEV) * 0.5
    vc = torch.randn((L, S, D), generator=g, device=DEV) * 0.5
    ka, va = kc.clone(), vc.clone()
    out, _, _ = fu.fused_decode_step(packed, h, ka, va, pos_d, fmask, num_heads=H)
    ref, _, _ = fu.fused_decode_step_plain(packed, h, kc, vc, pos_d, fmask, num_heads=H)
    sync(torch)
    err = max(float((out - ref).abs().max()), float((ka - kc).abs().max()),
              float((va - vc).abs().max()))
    print(f"[kernel] fused float32 weights and caches: max |kernel - plain| {err:.3e} "
          f"(tolerance 1e-3: fp32 sums in another order through 24 layers)")
    check(err <= 1e-3, "fused_decode_step float32")
    return results


def phase_kernel_int8(torch, live, seg_ms, W):
    """int8_big_attention vs its plain version at the serving shapes
    (B=8, H=16, Dh=32, S=896 read out of the slot state's [.., 1408]
    caches, bf16 q), then times."""
    import torch.nn.functional as F

    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops import int8_decode as i8

    B, H, Dh, L = 8, 16, 32, 24
    sx = sp = 192
    ring = 512
    S, S_full = sx + sp + ring, sx + sp + 2 * ring
    geom = dict(sx=sx, sp=sp, ring=ring)
    g = torch.Generator(device=DEV).manual_seed(5)

    def layer():
        kq, ks = slots.quantize_kv_columns(torch.randn((B, H, Dh, S_full), generator=g,
                                                       device=DEV))
        vq, vs = slots.quantize_kv_columns(torch.randn((B, H, Dh, S_full), generator=g,
                                                       device=DEV))
        return [t[..., :S] for t in (kq, ks, vq, vs)]

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device=DEV)

    x_len = [40, 191, 23, 120, 64, 100, 12, 150]
    p_len = [130, 1, 192, 77, 128, 150, 60, 42]
    cases = {   # name: (x_len, p_len, keys_written, ring_head); mid-decode rows
        "partial ring": (x_len, p_len, [256, 300, 200, 400, 128, 256, 350, 180], 416),
        "wrapped ring": (x_len, p_len, [512, 400, 300, 200, 150, 120, 101, 450], 100),
        "fully visible": ([sx] * B, [sp] * B, [ring] * B, 416),
        "keys_written=0 row": (x_len, p_len, [64, 0, 200, 300, 17, 256, 32, 1], 300),
        "empty row": (x_len[:3] + [0] + x_len[4:], p_len[:3] + [0] + p_len[4:],
                      [64, 128, 200, 0, 17, 256, 32, 1], 300),
    }
    st = live["state"]
    q = torch.randn((B, H, Dh), generator=g, device=DEV).bfloat16()
    caches = [layer() for _ in range(L)]

    def compare(name, args):
        """Kernel vs plain: relative error of o, m and l over the rows that
        see something (both run in fp32 and differ only in the order of
        their sums); rows that see nothing must match exactly."""
        out = i8.int8_big_attention(*args, **geom)
        ref = i8.int8_big_attention_plain(*args, **geom)
        sync(torch)
        seen = ref[1] > -1e30                               # [B, H]
        rel, worst = 0.0, 0.0
        for a, b in zip(out, ref):
            d = (a - b).abs()
            worst = max(worst, float(d.max()))
            rel = max(rel, float(d[seen].max()) / float(b[seen].abs().max()))
        print(f"[kernel] int8 {name}: max |kernel - plain| {worst:.3e}, relative {rel:.2e} "
              f"(tolerance 1e-4); {int((~seen).sum())} (b, h) rows see nothing")
        check(rel <= 1e-4 and all(torch.equal(a[~seen], b[~seen]) for a, b in zip(out, ref)),
              f"int8_big_attention {name}")
        return out, worst

    worst = 0.0
    for name, (xl, pl, kw, head) in cases.items():
        out, err = compare(name, (q, *caches[0], i32(xl), i32(pl), i32(kw), i32([head])))
        worst = max(worst, err)
        if name == "empty row":
            o, m, l = out
            check(bool((m[3] == -1e30).all()) and float(l[3].abs().max()) == 0.0
                  and float(o[3].abs().max()) == 0.0, "int8 empty row: m=-1e30, l=0, o=0")
    # the live slot state from the serving phase (layer 0, its own scalars)
    lq = torch.randn((B, H, Dh), generator=g, device=DEV).bfloat16()
    _, err = compare("live slot state (layer 0)", (
        lq, st.k_cache[0][..., :S], st.k_scale[0][..., :S], st.v_cache[0][..., :S],
        st.v_scale[0][..., :S], st.x_len, st.p_len, st.keys_written, live["head"]))
    worst = max(worst, err)

    # times at three visibility levels, rotating 24 layers' caches (> the 50
    # MB L2): device time per launch, one call per layer's caches, captured
    # and replayed. Labelled yardstick only: SDPA over pre-dequantized bf16
    # caches with the same mask (twice the code bytes; not the same function)
    deq = [((kq.float() * ks[:, :, None]).transpose(2, 3).bfloat16().contiguous(),
            (vq.float() * vs[:, :, None]).transpose(2, 3).bfloat16().contiguous())
           for kq, ks, vq, vs in caches]
    timed = {}
    for name in ("partial ring", "wrapped ring", "fully visible"):
        xl, pl, kw, head = cases[name]
        sc = (i32(xl), i32(pl), i32(kw), i32([head]))     # the ring head in device memory
        vis = i8.visibility(S, *sc[:3], head, **geom)
        n_vis = int(vis.sum())
        ms = graph_ms(torch, [lambda c=c: i8.int8_big_attention(q, *c, *sc, **geom)
                              for c in caches])
        amask = vis[:, None, None, :]
        sdpa_ms = graph_ms(torch, [lambda d=d: F.scaled_dot_product_attention(
            q[:, :, None], *d, attn_mask=amask) for d in deq])
        # visible codes and scales read once; q, o, m, l and the scalars
        moved = (H * n_vis * (2 * Dh + 2 * 4) + B * H * Dh * 2 + B * H * (Dh + 2) * 4
                 + 3 * B * 4)
        bms, by = bound(moved, 4 * Dh * H * n_vis, "float32")
        print(f"[kernel] int8 {name}: {n_vis / (B * S):.1%} of columns visible, "
              f"{moved / 1e6:.3f} MB, bound {bms:.5f} ms ({by}); kernel {ms:.4f} ms "
              f"(CUDA graph, {bms / ms:.1%} of the bound's rate); SDPA yardstick "
              f"{sdpa_ms:.4f} ms")
        timed[name] = dict(sc=sc, ms=ms, bms=bms, by=by, sdpa_ms=sdpa_ms)
    # the floor that every launch pays: no column visible, so no copies and
    # no arithmetic (launch, scalar loads, cluster barriers, the combine)
    none = (i32([0] * B), i32([0] * B), i32([0] * B), i32([416]))
    floor_ms = graph_ms(torch, [lambda c=c: i8.int8_big_attention(q, *c, *none, **geom)
                                for c in caches])
    print(f"[kernel] int8 nothing visible (the floor of a launch): kernel {floor_ms:.4f} ms "
          f"(CUDA graph)")
    # inside a launch: clock64 stamps of each block, in us at the card's
    # highest SM clock (what it runs at under this load)
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    for name in ("partial ring", "fully visible"):
        stamps = i8.phase_cycles(q, *caches[0], *timed[name]["sc"], **geom)
        print(f"[kernel] int8 {name} split in us (clock64 stamps of thread 0 of each "
              f"block at {mhz:.0f} MHz; slowest block in brackets): "
              + int8_split(torch, stamps.cpu(), mhz))

    # the partial ring is the row of the kernel table
    t = timed["partial ring"]
    sc = t["sc"]
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % L
        return caches[it[0]]

    eager_ms = cuda_ms(torch, lambda: i8.int8_big_attention(q, *nxt(), *sc, **geom), 240)
    plain_ms = graph_ms(torch, [lambda c=c: i8.int8_big_attention_plain(q, *c, *sc, **geom)
                                for c in caches])
    share = L * W * t["ms"] / seg_ms
    print(f"[kernel] int8 B={B} H={H} Dh={Dh} S={S} partial ring: device time per launch "
          f"(CUDA graph) kernel {t['ms']:.4f} ms, plain {plain_ms:.4f} ms; bound "
          f"{t['bms']:.5f} ms ({t['by']}); eager back-to-back launches {eager_ms:.4f} ms; "
          f"library: none (yardstick SDPA {t['sdpa_ms']:.4f} ms); {L * W} launches per "
          f"segment = {share:.2%} of the {seg_ms:.3f} ms segment")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=plain_ms, bound_ms=t["bms"],
                bound_by=t["by"], library_ms=None)


def phase_kernel_slot(torch, seg_ms=None, W=32):
    """slot_attention vs its plain version at the 8-slot serving geometry
    (B=8, H=16, Dh=32, S=896 read out of the slot state's [.., 1408]
    caches, a 32-column write buffer) in bf16 and fp32, at B=1 and on a tp
    shard's 8 heads, then device times per launch by CUDA-graph replay over
    24 layers' caches (more than the 50 MB L2), beside the plain version,
    the bound (the visible columns' bytes at 3.35 TB/s) and a yardstick."""
    import torch.nn.functional as F

    from genie_tts_tpu_torch.models import t2s
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.ops import slot_attention as sa

    H, Dh, L = 16, 32, 24
    sx = sp = 192
    ring = 512
    S = sx + sp + ring
    geom = dict(sx=sx, sp=sp, ring=ring)
    g = torch.Generator(device=DEV).manual_seed(9)

    def i32(xs):
        return torch.tensor(xs, dtype=torch.int32, device=DEV)

    def layer(B, Hs, dt):
        """One layer's exact caches (the doubled ring, sliced to the first
        copy) and write buffer."""
        k, v = (torch.randn((B, Hs, Dh, S + ring), generator=g, device=DEV).to(dt)
                for _ in range(2))
        kb, vb = (torch.randn((B, Hs, Dh, W), generator=g, device=DEV).to(dt)
                  for _ in range(2))
        return k[..., :S], v[..., :S], kb, vb

    def qkv(B, Hs, dt):
        x = torch.randn((B, 1, 3 * Hs * Dh), generator=g, device=DEV).to(dt)
        return tuple(t2s._split_heads(t, Hs)[:, :, 0] for t in x.chunk(3, dim=-1))

    x_len = [40, 191, 23, 120, 64, 100, 12, 150]
    p_len = [130, 1, 192, 77, 128, 150, 60, 42]
    cases = {   # name: (x_len, p_len, keys_written, ring_head, buffer column)
        "partial ring": (x_len, p_len, [256, 300, 200, 400, 128, 256, 350, 180], 416, 17),
        "wrapped ring": (x_len, p_len, [512, 400, 300, 200, 150, 120, 101, 450], 96, 31),
        "fully visible": ([sx] * 8, [sp] * 8, [ring] * 8, 416, 0),
        "empty row": (x_len[:3] + [0] + x_len[4:], p_len[:3] + [0] + p_len[4:],
                      [64, 128, 200, 0, 17, 256, 32, 1], 288, 0),
    }
    worst = 0.0
    for dt, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        for B, Hs, names in ((8, H, list(cases)), (1, H, ["partial ring"]),
                             (8, H // 2, ["wrapped ring"])):
            for name in names:
                xl, pl, kw, head, col = cases[name]
                sc = (i32(xl[:B]), i32(pl[:B]), i32(kw[:B]), i32([head]))
                q, kn, vn = qkv(B, Hs, dt)
                kc, vc, kb, vb = layer(B, Hs, dt)
                bufs = (kb.clone(), vb.clone())
                out = sa.slot_attention(q, kn, vn, kc, vc, kb, vb, col, *sc, **geom)
                ref = sa.slot_attention_plain(q, kn, vn, kc, vc, *bufs, col, *sc, **geom)
                sync(torch)
                err = float((out.float() - ref.float()).abs().max())
                worst = max(worst, err) if dt == torch.bfloat16 else worst
                print(f"[kernel] slot_attention {str(dt)[6:]} B={B} H={Hs} {name} (buffer "
                      f"column {col}): max |kernel - plain| {err:.3e} (tolerance {tol})")
                check(err <= tol and torch.equal(kb, bufs[0]) and torch.equal(vb, bufs[1]),
                      f"slot_attention {dt} B={B} H={Hs} {name}")

    # times, bf16 at B=8: one call per layer's caches, captured and replayed
    B, dt = 8, torch.bfloat16
    q, kn, vn = qkv(B, H, dt)
    caches = [layer(B, H, dt) for _ in range(L)]
    timed = {}
    for name in ("partial ring", "wrapped ring", "fully visible"):
        xl, pl, kw, head, col = cases[name]
        sc = (i32(xl), i32(pl), i32(kw), i32([head]))
        n_vis = int(i8.visibility(S, *sc[:3], head, **geom).sum())
        ms = graph_ms(torch, [lambda c=c: sa.slot_attention(q, kn, vn, *c, col, *sc, **geom)
                              for c in caches])
        # visible K and V columns and the buffer's, q, k_new, v_new, the
        # output and the written column, once each
        moved = 2 * (H * (n_vis + B * col) * 2 * Dh + B * H * Dh * 6)
        bms, by = bound(moved, 4 * Dh * H * (n_vis + B * (col + 1)), "float32")
        print(f"[kernel] slot_attention {name}: {n_vis / (B * S):.1%} of columns visible, "
              f"{moved / 1e6:.3f} MB, bound {bms:.5f} ms ({by}); kernel {ms:.4f} ms "
              f"(CUDA graph, {bms / ms:.1%} of the bound's rate)")
        timed[name] = dict(sc=sc, col=col, ms=ms, bms=bms, by=by)
    # the buffer's share: the same visibility at the first, a middle and
    # the last buffer column
    for name in ("partial ring", "fully visible"):
        sc = timed[name]["sc"]
        by_col = [graph_ms(torch, [lambda c=c: sa.slot_attention(q, kn, vn, *c, col, *sc, **geom)
                                   for c in caches]) for col in (0, W // 2, W - 1)]
        print(f"[kernel] slot_attention {name} at buffer columns 0, {W // 2}, {W - 1}: "
              + ", ".join(f"{ms:.4f}" for ms in by_col) + " ms (CUDA graph)")
    # the floor that every launch pays: no cache column visible and no
    # buffer column, only the step's own
    none = (i32([0] * B), i32([0] * B), i32([0] * B), i32([416]))
    floor_ms = graph_ms(torch, [lambda c=c: sa.slot_attention(q, kn, vn, *c, 0, *none, **geom)
                                for c in caches])
    print(f"[kernel] slot_attention nothing visible (the floor of a launch): kernel "
          f"{floor_ms:.4f} ms (CUDA graph)")
    t = timed["partial ring"]
    sc, col = t["sc"], t["col"]
    plain_ms = graph_ms(torch, [lambda c=c: sa.slot_attention_plain(q, kn, vn, *c, col, *sc,
                                                                     **geom) for c in caches])
    # yardstick only (not the same function): SDPA over the visible big-cache
    # columns, caches pre-transposed to [B,H,S,Dh]
    vis = i8.visibility(S, *sc[:3], int(sc[3]), **geom)[:, None, None, :]
    tr = [(c[0].transpose(2, 3).contiguous(), c[1].transpose(2, 3).contiguous())
          for c in caches]
    sdpa_ms = graph_ms(torch, [lambda d=d: F.scaled_dot_product_attention(
        q[:, :, None], *d, attn_mask=vis) for d in tr])
    share = ("" if seg_ms is None
             else f" = {L * W * t['ms'] / seg_ms:.2%} of the {seg_ms:.3f} ms segment")
    print(f"[kernel] slot_attention B={B} H={H} Dh={Dh} S={S} W={W} partial ring: device "
          f"time per launch (CUDA graph) kernel {t['ms']:.4f} ms, plain {plain_ms:.4f} ms; "
          f"bound {t['bms']:.5f} ms ({t['by']}); library: none (yardstick SDPA over the big "
          f"cache alone {sdpa_ms:.4f} ms); {L} launches a step{share}")
    return dict(max_abs_err=worst, ms=t["ms"], plain_ms=plain_ms, bound_ms=t["bms"],
                bound_by=t["by"], library_ms=None)


# ---------------------------------------------------------------------------

def main(argv) -> int:
    if not (REPO / "genie_tts_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: genie_tts_tpu_torch/ not found beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    # the int8 slot KV cache (and its kernel) for slot serving, as a user
    # opts in: set before the port reads its configuration
    os.environ["GENIE_SLOT_KV_INT8"] = "1"
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke run needs a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    work = REPO / "genie_tts_tpu_torch" / "build" / "smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t_start = time.perf_counter()

    def timed(fn, *args):
        """Run a phase and print its wall time."""
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    if argv[1:] == ["--slot-attention"]:
        # the exact caches' slot attention kernel alone: build, compare, time
        timed(phase_build)
        timed(phase_kernel_slot, torch)
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(f"{card}")
        return 0
    if argv[1:] == ["--cross-card"]:
        # the cross-card mesh alone (a machine with 2 or 4 cards): the
        # kernels, phase 3's character written, then phase (i)
        try:
            timed(phase_build)
            _, hub, _ = make_character(torch, work, {"max_decode_steps": 128})
            os.environ["GENIE_HUBERT_DIR"] = str(hub)
            res = timed(phase_cross_card, torch, work, card)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        check(res["ran"], "--cross-card on a machine with one card")
        print(f"[done] {time.perf_counter() - t_start:.1f} s")
        print(f"{card}")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    try:
        timed(phase_build)
        char, tts = timed(phase_tts, torch, work)
        b4 = timed(phase_generate_b4, torch, char)
        timed(phase_slice_check, torch, char)
        check(tts[2]["cache_len"] == b4["S"], "main-path cache lengths differ")
        sl = timed(phase_slots, torch, work)
        bf16 = timed(phase_slots_bf16, torch, sl["char"], sl["feats"], sl["phones"])
        timed(phase_slot_slice_check, torch, sl["char"])
        serve = timed(phase_serve, torch, work, card)
        timed(phase_graphs, torch, work, card)
        timed(phase_mesh, torch, work, card, tts, serve)
        timed(phase_cross_card, torch, work, card)
        _, clip, sv_path = timed(phase_v2pp, torch, work, card)
        timed(phase_v2pp_slice_check, torch, clip, sv_path)
        timed(phase_zh, torch, work, card)
        timed(phase_train, torch, work, card)
        timed(phase_shared_convert, torch, work, card)
        res = timed(phase_kernels, torch, char, b4["S"], b4)
        res8 = timed(phase_kernel_int8, torch, sl["live"], sl["seg_ms"][-1], sl["sb"].W)
        res_slot = timed(phase_kernel_slot, torch, bf16["ms"][-1], sl["sb"].W)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "genie_tts_tpu" or m.startswith("genie_tts_tpu.")],
          "the port imported JAX or the JAX package")
    kernels = [
        {**FLASH, "launches": b4["launches"], **res["flash", torch.bfloat16]},
        {**FUSED, "launches": tts[2]["launches"], **res["fused", "int8"]},
        {**INT8, "launches": sl["launches"], **res8},
        {**SLOT, "launches": bf16["launches"], **res_slot},
    ]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(f"{card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv))
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
