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
   be busy at once. Then decode ms per segment at occupancy 8, from CUDA
   events around ``decode_segment`` on the live state.
7. slot serving in the bf16 KV mode (the JAX package's default): 2
   requests through ``SlotBatcher.synthesize``; the int8 kernel must not
   launch.
8. slot slice check: greedy fp32 slot-machine codes with the int8 KV cache
   on the card (through the kernel) vs the CPU (plain version).
9. kernels: each kernel against its plain PyTorch version on the card at
   the shapes the main paths gave it (max error vs the stated tolerance),
   then its time, the plain version's, the library yardstick's and the
   least time the card could take (bound).

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
    if DEV == "cuda":
        torch.cuda.synchronize()


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


def bound(bytes_moved, ops, op_type):
    """Least time (ms) for the work: bytes over the memory rate or
    operations over the peak rate of their type, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    synth = api._make_synth_fn("slots", use_batcher=True)
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

    # decode ms per segment at occupancy 8, on the live state
    sb.stop()
    sb._thread.join(timeout=120)
    from genie_tts_tpu_torch.models import slots
    from genie_tts_tpu_torch.ops.sampling import SamplingConfig, SamplingRows, rows_from_config
    from genie_tts_tpu_torch.runtime.reference_audio import reference_audio_cache

    feats = reference_audio_cache.get_features(
        api.engine, char, str(root / "ref.wav"), "こんにちは、てすとです", "Japanese")
    phones = np.concatenate([feats.phones, api.get_phones_and_bert("。" + SENTENCES[0],
                                                                   "ja")[0]])
    samp = rows_from_config(SamplingConfig(), 1)
    state = sb._state
    with torch.inference_mode():
        ctx = slots.prefill_join(
            char.t2s_params, char.t2s_cfg,
            torch.tensor(np.pad(phones, (0, sb.sx - len(phones)))[None], device=DEV).long(),
            None, torch.tensor([len(phones)], device=DEV),
            torch.tensor(np.pad(feats.prompt_tokens, (0, sb.sp - len(feats.prompt_tokens)))[None],
                         device=DEV).long(),
            torch.tensor([len(feats.prompt_tokens)], device=DEV),
            SamplingRows(*(torch.tensor(a, device=DEV) for a in samp)),
            generator=sb._gen, any_top_p=False)
        for b in range(sb.n_slots):
            state = slots.insert_slot(state, b, *ctx, len(phones), len(feats.prompt_tokens),
                                      sb.ring, sb.ring, SamplingRows(*(a[0] for a in samp)))
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
            "sb": sb, "feats": feats, "phones": phones, "char": char, "live": live}


def phase_slots_bf16(torch, char, feats, phones):
    """The bf16 KV mode of the slot machine (the JAX package's default)."""
    import threading

    import numpy as np

    from genie_tts_tpu_torch.config import RuntimeConfig
    from genie_tts_tpu_torch.ops import int8_decode as i8
    from genie_tts_tpu_torch.runtime.engine import TTSEngine
    from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher

    sb = SlotBatcher(TTSEngine(RuntimeConfig(slot_kv_int8=False)), char, pcm16=True)
    check(sb._state.k_cache.dtype == torch.bfloat16, "bf16 slot caches")
    text = phones[len(feats.phones):]
    bert = np.zeros((len(text), char.t2s_cfg.bert_dim), np.float32)
    out = {}
    i8.int8_big_attention.launches = 0
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
    print(f"[slots bf16] 2 requests of 64 steps in {wall:.3f} s, {sb.stats['segments']} "
          f"segments, no int8 launches")


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
        kc = (torch.randn((L, S, D), generator=g, device=DEV) * 0.5).bfloat16()
        vc = (torch.randn((L, S, D), generator=g, device=DEV) * 0.5).bfloat16()
        ka, va, kb, vb = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        k32, v32 = kc.float(), vc.float()
        out, _, _ = fu.fused_decode_step(packed, h, ka, va, pos, fmask, num_heads=H)
        ref, _, _ = fu.fused_decode_step_plain(packed, h, kb, vb, pos, fmask, num_heads=H)
        # the same function with fp32 caches rounds no operand: the exact result
        ref32, _, _ = fu.fused_decode_step_plain(packed, h, k32, v32, pos, fmask,
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
        ms = cuda_ms(torch, lambda: fu.fused_decode_step(packed, h, ka, va, pos, fmask,
                                                         num_heads=H), 100)
        plain_ms = cuda_ms(torch, lambda: fu.fused_decode_step_plain(
            packed, h, kb, vb, pos, fmask, num_heads=H), 10)
        wbytes = sum(t.numel() * t.element_size() for t in packed.values())
        moved = wbytes + 2 * L * vis * D * 2 + 2 * L * D * 2 + S * 4 + 2 * D * 4
        ops = 2 * sum(packed[f"w{m}"].numel() for m in ("qkv", "out", "1", "2")) \
            + 4 * L * vis * D
        bms, by = bound(moved, ops, wname)
        print(f"[kernel] fused {wname} L={L} D={D} S={S} pos={pos}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bms:.5f} ms ({by}); "
              f"{moved / 1e6:.1f} MB moved")
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
    out, _, _ = fu.fused_decode_step(packed, h, ka, va, pos, fmask, num_heads=H)
    ref, _, _ = fu.fused_decode_step_plain(packed, h, kc, vc, pos, fmask, num_heads=H)
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
        out, err = compare(name, (q, *caches[0], i32(xl), i32(pl), i32(kw), head))
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

    # times: the partial-ring case, rotating 24 layers' caches (> the 50 MB L2)
    xl, pl, kw, head = cases["partial ring"]
    sc = (i32(xl), i32(pl), i32(kw), head)
    vis = i8.visibility(S, *sc[:3], head, **geom)
    n_vis = int(vis.sum())
    it = [0]

    def nxt():
        it[0] = (it[0] + 1) % L
        return caches[it[0]]

    eager_ms = cuda_ms(torch, lambda: i8.int8_big_attention(q, *nxt(), *sc, **geom), 240)
    # device times: one call per layer's caches, captured and replayed
    ms = graph_ms(torch, [lambda c=c: i8.int8_big_attention(q, *c, *sc, **geom)
                          for c in caches])
    plain_ms = graph_ms(torch, [lambda c=c: i8.int8_big_attention_plain(q, *c, *sc, **geom)
                                for c in caches])
    # labelled yardstick only: SDPA over pre-dequantized bf16 caches, same mask
    deq = [((kq.float() * ks[:, :, None]).transpose(2, 3).bfloat16().contiguous(),
            (vq.float() * vs[:, :, None]).transpose(2, 3).bfloat16().contiguous())
           for kq, ks, vq, vs in caches]
    amask = vis[:, None, None, :]
    sdpa_ms = graph_ms(torch, [lambda d=d: F.scaled_dot_product_attention(
        q[:, :, None], *d, attn_mask=amask) for d in deq])
    moved = H * n_vis * (2 * Dh + 2 * 4) + B * H * Dh * 2 + B * H * (Dh + 2) * 4 + 3 * B * 4
    bms, by = bound(moved, 4 * Dh * H * n_vis, "float32")
    share = L * W * ms / seg_ms
    print(f"[kernel] int8 B={B} H={H} Dh={Dh} S={S} ({n_vis / (B * S):.1%} of columns "
          f"visible): device time per launch (CUDA graph) kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; bound {bms:.5f} ms ({by}); eager back-to-back launches "
          f"{eager_ms:.4f} ms; library: none (yardstick, not the same function: SDPA over "
          f"pre-dequantized bf16 caches {sdpa_ms:.4f} ms); {L * W} launches per segment = "
          f"{share:.2%} of the {seg_ms:.3f} ms segment")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


# ---------------------------------------------------------------------------

def main() -> int:
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
    try:
        phase_build()
        char, tts = phase_tts(torch, work)
        b4 = phase_generate_b4(torch, char)
        phase_slice_check(torch, char)
        check(tts[2]["cache_len"] == b4["S"], "main-path cache lengths differ")
        sl = phase_slots(torch, work)
        phase_slots_bf16(torch, sl["char"], sl["feats"], sl["phones"])
        phase_slot_slice_check(torch, sl["char"])
        res = phase_kernels(torch, char, b4["S"], b4)
        res8 = phase_kernel_int8(torch, sl["live"], sl["seg_ms"][-1], sl["sb"].W)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(not [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "genie_tts_tpu" or m.startswith("genie_tts_tpu.")],
          "the port imported JAX or the JAX package")
    kernels = [
        {**FLASH, "launches": b4["launches"], **res["flash", torch.bfloat16]},
        {**FUSED, "launches": tts[2]["launches"], **res["fused", "int8"]},
        {**INT8, "launches": sl["launches"], **res8},
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
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke.py: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
