"""The entry ``slot_audio``: ``SlotBatcher.synthesize``, the slot machine,
keeping what the check needs of a synthesizer whose noise the request
chooses (GPT-SoVITS V4).

As ``entries/slot.py``, and besides: each greedy request carries a
``cfm_seed`` drawn from the run's seed and its place in the plan, and
keeps its served PCM and the CFM mel the pooled finisher sampled for it
(copied to host memory right behind the mel, read once the request is
done), so the check compares its audio, not its tokens alone."""
from __future__ import annotations

import hashlib

from perfbench.harness import spec
from perfbench.harness.system import System

_slot = spec.entry("slot")

STAGE_MARKS = False
prepare = _slot.prepare


def system(cfg, seed, device, texts, **kw):
    """The harness's system, remembering the run's seed."""
    s = System(cfg, seed, device, texts, **kw)
    s.run_seed = int(seed)
    return s


def cfm_seed(run_seed: int, idx: int) -> int:
    h = hashlib.sha256(f"cfm:{int(run_seed)}:{int(idx)}".encode()).digest()
    return int.from_bytes(h[:8], "little") & (2 ** 62 - 1)


def instrument(system, current):
    """``entries/slot.py``'s reading of the served tokens, and the mel of
    each greedy row (``sovits_v4.cfm_rows``, by its seed); returns the
    undo."""
    from genie_tts_tpu_torch.models import sovits_v4
    from genie_tts_tpu_torch.runtime.engine import start_host_copy

    undo_slot = _slot.instrument(system, current)
    wanted = system.kept_mels = {}
    orig = sovits_v4.cfm_rows

    def cfm_rows(params, cfg, rows, *a, **k):
        out = orig(params, cfg, rows, *a, **k)
        for row, mel in zip(rows, out):
            if row.seed in wanted and wanted[row.seed] is None:
                wanted[row.seed] = start_host_copy(mel)
        return out

    sovits_v4.cfm_rows = cfm_rows

    def undo():
        sovits_v4.cfm_rows = orig
        undo_slot()
    return undo


def serve(system, r, phones, bert, kw, stages: bool):
    """Returns the pieces [(time, samples)]; fills ``r.rec``."""
    import time

    import numpy as np

    from genie_tts_tpu_torch.runtime.engine import finish_host_copy
    from perfbench.harness.drive import REQUEST_TIMEOUT_S

    seed = None
    kept = getattr(system, "kept_mels", None)
    if r.greedy and kept is not None:
        seed = cfm_seed(system.run_seed, r.idx)
        kept[seed] = None
    audio = system.batcher.synthesize(system.ref, phones, bert, timeout=REQUEST_TIMEOUT_S,
                                      cfm_seed=seed, **kw)
    pieces = [(time.perf_counter(), len(audio))]
    r.rec["min_steps"] = r.codes
    req = r.rec.pop("_served", None)
    if req is not None:
        r.rec["tokens"] = np.concatenate([[req.tok0_np]] + list(req.seg_tokens))[
            :req.count_seen].astype(np.int64)
    if seed is not None:
        handle = kept.pop(seed, None)
        if handle is not None:
            r.rec.update(cfm_seed=seed, pcm=np.asarray(audio),
                         mel=finish_host_copy(handle).astype(np.float32))
    return pieces
