"""The entry ``slot``: ``SlotBatcher.synthesize``, the slot machine.

A request joins the character's slot machine (exact-KV decode segments
over its 8 slots) and waits for its whole audio, which the
pooled finisher vocodes. The machine draws its flow noise itself, so
the check compares its tokens and not its audio."""
from __future__ import annotations

import time

import numpy as np

STAGE_MARKS = False


def prepare(system, requests, serve, log) -> None:
    """The slot machine, its programs captured through the port's unit list."""
    system.slot_batcher()
    log(f"set-up: slot units: {system.units_log}")


def instrument(system, current):
    """Keep the thread's greedy request as the machine takes it (its first
    token and the segments' tokens are the codes it vocodes); returns the
    undo."""
    sb = system.batcher
    orig = sb._submit

    def submit(req):
        r = current()
        if r is not None and r.greedy:
            r.rec["_served"] = req
        return orig(req)

    sb._submit = submit
    return lambda: setattr(sb, "_submit", orig)


def serve(system, r, phones, bert, kw, stages: bool):
    """Returns the pieces [(time, samples)]; fills ``r.rec``."""
    from perfbench.harness.drive import REQUEST_TIMEOUT_S

    audio = system.batcher.synthesize(system.ref, phones, bert, timeout=REQUEST_TIMEOUT_S,
                                      **kw)
    pieces = [(time.perf_counter(), len(audio))]
    r.rec["min_steps"] = r.codes
    req = r.rec.pop("_served", None)
    if req is not None:
        r.rec["tokens"] = np.concatenate([[req.tok0_np]] + list(req.seg_tokens))[
            :req.count_seen].astype(np.int64)
    return pieces
