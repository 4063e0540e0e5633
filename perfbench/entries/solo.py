"""The entry ``solo``: ``TTSEngine.synthesize_utterance``, the ``tts()`` path.

One request decodes alone through the fused decode kernel, then the
synthesizer's latent and vocode graphs; the engine's stage marks are on
in a traced run. The greedy rows are served without flow noise
(``noise_scale`` 0: the same programs and work, the noise multiplied by
0), so the check compares their audio with the reference's."""
from __future__ import annotations

import time

import numpy as np

# the engine's synchronizing stage marks in a traced run (TTSEngine(timing=True))
STAGE_MARKS = True


def prepare(system, requests, serve, log) -> None:
    """One request per shape of the solo programs the requests reach:
    (packed-phoneme bucket, text bucket, step cap, frame bucket)."""
    from genie_tts_tpu_torch.runtime.buckets import pick_bucket

    rc = system.engine.cfg
    n_ref = len(system.ref.phones)
    shapes = {}
    for r in requests:
        cap = pick_bucket(r.codes, rc.step_caps)
        fb = pick_bucket(r.codes, rc.frame_buckets) if cap > rc.solo_fused_max_codes else 0
        key = (pick_bucket(n_ref + r.n_phones, rc.phoneme_buckets),
               pick_bucket(r.n_phones, rc.phoneme_buckets), cap, fb)
        shapes.setdefault(key, r)
    for r in shapes.values():
        serve(r)
    log(f"set-up: solo shapes: {len(shapes)}")


def instrument(system, current):
    """Keep the served tokens of the thread's greedy request (the decode's
    result, which the synthesizer vocodes); returns the undo."""
    from genie_tts_tpu_torch.models import t2s

    orig = t2s.generate

    def generate(*a, **k):
        res = orig(*a, **k)
        r = current()
        if r is not None and r.greedy:
            r.rec["_served"] = (res.tokens, res.counts)
        return res

    t2s.generate = generate
    return lambda: setattr(t2s, "generate", orig)


def serve(system, r, phones, bert, kw, stages: bool):
    """Returns the pieces [(time, samples)]; fills ``r.rec``."""
    audio = system.engine.synthesize_utterance(
        system.char, system.ref, phones, bert, pcm16=True,
        **({"noise_scale": 0.0} if r.greedy else {}), **kw)
    pieces = [(time.perf_counter(), len(audio))]
    r.rec["min_steps"] = r.codes
    if r.greedy:
        r.rec["pcm"] = np.asarray(audio)
    if stages:
        st = system.engine.last_stats
        r.rec["stages"] = dict(st.get("stages", {}))
        r.rec["decode_steps"] = st.get("decode_steps")
    served = r.rec.pop("_served", None)
    if served is not None:
        tokens, counts = served
        r.rec["tokens"] = tokens[0, : int(counts[0])].cpu().numpy().astype(np.int64)
    return pieces
