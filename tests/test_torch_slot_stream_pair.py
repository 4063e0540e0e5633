"""The port's slot-joined streams vs the JAX package's, piece for piece.

One tiny character loaded by both packages (tests/test_torch_pair.py), the
same slot geometry in both (4 slots, segments of 32 steps with join
segments of 16, a ring of 32, a first piece of 4 frames, ``vocode_chunk``
8 with a halo of 2, a lookahead of 2), greedy sampling in fp32, and the
flow noise scaled to 0 in both engines' window and finisher vocodes, so
neither package's noise plays a part. Every request is queued before the scheduler starts, so all
join in the same segment and the runs are deterministic.

``SlotBatcher.synthesize_stream`` must yield the same pieces as the JAX
one: the same boundaries (the speculative first piece of
``slot_first_piece`` frames, the pumped windows, the completion windows)
and allclose waveforms (rtol/atol 2e-4: fp32 sums in other orders through
the latent stack and HiFi-GAN), reassembling to 2 * codes * hop samples.
Cases: the stream alone; beside two blocking requests (served by the
pooled finisher, which must match the JAX one too); and with
``slot_stream_finisher``, where every row pumps windows.
"""
import functools
import threading
import time

import numpy as np
import pytest

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu.runtime.slot_batcher import SlotBatcher as JSlotBatcher
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime import slot_batcher as sbm

from test_torch_pair import HOP, load_pair, make_refs, write_character

KW = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64), frame_buckets=(32, 64),
          slot_batch=4, slot_steps=32, slot_ring=64, slot_join_steps=16,
          slot_phoneme_bucket=32, slot_prompt_bucket=32, slot_first_piece=4,
          vocode_chunk=8, vocode_halo=2, stream_lookahead=2)
STREAM_TEXT = np.array([5, 40, 17, 99, 230, 12, 8], np.int32)
BLOCK_TEXTS = [np.array([300, 41, 7, 77, 501, 18], np.int32),
               np.array([9, 14, 250, 3], np.int32)]
STEPS = dict(min_steps=18, max_steps=24)
TIMEOUT = 120


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    char_dir, _, _ = write_character(tmp_path_factory.mktemp("slotstream"))
    return load_pair(char_dir)


def _serve(sb, sampling, ref, n_block):
    """Queue one stream and ``n_block`` blocking requests, then start the
    scheduler: (the stream's pieces, the blocking results)."""
    sb.start = lambda: None               # hold the loop until all are queued
    outs, errors = {}, []
    bert = {len(t): np.zeros((len(t), 1024), np.float32)
            for t in [STREAM_TEXT] + BLOCK_TEXTS}

    def stream():
        try:
            outs["s"] = list(sb.synthesize_stream(ref, STREAM_TEXT, bert[len(STREAM_TEXT)],
                                                  timeout=TIMEOUT, sampling=sampling,
                                                  **STEPS))
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def block(i):
        try:
            t = BLOCK_TEXTS[i]
            outs[i] = sb.synthesize(ref, t, bert[len(t)], timeout=TIMEOUT,
                                    sampling=sampling, **STEPS)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = ([threading.Thread(target=stream)]
               + [threading.Thread(target=block, args=(i,)) for i in range(n_block)])
    for t in threads:
        t.start()
    deadline = time.monotonic() + TIMEOUT
    while sb._q.qsize() < len(threads) and time.monotonic() < deadline:
        time.sleep(0.001)
    assert sb._q.qsize() == len(threads), "a request was never queued"
    type(sb).start(sb)
    for t in threads:
        t.join(timeout=TIMEOUT)
    sb.stop()
    assert not errors, errors
    assert not any(t.is_alive() for t in threads), "a client hung"
    return outs["s"], [outs[i] for i in range(n_block)]


@pytest.mark.parametrize("windows,n_block", [(False, 0), (False, 2), (True, 2)],
                         ids=["alone", "beside_blocking_rows", "every_row_pumps"])
def test_slot_stream_pieces_match_jax(pair, monkeypatch, windows, n_block):
    jchar, tchar = pair
    kw = dict(KW, slot_stream_finisher=windows)
    jeng, teng, jref, tref = make_refs(jchar, tchar, JRuntimeConfig(**kw),
                                       RuntimeConfig(**kw))
    for eng in (jeng, teng):
        for name in ("vocode_windows_dispatch", "vocode_codes_dispatch"):
            monkeypatch.setattr(eng, name, functools.partial(getattr(eng, name),
                                                             noise_scale=0.0))
    spec = []
    real = sbm.spec_codes
    monkeypatch.setattr(sbm, "spec_codes", lambda *a, **k: spec.append(1) or real(*a, **k))

    jsb, tsb = JSlotBatcher(jeng, jchar), sbm.SlotBatcher(teng, tchar)
    assert (tsb.W, tsb.join_W, tsb.ring, tsb.first_piece) == (jsb.W, jsb.join_W, jsb.ring,
                                                              jsb.first_piece) == (32, 16, 32, 4)
    jp, jblock = _serve(jsb, JSampling(top_k=1), jref, n_block)
    tp, tblock = _serve(tsb, SamplingConfig(top_k=1), tref, n_block)

    assert spec, "no speculative first piece"
    assert len(tp) >= 4, f"{len(tp)} pieces: want the first piece, pumps and completion"
    assert len(tp[0]) == tsb.first_piece * HOP
    assert [len(p) for p in tp] == [len(p) for p in jp]
    for t, j in zip(tp, jp):
        np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=2e-4, atol=2e-4)
    total = sum(len(p) for p in tp)
    assert total % (2 * HOP) == 0 and 18 <= total // (2 * HOP) <= 24
    for t, j in zip(tblock, jblock):
        assert len(t) == len(j) > 0
        np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=2e-4, atol=2e-4)
    assert tsb.stats["streams"] == 1
