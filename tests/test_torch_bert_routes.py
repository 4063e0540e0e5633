"""Non-zero BERT through the port's solo and slot routes vs the JAX package.

Chinese text is the only input with non-zero BERT features, and a Chinese
reference transcript gives the reference its own: every route then packs
two non-zero blocks, [ref.bert | text bert], and pads them to its bucket.
Here both blocks are random (seeded numpy), on the tiny character of
tests/test_torch_pair.py loaded by both packages in fp32, with greedy
sampling and no flow noise. The codes must be identical and the
waveforms allclose (rtol/atol 2e-4, the bound of the zero-BERT parity
tests: fp32 sums in other orders through the latent stack and HiFi-GAN):

* the solo route, ``TTSEngine.synthesize_utterance`` (the fused decode
  step), with the codes of each package's ``generate_e2e``;
* the slot route, ``SlotBatcher.synthesize``: three requests queued
  before the scheduler starts, so they join the same segment, with the
  codes each package's pooled finisher vocodes.
"""
import dataclasses
import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.models import t2s as jt2s
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu.runtime.buckets import pad_to, pick_bucket
from genie_tts_tpu.runtime.slot_batcher import SlotBatcher as JSlotBatcher
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.models import t2s as tt2s
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime.slot_batcher import SlotBatcher

from test_torch_pair import HOP, load_pair, make_refs, write_character

SOLO_KW = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64), frame_buckets=(32, 64))
SLOT_KW = dict(SOLO_KW, slot_batch=4, slot_steps=32, slot_ring=64,
               slot_phoneme_bucket=32, slot_prompt_bucket=32)
TEXTS = [np.array([5, 40, 17, 99, 230, 12, 8], np.int32),
         np.array([300, 41, 7, 77, 501, 18], np.int32),
         np.array([9, 14, 250, 3, 66], np.int32)]
STEPS = dict(min_steps=6, max_steps=24)
TIMEOUT = 120


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    char_dir, _, _ = write_character(tmp_path_factory.mktemp("bert_routes"))
    return load_pair(char_dir)


def _bert(n, seed):
    return (np.random.default_rng(seed).standard_normal((n, 1024)) * 0.5).astype(np.float32)


def _refs(pair, kw):
    """Both packages' ReferenceFeatures with the same random reference BERT."""
    jchar, tchar = pair
    jeng, teng, jref, tref = make_refs(jchar, tchar, JRuntimeConfig(**kw),
                                       RuntimeConfig(**kw))
    rb = _bert(len(jref.phones), seed=11)
    return (jeng, teng, dataclasses.replace(jref, bert=rb),
            dataclasses.replace(tref, bert=rb.copy()))


def test_solo_route_nonzero_bert_matches_jax(pair):
    jchar, tchar = pair
    jeng, teng, jref, tref = _refs(pair, SOLO_KW)
    text, bert = TEXTS[0], _bert(len(TEXTS[0]), seed=12)
    jw = jeng.synthesize_utterance(jchar, jref, text, bert, sampling=JSampling(top_k=1),
                                   seed=0, noise_scale=0.0)
    tw = teng.synthesize_utterance(tchar, tref, text, bert, sampling=SamplingConfig(top_k=1),
                                   seed=0, noise_scale=0.0)
    n = teng.last_stats["codes_len"]
    assert 3 < n <= 24, "degenerate decode; reseed the fixture"
    assert len(tw) == len(jw) == 2 * n * HOP
    np.testing.assert_allclose(tw, np.asarray(jw), rtol=2e-4, atol=2e-4)

    # the codes, from each package's generate_e2e on the inputs the
    # engines build: packed [ref | text] phonemes and BERT rows
    phones = np.concatenate([jref.phones, text])
    packed_bert = np.concatenate([jref.bert, bert])
    sx = pick_bucket(len(phones), SOLO_KW["phoneme_buckets"])
    sp = pick_bucket(len(jref.prompt_tokens), SOLO_KW["prompt_buckets"])
    ph, pb = pad_to(phones, sx)[None], pad_to(packed_bert, sx, axis=0)[None]
    pr = pad_to(jref.prompt_tokens, sp)[None]
    cap = 64
    args = dict(max_steps=cap, cache_len=sx + sp + cap, max_steps_dyn=24)
    jc, jn = jt2s.generate_e2e(jchar.t2s_params, jchar.t2s_cfg, JSampling(top_k=1),
                               jax.random.PRNGKey(0), jnp.asarray(ph), jnp.asarray(pb),
                               jnp.array([len(phones)]), jnp.asarray(pr),
                               jnp.array([len(jref.prompt_tokens)]), **args)
    tc, tn = tt2s.generate_e2e(tchar.t2s_params, tchar.t2s_cfg, SamplingConfig(top_k=1),
                               None, torch.tensor(ph).long(), torch.tensor(pb),
                               torch.tensor([len(phones)]), torch.tensor(pr).long(),
                               torch.tensor([len(jref.prompt_tokens)]), **args)
    assert int(tn[0]) == int(jn[0]) == n
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))

    # the BERT rows matter: zero BERT decodes other codes
    zc, _ = tt2s.generate_e2e(tchar.t2s_params, tchar.t2s_cfg, SamplingConfig(top_k=1),
                              None, torch.tensor(ph).long(), None,
                              torch.tensor([len(phones)]), torch.tensor(pr).long(),
                              torch.tensor([len(jref.prompt_tokens)]), **args)
    assert not torch.equal(zc, tc)


def _serve(sb, sampling, ref, berts):
    """Queue every request, then start the scheduler: the waveforms."""
    sb.start = lambda: None               # hold the loop until all are queued
    outs, errors = {}, []

    def run(i):
        try:
            outs[i] = sb.synthesize(ref, TEXTS[i], berts[i], timeout=TIMEOUT,
                                    sampling=sampling, **STEPS)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(TEXTS))]
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
    return [outs[i] for i in range(len(TEXTS))]


def _record_codes(monkeypatch, eng):
    """Flow noise off in the pooled finisher; its codes recorded by text."""
    codes = {}
    real = functools.partial(eng.vocode_codes_dispatch, noise_scale=0.0)

    def dispatch(char, items, *a, **k):
        for _, text, c in items:
            codes[tuple(np.asarray(text).tolist())] = np.asarray(c).tolist()
        k.pop("noise_scale", None)
        return real(char, items, *a, **k)

    monkeypatch.setattr(eng, "vocode_codes_dispatch", dispatch)
    return codes


def test_slot_route_nonzero_bert_matches_jax(pair, monkeypatch):
    jchar, tchar = pair
    jeng, teng, jref, tref = _refs(pair, SLOT_KW)
    berts = [_bert(len(t), seed=20 + i) for i, t in enumerate(TEXTS)]
    jcodes, tcodes = _record_codes(monkeypatch, jeng), _record_codes(monkeypatch, teng)
    jw = _serve(JSlotBatcher(jeng, jchar), JSampling(top_k=1), jref, berts)
    tw = _serve(SlotBatcher(teng, tchar), SamplingConfig(top_k=1), tref, berts)
    assert len(tcodes) == len(jcodes) == len(TEXTS)
    assert tcodes == jcodes
    assert min(len(c) for c in tcodes.values()) > 3
    assert len({tuple(c) for c in tcodes.values()}) == len(TEXTS), "rows decoded alike"
    for t, j in zip(tw, jw):
        assert len(t) == len(j) > 0
        np.testing.assert_allclose(t, np.asarray(j, np.float32), rtol=2e-4, atol=2e-4)
