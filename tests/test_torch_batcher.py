"""The port's window batcher and batched synthesis vs the JAX package.

``engine.synthesize_batch`` on one tiny character loaded by both packages
(tests/test_torch_pair.py), greedy sampling in fp32 at noise_scale 0: the
codes and their lengths must be identical and the waveforms allclose
(rtol/atol 2e-4, as tests/test_torch_engine.py: fp32 sums in other orders
through the latent stack and HiFi-GAN). ``engine.synthesize_pipelined``
gives the JAX one's waveforms (the same tolerance). ``ContinuousBatcher``:
concurrent requests coalesce into one batch, every row gets its own
waveform, a failing batch fails its waiters, and ``stop`` joins the loop.
"""
import threading
import time

import numpy as np
import pytest

from genie_tts_tpu.config import RuntimeConfig as JRuntimeConfig
from genie_tts_tpu.ops.sampling import SamplingConfig as JSampling
from genie_tts_tpu_torch.config import RuntimeConfig
from genie_tts_tpu_torch.ops.sampling import SamplingConfig
from genie_tts_tpu_torch.runtime.batcher import ContinuousBatcher
from genie_tts_tpu_torch.utils.metrics import metrics

from test_torch_pair import HOP, load_pair, make_refs, write_character

BUCKETS = dict(phoneme_buckets=(32, 64), prompt_buckets=(32, 64),
               frame_buckets=(32, 64))
TEXTS = [np.array([5, 40, 17, 99, 230, 12, 8], np.int32),
         np.array([300, 41, 7, 77, 501, 18, 33, 90, 2, 61, 12], np.int32),
         np.array([9, 14, 250, 3], np.int32)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    char_dir, _, _ = write_character(tmp_path_factory.mktemp("batch"))
    jchar, tchar = load_pair(char_dir)
    jeng, teng, jref, tref = make_refs(jchar, tchar, JRuntimeConfig(**BUCKETS),
                                       RuntimeConfig(**BUCKETS))
    return jchar, tchar, jeng, teng, jref, tref


def _items(ref, texts):
    return [(ref, t, np.zeros((len(t), 1024), np.float32)) for t in texts]


def test_synthesize_batch_matches_jax(setup):
    """Three ragged rows (padded to a batch of 4): identical lengths (so
    identical codes counts) and allclose waveforms, row by row."""
    jchar, tchar, jeng, teng, jref, tref = setup
    jw = jeng.synthesize_batch(jchar, _items(jref, TEXTS), sampling=JSampling(top_k=1),
                               seed=0, noise_scale=0.0)
    stats = {}
    tw = teng.synthesize_batch(tchar, _items(tref, TEXTS), sampling=SamplingConfig(top_k=1),
                               seed=0, noise_scale=0.0, stats=stats)
    assert stats["decode_steps"] > 0
    lens = [len(a) // (2 * HOP) for a in tw]
    assert len(set(lens)) > 1 or lens[0] > 3, "degenerate decode"
    for j, t in zip(jw, tw):
        assert t.dtype == np.float32 and len(t) == len(j) > 0
        assert len(t) % (2 * HOP) == 0
        np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)


def test_synthesize_batch_codes_identical(setup, monkeypatch):
    """The codes each package vocodes: captured at the latent stage."""
    from genie_tts_tpu_torch.models import sovits as tsovits

    jchar, tchar, jeng, teng, jref, tref = setup
    seen = {}

    def spy(name, fn):
        def wrapped(params, cfg, *a, **k):
            codes, lens = (a[1], a[2]) if name == "jax" else (a[0], a[1])
            seen[name] = (np.asarray(codes), np.asarray(lens))
            return fn(params, cfg, *a, **k)
        return wrapped

    monkeypatch.setattr(tsovits, "synthesize_latent",
                        spy("torch", tsovits.synthesize_latent))
    teng.synthesize_batch(tchar, _items(tref, TEXTS[:2]), sampling=SamplingConfig(top_k=1),
                          seed=3, noise_scale=0.0)
    monkeypatch.setattr(jeng, "_latent", spy("jax", jeng._latent))
    jeng.synthesize_batch(jchar, _items(jref, TEXTS[:2]), sampling=JSampling(top_k=1),
                          seed=3, noise_scale=0.0)
    (tc, tn), (jc, jn) = seen["torch"], seen["jax"]
    np.testing.assert_array_equal(tn, jn)
    np.testing.assert_array_equal(tc, jc)


def test_synthesize_pipelined_matches_jax(setup):
    """Sequential utterances with up to two in flight: the same waveforms
    as the JAX ``synthesize_pipelined``, in order (rtol/atol 2e-4)."""
    jchar, tchar, jeng, teng, jref, tref = setup
    items = [(t, np.zeros((len(t), 1024), np.float32)) for t in TEXTS]
    jw = jeng.synthesize_pipelined(jchar, jref, items, sampling=JSampling(top_k=1),
                                   seed=2, noise_scale=0.0, window=2)
    tw = teng.synthesize_pipelined(tchar, tref, items, sampling=SamplingConfig(top_k=1),
                                   seed=2, noise_scale=0.0, window=2)
    assert len(tw) == len(jw) == len(TEXTS)
    for j, t in zip(jw, tw):
        assert t.dtype == np.float32 and len(t) == len(j) > 0
        np.testing.assert_allclose(t, j, rtol=2e-4, atol=2e-4)


def test_window_batcher_coalesces(setup):
    """Requests that arrive within the window run as one batch."""
    _, tchar, _, teng, _, tref = setup
    eng = type(teng)(RuntimeConfig(**BUCKETS))
    b = ContinuousBatcher(eng, max_batch=8, window_ms=400.0)
    metrics.reset()
    outs, errors = {}, []

    def client(i):
        try:
            outs[i] = b.synthesize(tchar, tref, TEXTS[i], np.zeros((len(TEXTS[i]), 1024),
                                                                   np.float32),
                                   sampling=SamplingConfig(top_k=1), timeout=120)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    b.stop()
    assert not errors and len(outs) == 3
    assert max(metrics._gauges["batch_size"].samples) >= 2
    assert b.stats["rows"] == 3 and b.stats["batches"] < 3
    for a in outs.values():
        assert a.dtype == np.float32 and len(a) > 0 and np.isfinite(a).all()


def test_window_batcher_fault_fails_waiters(setup, monkeypatch):
    _, tchar, _, teng, _, tref = setup
    eng = type(teng)(RuntimeConfig(**BUCKETS))

    def boom(*a, **k):
        raise RuntimeError("injected batch fault")

    monkeypatch.setattr(eng, "synthesize_batch", boom)
    b = ContinuousBatcher(eng, window_ms=1.0)
    with pytest.raises(RuntimeError, match="injected batch fault"):
        b.synthesize(tchar, tref, TEXTS[0], np.zeros((7, 1024), np.float32), timeout=60)
    b.stop()


def test_window_batcher_stop_joins_the_loop(setup, monkeypatch):
    """``stop`` waits for the loop to end; a request still queued behind
    the running batch fails instead of hanging, and a new submit starts a
    new loop (never two at once)."""
    _, tchar, _, teng, _, tref = setup
    eng = type(teng)(RuntimeConfig(**BUCKETS))
    entered, release = threading.Event(), threading.Event()

    def slow(char, items, **k):
        entered.set()
        assert release.wait(60)
        return [np.zeros(2 * HOP, np.float32)] * len(items)

    monkeypatch.setattr(eng, "synthesize_batch", slow)
    b = ContinuousBatcher(eng, window_ms=1.0)
    res = {}

    def client(i):
        try:
            res[i] = b.synthesize(tchar, tref, TEXTS[0], np.zeros((7, 1024), np.float32),
                                  timeout=60)
        except BaseException as e:  # noqa: BLE001 — checked below
            res[i] = e

    first = threading.Thread(target=client, args=(0,))
    first.start()
    assert entered.wait(60)
    second = threading.Thread(target=client, args=(1,))
    second.start()
    deadline = time.monotonic() + 60
    while b._q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    loop = b._thread
    stopper = threading.Thread(target=b.stop, kwargs={"timeout": 60})
    stopper.start()
    while b._running and time.monotonic() < deadline:
        time.sleep(0.001)
    release.set()
    for t in (stopper, first, second):
        t.join(timeout=60)
    assert not loop.is_alive() and not stopper.is_alive()
    assert isinstance(res[0], np.ndarray)
    assert isinstance(res[1], RuntimeError) and "stopped" in str(res[1])
    assert len(b.synthesize(tchar, tref, TEXTS[0], np.zeros((7, 1024), np.float32),
                            timeout=60)) == 2 * HOP
    assert b._thread is not loop
    b.stop(timeout=60)
    assert not b._thread.is_alive()


def test_launch_counters_exact_under_threads():
    """Request threads launch kernels concurrently: the wrappers' counts
    go through one lock (a bare ``+=`` loses updates under preemption)."""
    import sys

    from genie_tts_tpu_torch.ops import _build

    def fn():
        pass

    fn.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [_build.count_launch(fn)
                                                    for _ in range(2000)])
                   for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert fn.launches == 16 * 2000
