"""RoBERTa's phone features as a program per token bucket, vs the JAX package.

On the card the BERT hook runs RoBERTa's feature layer as a CUDA graph
per token bucket of the phoneme ladder (``models/roberta.py::
bucketed_features``; the graphs of a parameter set are one family: one
pool, one lock), as the JAX hook pads to a bucket and jits. Here the
same program runs eagerly on the same padded buffers. The tiny RoBERTa of
tests/test_torch_roberta.py (3 layers, d1024) in fp32:

* every bucket's padded route against the JAX ``phone_features`` at the
  padded bucket, and against the port's exact-length route: relative L2
  <= 1e-5; past the ladder's largest bucket (a multiple of it) against
  the exact route;
* the hook from many threads at once goes through one family: one key
  per bucket the texts reach, every call a hit after the first;
* ``engine.warmup(sweep=True)`` of a Chinese character prepares every
  bucket once per device: a second Chinese character's sweep counts
  hits and no new key or variant.
"""
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.models import roberta as jroberta
from genie_tts_tpu_torch.frontend import dispatcher as tdispatch
from genie_tts_tpu_torch.models import roberta
from genie_tts_tpu_torch.runtime import graphs
from test_torch_graphs import _sweep_case, tiny_roberta  # noqa: F401
from test_torch_roberta import (JCFG, KW, SENTENCES, TCFG, _hooks_cleared,  # noqa: F401
                                hooked, jparams, tparams)

BUCKETS = (32, 64, 128, 256)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tokens(n, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, KW["vocab_size"], n).astype(np.int64)
    return ids, np.ones(n, np.int64), rng.integers(1, 4, n - 2).astype(np.int64)


@pytest.mark.parametrize("n", [29, 61, 125, 253, 300],
                         ids=["bucket_32", "bucket_64", "bucket_128", "bucket_256",
                              "past_the_ladder"])
def test_bucketed_route_matches_jax_and_exact(jparams, tparams, n):
    ids, mask, reps = _tokens(n, seed=n)
    total = int(reps.sum())
    got = roberta.bucketed_features(tparams, TCFG, ids, mask, reps, BUCKETS).numpy()
    T = roberta.token_bucket(n, BUCKETS)
    assert got.shape == (total, 1024) and T == (512 if n > 256 else min(
        b for b in BUCKETS if b >= n))
    exact = roberta.phone_features(tparams, torch.from_numpy(ids)[None],
                                   torch.from_numpy(mask)[None], torch.from_numpy(reps),
                                   TCFG).numpy()
    assert rel_l2(got, exact) <= 1e-5
    if n <= BUCKETS[-1]:                 # the JAX hook truncates past its ladder
        pad = np.zeros(T, np.int64)
        want = np.asarray(jroberta.phone_features(
            jparams, jnp.asarray(np.concatenate([ids, pad])[:T])[None],
            jnp.asarray(np.concatenate([mask, pad])[:T])[None],
            jnp.asarray(np.concatenate([reps, pad])[:T - 2]), JCFG, total))
        assert rel_l2(got, want) <= 1e-5
    cache = graphs.cache_for(tparams)
    assert cache.family and ("roberta", T) in cache.keys()


def test_hook_through_one_family_from_many_threads(hooked, tparams):
    """16 threads call the hook (which reads ``tparams``) at once: the
    single-thread features, through the one graph of the texts' token
    bucket in the family, a hit for every call."""
    want = {t: tdispatch.get_phones_and_bert(t, "zh")[1] for t in SENTENCES}
    cache = graphs.cache_for(tparams)
    cache.reset_stats()
    bad, done = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(i):
        for k in range(4):
            text = SENTENCES[(i + k) % len(SENTENCES)]
            if not np.array_equal(tdispatch.get_phones_and_bert(text, "zh")[1], want[text]):
                bad.append(text)
        done.append(i)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == 16 and not bad
    assert cache.family and ("roberta", 32) in cache.keys()
    assert cache.stats["hits"] == 16 * 4 and cache.stats["misses"] == 0


def test_sweep_prepares_roberta_once_per_device(tiny_roberta):  # noqa: F811
    """Two Chinese characters swept on one device: the first sweep makes
    and prepares a graph per token bucket; the second finds them (hits,
    no miss, no new variant); a Japanese character's sweep does not touch
    them."""
    cache = graphs.cache_for(tiny_roberta)
    seen = []
    for language in ("Chinese", "Hybrid-Chinese-English", "Japanese"):
        eng, char, ref = _sweep_case(True, language=language)
        cache.reset_stats()
        eng.warmup(char, ref, sweep=True)
        seen.append(dict(cache.stats))
    assert sorted(cache.keys()) == [("roberta", T) for T in BUCKETS]
    assert seen[0] == {"hits": 0, "misses": 4, "variants": 4, "captures": 0}
    assert seen[1] == {"hits": 4, "misses": 0, "variants": 0, "captures": 0}
    assert seen[2] == {"hits": 0, "misses": 0, "variants": 0, "captures": 0}
