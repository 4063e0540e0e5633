"""The traffic generator: the requests of a run from the seed."""
import collections
import random

import numpy as np
import pytest

from perfbench.harness import spec, traffic
from perfbench.reference.frontend import phones


@pytest.fixture(scope="module")
def ja():
    cfg = spec.config("gsv-v2-ja")
    s = traffic.corpus(cfg)
    return cfg, s, traffic.phone_counts(cfg, s)


def _plan(ja, mix, seed):
    cfg, s, c = ja
    return traffic.plan(cfg, mix, seed, 192 - 20, c, s)


def _key(r):
    return (r.text, r.n_phones, r.codes, r.greedy)


@pytest.mark.parametrize("mix_name", ["narrate", "solo"])
def test_the_same_seed_gives_the_same_requests(ja, mix_name):
    mix = spec.traffic(mix_name)
    a, b = _plan(ja, mix, 2 ** 40 + 3), _plan(ja, mix, 2 ** 40 + 3)
    assert [_key(r) for r in a] == [_key(r) for r in b]


@pytest.mark.parametrize("mix_name", ["narrate", "solo"])
def test_every_seed_offers_the_same_work_in_another_order(ja, mix_name):
    mix = spec.traffic(mix_name)
    a, b = _plan(ja, mix, 11), _plan(ja, mix, 2 ** 33 + 5)
    assert [r.text for r in a] != [r.text for r in b]
    assert collections.Counter((r.text, r.codes) for r in a) == \
        collections.Counter((r.text, r.codes) for r in b)
    assert sum(r.greedy for r in a) == sum(r.greedy for r in b)
    assert len(a) == mix["pool"] and [r.idx for r in a] == list(range(len(a)))


@pytest.mark.parametrize("n, codes", [(0, 48), (10, 48), (24, 48), (25, 50), (57, 114),
                                      (240, 480), (500, 480)])
def test_the_length_rule(n, codes):
    cfg = {"length_rule": {"codes_per_phoneme": 2.0, "min_codes": 48, "max_codes": 480}}
    assert traffic.codes_for(cfg, n) == codes


def test_requests_fit_the_slot_bucket_with_the_reference(ja):
    mix = dict(spec.traffic("narrate"), pool=512)
    for r in _plan(ja, mix, 1):
        assert r.n_phones + 20 <= 192
        assert r.codes == traffic.codes_for(ja[0], r.n_phones)
        assert 1 <= sum(r.text.count(x) for x in "。？！") <= 3


@pytest.mark.parametrize("name", ["gsv-v2-ja", "gsv-v2pp-zh"])
def test_phonemes_of_joined_sentences_add_up(name):
    """The request's phoneme count (and so its codes) is the sum over its
    sentences: the frontend treats each sentence alone."""
    cfg = spec.config(name)
    s = traffic.corpus(cfg)
    c = traffic.phone_counts(cfg, s)
    fn = (lambda t: len(phones.chinese(t)[0])) if cfg["language"] == "zh" \
        else (lambda t: len(phones.japanese(t)))
    rnd = random.Random(0)
    for _ in range(40):
        picks = [rnd.randrange(len(s)) for _ in range(rnd.choice([2, 3]))]
        assert fn("".join(s[i] for i in picks)) == sum(c[i] for i in picks)


def test_the_corpora():
    ja = traffic.corpus(spec.config("gsv-v2-ja"))
    zh = traffic.corpus(spec.config("gsv-v2pp-zh"))
    assert len(ja) == 119 and len(zh) >= 100
    assert all(8 <= len(x) <= 40 for x in zh)


def test_the_check_sample_takes_the_longest_greedy_request():
    reqs = [traffic.Request(i, "t", 10, 48 + i, greedy=i % 2 == 0) for i in range(20)]
    for r in reqs:
        r.rec.update(ok=True, tokens=np.zeros(r.codes))
    pick = traffic.sample_for_check(reqs, 4, seed=3)
    assert pick[0].codes == 48 + 18 and len(pick) == 4
    assert all(r.greedy for r in pick)
    assert [r.idx for r in pick] == [r.idx for r in traffic.sample_for_check(reqs, 4, seed=3)]
