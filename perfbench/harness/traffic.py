"""The one traffic generator: requests made from a mix's parameters.

A mix (``traffic/<mix>.json``, a cell's ``params`` over it) is data:

- ``entry``: the entry it drives, a module of ``entries/`` found by name
  (``solo``: ``TTSEngine.synthesize_utterance``; ``slot``:
  ``SlotBatcher.synthesize``);
- ``clients``: the closed loop's clients, each sending its next request
  when its last one is served;
- ``sentences``: weights of 1, 2, 3 corpus sentences a request;
- ``greedy_share``: the share of requests decoded greedily (top-k 1),
  which the correctness check reads;
- ``pool``: the requests the clients take in order;
- ``pool_seed``: the seed of the pool's texts;
- ``warm_seconds``: traffic run before the window, unmeasured;
- ``check_requests``: greedy requests the check compares, the longest
  among them;
- ``trace_requests``: the whole requests a traced run profiles after
  its window, ``clients`` at a time.

The requests of a run are one FIXED multiset per mix and configuration,
drawn with ``pool_seed``; ``--seed`` only orders them and assigns the
greedy rows among them. A request's codes follow its text (the
configuration's ``length_rule``: round(ratio x phonemes), clipped), and
its text packed with the reference transcript fits the slot machine's
phoneme bucket (``RuntimeConfig.slot_phoneme_bucket``)."""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

import numpy as np

from .spec import ROOT


@dataclass
class Request:
    idx: int
    text: str
    n_phones: int            # phonemes of the text, by the benchmark's frontend
    codes: int               # semantic codes it is decoded to (min = max steps)
    greedy: bool
    rec: Dict = field(default_factory=dict)


def corpus(cfg: Dict) -> List[str]:
    path = ROOT / cfg["corpus"]
    return [s.strip() for s in Path(path).read_text(encoding="utf-8").splitlines()
            if s.strip()]


def phone_counts(cfg: Dict, sentences: List[str]) -> List[int]:
    from ..reference.frontend import phones

    if cfg["language"] == "zh":
        return [len(phones.chinese(s)[0]) for s in sentences]
    return [len(phones.japanese(s)) for s in sentences]


def codes_for(cfg: Dict, n_phones: int) -> int:
    rule = cfg["length_rule"]
    return int(min(max(round(rule["codes_per_phoneme"] * n_phones), rule["min_codes"]),
                   rule["max_codes"]))


def pool(cfg: Dict, mix: Dict, n: int, counts: List[int], sentences: List[str],
         limit: int) -> List[Request]:
    """``n`` requests drawn with the mix's ``pool_seed``: 1-3 sentences by
    the mix's weights, redrawn while the text has more than ``limit``
    phonemes."""
    rng = np.random.default_rng(int(mix.get("pool_seed", 0)))
    ks = [int(k) for k in mix["sentences"]]
    w = np.asarray([mix["sentences"][str(k)] for k in ks], np.float64)
    out = []
    while len(out) < n:
        k = ks[rng.choice(len(ks), p=w / w.sum())]
        picks = rng.integers(0, len(sentences), k)
        n_ph = sum(counts[i] for i in picks)
        if n_ph > limit:
            continue
        text = "".join(sentences[i] for i in picks)
        out.append(Request(idx=len(out), text=text, n_phones=n_ph,
                           codes=codes_for(cfg, n_ph), greedy=False))
    return out


def plan(cfg: Dict, mix: Dict, seed: int, limit: int, counts: List[int],
         sentences: List[str]) -> List[Request]:
    """The requests of one run, in the order the clients take them: the
    pool in the seed's order, a ``greedy_share`` of them greedy. ``limit``:
    the most phonemes a text may have (the slot machine's phoneme bucket
    less the reference transcript's)."""
    rng = np.random.default_rng(int(seed))
    n = int(mix["pool"])
    reqs = pool(cfg, mix, n, counts, sentences, limit)
    reqs = [reqs[i] for i in rng.permutation(n)]
    n_greedy = int(round(float(mix.get("greedy_share", 0.25)) * n))
    for i in rng.permutation(n)[:n_greedy]:
        reqs[i].greedy = True
    for i, r in enumerate(reqs):
        r.idx = i
    return reqs


def warm_seed(seed: int) -> int:
    """The seed of the unmeasured traffic before the window."""
    return (int(seed) * 2654435761 + 97) % (2 ** 62)


def sample_for_check(reqs: List[Request], k: int, seed: int) -> List[Request]:
    """Up to ``k`` finished greedy requests: the one with the most codes,
    and the rest drawn from the seed."""
    done = [r for r in reqs if r.greedy and r.rec.get("ok") and r.rec.get("tokens") is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (r.codes, -r.idx))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(int(seed) + 7)
    pick = [rest[i] for i in rng.permutation(len(rest))[:max(k - 1, 0)]]
    return [longest] + pick


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100), linear between order statistics."""
    v = sorted(values)
    if not v:
        return math.nan
    pos = (len(v) - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[lo]) or math.isinf(v[hi]):
        return v[hi] if pos > lo else v[lo]
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
