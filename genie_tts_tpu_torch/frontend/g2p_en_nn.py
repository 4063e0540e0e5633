"""Neural OOV English G2P (GRU seq2seq) + statistical word segmentation.

Re-owns the two data-driven fallbacks of the reference's English pipeline:

* ``NeuralG2P`` — the pure-NumPy GRU encoder/decoder the reference runs for
  out-of-vocabulary words (``genie_tts/G2P/English/
  EnglishG2P.py:130-198``). The weights are the public g2p-en
  ``checkpoint20.npz`` (enc/dec GRU + projection), distributed via
  GenieData; the grapheme/phoneme vocabularies are the fixed public
  g2p-en tables.
* ``WordSegmenter`` — unigram/bigram Viterbi segmentation of concatenated
  words ("helloworld" -> "hello world"), the public `wordsegment` corpus
  scoring (``WordSegment.py:9-143``). Implemented as an iterative
  memoized DP over (suffix-start, previous-word) states instead of the
  reference's recursion.

Both gate on their GenieData assets and return None when absent, so the
dictionary + rule-LTS path (g2p_en.py) keeps working offline.
"""
from __future__ import annotations

import logging
import math
from functools import lru_cache
from typing import Dict, List, Optional

import numpy as np

from ..config import english_g2p_dir

logger = logging.getLogger(__name__)

# Public g2p-en model vocabularies (fixed by the published checkpoint).
GRAPHEMES = ["<pad>", "<unk>", "</s>"] + list("abcdefghijklmnopqrstuvwxyz")
PHONEMES = ["<pad>", "<unk>", "<s>", "</s>"] + [
    "AA0", "AA1", "AA2", "AE0", "AE1", "AE2", "AH0", "AH1", "AH2",
    "AO0", "AO1", "AO2", "AW0", "AW1", "AW2", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH0", "EH1", "EH2", "ER0", "ER1", "ER2",
    "EY0", "EY1", "EY2", "F", "G", "HH", "IH0", "IH1", "IH2",
    "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW0", "OW1", "OW2", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2",
    "V", "W", "Y", "Z", "ZH",
]
_G2IDX = {g: i for i, g in enumerate(GRAPHEMES)}
_IDX2P = dict(enumerate(PHONEMES))


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


class NeuralG2P:
    """GRU seq2seq grapheme->phoneme model (g2p-en checkpoint schema)."""

    REQUIRED = ("enc_emb", "enc_w_ih", "enc_w_hh", "enc_b_ih", "enc_b_hh",
                "dec_emb", "dec_w_ih", "dec_w_hh", "dec_b_ih", "dec_b_hh",
                "fc_w", "fc_b")

    def __init__(self, npz_path):
        data = np.load(npz_path)
        missing = [k for k in self.REQUIRED if k not in data]
        if missing:
            raise KeyError(f"G2P checkpoint missing tensors: {missing}")
        self.v = {k: np.asarray(data[k], np.float32) for k in self.REQUIRED}
        self.sos = PHONEMES.index("<s>")
        self.eos = PHONEMES.index("</s>")

    def _cell(self, x: np.ndarray, h: np.ndarray, w_ih, w_hh, b_ih, b_hh):
        """Torch-layout GRU cell: gates packed [r | z | n] along the output."""
        H = h.shape[-1]
        gi = x @ w_ih.T + b_ih
        gh = h @ w_hh.T + b_hh
        r = _sigmoid(gi[..., :H] + gh[..., :H])
        z = _sigmoid(gi[..., H:2 * H] + gh[..., H:2 * H])
        n = np.tanh(gi[..., 2 * H:] + r * gh[..., 2 * H:])
        return (1.0 - z) * n + z * h

    def predict(self, word: str, max_steps: int = 20) -> List[str]:
        """Greedy decode an ARPAbet pronunciation for one word."""
        v = self.v
        ids = [_G2IDX.get(c, _G2IDX["<unk>"]) for c in word.lower()]
        ids.append(_G2IDX["</s>"])
        h = np.zeros((1, v["enc_w_hh"].shape[1]), np.float32)
        for i in ids:
            h = self._cell(v["enc_emb"][None, i], h,
                           v["enc_w_ih"], v["enc_w_hh"],
                           v["enc_b_ih"], v["enc_b_hh"])
        x = v["dec_emb"][None, self.sos]
        out: List[str] = []
        for _ in range(max_steps):
            h = self._cell(x, h, v["dec_w_ih"], v["dec_w_hh"],
                           v["dec_b_ih"], v["dec_b_hh"])
            logits = h @ v["fc_w"].T + v["fc_b"]
            idx = int(np.argmax(logits))
            if idx == self.eos:
                break
            out.append(_IDX2P.get(idx, "<unk>"))
            x = v["dec_emb"][None, idx]
        return out


class WordSegmenter:
    """Unigram/bigram max-likelihood segmentation (wordsegment corpus).

    ``score(w, prev)``: P(w) from unigram counts over TOTAL, with the
    10/(TOTAL*10^len) OOV penalty; bigram counts refine P(w | prev).
    """

    TOTAL = 1024908267229.0
    LIMIT = 24
    ALPHABET = frozenset("abcdefghijklmnopqrstuvwxyz0123456789")

    def __init__(self, unigrams: Dict[str, float], bigrams: Dict[str, float]):
        self.unigrams = unigrams
        self.bigrams = bigrams

    @classmethod
    def from_dir(cls, data_dir) -> "WordSegmenter":
        def parse(path):
            out: Dict[str, float] = {}
            for line in path.read_text(encoding="utf-8").splitlines():
                parts = line.split("\t")
                if len(parts) == 2 and parts[0]:
                    out[parts[0]] = float(parts[1])
            return out

        return cls(parse(data_dir / "unigrams.txt"),
                   parse(data_dir / "bigrams.txt"))

    def _log_score(self, word: str, prev: Optional[str]) -> float:
        if prev is not None:
            big = self.bigrams.get(f"{prev} {word}")
            if big is not None and prev in self.unigrams:
                return (math.log10(big / self.TOTAL)
                        - self._log_score(prev, None))
        uni = self.unigrams.get(word)
        if uni is not None:
            return math.log10(uni / self.TOTAL)
        return math.log10(10.0) - math.log10(self.TOTAL) - len(word)

    def segment(self, text: str) -> List[str]:
        """Best segmentation of (cleaned) ``text`` into corpus words."""
        s = "".join(c for c in text.lower() if c in self.ALPHABET)
        if not s:
            return []
        n = len(s)
        # memo[(start, prev)] = (score, words); iterative over suffix starts
        # from the end so each state's dependencies are already solved.
        memo: Dict[tuple, tuple] = {}

        def solve(start: int, prev: Optional[str]):
            return memo.get((start, prev), (0.0, []))

        # enumerate the (start, prev) states actually reachable: prev is a
        # prefix s[j:start] with start - j <= LIMIT
        for start in range(n, -1, -1):
            prevs: List[Optional[str]] = [None]
            prevs += [s[j:start] for j in range(max(0, start - self.LIMIT), start)]
            for prev in prevs:
                if start == n:
                    memo[(start, prev)] = (0.0, [])
                    continue
                best = None
                for end in range(start + 1, min(n, start + self.LIMIT) + 1):
                    word = s[start:end]
                    sc = self._log_score(word, prev)
                    tail_sc, tail = solve(end, word)
                    cand = (sc + tail_sc, [word] + tail)
                    if best is None or cand[0] > best[0]:
                        best = cand
                memo[(start, prev)] = best
        return solve(0, None)[1]


@lru_cache(maxsize=1)
def neural_g2p() -> Optional[NeuralG2P]:
    path = english_g2p_dir() / "checkpoint20.npz"
    if not path.is_file():
        return None
    try:
        model = NeuralG2P(path)
        logger.info("neural English G2P loaded from %s", path)
        return model
    except Exception as e:  # malformed asset: fall back to rules
        logger.warning("could not load neural G2P (%s); using rule LTS", e)
        return None


@lru_cache(maxsize=1)
def word_segmenter() -> Optional[WordSegmenter]:
    root = english_g2p_dir() / "wordsegment"
    if not (root / "unigrams.txt").is_file():
        return None
    try:
        seg = WordSegmenter.from_dir(root)
        logger.info("word segmenter loaded: %d unigrams", len(seg.unigrams))
        return seg
    except Exception as e:
        logger.warning("could not load word segmenter (%s)", e)
        return None
