"""English grapheme-to-phoneme conversion (ARPAbet, stress-marked).

Capability parity with the reference's English pipeline
(``genie_tts/G2P/English/EnglishG2P.py``): text
normalization -> per-word pronunciation via (1) a CMU-style dictionary
loaded from the GenieData assets when present, (2) possessive/suffix
fallbacks, (3) a self-contained rule-based letter-to-sound transducer for
out-of-vocabulary words (standing in for the reference's NumPy GRU
seq2seq, which depends on a downloadable checkpoint).

Dictionary format accepted: classic ``cmudict.dict`` lines
(``word  P1 P2 ...``, lowercase or uppercase head, ``(2)`` variants
ignored).
"""
from __future__ import annotations

import logging
import re
from functools import lru_cache
from typing import Dict, List, Optional

from ..config import english_g2p_dir
from .normalize_en import normalize_english
from .symbols import phones_to_ids

logger = logging.getLogger(__name__)

_PUNCT_KEEP = {".", "!", "?", ",", "…", "-"}
_WORD_RE = re.compile(r"[a-z']+|[.!?,…\-]")


# ---------------------------------------------------------------------------
# Dictionary
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _load_dict() -> Dict[str, List[str]]:
    d: Dict[str, List[str]] = {}
    root = english_g2p_dir()
    for name in ("cmudict.dict", "cmudict.rep", "engdict.rep", "engdict-hot.rep"):
        p = root / name
        if not p.exists():
            continue
        try:
            for line in p.read_text(encoding="utf-8", errors="ignore").splitlines():
                line = line.strip()
                if not line or line.startswith(";;;"):
                    continue
                parts = line.split()
                word = parts[0].lower()
                if "(" in word:  # alternate pronunciations: keep the first
                    continue
                d[word] = parts[1:]
        except OSError:
            continue
    if d:
        logger.info("English dictionary loaded: %d entries", len(d))
    return d


# ---------------------------------------------------------------------------
# Rule-based letter-to-sound fallback (context-sensitive rules)
# ---------------------------------------------------------------------------

# (pattern at current position, phones, advance). Longest match wins;
# applied left-to-right. A compact ruleset covering common orthography.
_LTS_RULES = [
    ("tion", ["SH", "AH0", "N"]), ("sion", ["ZH", "AH0", "N"]),
    ("ought", ["AO1", "T"]), ("aught", ["AO1", "T"]),
    ("igh", ["AY1"]), ("eigh", ["EY1"]), ("ough", ["AO1"]),
    ("tch", ["CH"]), ("dge", ["JH"]), ("sch", ["S", "K"]),
    ("ck", ["K"]), ("ch", ["CH"]), ("sh", ["SH"]), ("th", ["TH"]),
    ("ph", ["F"]), ("wh", ["W"]), ("gh", ["G"]), ("ng", ["NG"]),
    ("qu", ["K", "W"]), ("wr", ["R"]), ("kn", ["N"]), ("gn", ["N"]),
    ("oo", ["UW1"]), ("ee", ["IY1"]), ("ea", ["IY1"]), ("ai", ["EY1"]),
    ("ay", ["EY1"]), ("oa", ["OW1"]), ("ow", ["OW1"]), ("ou", ["AW1"]),
    ("oi", ["OY1"]), ("oy", ["OY1"]), ("au", ["AO1"]), ("aw", ["AO1"]),
    ("ew", ["UW1"]), ("ue", ["UW1"]), ("ie", ["IY1"]), ("ei", ["EY1"]),
    ("ar", ["AA1", "R"]), ("er", ["ER0"]), ("ir", ["ER1"]),
    ("or", ["AO1", "R"]), ("ur", ["ER1"]),
    ("a", ["AE1"]), ("b", ["B"]), ("c", ["K"]), ("d", ["D"]),
    ("e", ["EH1"]), ("f", ["F"]), ("g", ["G"]), ("h", ["HH"]),
    ("i", ["IH1"]), ("j", ["JH"]), ("k", ["K"]), ("l", ["L"]),
    ("m", ["M"]), ("n", ["N"]), ("o", ["AA1"]), ("p", ["P"]),
    ("q", ["K"]), ("r", ["R"]), ("s", ["S"]), ("t", ["T"]),
    ("u", ["AH1"]), ("v", ["V"]), ("w", ["W"]), ("x", ["K", "S"]),
    ("y", ["IY0"]), ("z", ["Z"]), ("'", []),
]
_LTS_RULES.sort(key=lambda r: -len(r[0]))

_VOWEL_PHONES = re.compile(r"^(AA|AE|AH|AO|AW|AY|EH|ER|EY|IH|IY|OW|OY|UH|UW)")


def _soft_c_g(word: str, i: int, phones: List[str]) -> Optional[List[str]]:
    nxt = word[i + 1] if i + 1 < len(word) else ""
    if word[i] == "c" and nxt in "eiy":
        return ["S"]
    if word[i] == "g" and nxt in "eiy":
        return ["JH"]
    return None


def rule_g2p(word: str) -> List[str]:
    """Rule-based fallback for OOV words."""
    word = word.lower()
    phones: List[str] = []
    i = 0
    # final silent 'e' (make, time) with magic-e vowel lengthening
    magic_e = (len(word) >= 3 and word.endswith("e")
               and word[-2] not in "aeiou" and word[-3] in "aeiou")
    body = word[:-1] if magic_e else word
    long_map = {"a": ["EY1"], "e": ["IY1"], "i": ["AY1"], "o": ["OW1"], "u": ["UW1"]}
    while i < len(body):
        special = _soft_c_g(body, i, phones)
        if special is not None:
            phones.extend(special)
            i += 1
            continue
        for pat, ph in _LTS_RULES:
            if body.startswith(pat, i):
                if (magic_e and len(pat) == 1 and pat in long_map
                        and i == len(body) - 2):
                    phones.extend(long_map[pat])
                else:
                    phones.extend(ph)
                i += len(pat)
                break
        else:
            i += 1
    return phones


# ---------------------------------------------------------------------------
# Homograph disambiguation (reference uses nltk POS tagging,
# EnglishG2P.py homograph path; here: POS when nltk data is present, else a
# determiner/infinitive context heuristic over the noun/verb stress pairs)
# ---------------------------------------------------------------------------

# word -> (noun/adjective pronunciation, verb pronunciation)
_HOMOGRAPHS: Dict[str, tuple] = {
    "read": (["R", "IY1", "D"], ["R", "IY1", "D"]),  # past tense handled below
    "lead": (["L", "EH1", "D"], ["L", "IY1", "D"]),
    "live": (["L", "AY1", "V"], ["L", "IH1", "V"]),
    "wind": (["W", "IH1", "N", "D"], ["W", "AY1", "N", "D"]),
    "tear": (["T", "IH1", "R"], ["T", "EH1", "R"]),
    "bow": (["B", "OW1"], ["B", "AW1"]),
    "close": (["K", "L", "OW1", "S"], ["K", "L", "OW1", "Z"]),
    "use": (["Y", "UW1", "S"], ["Y", "UW1", "Z"]),
    "record": (["R", "EH1", "K", "ER0", "D"], ["R", "IH0", "K", "AO1", "R", "D"]),
    "present": (["P", "R", "EH1", "Z", "AH0", "N", "T"],
                ["P", "R", "IH0", "Z", "EH1", "N", "T"]),
    "object": (["AA1", "B", "JH", "EH0", "K", "T"],
               ["AH0", "B", "JH", "EH1", "K", "T"]),
    "project": (["P", "R", "AA1", "JH", "EH0", "K", "T"],
                ["P", "R", "AH0", "JH", "EH1", "K", "T"]),
    "produce": (["P", "R", "OW1", "D", "UW0", "S"],
                ["P", "R", "AH0", "D", "UW1", "S"]),
    "conduct": (["K", "AA1", "N", "D", "AH0", "K", "T"],
                ["K", "AH0", "N", "D", "AH1", "K", "T"]),
    "content": (["K", "AA1", "N", "T", "EH0", "N", "T"],
                ["K", "AH0", "N", "T", "EH1", "N", "T"]),
    "contract": (["K", "AA1", "N", "T", "R", "AE0", "K", "T"],
                 ["K", "AH0", "N", "T", "R", "AE1", "K", "T"]),
    "permit": (["P", "ER1", "M", "IH0", "T"], ["P", "ER0", "M", "IH1", "T"]),
    "subject": (["S", "AH1", "B", "JH", "EH0", "K", "T"],
                ["S", "AH0", "B", "JH", "EH1", "K", "T"]),
    "desert": (["D", "EH1", "Z", "ER0", "T"], ["D", "IH0", "Z", "ER1", "T"]),
    "refuse": (["R", "EH1", "F", "Y", "UW0", "S"],
               ["R", "IH0", "F", "Y", "UW1", "Z"]),
    "increase": (["IH1", "N", "K", "R", "IY0", "S"],
                 ["IH0", "N", "K", "R", "IY1", "S"]),
    "progress": (["P", "R", "AA1", "G", "R", "EH0", "S"],
                 ["P", "R", "AH0", "G", "R", "EH1", "S"]),
    "import": (["IH1", "M", "P", "AO0", "R", "T"],
               ["IH0", "M", "P", "AO1", "R", "T"]),
    "export": (["EH1", "K", "S", "P", "AO0", "R", "T"],
               ["IH0", "K", "S", "P", "AO1", "R", "T"]),
}

_VERB_CUES = frozenset({
    "to", "will", "would", "can", "could", "shall", "should", "may", "might",
    "must", "do", "does", "did", "don't", "doesn't", "didn't", "i", "we",
    "you", "they", "please",
})
_NOUN_CUES = frozenset({
    "the", "a", "an", "this", "that", "these", "those", "my", "your", "his",
    "her", "its", "our", "their", "no", "some", "any", "each", "every",
})


def _nltk_pos(tokens: List[str], idx: int) -> Optional[str]:
    """POS via nltk when its tagger data is installed; None otherwise."""
    try:
        import nltk

        tags = nltk.pos_tag(tokens)
        return tags[idx][1]
    except Exception:
        return None


def disambiguate_homograph(word: str, prev: Optional[str] = None,
                           ctx=None) -> Optional[List[str]]:
    """Context-sensitive pronunciation for a homograph, or None.

    ``ctx``: optional (tokens, index) — the full sentence token list and
    this word's position. Resolution order: (1) the special table
    (read/lead/live/wind/... — splits nltk's 2-token tagging could never
    see), (2) nltk's tagger when its data is installed (reference parity,
    ``EnglishG2P.py:240``), (3) the offline POS-lite classifier
    (frontend/pos_lite.py) — no silent degradation without nltk data.
    """
    from . import pos_lite

    if ctx is not None:
        tokens, idx = ctx
    else:
        tokens = [prev, word] if prev else [word]
        idx = len(tokens) - 1
    special = pos_lite.special_homograph(word, tokens, idx)
    if special is not None:
        return special
    pair = _HOMOGRAPHS.get(word)
    if pair is None:
        return None
    noun_pron, verb_pron = pair
    tag = _nltk_pos(list(tokens), idx)
    if tag is not None:
        return verb_pron if tag.startswith("VB") else noun_pron
    return verb_pron if pos_lite.is_verb(tokens, idx) else noun_pron


# ---------------------------------------------------------------------------
# Word lookup with fallbacks
# ---------------------------------------------------------------------------

def word_to_phones(word: str, prev: Optional[str] = None,
                   ctx=None) -> List[str]:
    homograph = disambiguate_homograph(word.lower(), prev, ctx=ctx)
    if homograph is not None:
        return list(homograph)
    return _word_to_phones_nohg(word)


def _word_to_phones_nohg(word: str) -> List[str]:
    """Fallback chain mirroring the reference ``_query_word``
    (``EnglishG2P.py:255-279``): dict -> possessive -> hyphen ->
    corpus word segmentation -> neural GRU -> rule LTS."""
    d = _load_dict()
    w = word.lower()
    if w in d:
        return list(d[w])
    # possessive: word's -> word + AH0 Z / S / Z by final phone class
    if w.endswith("'s") and len(w) > 2:
        base = _word_to_phones_nohg(w[:-2])
        if base:
            last = base[-1]
            if last in {"S", "Z", "SH", "ZH", "CH", "JH"}:
                return base + ["AH0", "Z"]
            if last in {"P", "T", "K", "F", "TH"}:
                return base + ["S"]
            return base + ["Z"]
    # plural strip (dictionary-backed only)
    if w.endswith("s") and w[:-1] in d:
        base = list(d[w[:-1]])
        tail = "S" if base and base[-1] in {"P", "T", "K", "F", "TH"} else "Z"
        return base + [tail]
    # hyphen/compound split
    if "-" in w:
        out: List[str] = []
        for part in w.split("-"):
            if part:
                out.extend(word_to_phones(part))
        return out
    # concatenated words: corpus-statistics segmentation (helloworld)
    from .g2p_en_nn import neural_g2p, word_segmenter

    if len(w) > 3 and w.isalpha():
        seg = word_segmenter()
        if seg is not None:
            parts = seg.segment(w)
            if len(parts) > 1 and "".join(parts) == w:
                out = []
                for part in parts:
                    out.extend(_word_to_phones_nohg(part))
                if out:
                    return out
    # neural OOV model (the reference's NumPy GRU seq2seq)
    nn = neural_g2p()
    if nn is not None:
        pron = [("UNK" if p == "<unk>" else p) for p in nn.predict(w)
                if p not in {"<pad>", "<s>", "</s>", " ", "UW"}]
        if pron:
            return pron
    return rule_g2p(w)


def english_to_phone_strs(text: str) -> List[str]:
    text = normalize_english(text.lower())
    toks = _WORD_RE.findall(text)
    # sentence-level token context for homograph disambiguation
    # (punctuation tokens stay in place — neighbors matter, and a comma
    # matching no lexicon set is the right neutral signal)
    words = [t if t in _PUNCT_KEEP else t.strip("'") for t in toks]
    phones: List[str] = []
    prev: Optional[str] = None
    for i, tok in enumerate(toks):
        if tok in _PUNCT_KEEP:
            phones.append(tok)
            prev = None
        elif tok.strip("'"):
            word = tok.strip("'")
            phones.extend(word_to_phones(word, prev=prev, ctx=(words, i)))
            prev = word
    return phones


def english_to_phones(text: str) -> List[int]:
    return phones_to_ids(english_to_phone_strs(text))
