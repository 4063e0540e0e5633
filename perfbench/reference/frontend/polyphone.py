"""Context-sensitive polyphone resolution for Chinese OOV characters.

The reference disambiguates per-character pinyin with g2pM — a trained
neural classifier run over the whole sentence
(``genie_tts/G2P/Chinese/ChineseG2P.py:7,32,127``) —
then applies word-level corrections. g2pM's training data cannot be
shipped here, so this module re-owns the *capability* with a curated
decision-list model (``data/polyphone_model.json``): for each
high-frequency polyphonic hanzi, candidate readings carry lexical
evidence (aligned word cues that may cross jieba's word boundary,
neighbor-character cues, POS-prefix cues) and a frequency-default
reading. Resolution is deterministic and auditable — every prediction
can be traced to the cue that fired.

Priority in the pipeline (g2p_zh.py): word-pinyin dictionary (GenieData
``pinyin_words.tsv`` + seed) > this model > first dictionary reading.
The polyphone-correction table (``correct_pronunciation``) still applies
afterwards, exactly like the reference's CorrectPronunciation pass.

Tier order within the model, mirroring how g2pM's features weight
evidence (lexical identity >> local context >> syntax >> prior):

1. aligned word cue — the longest cue word that overlaps this character
   occurrence in the *sentence* (not just the segmented word, so cues
   survive segmentation mistakes);
2. neighbor cue — the immediate left/right sentence character;
3. POS cue — prefix match on the jieba POS tag of the containing word
   (e.g. ``u*`` particles: 地/得/着 read de5/de5/zhe5);
4. default reading.
"""
from __future__ import annotations

import json
import logging
from functools import lru_cache
from importlib import resources
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@lru_cache(maxsize=1)
def _model() -> Dict[str, dict]:
    with resources.files(__package__ + ".data").joinpath(
            "polyphone_model.json").open("r", encoding="utf-8") as f:
        model = json.load(f)
    # index word cues as (cue, char_offset, reading), longest cue first,
    # so prediction is a scan over pre-aligned candidates
    for ch, entry in model.items():
        cues: List[Tuple[str, int, str]] = []
        for reading, ev in entry.get("r", {}).items():
            for w in ev.get("w", ()):
                start = 0
                while True:
                    k = w.find(ch, start)
                    if k < 0:
                        break
                    cues.append((w, k, reading))
                    start = k + 1
        cues.sort(key=lambda c: -len(c[0]))
        entry["_cues"] = cues
    return model


def is_polyphonic(ch: str) -> bool:
    return ch in _model()


def readings(ch: str) -> List[str]:
    entry = _model().get(ch)
    if not entry:
        return []
    out = [entry["d"]]
    out.extend(r for r in entry.get("r", {}) if r != entry["d"])
    return out


def predict(ch: str, sent: str, i: int, pos: str = "") -> Optional[str]:
    """Reading of ``sent[i]`` (== ``ch``) in context, or None.

    ``pos``: jieba POS tag of the word containing the char ("" if
    unknown). The sentence should be the normalized sub-sentence the
    G2P pipeline is walking; cues never match across its boundary.
    """
    entry = _model().get(ch)
    if entry is None:
        return None
    # tier 1: aligned word cues (longest first)
    for cue, k, reading in entry["_cues"]:
        start = i - k
        if start >= 0 and sent.startswith(cue, start):
            return reading
    # tier 2: neighbor-character cues
    left = sent[i - 1] if i > 0 else ""
    right = sent[i + 1] if i + 1 < len(sent) else ""
    for reading, ev in entry.get("r", {}).items():
        if left and left in ev.get("l", ()):
            return reading
        if right and right in ev.get("x", ()):
            return reading
    # tier 3: POS-prefix cues
    for prefix, reading in entry.get("p", {}).items():
        if pos.startswith(prefix):
            return reading
    return entry["d"]
