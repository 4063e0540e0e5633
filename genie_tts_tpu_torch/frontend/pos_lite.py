"""Offline homograph disambiguation (POS-lite).

The reference resolves English homographs with nltk's perceptron tagger
(``genie_tts/G2P/English/EnglishG2P.py:9,240``) and
hard-depends on its downloaded model data. This module is the offline
replacement: a compact rule-based classifier over a closed-class lexicon
(determiners, modals, pronouns, prepositions, auxiliaries) plus per-word
cue rules for the homographs whose split is not noun-vs-verb stress
(read/lead/live/wind/tear/bow/bass/wound/close/use/house). No model
data, no downloads — g2p_en falls back here whenever nltk's tagger data
is absent, instead of silently degrading to a prev-word-only guess.

The classifier answers one narrow question — "is THIS homograph token
acting as a verb here?" — which needs far less machinery than full POS
tagging: homographs sit in noun-or-verb slots, and the immediate left
and right neighbors carry the signal (a determiner/preposition to the
left marks a nominal; a modal/subject-pronoun/"to" marks a verb; a
determiner to the RIGHT marks a transitive verb reading).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

SUBJ_PRONOUNS = frozenset({"i", "we", "you", "they", "he", "she", "it",
                           "who", "people"})
OBJ_PRONOUNS = frozenset({"me", "us", "him", "her", "them", "it"})
MODALS = frozenset({
    "will", "would", "can", "could", "shall", "should", "may", "might",
    "must", "do", "does", "did", "don't", "doesn't", "didn't", "won't",
    "can't", "cannot", "couldn't", "shouldn't", "wouldn't", "to",
    "please", "let's", "gonna", "not", "never", "always", "often",
    "usually", "sometimes", "rarely",
})
DET_ADJ = frozenset({  # determiners + frequent prenominal adjectives
    "the", "a", "an", "this", "that", "these", "those", "my", "your",
    "his", "her", "its", "our", "their", "no", "some", "any", "each",
    "every", "another", "such", "what", "which", "whose", "one", "two",
    "three", "first", "second", "new", "old", "good", "bad", "big",
    "small", "broken", "strong", "heavy", "public", "official",
})
PREPOSITIONS = frozenset({
    "of", "in", "on", "at", "by", "for", "with", "from", "about", "over",
    "under", "after", "before", "during", "without", "into", "onto",
    "against", "between", "through", "per",
})
BE_AUX = frozenset({"is", "are", "was", "were", "am", "be", "been",
                    "being", "'s", "'re", "'m", "seems", "looks",
                    "stays", "went", "goes"})
HAVE_AUX = frozenset({"have", "has", "had", "having", "'ve", "'d"})
PAST_CUES = frozenset({"yesterday", "ago", "last", "already", "earlier",
                       "once", "previously", "recently"})


def _tok(tokens: Sequence[str], i: int) -> str:
    return tokens[i].lower() if 0 <= i < len(tokens) else ""


def is_verb(tokens: Sequence[str], i: int) -> bool:
    """Generic noun-vs-verb call for a stress-pair homograph at ``i``."""
    prev, prev2, nxt = _tok(tokens, i - 1), _tok(tokens, i - 2), _tok(tokens, i + 1)
    verb = noun = 0
    if prev in MODALS:
        verb += 2
    if prev in SUBJ_PRONOUNS:
        verb += 2
    if prev in MODALS and prev2 in SUBJ_PRONOUNS:
        verb += 1
    if nxt in DET_ADJ or nxt in OBJ_PRONOUNS:
        verb += 1                      # transitive reading: "record the data"
    if prev in DET_ADJ:
        noun += 2
    if prev in PREPOSITIONS:
        noun += 2
    if prev in BE_AUX and nxt in ("of", "to", ""):
        noun += 1                      # predicative nominal: "is a record of"
    if nxt in BE_AUX:
        noun += 2                      # subject position: "the permit is"
    return verb > noun


def _has_any(tokens: Sequence[str], words: frozenset) -> bool:
    return any(t.lower() in words for t in tokens)


# -- special (non-stress-pair) homographs -----------------------------------

def read_class(tokens: Sequence[str], i: int) -> str:
    """'read': present R IY1 D vs past/participle R EH1 D."""
    prev, prev2 = _tok(tokens, i - 1), _tok(tokens, i - 2)
    if prev in HAVE_AUX or prev2 in HAVE_AUX:
        return "past"                  # "have read", "had just read"
    if prev in ("was", "were", "been", "is", "are", "being"):
        return "past"                  # passive: "the book was read"
    if prev in MODALS or prev == "to":
        return "present"
    if _has_any(tokens, PAST_CUES):
        return "past"
    return "present"


def live_class(tokens: Sequence[str], i: int) -> str:
    """'live': verb L IH1 V vs adjective/adverb L AY1 V."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt in ("music", "show", "stream", "broadcast", "concert",
               "audience", "performance", "tv", "coverage", "wire",
               "ammunition"):
        return "adj"
    if prev in BE_AUX or prev == "gone":
        return "adj"                   # "the show is live"
    return "verb"                      # "they live in tokyo"


def wind_class(tokens: Sequence[str], i: int) -> str:
    """'wind': noun W IH1 N D vs verb W AY1 N D."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt in ("up", "down", "around", "through"):
        return "verb"                  # "wind up the clock"
    if prev in MODALS and prev != "not":
        return "verb"
    return "noun"                      # "the wind", "strong wind"


def lead_class(tokens: Sequence[str], i: int) -> str:
    """'lead': L IY1 D (verb/leader) vs the metal L EH1 D."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt in ("pipe", "pipes", "paint", "poisoning", "acid", "battery",
               "shielding", "content", "levels"):
        return "metal"
    if prev in ("molten", "heavy"):
        return "metal"
    # sentence-wide material cues: "the pipe is made of lead"
    if _has_any(tokens, frozenset({"pipe", "pipes", "paint", "poisoning",
                                   "metal", "poison", "toxic", "exposure",
                                   "pencil", "solder"})):
        return "metal"
    return "verb"


def tear_class(tokens: Sequence[str], i: int) -> str:
    """'tear': rip T EH1 R vs teardrop T IH1 R."""
    nxt = _tok(tokens, i + 1)
    if nxt in ("rolled", "fell", "ran", "drop", "drops", "gas") or \
            _has_any(tokens, frozenset({"eye", "eyes", "cry", "crying",
                                        "wept", "shed", "cheek", "cheeks"})):
        return "drop"
    return "rip"                       # "tear it up", "a tear in the fabric"


def bow_class(tokens: Sequence[str], i: int) -> str:
    """'bow': bend B AW1 vs archery/ribbon B OW1."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt in ("tie", "ties", "and") or \
            _has_any(tokens, frozenset({"arrow", "arrows", "ribbon",
                                        "violin", "string", "hair"})):
        return "knot"
    if prev in MODALS or prev in SUBJ_PRONOUNS or nxt in ("down", "before",
                                                          "to", "out"):
        return "bend"                  # "they bow to the audience"
    if _has_any(tokens, frozenset({"ship", "boat", "deck"})):
        return "bend"                  # ship's bow is also B AW1
    return "knot"


def bass_class(tokens: Sequence[str], i: int) -> str:
    """'bass': music B EY1 S vs the fish B AE1 S."""
    if _has_any(tokens, frozenset({"fish", "fishing", "lake", "caught",
                                   "catch", "river", "sea", "striped"})):
        return "fish"
    return "music"


def wound_class(tokens: Sequence[str], i: int) -> str:
    """'wound': injury W UW1 N D vs wind-past W AW1 N D."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt in ("up", "down", "around", "through") or prev in HAVE_AUX:
        return "coiled"                # "wound up", "had wound"
    return "injury"


def close_class(tokens: Sequence[str], i: int) -> str:
    """'close': verb K L OW1 Z vs adjective K L OW1 S."""
    prev, nxt = _tok(tokens, i - 1), _tok(tokens, i + 1)
    if nxt == "to" or prev in ("so", "too", "very", "how", "quite"):
        return "adj"                   # "close to the station"
    if prev in BE_AUX and nxt != "":
        return "adj"
    return "verb"                      # "close the door"


def use_class(tokens: Sequence[str], i: int) -> str:
    """'use': verb Y UW1 Z vs noun Y UW1 S."""
    return "verb" if is_verb(tokens, i) else "noun"


def house_class(tokens: Sequence[str], i: int) -> str:
    """'house': noun HH AW1 S vs verb HH AW1 Z."""
    return "verb" if is_verb(tokens, i) else "noun"


SPECIAL_CLASSIFIERS = {
    "read": read_class, "live": live_class, "wind": wind_class,
    "lead": lead_class, "tear": tear_class, "bow": bow_class,
    "bass": bass_class, "wound": wound_class, "close": close_class,
    "use": use_class, "house": house_class,
}

# pronunciation per class (ARPAbet, stress-marked like CMUdict)
SPECIAL_PRONS = {
    "read": {"present": ["R", "IY1", "D"], "past": ["R", "EH1", "D"]},
    "live": {"verb": ["L", "IH1", "V"], "adj": ["L", "AY1", "V"]},
    "wind": {"noun": ["W", "IH1", "N", "D"],
             "verb": ["W", "AY1", "N", "D"]},
    "lead": {"verb": ["L", "IY1", "D"], "metal": ["L", "EH1", "D"]},
    "tear": {"rip": ["T", "EH1", "R"], "drop": ["T", "IH1", "R"]},
    "bow": {"bend": ["B", "AW1"], "knot": ["B", "OW1"]},
    "bass": {"music": ["B", "EY1", "S"], "fish": ["B", "AE1", "S"]},
    "wound": {"injury": ["W", "UW1", "N", "D"],
              "coiled": ["W", "AW1", "N", "D"]},
    "close": {"verb": ["K", "L", "OW1", "Z"],
              "adj": ["K", "L", "OW1", "S"]},
    "use": {"verb": ["Y", "UW1", "Z"], "noun": ["Y", "UW1", "S"]},
    "house": {"noun": ["HH", "AW1", "S"], "verb": ["HH", "AW1", "Z"]},
}


def special_homograph(word: str, tokens: Sequence[str],
                      i: int) -> Optional[List[str]]:
    """Pronunciation for a special homograph in context, or None."""
    cls_fn = SPECIAL_CLASSIFIERS.get(word)
    if cls_fn is None:
        return None
    return list(SPECIAL_PRONS[word][cls_fn(tokens, i)])
