"""Japanese grapheme-to-phoneme conversion.

Produces OpenJTalk-style phones plus prosody marks in the GPT-SoVITS V2
symbol inventory (``#``/``[``/``]``/``?``/``$``/``_`` prosody symbols,
romaji phones ``a i u e o k s t n ... ky sh ch ts cl N``).

Two backends:

* **pyopenjtalk** (full): morphological analysis of arbitrary Japanese
  (kanji included) via full-context HTS labels, with pitch-accent prosody
  marks. Behavioral parity target:
  ``genie_tts/G2P/Japanese/JapaneseG2P.py:64-150``.
* **kana fallback** (pure Python, always available): direct kana-to-phone
  transliteration for hiragana/katakana text. No pitch-accent marks are
  emitted (OpenJTalk's accent dictionary is required for those); kanji
  characters are dropped with a warning. Used when pyopenjtalk is not
  installed so the framework stays importable and testable everywhere.

The text pipeline (both backends): normalize -> split into Japanese runs /
punctuation runs -> phonemize runs -> re-interleave punctuation -> map
fullwidth punctuation to vocabulary symbols.
"""
from __future__ import annotations

import logging
import re
from typing import List, Optional

from .symbols import phones_to_ids

logger = logging.getLogger(__name__)

try:  # optional native backend
    import pyopenjtalk  # type: ignore

    _HAS_OPENJTALK = True
except Exception:  # pragma: no cover - environment without pyopenjtalk
    pyopenjtalk = None
    _HAS_OPENJTALK = False

# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------

_REPEAT_PUNCT_RE = re.compile(r"([,./?!~…・])\1+")
_PERCENT_RE = re.compile(r"[%％]")

# Japanese content characters: kanji, kana, 々, fullwidth alnum, halfwidth kana.
_JA_CHAR = (
    r"A-Za-z\d々぀-ヿ一-鿿"
    r"１-９Ａ-Ｚａ-ｚｦ-ﾝ"
)
_JA_RUN_RE = re.compile(f"[{_JA_CHAR}]+")
_MARK_RUN_RE = re.compile(f"[^{_JA_CHAR}]+")

_FULLWIDTH_PUNCT = {
    "：": ",", "；": ",", "，": ",", "。": ".",
    "！": "!", "？": "?", "\n": ".", "·": ",",
    "、": ",", "...": "…",
}


def normalize_ja(text: str) -> str:
    text = _PERCENT_RE.sub("パーセント", text)
    text = _REPEAT_PUNCT_RE.sub(r"\1", text)
    return text.lower()


# ---------------------------------------------------------------------------
# Kana fallback backend
# ---------------------------------------------------------------------------

# Base kana -> phone sequence (hiragana keys; katakana normalized to hiragana).
_KANA_BASE = {
    "あ": "a", "い": "i", "う": "u", "え": "e", "お": "o",
    "か": "k a", "き": "k i", "く": "k u", "け": "k e", "こ": "k o",
    "さ": "s a", "し": "sh i", "す": "s u", "せ": "s e", "そ": "s o",
    "た": "t a", "ち": "ch i", "つ": "ts u", "て": "t e", "と": "t o",
    "な": "n a", "に": "n i", "ぬ": "n u", "ね": "n e", "の": "n o",
    "は": "h a", "ひ": "h i", "ふ": "f u", "へ": "h e", "ほ": "h o",
    "ま": "m a", "み": "m i", "む": "m u", "め": "m e", "も": "m o",
    "や": "y a", "ゆ": "y u", "よ": "y o",
    "ら": "r a", "り": "r i", "る": "r u", "れ": "r e", "ろ": "r o",
    "わ": "w a", "ゐ": "i", "ゑ": "e", "を": "o", "ん": "N",
    "が": "g a", "ぎ": "g i", "ぐ": "g u", "げ": "g e", "ご": "g o",
    "ざ": "z a", "じ": "j i", "ず": "z u", "ぜ": "z e", "ぞ": "z o",
    "だ": "d a", "ぢ": "j i", "づ": "z u", "で": "d e", "ど": "d o",
    "ば": "b a", "び": "b i", "ぶ": "b u", "べ": "b e", "ぼ": "b o",
    "ぱ": "p a", "ぴ": "p i", "ぷ": "p u", "ぺ": "p e", "ぽ": "p o",
    "ゔ": "v u",
    "ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o",
    "ゎ": "w a", "っ": "cl",
}

# Palatalized digraphs: consonant kana + small ya/yu/yo.
_PALATAL_ONSET = {
    "き": "ky", "ぎ": "gy", "し": "sh", "じ": "j", "ち": "ch", "ぢ": "j",
    "に": "ny", "ひ": "hy", "び": "by", "ぴ": "py", "み": "my", "り": "ry",
    "け": "ky", "て": "ty",
}
_SMALL_Y = {"ゃ": "a", "ゅ": "u", "ょ": "o"}
# Foreign-sound digraphs: kana + small vowel.
_SMALL_VOWEL = {"ぁ": "a", "ぃ": "i", "ぅ": "u", "ぇ": "e", "ぉ": "o"}
_FOREIGN_ONSET = {
    "ふ": "f", "う": "w", "ゔ": "v", "て": "t", "で": "d", "と": "t", "ど": "d",
    "つ": "ts", "ち": "ch", "し": "sh", "じ": "j",
}

_VOWELS = frozenset("aiueo")

# Fallback-mode lexical exceptions: the topic particle は reads "wa". Full
# particle detection needs morphology (pyopenjtalk); hardcode frequent
# greetings so the kana path reads them naturally.
_KANA_LEXICAL = [
    ("こんにちは", "こんにちわ"), ("こんばんは", "こんばんわ"),
    ("コンニチハ", "コンニチワ"), ("コンバンハ", "コンバンワ"),
    # では is overwhelmingly the particle combination (copula では/
    # location-topic では); as word-internal kana it is rare
    ("では", "でわ"),
]


def _to_hiragana(ch: str) -> str:
    code = ord(ch)
    if 0x30A1 <= code <= 0x30F6:  # katakana -> hiragana
        return chr(code - 0x60)
    return ch


_warned_kanji = False


class UnreadableJapaneseError(ValueError):
    """Raised when the kana fallback meets kanji it cannot read.

    The reference always has pyopenjtalk (``JapaneseG2P.py:6``) so this
    cannot happen there; silently dropping kanji would synthesize wrong
    audio, so without pyopenjtalk the failure must be loud. Servers map
    this to HTTP 400."""


def _is_kanji(ch: str) -> bool:
    cp = ord(ch)
    return (0x3400 <= cp <= 0x4DBF or 0x4E00 <= cp <= 0x9FFF
            or 0xF900 <= cp <= 0xFAFF or 0x20000 <= cp <= 0x2FA1F)


_JA_READINGS = None


def _load_readings():
    """(words, chars, accents, max_word_len) from the bundled reading
    lexicon (data/ja_readings.json — the JA analogue of
    data/pinyin_seed.json). ``accents`` maps a subset of the words to
    their standard Tokyo pitch-accent type (mora index of the accent
    nucleus, 0 = heiban); words without an entry synthesize heiban."""
    global _JA_READINGS
    if _JA_READINGS is None:
        import json
        from pathlib import Path

        path = Path(__file__).resolve().parent / "data" / "ja_readings.json"
        d = json.loads(path.read_text(encoding="utf-8"))
        words, chars = d["words"], d["chars"]
        _JA_READINGS = (words, chars, d.get("accents", {}),
                        max(map(len, words)))
    return _JA_READINGS


def kanji_to_kana(text: str) -> str:
    """Offline kanji -> kana via the bundled lexicon (longest match).

    Word entries win over per-character fallbacks; the 々 iteration mark
    repeats the previous character's reading; は/へ directly after a
    kanji are read as the topic/direction particles (わ/え) — the usual
    case when morphology is unavailable. Raises
    :class:`UnreadableJapaneseError` listing any kanji outside the
    lexicon (pyopenjtalk reads those; silently dropping them would
    synthesize wrong audio).
    """
    return _kanji_to_kana_spans(text)[0]


def _kanji_to_kana_spans(text: str):
    """:func:`kanji_to_kana` plus accent-phrase spans.

    Returns ``(kana, spans)`` where ``spans`` is a sorted list of
    ``(kana_start_index, accent_type_or_None)`` — one entry per lexicon
    *word* match (the fallback's stand-in for a content word). Particles
    and okurigana after a word extend its phrase, which is what makes an
    odaka word + particle fall correctly (e.g. 花が -> はな]が).
    Per-character readings of unknown compounds do NOT open new phrases
    (char-by-char phrase breaks would shred the contour)."""
    words, chars, accents, maxlen = _load_readings()
    out: List[str] = []
    spans: List[tuple] = []
    pos = 0
    unreadable = set()
    last_char_reading = ""
    i, n = 0, len(text)
    while i < n:
        ch = text[i]
        matched = False
        if _is_kanji(ch) or (i + 1 < n and _is_kanji(text[i + 1])):
            for L in range(min(maxlen, n - i), 1, -1):
                w = text[i:i + L]
                if w in words and any(_is_kanji(c) for c in w):
                    spans.append((pos, accents.get(w)))
                    out.append(words[w])
                    pos += len(words[w])
                    last_char_reading = ""
                    i += L
                    matched = True
                    break
        if matched:
            continue
        if ch == "々" and last_char_reading:
            out.append(last_char_reading)
            pos += len(last_char_reading)
            i += 1
            continue
        if _is_kanji(ch):
            r = words.get(ch)
            if r is not None:               # single-kanji content word
                spans.append((pos, accents.get(ch)))
            else:
                r = chars.get(ch)
            if r is None:
                unreadable.add(ch)
            else:
                out.append(r)
                pos += len(r)
                last_char_reading = r
            i += 1
            continue
        last_char_reading = ""
        if ch == "は" and i > 0 and _is_kanji(text[i - 1]):
            out.append("わ")                  # topic particle after a noun
        elif ch == "へ" and i > 0 and _is_kanji(text[i - 1]):
            out.append("え")                  # direction particle
        else:
            out.append(ch)
        pos += 1
        i += 1
    if unreadable:
        raise UnreadableJapaneseError(
            f"Japanese text contains kanji {''.join(sorted(unreadable)[:10])!r} "
            "outside the bundled reading lexicon and pyopenjtalk is not "
            "installed. Install pyopenjtalk-plus for full Japanese support, "
            "or supply kana/romaji text.")
    return "".join(out), spans


def _kana_to_morae(chars: List[str]) -> List[tuple]:
    """Hiragana characters -> morae as ``(char_index, [phones])``.

    One mora per (C)V unit, palatal/foreign digraph, っ (``cl``), ん
    (``N``) or long-vowel mark; unknown symbols are dropped with a
    one-time warning. The char index lets accent-phrase spans (kana
    string offsets) map onto mora positions."""
    global _warned_kanji
    morae: List[tuple] = []
    i = 0
    while i < len(chars):
        ch = chars[i]
        nxt = chars[i + 1] if i + 1 < len(chars) else ""
        if ch in _PALATAL_ONSET and nxt in _SMALL_Y:
            morae.append((i, [_PALATAL_ONSET[ch], _SMALL_Y[nxt]]))
            i += 2
            continue
        if ch in _FOREIGN_ONSET and nxt in _SMALL_VOWEL:
            morae.append((i, [_FOREIGN_ONSET[ch], _SMALL_VOWEL[nxt]]))
            i += 2
            continue
        if ch == "ー":  # long-vowel mark: repeat previous vowel
            if morae and morae[-1][1][-1] in _VOWELS:
                morae.append((i, [morae[-1][1][-1]]))
            i += 1
            continue
        seq = _KANA_BASE.get(ch)
        if seq is not None:
            morae.append((i, seq.split()))
        elif not _warned_kanji:
            _warned_kanji = True
            logger.warning(
                "Japanese kana-fallback G2P cannot read %r (install pyopenjtalk "
                "for full kanji support); dropping such characters.", ch
            )
        i += 1
    return morae


def _emit_prosody(morae: List[tuple], spans: List[tuple]) -> List[str]:
    """Insert prosody marks into a mora sequence from accent-phrase spans.

    Mirrors the HTS-label extraction in :func:`labels_to_prosody` (the
    reference algorithm, ``JapaneseG2P.py:64-100``) on the fallback's
    approximate phrase segmentation: within a phrase of ``n`` morae with
    accent type ``a`` (0 = heiban), after mora ``j`` emit

    * ``]`` (pitch fall) when ``j == a`` and ``j < n`` — the label
      condition ``a1==0 and a2_next==a2+1 and a2!=f1``;
    * else ``[`` (pitch rise) when ``j == 1`` and ``n >= 2`` — the label
      condition ``a2==1 and a2_next==2``;

    and ``#`` between phrases (``a3==1 and a2_next==1``). Mora-final
    phones here are always vowels/N/cl, so the label path's phone-class
    guard on ``#`` is vacuous."""
    bounds = list(spans)
    if not bounds or bounds[0][0] != 0:
        bounds.insert(0, (0, None))
    phrases: List[tuple] = []          # (accent, [[phones], ...])
    cur: List[List[str]] = []
    si = 0
    for idx, phs in morae:
        while si + 1 < len(bounds) and idx >= bounds[si + 1][0]:
            if cur:
                phrases.append((bounds[si][1], cur))
                cur = []
            si += 1
        cur.append(phs)
    if cur:
        phrases.append((bounds[si][1], cur))
    out: List[str] = []
    for pi, (accent, ms) in enumerate(phrases):
        a = 0 if accent is None else accent
        n = len(ms)
        for j, m in enumerate(ms, 1):
            out.extend(m)
            if a >= 1 and j == a and j < n:
                out.append("]")
            elif j == 1 and n >= 2:
                out.append("[")
        if pi < len(phrases) - 1:
            out.append("#")
    return out


def kana_to_phones(text: str, prosody: bool = False) -> List[str]:
    """Transliterate a kana run to OpenJTalk-style phones.

    Kanji are first read through the bundled lexicon
    (:func:`kanji_to_kana`; raises :class:`UnreadableJapaneseError` for
    kanji it cannot read); unknown non-ideograph symbols are dropped
    with a one-time warning. With ``prosody=True`` pitch-accent marks
    (``[``/``]``/``#``) are emitted from the lexicon's accent types —
    heiban (rise-only) for words without accent data."""
    spans: List[tuple] = []
    if any(_is_kanji(c) for c in text):
        text, spans = _kanji_to_kana_spans(text)
    for src, dst in _KANA_LEXICAL:
        if src in text:
            # equal-length replacements by construction, so accent-phrase
            # span offsets into the kana string stay valid
            text = text.replace(src, dst)
    chars = [_to_hiragana(c) for c in text]
    morae = _kana_to_morae(chars)
    if prosody:
        return _emit_prosody(morae, spans)
    return [p for _, phs in morae for p in phs]


# ---------------------------------------------------------------------------
# pyopenjtalk backend (full-context label prosody extraction)
# ---------------------------------------------------------------------------

def _label_feature(pattern: str, label: str) -> int:
    m = re.search(pattern, label)
    return int(m.group(1)) if m else -50


def openjtalk_g2p_prosody(text: str) -> List[str]:
    """Phones + prosody marks from OpenJTalk full-context labels.

    Standard prosody-symbol extraction (accent-phrase boundary ``#``, pitch
    fall ``]``, pitch rise ``[``, question ``?``, end ``$``), matching the
    reference's output symbol conventions.
    """
    return labels_to_prosody(
        pyopenjtalk.make_label(pyopenjtalk.run_frontend(text)))


def labels_to_prosody(labels: List[str]) -> List[str]:
    """Prosody extraction from HTS full-context labels (pyopenjtalk's
    ``make_label`` output, or committed fixtures — the parser is pure so
    it is testable without OpenJTalk in the image)."""
    out: List[str] = []
    n_labels = len(labels)
    for i, lab in enumerate(labels):
        phone = re.search(r"\-(.*?)\+", lab).group(1)
        if phone in "AEIOU":
            phone = phone.lower()
        if phone == "sil":
            if i == 0:
                out.append("^")
            elif i == n_labels - 1:
                out.append("?" if _label_feature(r"!(\d+)_", lab) == 1 else "$")
            continue
        if phone == "pau":
            out.append("_")
            continue
        out.append(phone)

        a1 = _label_feature(r"/A:([0-9\-]+)\+", lab)
        a2 = _label_feature(r"\+(\d+)\+", lab)
        a3 = _label_feature(r"\+(\d+)/", lab)
        f1 = _label_feature(r"/F:(\d+)_", lab)
        nxt = labels[i + 1] if i + 1 < n_labels else ""
        a2_next = _label_feature(r"\+(\d+)\+", nxt)
        if a3 == 1 and a2_next == 1 and phone in "aeiouAEIOUNcl":
            out.append("#")  # accent-phrase boundary
        elif a1 == 0 and a2_next == a2 + 1 and a2 != f1:
            out.append("]")  # pitch fall
        elif a2 == 1 and a2_next == 2:
            out.append("[")  # pitch rise
    return out


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def japanese_to_phone_strs(text: str, use_openjtalk: Optional[bool] = None) -> List[str]:
    """Full JA G2P: normalize, segment, phonemize, re-punctuate."""
    if not text.strip():
        return []
    if use_openjtalk is None:
        use_openjtalk = _HAS_OPENJTALK

    norm = normalize_ja(text)
    segments = _MARK_RUN_RE.split(norm)
    marks = _MARK_RUN_RE.findall(norm)

    phones: List[str] = []
    for i, seg in enumerate(segments):
        if seg:
            if use_openjtalk:
                # strip the per-segment ^ head and $/? tail markers
                phones.extend(openjtalk_g2p_prosody(seg)[1:-1])
            else:
                phones.extend(kana_to_phones(seg, prosody=True))
        if i < len(marks):
            mark = marks[i].strip()
            if mark:
                phones.append(mark)

    return [_FULLWIDTH_PUNCT.get(p, p) for p in phones]


def japanese_to_phones(text: str) -> List[int]:
    """JA text -> symbol ids (unknown symbols dropped, as in the reference)."""
    return phones_to_ids(japanese_to_phone_strs(text))


def has_openjtalk() -> bool:
    return _HAS_OPENJTALK
