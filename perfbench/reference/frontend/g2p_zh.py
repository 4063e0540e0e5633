"""Chinese grapheme-to-phoneme conversion.

Capability parity with the reference's Chinese pipeline
(``genie_tts/G2P/Chinese/ChineseG2P.py:113-213``):
normalization -> jieba segmentation -> per-word pinyin -> tone sandhi ->
erhua merge -> opencpop-strict initial/final phoneme symbols. Returns
``(norm_text, pinyins, phoneme_ids, word2ph)`` where ``word2ph[i]`` is the
number of phonemes produced by the i-th character of ``norm_text`` (drives
per-phoneme BERT feature repetition, ``GetPhonesAndBert.py:64-76``).

Pinyin sources, in priority order: word-level dictionary (polyphones),
char-level dictionary. Both merge a bundled seed table
(``data/pinyin_seed.json``) with optional full dictionaries from the
GenieData assets (``pinyin_chars.tsv`` / ``pinyin_words.tsv``: token TAB
space-separated pinyins). pypinyin is used when importable.
"""
from __future__ import annotations

import json
import logging
import re
from functools import lru_cache
from importlib import resources
from typing import Dict, List, Tuple

from ._assets import chinese_g2p_dir
from .normalize_zh import normalize_chinese
from .symbols import phones_to_ids, symbol_to_id_v2

logger = logging.getLogger(__name__)

try:
    import jieba

    jieba.setLogLevel(logging.WARNING)
    _HAS_JIEBA = True
except Exception:  # pragma: no cover
    jieba = None
    _HAS_JIEBA = False

try:
    import pypinyin  # type: ignore

    _HAS_PYPINYIN = True
except Exception:
    pypinyin = None
    _HAS_PYPINYIN = False

_HANZI_RE = re.compile(r"[一-鿿]")
_PUNCT_KEEP = {".", "!", "?", ",", "…", "-"}

# ---------------------------------------------------------------------------
# Pinyin dictionaries
# ---------------------------------------------------------------------------


@lru_cache(maxsize=1)
def _dicts() -> Tuple[Dict[str, List[str]], Dict[str, List[str]]]:
    with resources.files(__package__ + ".data").joinpath("pinyin_seed.json").open(
        "r", encoding="utf-8"
    ) as f:
        seed = json.load(f)
    chars: Dict[str, List[str]] = dict(seed["chars"])
    words: Dict[str, List[str]] = dict(seed["words"])
    root = chinese_g2p_dir()
    for fname, target in (("pinyin_chars.tsv", chars), ("pinyin_words.tsv", words)):
        p = root / fname
        if p.exists():
            try:
                for line in p.read_text(encoding="utf-8").splitlines():
                    if "\t" in line:
                        tok, pys = line.split("\t", 1)
                        target[tok] = pys.split()
            except OSError:
                pass
    return chars, words


_warned_oov = set()


def char_pinyin(ch: str) -> str | None:
    chars, _ = _dicts()
    if ch in chars:
        return chars[ch][0]
    if _HAS_PYPINYIN:
        out = pypinyin.pinyin(ch, style=pypinyin.Style.TONE3, neutral_tone_with_five=True)
        if out and out[0][0] != ch:
            return out[0][0]
    from . import polyphone

    if polyphone.is_polyphonic(ch):
        return polyphone.predict(ch, ch, 0)
    if ch not in _warned_oov and len(_warned_oov) < 20:
        _warned_oov.add(ch)
        logger.warning("no pinyin for %r (provide GenieData pinyin_chars.tsv "
                       "or install pypinyin); skipped", ch)
    return None


def word_pinyins(word: str,
                 ctx: "Tuple[str, int, str] | None" = None
                 ) -> List[str | None]:
    """Per-char pinyin for ``word``; dictionary first, then the
    context-sensitive polyphone model (frontend/polyphone.py — the
    reference's g2pM role, ``ChineseG2P.py:113-172``), then the first
    char-dictionary reading.

    ``ctx``: (sentence, start_index_of_word, jieba_pos) — lets the
    polyphone model see cross-word context exactly like g2pM's
    whole-sentence inference. Without it the word itself is the context
    (in-word cues and defaults still apply)."""
    _, words = _dicts()
    if word in words:
        return list(words[word])
    from . import polyphone

    sent, start, pos = ctx if ctx is not None else (word, 0, "")
    out: List[str | None] = []
    for i, c in enumerate(word):
        if polyphone.is_polyphonic(c):
            out.append(polyphone.predict(c, sent, start + i, pos))
        else:
            out.append(char_pinyin(c))
    return out


# ---------------------------------------------------------------------------
# Pinyin -> phoneme symbols (opencpop-strict scheme)
# ---------------------------------------------------------------------------

_INITIALS = ["zh", "ch", "sh", "b", "p", "m", "f", "d", "t", "n", "l", "g",
             "k", "h", "j", "q", "x", "r", "z", "c", "s", "y", "w"]

# zero-initial vowels take pseudo-initials AA/EE/OO
_ZERO_INITIAL = {"a": "AA", "e": "EE", "o": "OO"}

# orthographic corrections after 'y'
_Y_FINAL_FIX = {"e": "E", "an": "En"}


def pinyin_to_symbols(py: str) -> List[str]:
    """'zhong1' -> ['zh', 'ong1']; 'a4' -> ['AA', 'a4']; 'yu2' -> ['y','v2']."""
    py = py.strip().lower().replace("ü", "v").replace("u:", "v")
    if not py:
        return []
    tone = "5"
    if py[-1].isdigit():
        tone = py[-1]
        if tone == "0":
            tone = "5"
        py = py[:-1]
    if not py:
        return []
    initial = ""
    for ini in _INITIALS:
        if py.startswith(ini):
            initial = ini
            break
    final = py[len(initial):]
    if not initial:
        head = final[0]
        initial = _ZERO_INITIAL.get(head, "")
        if not initial:
            return []  # not a pinyin syllable
    elif initial in ("j", "q", "x", "y") and final.startswith("u"):
        final = "v" + final[1:]
    if initial == "y":
        final = _Y_FINAL_FIX.get(final, final)
    elif initial in ("z", "c", "s") and final == "i":
        final = "i0"
    elif initial in ("zh", "ch", "sh", "r") and final == "i":
        final = "ir"
    if not final:  # syllabic consonants (hm, ng): skip
        return []
    out = [initial, final + tone]
    table = symbol_to_id_v2()
    if out[1] not in table:
        logger.debug("unknown pinyin final %r from %r", out[1], py)
        return []
    return out


# ---------------------------------------------------------------------------
# Polyphone correction (reference CorrectPronunciation.py: whole-word match
# first, then per-char overrides; dict = bundled seed + GenieData
# polyphonic.pickle / polyphonic.tsv)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _polyphonic_dict() -> Dict[str, List[str]]:
    d: Dict[str, List[str]] = {}
    try:
        with resources.files(__package__ + ".data").joinpath(
                "polyphonic_seed.json").open("r", encoding="utf-8") as f:
            d.update(json.load(f))
    except FileNotFoundError:  # pragma: no cover
        pass
    root = chinese_g2p_dir()
    pkl = root / "polyphonic.pickle"
    if pkl.exists():
        try:
            import pickle

            with open(pkl, "rb") as f:
                loaded = pickle.load(f)
            d.update({k: (v if isinstance(v, list) else [v])
                      for k, v in loaded.items()})
        except Exception:
            logger.warning("could not load %s", pkl)
    tsv = root / "polyphonic.tsv"
    if tsv.exists():
        for line in tsv.read_text(encoding="utf-8").splitlines():
            if "\t" in line:
                tok, pys = line.split("\t", 1)
                d[tok] = pys.split()
    return d


def correct_pronunciation(word: str, pinyins: List[str]) -> List[str]:
    pp = _polyphonic_dict()
    whole = pp.get(word)
    if whole:
        return list(whole)
    out = list(pinyins)
    for i, ch in enumerate(word):
        if i >= len(out):
            break
        per_char = pp.get(ch)
        if per_char:
            out[i] = per_char[0]
    return out


# ---------------------------------------------------------------------------
# Erhua (reference Erhua.py semantics: the 儿 keeps its slot, re-toned to
# the previous syllable)
# ---------------------------------------------------------------------------

_MUST_ERHUA = {
    "小院儿", "胡同儿", "范儿", "老汉儿", "撒欢儿", "寻老礼儿", "妥妥儿", "媳妇儿",
}
_NOT_ERHUA = {
    "虐儿", "为儿", "护儿", "瞒儿", "救儿", "替儿", "有儿", "一儿", "我儿", "俺儿",
    "妻儿", "拐儿", "聋儿", "乞儿", "患儿", "幼儿", "孤儿", "婴儿", "婴幼儿",
    "连体儿", "脑瘫儿", "流浪儿", "体弱儿", "混血儿", "蜜雪儿", "舫儿", "祖儿",
    "美儿", "应采儿", "可儿", "侄儿", "孙儿", "侄孙儿", "女儿", "男儿", "红孩儿",
    "花儿", "虫儿", "马儿", "鸟儿", "猪儿", "猫儿", "狗儿", "少儿",
}


def merge_erhua(word: str, pinyins: List[str], pos: str = "n"
                ) -> Tuple[str, List[str]]:
    """Erhua handling: word-final 儿 reads as er with the previous
    syllable's tone (must/not lexicons + POS gates as in the reference)."""
    py = list(pinyins)
    if py and word and word[-1] == "儿" and py[-1] == "er1":
        py[-1] = "er2"
    if word not in _MUST_ERHUA and (word in _NOT_ERHUA
                                    or pos in {"a", "j", "nr"}):
        return word, py
    if len(py) != len(word):
        return word, py
    if (len(py) >= 2 and word[-1] == "儿" and py[-1] in ("er2", "er5")
            and word[-2:] not in _NOT_ERHUA):
        py[-1] = "er" + py[-2][-1]
    return word, py


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

_ENG_RE = re.compile(r"[a-zA-Z]+")
_SENT_SPLIT_RE = re.compile(r"(?<=[!?…,.\-])\s*")


def _segment(text: str) -> List[Tuple[str, str]]:
    """(word, POS) segmentation: jieba.posseg when available, else chars."""
    if _HAS_JIEBA:
        import jieba.posseg as psg

        return [(w, p) for w, p in psg.lcut(text) if w.strip()]
    return [(c, "x") for c in text if c.strip()]  # pragma: no cover


def chinese_to_phone_data(text: str):
    """-> (norm_text, pinyins, phone_strs, word2ph).

    Pipeline order matches the reference ChineseG2P.g2p
    (``ChineseG2P.py:113-171``): normalize -> per-sentence POS
    segmentation -> tone-sandhi pre-merge -> per-word pinyin + polyphone
    correction -> modified_tone -> erhua -> opencpop-strict symbols."""
    norm = normalize_chinese(text)
    sentences = [s for s in _SENT_SPLIT_RE.split(norm) if s.strip()]

    norm_text_chars: List[str] = []
    all_pinyins: List[str] = []
    phones: List[str] = []
    word2ph: List[int] = []
    for sent in sentences:
        sent = _ENG_RE.sub("", sent)
        seg_cut = _segment(sent)
        from .tone_sandhi import modified_tone, pre_merge

        seg_cut = pre_merge(seg_cut, lambda w: [p or "" for p in word_pinyins(w)])
        # sentence-context string for the polyphone model: the segmented
        # words concatenated (cues align across word boundaries, like
        # g2pM's whole-sentence inference)
        ctx_sent = "".join(w for w, _ in seg_cut)
        offset = 0
        for word, pos in seg_cut:
            start = offset
            offset += len(word)
            if pos == "eng":
                continue
            if not _HANZI_RE.search(word):
                for ch in word:
                    if ch in _PUNCT_KEEP:
                        norm_text_chars.append(ch)
                        phones.append(ch)
                        word2ph.append(1)
                continue
            py = word_pinyins(word, ctx=(ctx_sent, start, pos))
            known = [p for p in py if p]
            if len(known) != len(word):
                # unknown chars inside the word: emit what we can, skip rest
                for ch, p in zip(word, py):
                    if p is None:
                        continue
                    syms = pinyin_to_symbols(p)
                    if syms:
                        norm_text_chars.append(ch)
                        all_pinyins.append(p)
                        phones.extend(syms)
                        word2ph.append(len(syms))
                continue
            py = correct_pronunciation(word, known)
            py = modified_tone(word, pos, py)
            _, py = merge_erhua(word, py, pos)
            for ch, p in zip(word, py):
                syms = pinyin_to_symbols(p)
                if not syms:
                    continue
                norm_text_chars.append(ch)
                all_pinyins.append(p)
                phones.extend(syms)
                word2ph.append(len(syms))
    return "".join(norm_text_chars), all_pinyins, phones, word2ph


def chinese_to_phones(text: str):
    """-> (norm_text, pinyins, phoneme_ids, word2ph)."""
    norm_text, pinyins, phone_strs, word2ph = chinese_to_phone_data(text)
    ids = phones_to_ids(phone_strs, drop_unknown=True)
    return norm_text, pinyins, ids, word2ph
