"""G2P dispatch: language routing + hybrid zh/en splitting.

The port of ``genie_tts_tpu/frontend/dispatcher.py`` (behaviour of
``genie_tts/GetPhonesAndBert.py:7-83``): returns
``(phoneme_ids [T] int32, bert [T, 1024] float32)``. Chinese text gets
per-phoneme RoBERTa features when the runtime has installed the feature
hook (``runtime/model_manager.py::ModelManager.load_roberta``); other
languages, and Chinese text with no hook, get zero BERT rows.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..utils.metrics import metrics
from .language import CHINESE, ENGLISH, HYBRID, JAPANESE, normalize_language

BERT_DIM = 1024

_ENGLISH_RUN = re.compile(r"[a-zA-Z]+")


def split_zh_en(text: str) -> List[Tuple[str, str]]:
    """Hybrid text -> [(language, chunk)] preserving order."""
    out: List[Tuple[str, str]] = []
    pos = 0
    for m in _ENGLISH_RUN.finditer(text):
        if m.start() > pos and text[pos:m.start()].strip():
            out.append((CHINESE, text[pos:m.start()]))
        out.append((ENGLISH, m.group()))
        pos = m.end()
    if pos < len(text) and text[pos:].strip():
        out.append((CHINESE, text[pos:]))
    return out


# Chinese BERT feature hook: installed by the runtime when the RoBERTa
# model is loaded; signature (norm_text, word2ph) -> [sum(word2ph), 1024].
_bert_feature_fn: Optional[Callable[[str, List[int]], np.ndarray]] = None


def set_bert_feature_fn(fn: Optional[Callable]) -> None:
    global _bert_feature_fn
    _bert_feature_fn = fn


def _phones_pure(text: str, language: str) -> Tuple[List[int], np.ndarray]:
    """One language's text -> (ids, bert). Spans: ``frontend_g2p`` around
    the G2P, ``frontend_bert`` (also a timer) around the RoBERTa hook."""
    if language == JAPANESE:
        from .g2p_ja import japanese_to_phones

        with metrics.span("frontend_g2p"):
            ids = japanese_to_phones(text)
        return ids, np.zeros((len(ids), BERT_DIM), np.float32)
    if language == ENGLISH:
        from .g2p_en import english_to_phones

        with metrics.span("frontend_g2p"):
            ids = english_to_phones(text)
        return ids, np.zeros((len(ids), BERT_DIM), np.float32)
    if language == CHINESE:
        from .g2p_zh import chinese_to_phones

        with metrics.span("frontend_g2p"):
            norm_text, _, ids, word2ph = chinese_to_phones(text)
        fn = _bert_feature_fn
        if fn is not None:
            with metrics.timer("frontend_bert"):
                bert = fn(norm_text, word2ph).astype(np.float32)
            if bert.shape[0] != len(ids):  # defensive: fall back to zeros
                bert = np.zeros((len(ids), BERT_DIM), np.float32)
        else:
            bert = np.zeros((len(ids), BERT_DIM), np.float32)
        return ids, bert
    raise ValueError(f"unsupported language: {language}")


def get_phones_and_bert(text: str, language: str = JAPANESE) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> (phoneme ids [T], bert [T, 1024])."""
    language = normalize_language(language)
    if language == HYBRID:
        all_ids: List[int] = []
        berts: List[np.ndarray] = []
        for lang, chunk in split_zh_en(text):
            ids, bert = _phones_pure(chunk, lang)
            all_ids.extend(ids)
            berts.append(bert)
        bert = (np.concatenate(berts, axis=0) if berts
                else np.zeros((0, BERT_DIM), np.float32))
        return np.asarray(all_ids, np.int32), bert
    ids, bert = _phones_pure(text, language)
    return np.asarray(ids, np.int32), bert
