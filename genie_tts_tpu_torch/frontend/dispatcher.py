"""G2P dispatch: text -> (phoneme ids, BERT features).

The Japanese route of ``genie_tts_tpu/frontend/dispatcher.py``: returns
``(phoneme_ids [T] int32, bert [T, 1024] float32)`` with all-zero BERT
rows. English, Chinese and hybrid text are later slices of the port
(ROADMAP.md, Queue 1 item 11).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .language import CHINESE, ENGLISH, HYBRID, JAPANESE, normalize_language

BERT_DIM = 1024


def get_phones_and_bert(text: str, language: str = JAPANESE) -> Tuple[np.ndarray, np.ndarray]:
    """Text -> (phoneme ids [T], bert [T, 1024])."""
    language = normalize_language(language)
    if language == JAPANESE:
        from .g2p_ja import japanese_to_phones

        ids = japanese_to_phones(text)
        return np.asarray(ids, np.int32), np.zeros((len(ids), BERT_DIM), np.float32)
    if language in (ENGLISH, CHINESE, HYBRID):
        raise NotImplementedError(
            f"{language} text is not ported yet (ROADMAP.md, Queue 1 item 11: "
            f"EN/ZH frontends with RoBERTa); the port synthesizes Japanese")
    raise ValueError(f"unsupported language: {language}")
