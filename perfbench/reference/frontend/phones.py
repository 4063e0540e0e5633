"""Text -> phoneme ids for the languages the benchmark's cells send.

The routing of the program's ``frontend/dispatcher.py`` for Japanese and
Chinese text, without the BERT hook: the Chinese route also returns the
normalized text and ``word2ph``, from which the reference computes its own
RoBERTa features."""
from typing import List, Tuple

import numpy as np


def japanese(text: str) -> np.ndarray:
    from .g2p_ja import japanese_to_phones

    return np.asarray(japanese_to_phones(text), np.int32)


def chinese(text: str) -> Tuple[np.ndarray, str, List[int]]:
    """(phoneme ids, normalized text, phonemes per character)."""
    from .g2p_zh import chinese_to_phones

    norm_text, _, ids, word2ph = chinese_to_phones(text)
    return np.asarray(ids, np.int32), norm_text, list(word2ph)
