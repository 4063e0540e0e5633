"""Punctuation-aware sentence splitting for streaming synthesis.

Behavioral parity with the reference splitter
(``genie_tts/Utils/TextSplitter.py:66-123``):

* text is tokenized into alternating content / punctuation runs;
* a punctuation run containing a *terminator* (。！？…!?.) flushes the buffer
  if its *effective length* is at least ``min_len``;
* a run of pure separators (、，;… quotes) flushes only once the buffer's
  effective length reaches ``max_len``;
* effective length counts only non-punctuation characters: ASCII chars count
  1, everything else (CJK) counts 2;
* a trailing punctuation-only remainder is appended to the prior sentence.

The implementation here is a single linear scan (no regex split pass).
"""
from __future__ import annotations

from typing import List

TERMINATORS = frozenset("。！？…!?.")
SEPARATORS = frozenset("，、；：,;:——“”‘’\"'")
ALL_PUNCTS = TERMINATORS | SEPARATORS

DEFAULT_MAX_LEN = 40
DEFAULT_MIN_LEN = 5


def effective_len(text: str) -> int:
    """Width of the content characters only: ASCII=1, other (CJK)=2."""
    n = 0
    for ch in text:
        if ch in ALL_PUNCTS:
            continue
        n += 1 if ord(ch) < 128 else 2
    return n


class TextSplitter:
    """Split long text into synthesizable sentence chunks."""

    def __init__(self, max_len: int = DEFAULT_MAX_LEN, min_len: int = DEFAULT_MIN_LEN):
        self.max_len = max_len
        self.min_len = min_len

    def split(self, text: str) -> List[str]:
        if not text:
            return []
        text = text.replace("\n", "")

        sentences: List[str] = []
        buf: List[str] = []
        i, n = 0, len(text)
        while i < n:
            ch = text[i]
            if ch not in ALL_PUNCTS:
                buf.append(ch)
                i += 1
                continue
            # consume a full punctuation run
            j = i
            while j < n and text[j] in ALL_PUNCTS:
                j += 1
            run = text[i:j]
            i = j
            buf.append(run)
            current = "".join(buf)
            elen = effective_len(current)
            if any(c in TERMINATORS for c in run):
                if elen >= self.min_len:
                    sentences.append(current.strip())
                    buf = []
                # else: too short — merge into the next sentence
            else:
                if elen >= self.max_len:
                    sentences.append(current.strip())
                    buf = []

        remainder = "".join(buf).strip()
        if remainder:
            if effective_len(remainder) > 0:
                sentences.append(remainder)
            elif sentences:  # trailing punctuation only
                sentences[-1] += remainder
        return sentences


_default = TextSplitter()


def split_text(text: str) -> List[str]:
    return _default.split(text)
