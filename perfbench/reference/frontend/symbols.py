"""GPT-SoVITS V2 phoneme symbol table.

The 732-entry master phoneme vocabulary shared by every GPT-SoVITS V2 /
V2ProPlus checkpoint (pinyin initials/finals x 5 tones, romaji, ARPAbet,
punctuation, Korean jamo, Cantonese jyutping). Symbol *order* defines the
embedding row for each phoneme, so it is shipped as a data asset
(``data/symbols_v2.json``) for exact ID parity with trained checkpoints.

Reference behavior: ``genie_tts/G2P/SymbolsV2.py:100-119``
(table built procedurally there; here it is frozen data, same contents).
"""
from __future__ import annotations

import json
from functools import lru_cache
from importlib import resources
from typing import Dict, List, Sequence

PAD_SYMBOL = "_"
UNK_SYMBOL = "UNK"

# Sentence-internal punctuation symbols that exist in the vocabulary.
PUNCTUATION: frozenset = frozenset({"!", "?", "…", ",", ".", "-"})


@lru_cache(maxsize=1)
def symbols_v2() -> List[str]:
    """The ordered V2 symbol list (len == 732)."""
    with resources.files(__package__ + ".data").joinpath("symbols_v2.json").open(
        "r", encoding="utf-8"
    ) as f:
        syms = json.load(f)
    if len(syms) != 732:
        raise RuntimeError(f"corrupt symbols_v2.json: {len(syms)} entries")
    return syms


@lru_cache(maxsize=1)
def symbol_to_id_v2() -> Dict[str, int]:
    return {s: i for i, s in enumerate(symbols_v2())}


def vocab_size() -> int:
    return len(symbols_v2())


def phones_to_ids(phones: Sequence[str], drop_unknown: bool = True) -> List[int]:
    """Map phoneme strings to embedding ids.

    Unknown phonemes are silently dropped, matching the reference's filtering
    (`JapaneseG2P.py:147`: ``[ph for ph in phones if ph in symbols_v2]``).
    """
    table = symbol_to_id_v2()
    if drop_unknown:
        return [table[p] for p in phones if p in table]
    return [table.get(p, table[UNK_SYMBOL]) for p in phones]
