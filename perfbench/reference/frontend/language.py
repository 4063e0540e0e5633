"""Language name normalization.

Canonical names follow the reference
(``genie_tts/Utils/Language.py:1-31``):
``Japanese``, ``English``, ``Chinese``, ``Hybrid-Chinese-English``.
"""
from __future__ import annotations

JAPANESE = "Japanese"
ENGLISH = "English"
CHINESE = "Chinese"
HYBRID = "Hybrid-Chinese-English"

_ALIASES = {
    # Chinese
    "chinese": CHINESE, "zh": CHINESE, "zh-cn": CHINESE, "zh-tw": CHINESE,
    "zh-hans": CHINESE, "zh-hant": CHINESE,
    # English
    "english": ENGLISH, "en": ENGLISH, "en-us": ENGLISH, "en-gb": ENGLISH,
    "eng": ENGLISH,
    # Japanese
    "japanese": JAPANESE, "jp": JAPANESE, "ja": JAPANESE, "nihongo": JAPANESE,
    # Hybrid
    "hybrid": HYBRID, "hybrid-zh-en": HYBRID, "hybrid-en-zh": HYBRID,
    "hybrid-chinese-english": HYBRID,
}

SUPPORTED = (JAPANESE, ENGLISH, CHINESE, HYBRID)
MONOLINGUAL = (JAPANESE, ENGLISH, CHINESE)


def normalize_language(lang: str) -> str:
    return _ALIASES.get(lang.lower(), lang)


def require_supported(lang: str, allow_hybrid: bool = True) -> str:
    lang = normalize_language(lang)
    allowed = SUPPORTED if allow_hybrid else MONOLINGUAL
    if lang not in allowed:
        raise ValueError(f"Unknown language: {lang!r} (supported: {allowed})")
    return lang
