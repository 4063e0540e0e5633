"""A reader of BERT-family ``tokenizer.json`` files (HuggingFace
``tokenizers`` layout) for the RoBERTa feature hook.

The port's own stand-in for ``tokenizers.Tokenizer`` (the JAX package
imports that library, which the GPU machine may not have). It encodes
one sequence the way ``Tokenizer.encode(text)`` does for the components
that BERT checkpoints ship, and raises for any other component:

* added tokens that match their literal content (``normalized: false``,
  no lstrip/rstrip/single_word), split out before normalization;
* normalizer ``BertNormalizer`` (clean_text, handle_chinese_chars,
  strip_accents, lowercase) or none;
* pre-tokenizer ``BertPreTokenizer`` (whitespace split, punctuation
  isolated), ``Split`` on the empty string with ``Isolated`` behaviour
  (one piece per character), or none;
* model ``WordPiece`` (greedy longest match, ``##`` continuation prefix,
  ``max_input_chars_per_word``, ``[UNK]`` for a word that does not split);
* post-processor ``TemplateProcessing`` (single-sequence template) or
  ``BertProcessing`` (``[CLS] $A [SEP]``), or none.

No truncation and no padding: every attention-mask entry is 1.
"""
from __future__ import annotations

import json
import string
import unicodedata
from typing import Dict, List, NamedTuple, Optional, Tuple

# Unicode White_Space, the set Rust's ``char::is_whitespace`` tests
_WHITESPACE = frozenset(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000))
_ASCII_PUNCT = frozenset(string.punctuation)
_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


class Encoding(NamedTuple):
    ids: List[int]
    attention_mask: List[int]
    tokens: List[str]


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_punct(c: str) -> bool:
    return c in _ASCII_PUNCT or unicodedata.category(c).startswith("P")


def _is_cjk(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _unsupported(what: str, spec) -> ValueError:
    return ValueError(f"tokenizer.json: unsupported {what}: {spec!r}")


class WordPieceTokenizer:
    """``tokenizer.json`` -> ``encode(text)`` with ``ids``,
    ``attention_mask`` and ``tokens`` as ``tokenizers`` gives them."""

    def __init__(self, spec: Dict):
        for key in ("truncation", "padding"):
            if spec.get(key) is not None:
                raise _unsupported(key, spec[key])
        self._added = self._read_added(spec.get("added_tokens") or [])
        self._norm = self._read_normalizer(spec.get("normalizer"))
        self._pre = self._read_pre_tokenizer(spec.get("pre_tokenizer"))
        model = spec.get("model") or {}
        if model.get("type") != "WordPiece":
            raise _unsupported("model", model.get("type"))
        self.vocab: Dict[str, int] = dict(model["vocab"])
        self.unk_token: str = model.get("unk_token", "[UNK]")
        self.prefix: str = model.get("continuing_subword_prefix", "##")
        self.max_chars: int = int(model.get("max_input_chars_per_word", 100))
        if self.unk_token not in self.vocab:
            raise ValueError(f"tokenizer.json: unk token {self.unk_token!r} "
                             f"is not in the vocabulary")
        self._template = self._read_post(spec.get("post_processor"))

    @classmethod
    def from_file(cls, path) -> "WordPieceTokenizer":
        with open(path, "r", encoding="utf-8") as f:
            return cls(json.load(f))

    # -- reading the spec ---------------------------------------------------

    @staticmethod
    def _read_added(tokens) -> Dict[str, int]:
        out = {}
        for t in tokens:
            if t.get("normalized") or t.get("lstrip") or t.get("rstrip") \
                    or t.get("single_word"):
                raise _unsupported("added token", t)
            out[t["content"]] = int(t["id"])
        return out

    @staticmethod
    def _read_normalizer(spec) -> Optional[Tuple[bool, bool, bool, bool]]:
        if spec is None:
            return None
        if spec.get("type") != "BertNormalizer":
            raise _unsupported("normalizer", spec.get("type"))
        lower = bool(spec.get("lowercase", True))
        strip = spec.get("strip_accents")
        return (bool(spec.get("clean_text", True)),
                bool(spec.get("handle_chinese_chars", True)),
                lower if strip is None else bool(strip), lower)

    @staticmethod
    def _read_pre_tokenizer(spec) -> Optional[str]:
        if spec is None:
            return None
        kind = spec.get("type")
        if kind == "BertPreTokenizer":
            return "bert"
        if (kind == "Split" and spec.get("pattern") == {"String": ""}
                and spec.get("behavior") == "Isolated"
                and not spec.get("invert", False)):
            return "chars"
        raise _unsupported("pre_tokenizer", spec)

    def _read_post(self, spec) -> List[Tuple[str, Optional[List[int]]]]:
        """The single-sequence template: ("A", None) for the sequence,
        (token, ids) for a special token."""
        if spec is None:
            return [("A", None)]
        kind = spec.get("type")
        if kind == "BertProcessing":
            (cls_tok, cls_id), (sep_tok, sep_id) = spec["cls"], spec["sep"]
            return [(cls_tok, [int(cls_id)]), ("A", None), (sep_tok, [int(sep_id)])]
        if kind == "TemplateProcessing":
            specials = spec.get("special_tokens", {})
            out = []
            for piece in spec["single"]:
                if "Sequence" in piece:
                    out.append(("A", None))
                    continue
                name = piece["SpecialToken"]["id"]
                st = specials[name]
                out.append((name, [int(i) for i in st["ids"]]))
            return out
        raise _unsupported("post_processor", kind)

    # -- encoding -------------------------------------------------------------

    def _normalize(self, text: str) -> str:
        if self._norm is None:
            return text
        clean, chinese, strip, lower = self._norm
        if clean:
            text = "".join(" " if c in _WHITESPACE else c for c in text
                           if c not in "\x00\ufffd" and not _is_control(c))
        if chinese:
            text = "".join(f" {c} " if _is_cjk(c) else c for c in text)
        if strip:
            text = "".join(c for c in unicodedata.normalize("NFD", text)
                           if unicodedata.category(c) != "Mn")
        if lower:
            text = "".join(c.lower() for c in text)
        return text

    def _pre_tokenize(self, text: str) -> List[str]:
        if self._pre is None:
            return [text] if text else []
        if self._pre == "chars":
            return list(text)
        words, cur = [], []
        for c in text:
            if c in _WHITESPACE or _is_punct(c):
                if cur:
                    words.append("".join(cur))
                    cur = []
                if c not in _WHITESPACE:
                    words.append(c)
            else:
                cur.append(c)
        if cur:
            words.append("".join(cur))
        return words

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = self.prefix + sub
                if sub in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk_token]
            out.append(sub)
            start = end
        return out

    def _split_added(self, text: str) -> List[Tuple[str, bool]]:
        """(piece, is_added_token) in order; the longest added token wins
        at each position."""
        if not self._added:
            return [(text, False)]
        names = sorted(self._added, key=len, reverse=True)
        out, buf, i = [], [], 0
        while i < len(text):
            hit = next((n for n in names if text.startswith(n, i)), None)
            if hit is None:
                buf.append(text[i])
                i += 1
                continue
            if buf:
                out.append(("".join(buf), False))
                buf = []
            out.append((hit, True))
            i += len(hit)
        if buf:
            out.append(("".join(buf), False))
        return out

    def encode(self, text: str) -> Encoding:
        tokens: List[str] = []
        ids: List[int] = []
        for piece, added in self._split_added(text):
            if added:
                tokens.append(piece)
                ids.append(self._added[piece])
                continue
            for word in self._pre_tokenize(self._normalize(piece)):
                for tok in self._wordpiece(word):
                    tokens.append(tok)
                    ids.append(self.vocab[tok])
        out_tokens: List[str] = []
        out_ids: List[int] = []
        for name, sids in self._template:
            if sids is None:
                out_tokens += tokens
                out_ids += ids
            else:
                out_tokens += [name] * len(sids)
                out_ids += sids
        return Encoding(out_ids, [1] * len(out_ids), out_tokens)


def bert_layout(vocab: Dict[str, int]) -> Dict:
    """The ``tokenizer.json`` of a BERT checkpoint (the layout of
    chinese-roberta-wwm-ext-large's) over ``vocab``, which holds
    ``[PAD] [UNK] [CLS] [SEP] [MASK]``; for random-weight runs."""
    specials = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [
            {"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": True}
            for t in specials],
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")}},
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100, "vocab": dict(vocab)},
    }
