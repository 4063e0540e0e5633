"""The port's ``tokenizer.json`` reader vs the ``tokenizers`` library.

Two layouts: the public BERT layout (``BertNormalizer``,
``BertPreTokenizer``, ``WordPiece``, a ``[CLS] $A [SEP]`` post-processor,
special tokens as added tokens), written both by the library and by the
port's ``bert_layout``, and the per-character layout of the JAX package's
RoBERTa test (``Split("", "isolated")``, no normalizer). The ids and the
attention masks must be equal (exactly) on the frontend corpora, on the
Chinese normalized texts the BERT hook encodes, and on random strings of
CJK, Latin, accented, whitespace, control and punctuation characters.
"""
import json
import random

import pytest

from genie_tts_tpu_torch.frontend.wordpiece import WordPieceTokenizer, bert_layout

from test_torch_frontend_en_zh import EN, HYBRID, ZH

tokenizers = pytest.importorskip("tokenizers")

SPECIALS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
CHARS = list("你好世界天气很这是测试不一个中文句子我们他她，。！？：；、“”（）")
WORDS = ["hello", "##lo", "hel", "##l", "world", "the", "##s", "test", "##ing",
         "cafe", "a", "##b", "x", "$", ",", ".", "!", "?", "'", "-", "3", "##0"]


def _vocab():
    vocab = {}
    for t in SPECIALS + CHARS + WORDS:
        vocab.setdefault(t, len(vocab))
    return vocab


def _texts():
    rng = random.Random(0)
    pool = (CHARS + list("abcdefghlorstwxyzABCHLO 0123$,.!?'-\t\n\x0b\x85\x00")
            + ["é", "é", "İ", "Σ", "　", "​", "�", "hello",
               "[MASK]", "[CLS]", "𠀀", "﨑"])
    corpus = [s for table in (ZH, EN, HYBRID) for v in table.values() for s in v]
    rand = ["".join(rng.choice(pool) for _ in range(rng.randint(0, 40)))
            for _ in range(400)]
    return corpus + rand + ["", " ", "a" * 101, "hellolo " * 3]


def _library_bert(vocab, lowercase=True, strip_accents=None, post="template"):
    from tokenizers import Tokenizer, models, normalizers, pre_tokenizers, processors

    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]",
                                     max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(
        clean_text=True, handle_chinese_chars=True, strip_accents=strip_accents,
        lowercase=lowercase)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    if post == "template":
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])])
    else:
        tok.post_processor = processors.BertProcessing(
            ("[SEP]", vocab["[SEP]"]), ("[CLS]", vocab["[CLS]"]))
    tok.add_special_tokens(SPECIALS)
    return tok


def _library_chars(vocab):
    """The JAX RoBERTa test's tokenizer (tests/test_roberta_integration.py)."""
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = pre_tokenizers.Split("", "isolated")
    tok.post_processor = processors.TemplateProcessing(
        single="[CLS] $A [SEP]",
        special_tokens=[("[CLS]", vocab["[CLS]"]), ("[SEP]", vocab["[SEP]"])])
    return tok


def _assert_same(lib, port, texts):
    bad = []
    for s in texts:
        e, f = lib.encode(s), port.encode(s)
        if e.ids != f.ids or e.attention_mask != f.attention_mask:
            bad.append((s, e.tokens, f.tokens))
    assert not bad, bad[:5]


@pytest.mark.parametrize("kw", [
    dict(), dict(lowercase=False), dict(strip_accents=False),
    dict(strip_accents=True, lowercase=False), dict(post="bert"),
], ids=["bert", "cased", "keep_accents", "cased_strip_accents", "bert_processing"])
def test_bert_layout_matches_tokenizers(tmp_path, kw):
    vocab = _vocab()
    lib = _library_bert(vocab, **kw)
    path = tmp_path / "tokenizer.json"
    lib.save(str(path))
    _assert_same(lib, WordPieceTokenizer.from_file(path), _texts())


def test_char_layout_matches_tokenizers(tmp_path):
    vocab = _vocab()
    lib = _library_chars(vocab)
    path = tmp_path / "tokenizer.json"
    lib.save(str(path))
    _assert_same(lib, WordPieceTokenizer.from_file(path), _texts())


def test_port_written_layout_reads_the_same_in_both(tmp_path):
    """``bert_layout`` (the file chip_smoke.py writes) is a file the
    library reads, and encodes the same there."""
    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(bert_layout(_vocab())), encoding="utf-8")
    lib = tokenizers.Tokenizer.from_file(str(path))
    _assert_same(lib, WordPieceTokenizer.from_file(path), _texts())


def test_chinese_hook_texts_match_and_align(tmp_path):
    """The hook's input, the normalized text of chinese_to_phones, encodes
    the same in both and gives one content token per word2ph entry."""
    from genie_tts_tpu_torch.frontend.g2p_zh import chinese_to_phones

    vocab = _vocab()
    for text in [s for v in ZH.values() for s in v]:
        for c in chinese_to_phones(text)[0]:
            vocab.setdefault(c, len(vocab))
    lib = _library_bert(vocab)
    path = tmp_path / "tokenizer.json"
    lib.save(str(path))
    port = WordPieceTokenizer.from_file(path)
    for text in [s for v in ZH.values() for s in v]:
        norm, _, _, word2ph = chinese_to_phones(text)
        e, f = lib.encode(norm), port.encode(norm)
        assert e.ids == f.ids and e.attention_mask == f.attention_mask, text
        assert len(f.ids) - 2 == len(word2ph), text
        assert 1 not in f.ids, text            # no [UNK]: the vocab covers it


@pytest.mark.parametrize("patch", [
    {"normalizer": {"type": "NFKC"}},
    {"pre_tokenizer": {"type": "Whitespace"}},
    {"pre_tokenizer": {"type": "Split", "pattern": {"Regex": "\\s+"},
                       "behavior": "Removed", "invert": False}},
    {"model": {"type": "BPE", "vocab": {}, "merges": []}},
    {"post_processor": {"type": "RobertaProcessing"}},
    {"truncation": {"max_length": 8}},
    {"padding": {"strategy": "BatchLongest"}},
    {"added_tokens": [{"id": 0, "content": "[PAD]", "single_word": False,
                       "lstrip": True, "rstrip": False, "normalized": False,
                       "special": True}]},
], ids=["normalizer", "pre_tokenizer", "split_regex", "model", "post", "truncation",
        "padding", "added_lstrip"])
def test_other_components_raise(patch):
    spec = bert_layout(_vocab())
    spec.update(patch)
    with pytest.raises(ValueError, match="unsupported"):
        WordPieceTokenizer(spec)
