"""The port's RoBERTa BERT features vs the JAX package's.

A tiny RoBERTa (the JAX package's test geometry: 3 layers, d1024, 2 heads,
FFN 32, 64 positions) from the JAX ``init_params``, carried to the port by
``params_from_numpy``. Tolerances:

* ``phone_features`` in fp32: rtol 1e-4, atol 1e-5 against the JAX
  function (the port runs the exact token count and stops at the feature
  layer; the JAX function pads and runs every layer);
* in bf16: the port's features are within 0.0625 (two bf16 steps at the
  features' magnitude, |x| < 8) of the JAX fp32 features at every entry,
  and within 2e-2 in relative Frobenius norm, where the JAX package's
  own bf16 run is ~1e-2 and 0.03;
* the dispatcher hook of each package's model manager: the same phoneme
  ids, BERT rows allclose at rtol 1e-4, atol 1e-5.

``test_card_state_without_optional_packages`` runs the port in a
subprocess with ``tokenizers``, ``jieba``, ``pypinyin`` and ``nltk``
blocked (the GPU machine's state): RoBERTa loads from files through
``load_roberta``, and Chinese, English and hybrid text go through the
hooked dispatcher and ``tts()``. The CLI drives ``--lang zh`` and
``--lang en`` on the CPU.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genie_tts_tpu.config import RobertaConfig as JRobertaConfig
from genie_tts_tpu.frontend import dispatcher as jdispatch
from genie_tts_tpu.models import roberta as jroberta
from genie_tts_tpu.runtime.model_manager import ModelManager as JModelManager
from genie_tts_tpu_torch.config import RobertaConfig
from genie_tts_tpu_torch.convert.io import params_from_numpy, save_params
from genie_tts_tpu_torch.frontend import dispatcher as tdispatch
from genie_tts_tpu_torch.frontend.g2p_zh import chinese_to_phones
from genie_tts_tpu_torch.frontend.wordpiece import WordPieceTokenizer, bert_layout
from genie_tts_tpu_torch.models import roberta
from genie_tts_tpu_torch.runtime.model_manager import ModelManager

REPO = Path(__file__).resolve().parents[1]
KW = dict(vocab_size=64, embed_dim=1024, num_layers=3, num_heads=2, ffn_dim=32,
          max_position=64)
JCFG, TCFG = JRobertaConfig(**KW), RobertaConfig(**KW)
CHARS = list("你好世界天气很这是测试不一个中文句子，。")
SENTENCES = ["你好世界。", "这是一个测试。", "天气很好，不是吗？", "中文句子。"]


@pytest.fixture(scope="module")
def jparams():
    return jroberta.init_params(jax.random.PRNGKey(0), JCFG, jnp.float32)


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jparams, torch.float32)


@pytest.fixture(autouse=True)
def _hooks_cleared():
    yield
    jdispatch.set_bert_feature_fn(None)
    tdispatch.set_bert_feature_fn(None)


def _inputs(T, pad, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, KW["vocab_size"], (1, T)).astype(np.int32)
    mask = np.ones((1, T), np.int32)
    reps = rng.integers(1, 4, T - 2).astype(np.int32)
    if pad:
        mask[0, T - pad:] = 0
        reps[T - pad - 1:] = 0
    return ids, mask, reps


def _jax_features(jparams, ids, mask, reps):
    """The JAX function's rows, padded 5 past sum(repeats): (the first
    sum(repeats) rows, the padding rows)."""
    n = int(reps.sum())
    j = np.asarray(jroberta.phone_features(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                           jnp.asarray(reps), JCFG, n + 5))
    return j[:n], j[n:]


@pytest.mark.parametrize("T,pad", [(12, 0), (20, 5), (70, 0)],
                         ids=["exact", "padded", "past_max_position"])
def test_phone_features_fp32_match_jax(jparams, tparams, T, pad):
    ids, mask, reps = _inputs(T, pad, seed=T)
    j, j_pad = _jax_features(jparams, ids, mask, reps)
    t = roberta.phone_features(tparams, torch.tensor(ids), torch.tensor(mask),
                               torch.tensor(reps), TCFG)
    assert t.dtype == torch.float32 and t.shape == j.shape == (int(reps.sum()), 1024)
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-5)
    assert np.abs(j).max() > 1.0 and not np.any(j_pad)


def test_hidden_states_and_layer_cut(jparams, tparams):
    """The states the port computes up to the feature layer are the JAX
    package's."""
    ids, mask, reps = _inputs(16, 0, seed=3)
    js = np.asarray(jroberta.hidden_states(jparams, jnp.asarray(ids), jnp.asarray(mask),
                                           JCFG))
    ts = roberta.hidden_states(tparams, torch.tensor(ids), torch.tensor(mask), TCFG)
    assert ts.shape == js.shape == (KW["num_layers"] + 1, 1, 16, 1024)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-4, atol=1e-5)
    cut = roberta.hidden_states(tparams, torch.tensor(ids), torch.tensor(mask), TCFG,
                                num_layers=1)
    np.testing.assert_array_equal(cut.numpy(), ts[:2].numpy())


def test_phone_features_bf16_within_bound(jparams):
    ids, mask, reps = _inputs(24, 0, seed=7)
    j, _ = _jax_features(jparams, ids, mask, reps)
    tb = roberta.phone_features(params_from_numpy(jparams, torch.bfloat16),
                                torch.tensor(ids), torch.tensor(mask),
                                torch.tensor(reps), TCFG).numpy()
    assert np.abs(j).max() < 8.0
    assert np.abs(tb - j).max() <= 0.0625
    assert np.linalg.norm(tb - j) / np.linalg.norm(j) <= 2e-2


def _char_tokenizer_file(path):
    """The JAX package's test tokenizer (per-character WordPiece), saved."""
    tk = pytest.importorskip("tokenizers")
    vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3}
    for c in CHARS:
        vocab.setdefault(c, len(vocab))
    tok = tk.Tokenizer(tk.models.WordPiece(vocab, unk_token="[UNK]"))
    tok.pre_tokenizer = tk.pre_tokenizers.Split("", "isolated")
    tok.post_processor = tk.processors.TemplateProcessing(
        single="[CLS] $A [SEP]", special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    tok.save(str(path))
    return tok


@pytest.fixture()
def hooked(jparams, tparams, tmp_path):
    """Both packages' model managers with the tiny RoBERTa installed."""
    path = tmp_path / "tokenizer.json"
    jtok = _char_tokenizer_file(path)
    JModelManager().set_roberta(jparams, JCFG, jtok)
    ModelManager().set_roberta(tparams, TCFG, WordPieceTokenizer.from_file(path))


@pytest.mark.parametrize("lang", ["zh", "Hybrid-Chinese-English"])
def test_hook_end_to_end_matches_jax(hooked, lang):
    for text in SENTENCES + ["我爱Python，你好世界。"]:
        jids, jbert = jdispatch.get_phones_and_bert(text, lang)
        tids, tbert = tdispatch.get_phones_and_bert(text, lang)
        np.testing.assert_array_equal(tids, np.asarray(jids))
        assert tbert.shape == (len(tids), 1024) and tbert.dtype == np.float32
        np.testing.assert_allclose(tbert, np.asarray(jbert), rtol=1e-4, atol=1e-5)
        assert np.abs(tbert).sum() > 0


def test_hook_rows_nonzero_and_aligned_per_character(hooked):
    for text in SENTENCES:
        _, _, ids, word2ph = chinese_to_phones(text)
        tids, bert = tdispatch.get_phones_and_bert(text, "zh")
        assert len(tids) == len(ids) == sum(word2ph)
        assert np.all(np.abs(bert).sum(axis=1) > 0), "a zero row"
        ofs = 0
        for n in word2ph:                  # phones of one character share a row
            for k in range(1, n):
                np.testing.assert_array_equal(bert[ofs], bert[ofs + k])
            ofs += n
        starts = np.cumsum([0] + list(word2ph[:-1]))
        assert len({bert[s].tobytes() for s in starts}) == len(word2ph)


def test_hook_from_many_threads_at_once(hooked):
    """Server threads call the hook at once: every call gives the
    single-thread features (16 threads, a short switch interval)."""
    import threading

    want = {t: tdispatch.get_phones_and_bert(t, "zh")[1] for t in SENTENCES}
    bad, done = [], []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(i):
        for k in range(6):
            text = SENTENCES[(i + k) % len(SENTENCES)]
            if not np.array_equal(tdispatch.get_phones_and_bert(text, "zh")[1], want[text]):
                bad.append(text)
        done.append(i)

    try:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and len(done) == 16
    assert not bad, bad


def test_english_rows_zero_with_hook(hooked):
    for pkg in (jdispatch, tdispatch):
        ids, bert = pkg.get_phones_and_bert("Hello world.", "en")
        assert len(ids) > 0 and not np.any(bert)


def test_no_hook_gives_zeros():
    for pkg in (jdispatch, tdispatch):
        pkg.set_bert_feature_fn(None)
        ids, bert = pkg.get_phones_and_bert("你好世界。", "zh")
        assert bert.shape == (len(ids), 1024) and not np.any(bert)


class _OffByOne:
    """A tokenizer that gives one content token too many (a
    tokenizer/character mismatch)."""

    def __init__(self, inner):
        self.inner = inner

    def encode(self, text):
        e = self.inner.encode(text)

        class Enc:
            ids = e.ids[:1] + [1] + e.ids[1:]
            attention_mask = [1] * (len(e.ids) + 1)
        return Enc()


def test_tokenizer_mismatch_gives_zeros(jparams, tparams, tmp_path):
    path = tmp_path / "tokenizer.json"
    jtok = _char_tokenizer_file(path)
    JModelManager().set_roberta(jparams, JCFG, _OffByOne(jtok))
    ModelManager().set_roberta(tparams, TCFG, _OffByOne(WordPieceTokenizer.from_file(path)))
    for pkg in (jdispatch, tdispatch):
        ids, bert = pkg.get_phones_and_bert("你好世界。", "zh")
        assert bert.shape == (len(ids), 1024) and not np.any(bert)


def _write_roberta_dir(root: Path, tparams) -> Path:
    """roberta.safetensors (the port's writer), a BERT-layout
    tokenizer.json and a config.json of the tiny geometry."""
    root.mkdir(parents=True, exist_ok=True)
    save_params(tparams, root / "roberta.safetensors")
    vocab = {t: i for i, t in enumerate(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])}
    for c in CHARS + list("我爱？"):
        vocab.setdefault(c, len(vocab))
    (root / "tokenizer.json").write_text(json.dumps(bert_layout(vocab)), encoding="utf-8")
    (root / "config.json").write_text(json.dumps(KW))
    return root


def test_load_roberta_once_per_device(tparams, tmp_path, monkeypatch, caplog):
    root = _write_roberta_dir(tmp_path / "RoBERTa", tparams)
    monkeypatch.setenv("GENIE_ROBERTA_DIR", str(root))
    mgr = ModelManager()
    loaded = mgr.load_roberta("cpu")
    params, cfg, tok = loaded
    assert cfg == TCFG and isinstance(tok, WordPieceTokenizer)
    assert params["word_embed"].dtype == torch.bfloat16
    assert params["embed_norm"]["scale"].dtype == torch.float32
    assert mgr.load_roberta("cpu") is loaded
    _, bert = tdispatch.get_phones_and_bert("你好世界。", "zh")
    assert np.all(np.abs(bert).sum(axis=1) > 0)
    tdispatch.set_bert_feature_fn(None)
    monkeypatch.setenv("GENIE_ROBERTA_DIR", str(tmp_path / "missing"))
    assert ModelManager().load_roberta("cpu") is None
    assert "RoBERTa assets not found" in caplog.text
    _, bert = tdispatch.get_phones_and_bert("你好世界。", "zh")
    assert not np.any(bert)


CARD_STATE = r"""
import sys
for name in ("tokenizers", "jieba", "jieba.posseg", "pypinyin", "nltk"):
    sys.modules[name] = None
import numpy as np
import genie_tts_tpu_torch as genie
from genie_tts_tpu_torch import api
from genie_tts_tpu_torch.frontend import dispatcher
from genie_tts_tpu_torch.frontend import g2p_zh
from genie_tts_tpu_torch.ops.sampling import SamplingConfig

assert not g2p_zh._HAS_JIEBA and not g2p_zh._HAS_PYPINYIN
char_dir, ref_wav = sys.argv[1], sys.argv[2]
genie.load_character("c", char_dir, "zh", device="cpu")
assert api.model_manager.load_roberta("cpu") is not None
zh_ids, zh = dispatcher.get_phones_and_bert("你好世界，这是一个测试。", "zh")
en_ids, en = dispatcher.get_phones_and_bert("Hello world, it costs $5.", "en")
hy_ids, hy = dispatcher.get_phones_and_bert("我爱Python，你好。", "Hybrid-Chinese-English")
assert len(zh_ids) and np.all(np.abs(zh).sum(axis=1) > 0)
assert len(en_ids) and not np.any(en)
assert len(hy_ids) and np.any(hy) and not np.all(np.abs(hy).sum(axis=1) > 0)
genie.set_reference_audio("c", ref_wav, "你好世界。")
ref = api._reference_features(api.model_manager.get("c"), api._reference_audios["c"])
assert np.all(np.abs(ref.bert).sum(axis=1) > 0)
wav = genie.tts("c", "你好世界。", sampling=SamplingConfig(top_k=1))
assert wav is not None and len(wav) > 0 and np.all(np.isfinite(wav))
bad = [m for m in sys.modules if m.split(".")[0] in
       ("jax", "genie_tts_tpu", "tokenizers", "jieba", "pypinyin", "nltk")
       and sys.modules[m] is not None]
assert not bad, bad
print("CARD_STATE_OK", len(zh_ids), len(en_ids), len(hy_ids), len(wav))
"""


def test_card_state_without_optional_packages(tparams, tmp_path):
    """tokenizers, jieba, pypinyin and nltk blocked: RoBERTa loads from
    files, ZH/EN/hybrid text runs through the hooked dispatcher, and a
    Chinese sentence goes through load_character, set_reference_audio
    and tts() with non-zero reference and text BERT."""
    from test_torch_pair import write_character

    char_dir, hub, ref_wav = write_character(tmp_path)
    root = _write_roberta_dir(tmp_path / "RoBERTa", tparams)
    env = dict(os.environ, PYTHONPATH=str(REPO), GENIE_ROBERTA_DIR=str(root),
               GENIE_HUBERT_DIR=str(hub), GENIE_DATA_DIR=str(tmp_path / "GenieData"))
    r = subprocess.run([sys.executable, "-c", CARD_STATE, str(char_dir), str(ref_wav)],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "CARD_STATE_OK" in r.stdout


@pytest.mark.parametrize("lang,ref_text,text", [
    ("zh", "你好世界。", "这是一个测试。"),
    ("en", "Hello world.", "It costs $5, a test."),
])
def test_cli_tts_chinese_and_english(tparams, tmp_path, lang, ref_text, text):
    """``python -m genie_tts_tpu_torch tts --lang zh|en --device cpu`` on the
    tiny character, with RoBERTa read from GENIE_ROBERTA_DIR."""
    import wave

    from test_torch_pair import write_character

    char_dir, hub, ref_wav = write_character(tmp_path)
    root = _write_roberta_dir(tmp_path / "RoBERTa", tparams)
    out = tmp_path / "out.wav"
    env = dict(os.environ, PYTHONPATH=str(REPO), GENIE_ROBERTA_DIR=str(root),
               GENIE_HUBERT_DIR=str(hub), GENIE_DATA_DIR=str(tmp_path / "GenieData"))
    r = subprocess.run([sys.executable, "-m", "genie_tts_tpu_torch", "tts", "--model",
                        str(char_dir), "--lang", lang, "--ref", str(ref_wav), "--ref-text",
                        ref_text, "--text", text, "--out", str(out), "--device", "cpu"],
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    with wave.open(str(out)) as f:
        assert f.getframerate() == 32000 and f.getnframes() > 0
