"""The port's English, Chinese and hybrid frontends vs the JAX package's.

Each corpus case runs the same sentences through both packages and wants
exactly equal outputs (no tolerance: these are strings and integers):
the normalized text, the phoneme symbols and ids, and for Chinese the
pinyins and ``word2ph``. Chinese and hybrid text run twice: with
``jieba`` (POS segmentation, search-mode sandhi splits) and without it,
the state of a machine that lacks it (both packages' ``g2p_zh`` flags
patched off and ``import jieba`` made to fail). Both packages'
``lru_cache``d dictionaries are cleared before and after every case.
No GenieData G2P assets are present, so both take their rule paths
(seed pinyin dictionary, rule LTS, no neural G2P).
"""
import functools
import importlib
import sys

import numpy as np
import pytest

MODULES = ("normalize_en", "pos_lite", "g2p_en_nn", "g2p_en", "normalize_zh",
           "polyphone", "tone_sandhi", "g2p_zh", "symbols", "dispatcher")
PACKAGES = ("genie_tts_tpu", "genie_tts_tpu_torch")

ZH = {
    "numbers": [
        "我有3个苹果。", "他今年25岁了。", "这个数是1234567。", "价格是3.14元。",
        "一共有100000001个人。", "电话号码是13812345678。", "比分是3比2。",
        "第1次和第2次。", "负5是一个数。", "他的分数是-3.5分。",
    ],
    "dates_times": [
        "2024年3月5日是星期二。", "今天是2023-10-01。", "现在是下午3:30。",
        "会议在9:00到10:30之间。", "1999年12月31日。", "他2008年8月8日来的。",
    ],
    "units_percent": [
        "他跑了5km。", "体重是60kg。", "温度是25°C。", "面积是100m²。",
        "百分之五十，也就是50%。", "水有2.5L。", "长3cm，宽4mm。",
    ],
    "currency": [
        "这本书要￥35。", "他给了我$100。", "一共是3.5元。", "花了2万元。",
        "一千块钱，两百块钱。",
    ],
    "traditional": [
        "這是一個測試。", "我們會說中國話。", "學習漢語很難。", "東西都買了。",
        "電話號碼是多少？",
    ],
    "polyphones": [
        "银行的行长来了。", "他长大了。", "我觉得很好。", "音乐让人快乐。",
        "重庆是个好地方。", "这个东西很便宜。", "他在睡觉。", "还有什么事吗？",
        "我还是不知道。", "教师在教书。", "他得了第一。", "你得去上学。",
        "这个地方很好看。", "他重新看了一遍。",
    ],
    "tone_sandhi": [
        "你好，我很好。", "我也想买。", "一个人，一天，一样。", "不是不对。",
        "看一看，想一想。", "第一，一二三。", "老老实实的人。", "小小的手。",
        "展览馆里有很多人。", "不要不去。", "他不会来了吗？", "我只有五本书。",
    ],
    "erhua_punct": [
        "花儿开了！", "女儿在哪儿？", "这是什么？你说呢。", "天啊……太好了！",
        "“你好”，他说。", "好——好吧。",
    ],
}

EN = {
    "numbers": [
        "I have 3 apples.", "There are 1,234 people.", "The score was 21 to 13.",
        "He was born in 1999.", "The 1st and 2nd places.", "Call 555-1234 now.",
        "In 2005 and 1900 they met.", "Version 3.14 is out.",
        "The temperature is -5 degrees.", "Chapter 11 begins.",
    ],
    "dates_times_units": [
        "At 3:30 pm we leave.", "On 12/25/2023 we met.", "It weighs 5kg.",
        "He ran 10 km today.", "About 50% off.", "Dr. Smith lives on Main St.",
        "Mr. and Mrs. Jones came.", "It is 100 degrees!",
    ],
    "currency": [
        "It costs $5.50 please.", "Pay £20 now.", "I owe you $1,000,000.",
        "That's 99 cents.", "It was $3 a pound.",
    ],
    "homographs": [
        "I read the book yesterday.", "I will read the book.",
        "Lead the way with a lead pipe.", "I live here, and the show is live.",
        "Wind the clock in the wind.", "They record a new record.",
        "Please present the present.", "The project will project growth.",
        "I object to that object.", "Tear the paper, do not shed a tear.",
        "Close the door, it is close.", "What is the use? Use it.",
        "I am content with the content.",
    ],
    "oov_runtogether": [
        "helloworld is one word.", "The quickbrownfox jumps.",
        "Zyxwv blorft grimble.", "I love thisisatest.", "GitHub and YouTube.",
        "The xylophonist played.", "Qwerty keyboards.", "Schmidt's wiener.",
        "The cat's toy and the dogs' bones.", "A well-known fact.",
        "State-of-the-art tech.", "Don't, can't, won't.", "I'm sure they've gone.",
    ],
    "punct_misc": [
        "Hello world, this is a test.", "Stop. Now!", "What? Really...",
        "Wait - no!", "NASA and FBI agents.", "I'll be back.", "Ok.",
    ],
}

HYBRID = {
    "words": [
        "我爱Python编程。", "今天的meeting很重要。", "这个app很好用。",
        "他用iPhone打电话。", "我们去KTV唱歌吧。", "这是OK的。", "AI改变了世界。",
        "他在Google工作。", "这个bug很难修。", "请发email给我。",
        "我喜欢hello kitty。", "她说了一声thank you。", "我的WiFi坏了。",
        "今天是Monday。", "这个project很大。", "你有time吗？",
    ],
    "numbers": [
        "这是3D电影。", "买了2个iPad。", "他有100 dollars。", "在2024年用GPT4。",
        "价格是$5，很便宜。", "我跑了5km，很累。", "iOS 17很好用。",
        "打了50%的折。",
    ],
    "polyphones_sandhi": [
        "银行的CEO来了。", "我觉得game很好玩。", "你好，hello。", "不是bug，是feature。",
        "一个team，一个goal。", "他长大了，成了doctor。", "还有什么question吗？",
        "音乐app让人快乐。",
    ],
    "mixed": [
        "Hello，你好。", "OK，好的。", "我read了这本book。", "他live在北京。",
        "我们record一下。", "helloworld你好。", "這是test。", "東西在box里。",
        "Yes！我们赢了！", "小明说：Good morning！", "我们的team有5个人。",
        "他用Chrome上网。", "今天天气good。", "这个idea不错。",
        "我想learn中文。", "start和stop。", "zyxwv是什么？", "他的blog很有名。",
    ],
}


def _corpus(table):
    return [(k, v) for k, v in table.items()]


def test_corpora_are_large():
    for table in (ZH, EN, HYBRID):
        assert sum(len(v) for v in table.values()) >= 50


def _modules(pkg):
    return {m: importlib.import_module(f"{pkg}.frontend.{m}") for m in MODULES}


def _clear_caches():
    for pkg in PACKAGES:
        for mod in _modules(pkg).values():
            for obj in vars(mod).values():
                if isinstance(obj, functools._lru_cache_wrapper):
                    obj.cache_clear()


@pytest.fixture(params=["jieba", "no_jieba"])
def jieba_state(request, monkeypatch):
    if request.param == "jieba":
        pytest.importorskip("jieba")
    else:
        for pkg in PACKAGES:
            g2p_zh = importlib.import_module(f"{pkg}.frontend.g2p_zh")
            monkeypatch.setattr(g2p_zh, "_HAS_JIEBA", False)
            monkeypatch.setattr(g2p_zh, "jieba", None)
        for name in ("jieba", "jieba.posseg"):
            monkeypatch.setitem(sys.modules, name, None)
    _clear_caches()
    yield request.param
    _clear_caches()


def _zh_outputs(pkg, text):
    m = _modules(pkg)
    norm, pinyins, phones, word2ph = m["g2p_zh"].chinese_to_phone_data(text)
    _, _, ids, _ = m["g2p_zh"].chinese_to_phones(text)
    return dict(normalized=m["normalize_zh"].normalize_chinese(text),
                norm_text=norm, pinyins=pinyins, phones=phones, word2ph=word2ph,
                ids=list(ids))


def _en_outputs(pkg, text):
    m = _modules(pkg)
    return dict(normalized=m["normalize_en"].normalize_english(text.lower()),
                phones=m["g2p_en"].english_to_phone_strs(text),
                ids=list(m["g2p_en"].english_to_phones(text)))


def _hybrid_outputs(pkg, text):
    m = _modules(pkg)
    ids, bert = m["dispatcher"].get_phones_and_bert(text, "Hybrid-Chinese-English")
    return dict(chunks=m["dispatcher"].split_zh_en(text), ids=ids.tolist(),
                bert_shape=bert.shape, bert_zero=not np.any(bert))


def _assert_same(fn, sentences):
    bad = []
    for text in sentences:
        j, t = fn("genie_tts_tpu", text), fn("genie_tts_tpu_torch", text)
        if j != t:
            bad.append((text, {k: (j[k], t[k]) for k in j if j[k] != t[k]}))
    assert not bad, bad


@pytest.fixture(autouse=True)
def _no_hook():
    """Both packages' BERT hooks unset (zero Chinese BERT)."""
    from genie_tts_tpu.frontend import dispatcher as jd
    from genie_tts_tpu_torch.frontend import dispatcher as td

    saved = (jd._bert_feature_fn, td._bert_feature_fn)
    jd.set_bert_feature_fn(None)
    td.set_bert_feature_fn(None)
    yield
    jd.set_bert_feature_fn(saved[0])
    td.set_bert_feature_fn(saved[1])


@pytest.mark.parametrize("category,sentences", _corpus(ZH), ids=list(ZH))
def test_chinese_matches_jax(jieba_state, category, sentences):
    _assert_same(_zh_outputs, sentences)


@pytest.mark.parametrize("category,sentences", _corpus(EN), ids=list(EN))
def test_english_matches_jax(category, sentences):
    _clear_caches()
    _assert_same(_en_outputs, sentences)


@pytest.mark.parametrize("category,sentences", _corpus(HYBRID), ids=list(HYBRID))
def test_hybrid_matches_jax(jieba_state, category, sentences):
    _assert_same(_hybrid_outputs, sentences)


def test_dispatcher_routes_every_language():
    """get_phones_and_bert serves en, zh and hybrid with zero BERT rows when
    no hook is installed, with the same ids as the JAX dispatcher."""
    from genie_tts_tpu.frontend.dispatcher import get_phones_and_bert as jget
    from genie_tts_tpu_torch.frontend.dispatcher import get_phones_and_bert

    for text, lang in (("你好，世界。", "zh"), ("Hello world.", "en"),
                       ("我爱Python。", "Hybrid-Chinese-English"),
                       ("こんにちは。", "ja")):
        ids, bert = get_phones_and_bert(text, lang)
        jids, jbert = jget(text, lang)
        assert ids.dtype == np.int32 and len(ids) > 0
        np.testing.assert_array_equal(ids, np.asarray(jids))
        assert bert.shape == (len(ids), 1024) and not np.any(bert)
    with pytest.raises(ValueError):
        get_phones_and_bert("x", "klingon")
