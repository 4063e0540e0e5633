"""Chinese text normalization (NSW verbalization) — full reference depth.

Covers the same non-standard-word classes as the reference's
``genie_tts/G2P/Chinese/Normalization/`` package
(PaddleSpeech-derived: ``num.py`` 340 lines, ``chronology.py``,
``phonecode.py``, ``quantifier.py``, ``text_normlization.py``): dates,
times and time ranges, temperatures, measures, math expressions, powers,
fractions, percentages, phone numbers (mobile / landline / 400),
numeric ranges, negative numbers, version numbers, decimals,
quantifier-counted integers (with the 二->两 rule), digit strings
(with the 一->幺 rule), Greek letters, circled digits, and
traditional->simplified mapping. Number verbalization follows standard
modern-Chinese reading (一万零二百零三点零四); outputs are golden-tested
against the reference modules executed directly
(tests/test_normalize_zh_golden.py).
"""
from __future__ import annotations

import json
import re
from functools import lru_cache
from importlib import resources
from typing import List

# ---------------------------------------------------------------------------
# Number verbalization core
# ---------------------------------------------------------------------------

_DIGITS = "零一二三四五六七八九"
_SMALL_UNITS = ["", "十", "百", "千"]
_GROUP_UNITS = ["", "万", "亿", "万亿"]


def _verbalize_group(group: str) -> str:
    """Verbalize a 1-4 digit group ('0203' -> 零二百零三 handled by caller)."""
    out = []
    n = len(group)
    pending_zero = False
    for i, ch in enumerate(group):
        d = int(ch)
        unit = _SMALL_UNITS[n - 1 - i]
        if d == 0:
            # zeros only need voicing AFTER an emitted digit (internal
            # gaps: 103 -> 一百零三); leading zeros are the caller's
            # inter-group 零
            if out:
                pending_zero = True
            continue
        if pending_zero:
            out.append(_DIGITS[0])
            pending_zero = False
        out.append(_DIGITS[d] + unit)
    return "".join(out)


def verbalize_cardinal(value: str) -> str:
    """'10203' -> 一万零二百零三. Leading zeros stripped; '000' -> 零."""
    value = value.lstrip("0")
    if not value:
        return _DIGITS[0]
    # split into 4-digit groups from the right
    groups: List[str] = []
    while value:
        groups.append(value[-4:])
        value = value[:-4]
    groups.reverse()  # most-significant first
    out = []
    for gi, g in enumerate(groups):
        spoken = _verbalize_group(g)
        unit = _GROUP_UNITS[len(groups) - 1 - gi]
        if spoken:
            # inter-group zero: a group with a leading 0 digit (e.g. 10203 ->
            # groups 1|0203) needs 零 between 万/亿 sections
            if out and len(g.lstrip("0")) < len(g):
                out.append(_DIGITS[0])
            out.append(spoken + unit)
    result = "".join(out)
    # 一十X -> 十X abbreviation
    if result.startswith("一十"):
        result = result[1:]
    return result or _DIGITS[0]


def verbalize_digit(value: str, alt_one: bool = False) -> str:
    """Digit-by-digit reading; alt_one reads 1 as 幺 (phone numbers)."""
    out = "".join(_DIGITS[int(c)] if c.isdigit() else c for c in value)
    return out.replace("一", "幺") if alt_one else out


def num2str(value: str) -> str:
    """Full number reading: integer part cardinal + 点 + digitwise decimals.

    Trailing-zero quirk preserved from the reference: '3.20' -> 三点二 but
    '3.00' -> 三点零 (decimals ending in 0 keep one zero)."""
    if "." in value:
        integer, decimal = value.split(".", 1)
    else:
        integer, decimal = value, ""
    result = verbalize_cardinal(integer) if integer else ""
    if decimal.endswith("0"):
        decimal = decimal.rstrip("0") + "0"
    else:
        decimal = decimal.rstrip("0")
    if decimal:
        result = (result or _DIGITS[0]) + "点" + verbalize_digit(decimal)
    return result


# ---------------------------------------------------------------------------
# NSW patterns (same classes and precedence as the reference pipeline)
# ---------------------------------------------------------------------------

_NUM = r"(-?)((\d+)(\.\d+)?)|(\.(\d+))"
_RE_DATE = re.compile(
    r"(\d{4}|\d{2})年((0?[1-9]|1[0-2])月)?"
    r"(((0?[1-9])|((1|2)[0-9])|30|31)([日号]))?")
_RE_DATE2 = re.compile(
    r"(\d{4})([- /.])(0[1-9]|1[012])\2(0[1-9]|[12][0-9]|3[01])")
_RE_TIME = re.compile(r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
_RE_TIME_RANGE = re.compile(
    r"([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?"
    r"(~|-)([0-1]?[0-9]|2[0-3]):([0-5][0-9])(:([0-5][0-9]))?")
_MEASURES = [  # EXACT reference iteration order (quantifier.py:20-37):
    # note "m" precedes "mm", so "20mm" reads 二十米米 — a reference quirk
    # kept for behavior parity
    ("cm2", "平方厘米"), ("cm²", "平方厘米"), ("cm3", "立方厘米"),
    ("cm³", "立方厘米"), ("cm", "厘米"), ("db", "分贝"), ("ds", "毫秒"),
    ("kg", "千克"), ("km", "千米"), ("m2", "平方米"), ("m²", "平方米"),
    ("m³", "立方米"), ("m3", "立方米"), ("ml", "毫升"), ("m", "米"),
    ("mm", "毫米"), ("s", "秒"),
]
_UNIT_ALT = "%|°C|℃|度|摄氏度|" + "|".join(re.escape(u) for u, _ in _MEASURES)
_RE_TO_RANGE = re.compile(
    rf"({_NUM})({_UNIT_ALT})[~]({_NUM})({_UNIT_ALT})")
_RE_TEMPERATURE = re.compile(r"(-?)(\d+(\.\d+)?)(°C|℃|度|摄氏度)")
_SUPERSCRIPT = dict(zip("⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ", "0123456789xyn"))
_SUP = "⁰¹²³⁴⁵⁶⁷⁸⁹ˣʸⁿ"
_RE_POWER = re.compile(rf"[{_SUP}]+")
_RE_ASMD = re.compile(
    rf"((-?)((\d+)(\.\d+)?[{_SUP}]*)|(\.\d+[{_SUP}]*)|([A-Za-z][{_SUP}]*))"
    rf"([+\-×÷=])"
    rf"((-?)((\d+)(\.\d+)?[{_SUP}]*)|(\.\d+[{_SUP}]*)|([A-Za-z][{_SUP}]*))")
_RE_FRAC = re.compile(r"(-?)(\d+)/(\d+)")
_RE_PERCENTAGE = re.compile(r"(-?)(\d+(\.\d+)?)%")
_RE_MOBILE = re.compile(
    r"(?<!\d)((\+?86 ?)?1([38]\d|5[0-35-9]|7[678]|9[89])\d{8})(?!\d)")
_RE_TELEPHONE = re.compile(
    r"(?<!\d)((0(10|2[1-3]|[3-9]\d{2})-?)?[1-9]\d{6,7})(?!\d)")
_RE_400 = re.compile(r"(400)(-)?\d{3}(-)?\d{4}")
_RE_RANGE = re.compile(
    r"(?<![\d+\-×÷=])((-?)((\d+)(\.\d+)?))[-~]((-?)((\d+)(\.\d+)?))"
    r"(?![\d+\-×÷=])")
_RE_INTEGER = re.compile(r"(-)(\d+)")
_RE_VERSION = re.compile(r"((\d+)(\.\d+)(\.\d+)?(\.\d+)+)")
_RE_DECIMAL = re.compile(r"(-?)((\d+)(\.\d+))|(\.(\d+))")
_RE_DEFAULT_NUM = re.compile(r"\d{3}\d*")
_RE_NUMBER = re.compile(_NUM)

_ASMD_MAP = {"+": "加", "-": "减", "×": "乘", "÷": "除", "=": "等于"}

_GREEK = {
    "α": "阿尔法", "β": "贝塔", "γ": "伽玛", "Γ": "伽玛", "δ": "德尔塔",
    "Δ": "德尔塔", "ε": "艾普西龙", "ζ": "捷塔", "η": "依塔", "θ": "西塔",
    "Θ": "西塔", "ι": "艾欧塔", "κ": "喀帕", "λ": "拉姆达", "Λ": "拉姆达",
    "μ": "缪", "ν": "拗", "ξ": "克西", "Ξ": "克西", "ο": "欧米克伦",
    "π": "派", "Π": "派", "ρ": "肉", "ς": "西格玛", "Σ": "西格玛",
    "σ": "西格玛", "τ": "套", "υ": "宇普西龙", "φ": "服艾", "Φ": "服艾",
    "χ": "器", "ψ": "普赛", "Ψ": "普赛", "ω": "欧米伽", "Ω": "欧米伽",
}
_CIRCLED = dict(zip("①②③④⑤⑥⑦⑧⑨⑩", "一二三四五六七八九十"))

# 量词 set for the quantifier rule (二 -> 两); the reference's giant
# alternation boils down to "digit(s) [多余几+]? quantifier"
_QUANTIFIERS = (
    "处|台|架|枚|趟|幅|平|方|堵|间|床|株|批|项|例|列|篇|栋|注|亩|封|艘|把|目|套|"
    "段|人|所|朵|匹|张|座|回|场|尾|条|个|首|阙|阵|网|炮|顶|丘|棵|只|支|袭|辆|挑|"
    "担|颗|壳|窠|曲|墙|群|腔|砣|客|贯|扎|捆|刀|令|打|手|罗|坡|山|岭|江|溪|钟|队|"
    "单|双|对|出|口|头|脚|板|跳|枝|件|贴|针|线|管|名|位|身|堂|课|本|页|家|户|层|"
    "丝|毫|厘|分|钱|两|斤|铢|石|钧|锱|忽|(?:千|毫|微)克|(?:公)?分|寸|尺|丈|里|"
    "寻|常|铺|程|(?:千|分|厘|毫|微)米|米|撮|勺|合|升|斗|盘|碗|碟|叠|桶|笼|盆|盒|"
    "杯|斛|锅|簋|篮|罐|瓶|壶|卮|盏|箩|箱|煲|啖|袋|钵|年|月|日|季|刻|时|周|天|秒|"
    "小时|旬|纪|岁|世|更|夜|春|夏|秋|冬|代|伏|辈|丸|泡|粒|幢|堆|根|道|面|片|块|"
    "元|(?:亿|千万|百万|万|千|百)|(?:亿|千万|百万|万|千|百|美)?元|"
    "(?:亿|千万|百万|万|千|百|十)?吨|(?:亿|千万|百万|万|千|百)?块|角|毛"
)
_RE_QUANTIFIER = re.compile(rf"(\d+)([多余几+])?({_QUANTIFIERS})")

# fullwidth -> halfwidth for LETTERS, DIGITS and space only — the
# reference does NOT fold fullwidth punctuation here (constants.py tables)
_F2H = {chr(ord(c) + 0xFEE0): c for c in
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"}
_F2H["　"] = " "


# ---------------------------------------------------------------------------
# Replacement functions
# ---------------------------------------------------------------------------

def _time_num(num: str) -> str:
    s = num2str(num.lstrip("0") or "0")
    if num.startswith("0") and num.lstrip("0"):
        s = _DIGITS[0] + s
    elif not num.lstrip("0"):
        s = _DIGITS[0]
    return s


def _fmt_time(hour, minute, second) -> str:
    out = f"{num2str(hour)}点"
    if minute and minute.lstrip("0"):
        out += "半" if int(minute) == 30 else f"{_time_num(minute)}分"
    if second and second.lstrip("0"):
        out += f"{_time_num(second)}秒"
    return out


def _sub_time_range(m: re.Match) -> str:
    # reference quirk kept: the 半 decision for the SECOND time tests the
    # FIRST minute value (chronology.py:87)
    first = _fmt_time(m.group(1), m.group(2), m.group(4))
    out = first + "至" + f"{num2str(m.group(6))}点"
    minute2, minute1 = m.group(7), m.group(2)
    if minute2 and minute2.lstrip("0"):
        out += "半" if int(minute1) == 30 else f"{_time_num(minute2)}分"
    if m.group(9) and m.group(9).lstrip("0"):
        out += f"{_time_num(m.group(9))}秒"
    return out


def _sub_time(m: re.Match) -> str:
    return _fmt_time(m.group(1), m.group(2), m.group(4))


def _sub_date(m: re.Match) -> str:
    out = ""
    if m.group(1):
        out += f"{verbalize_digit(m.group(1))}年"
    if m.group(3):
        out += f"{verbalize_cardinal(m.group(3))}月"
    if m.group(5):
        out += f"{verbalize_cardinal(m.group(5))}{m.group(9)}"
    return out


def _sub_date2(m: re.Match) -> str:
    return (f"{verbalize_digit(m.group(1))}年"
            f"{verbalize_cardinal(m.group(3))}月"
            f"{verbalize_cardinal(m.group(4))}日")


def _sub_temperature(m: re.Match) -> str:
    sign = "零下" if m.group(1) else ""
    # reference quirk kept: replace_temperature reads its group(3) — the
    # DECIMAL group, never the unit — so 摄氏度 always verbalizes as 度
    # (quantifier.py:41-54)
    return f"{sign}{num2str(m.group(2))}度"


def _sub_frac(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(3))}分之{num2str(m.group(2))}"


def _sub_percentage(m: re.Match) -> str:
    sign = "负" if m.group(1) else ""
    return f"{sign}百分之{num2str(m.group(2))}"


def _phone2str(s: str, mobile: bool = True) -> str:
    parts = s.strip("+").split() if mobile else s.split("-")
    return "，".join(verbalize_digit(p, alt_one=True) for p in parts)


def _sub_number(m: re.Match) -> str:
    if m.group(5):  # pure decimal .22
        return num2str(m.group(5))
    sign = "负" if m.group(1) else ""
    return f"{sign}{num2str(m.group(2))}"


def _sub_range(m: re.Match) -> str:
    first = _RE_NUMBER.sub(_sub_number, m.group(1))
    second = _RE_NUMBER.sub(_sub_number, m.group(6))
    return f"{first}到{second}"


def _sub_quantifier(m: re.Match) -> str:
    number = num2str(m.group(1))
    if number == "二":
        number = "两"
    mid = m.group(2) or ""
    if mid == "+":
        mid = "多"
    return f"{number}{mid}{m.group(3)}"


def _sub_version(m: re.Match) -> str:
    return "".join("点" if c == "." else num2str(c) for c in m.group(1))


def _sub_power(m: re.Match) -> str:
    return "的" + "".join(_SUPERSCRIPT[c] for c in m.group(0)) + "次方"


# ---------------------------------------------------------------------------
# Traditional -> simplified (seed table + optional GenieData extension)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=1)
def _t2s_table() -> dict:
    with resources.files(__package__ + ".data").joinpath(
            "trad2simp_seed.json").open("r", encoding="utf-8") as f:
        return json.load(f)


def traditional_to_simplified(text: str) -> str:
    table = _t2s_table()
    return "".join(table.get(c, c) for c in text)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------

_SENT_SPLIT = re.compile(r"([：、，；。？！,;?!][”’]?)")
_STRIP_SPECIAL = re.compile(r"[——《》【】<>{}()（）#&@“”^_|\\]")
_POST_STRIP = re.compile(r"[-——《》【】<=>{}()（）#&@“”^_|\\]")


def _normalize_sentence(s: str) -> str:
    s = traditional_to_simplified(s)
    s = s.translate(str.maketrans(_F2H))
    s = _RE_DATE.sub(_sub_date, s)
    s = _RE_DATE2.sub(_sub_date2, s)
    s = _RE_TIME_RANGE.sub(_sub_time_range, s)
    s = _RE_TIME.sub(_sub_time, s)
    s = _RE_TO_RANGE.sub(lambda m: m.group(0).replace("~", "至"), s)
    s = _RE_TEMPERATURE.sub(_sub_temperature, s)
    for unit, reading in _MEASURES:
        if unit in s:
            s = s.replace(unit, reading)
    while _RE_ASMD.search(s):
        s = _RE_ASMD.sub(lambda m: m.group(1) + _ASMD_MAP[m.group(8)] + m.group(9), s)
    s = _RE_POWER.sub(_sub_power, s)
    s = _RE_FRAC.sub(_sub_frac, s)
    s = _RE_PERCENTAGE.sub(_sub_percentage, s)
    s = _RE_MOBILE.sub(lambda m: _phone2str(m.group(0)), s)
    s = _RE_TELEPHONE.sub(lambda m: _phone2str(m.group(0), mobile=False), s)
    s = _RE_400.sub(lambda m: _phone2str(m.group(0), mobile=False), s)
    s = _RE_RANGE.sub(_sub_range, s)
    s = _RE_INTEGER.sub(lambda m: "负" + num2str(m.group(2)), s)
    s = _RE_VERSION.sub(_sub_version, s)
    s = _RE_DECIMAL.sub(_sub_number, s)
    s = _RE_QUANTIFIER.sub(_sub_quantifier, s)
    s = _RE_DEFAULT_NUM.sub(lambda m: verbalize_digit(m.group(0), alt_one=True), s)
    s = _RE_NUMBER.sub(_sub_number, s)
    s = _post_replace(s)
    return s


def _post_replace(s: str) -> str:
    s = s.replace("/", "每")
    for k, v in _CIRCLED.items():
        s = s.replace(k, v)
    for k, v in _GREEK.items():
        s = s.replace(k, v)
    for k, v in _ASMD_MAP.items():
        s = s.replace(k, v if k != "=" else "等")
    return _POST_STRIP.sub("", s)


def number_to_hanzi(n: int) -> str:
    """Cardinal reading of a Python int (compat helper)."""
    return ("负" if n < 0 else "") + verbalize_cardinal(str(abs(n)))


def digits_to_hanzi(s: str, alt_one: bool = True) -> str:
    """Digit-string reading, 幺 for 1 by default (compat helper)."""
    return verbalize_digit(s, alt_one=alt_one)


# punctuation canonicalization + charset filter (reference
# ChineseG2P._replace_punctuation + pattern_filter/pattern_consecutive)
PUNCTUATION = ["!", "?", "…", ",", ".", "-"]
_PUNCT_MAP = {
    "：": ",", "；": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": ".", "·": ",", "、": ",", "$": ".", "/": ",", "—": "-",
    "~": "…", "～": "…",
}
_ALLOWED = "".join(re.escape(p) for p in PUNCTUATION)
_RE_FILTER = re.compile(r"[^一-龥" + _ALLOWED + r"]+")
_RE_CONSECUTIVE = re.compile(f"([{_ALLOWED}])\\1+")


def replace_punctuation(text: str) -> str:
    """Map CJK punctuation to the canonical ASCII set, drop everything that
    is neither hanzi nor allowed punctuation, squeeze repeats."""
    text = text.replace("...", "…")
    for k, v in _PUNCT_MAP.items():
        text = text.replace(k, v)
    text = _RE_FILTER.sub("", text)
    return _RE_CONSECUTIVE.sub(r"\1", text)


def normalize_chinese(text: str) -> str:
    """Full normalization: split on sentence punctuation, verbalize every
    NSW class, rejoin (the reference normalizes per sentence too)."""
    text = text.replace(" ", "")
    text = _STRIP_SPECIAL.sub("", text)
    parts = []
    buf = ""
    for piece in _SENT_SPLIT.split(text):
        buf += piece
        if _SENT_SPLIT.fullmatch(piece):
            parts.append(buf)
            buf = ""
    if buf:
        parts.append(buf)
    out = "".join(_normalize_sentence(p) for p in parts if p.strip())
    return replace_punctuation(out)
