"""Mandarin tone sandhi — full reference-fidelity rule set.

Re-owns the content of the reference's ToneSandhi
(``genie_tts/G2P/Chinese/ToneSandhi.py``, the
PaddleSpeech rule set): the must/must-not neutral-tone lexicons, the
POS-gated neutralization rules, 不/一 sandhi, third-tone sandhi with
word-splitting, and the pre-merge segmentation passes
(不/一/reduplication/continuous-third-tone/儿 merging) that reshape the
jieba segmentation before tones are modified.

Operates on pinyin syllables with trailing tone digits ("hao3"): every
rule only reads/writes the final digit, so full syllables behave exactly
like the reference's FINALS_TONE3 finals.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Lexicons (data: PaddleSpeech/GPT-SoVITS neutral-tone word lists)
# ---------------------------------------------------------------------------

MUST_NEURAL = {
    "麻烦", "麻利", "鸳鸯", "高粱", "骨头", "骆驼", "马虎", "首饰", "馒头", "馄饨",
    "风筝", "难为", "队伍", "阔气", "闺女", "门道", "锄头", "铺盖", "铃铛", "铁匠",
    "钥匙", "里脊", "里头", "部分", "那么", "道士", "造化", "迷糊", "连累", "这么",
    "这个", "运气", "过去", "软和", "转悠", "踏实", "跳蚤", "跟头", "趔趄", "财主",
    "豆腐", "讲究", "记性", "记号", "认识", "规矩", "见识", "裁缝", "补丁", "衣裳",
    "衣服", "衙门", "街坊", "行李", "行当", "蛤蟆", "蘑菇", "薄荷", "葫芦", "葡萄",
    "萝卜", "荸荠", "苗条", "苗头", "苍蝇", "芝麻", "舒服", "舒坦", "舌头", "自在",
    "膏药", "脾气", "脑袋", "脊梁", "能耐", "胳膊", "胭脂", "胡萝", "胡琴", "胡同",
    "聪明", "耽误", "耽搁", "耷拉", "耳朵", "老爷", "老实", "老婆", "老头", "老太",
    "翻腾", "罗嗦", "罐头", "编辑", "结实", "红火", "累赘", "糨糊", "糊涂", "精神",
    "粮食", "簸箕", "篱笆", "算计", "算盘", "答应", "笤帚", "笑语", "笑话", "窟窿",
    "窝囊", "窗户", "稳当", "稀罕", "称呼", "秧歌", "秀气", "秀才", "福气", "祖宗",
    "砚台", "码头", "石榴", "石头", "石匠", "知识", "眼睛", "眯缝", "眨巴", "眉毛",
    "相声", "盘算", "白净", "痢疾", "痛快", "疟疾", "疙瘩", "疏忽", "畜生", "生意",
    "甘蔗", "琵琶", "琢磨", "琉璃", "玻璃", "玫瑰", "玄乎", "狐狸", "状元", "特务",
    "牲口", "牙碜", "牌楼", "爽快", "爱人", "热闹", "烧饼", "烟筒", "烂糊", "点心",
    "炊帚", "灯笼", "火候", "漂亮", "滑溜", "溜达", "温和", "清楚", "消息", "浪头",
    "活泼", "比方", "正经", "欺负", "模糊", "槟榔", "棺材", "棒槌", "棉花", "核桃",
    "栅栏", "柴火", "架势", "枕头", "枇杷", "机灵", "本事", "木头", "木匠", "朋友",
    "月饼", "月亮", "暖和", "明白", "时候", "新鲜", "故事", "收拾", "收成", "提防",
    "挖苦", "挑剔", "指甲", "指头", "拾掇", "拳头", "拨弄", "招牌", "招呼", "抬举",
    "护士", "折腾", "扫帚", "打量", "打算", "打点", "打扮", "打听", "打发", "扎实",
    "扁担", "戒指", "懒得", "意识", "意思", "情形", "悟性", "怪物", "思量", "怎么",
    "念头", "念叨", "快活", "忙活", "志气", "心思", "得罪", "张罗", "弟兄", "开通",
    "应酬", "庄稼", "干事", "帮手", "帐篷", "希罕", "师父", "师傅", "巴结", "巴掌",
    "差事", "工夫", "岁数", "屁股", "尾巴", "少爷", "小气", "小伙", "将就", "对头",
    "对付", "寡妇", "家伙", "客气", "实在", "官司", "学问", "学生", "字号", "嫁妆",
    "媳妇", "媒人", "婆家", "娘家", "委屈", "姑娘", "姐夫", "妯娌", "妥当", "妖精",
    "奴才", "女婿", "头发", "太阳", "大爷", "大方", "大意", "大夫", "多少", "多么",
    "外甥", "壮实", "地道", "地方", "在乎", "困难", "嘴巴", "嘱咐", "嘟囔", "嘀咕",
    "喜欢", "喇嘛", "喇叭", "商量", "唾沫", "哑巴", "哈欠", "哆嗦", "咳嗽", "和尚",
    "告诉", "告示", "含糊", "吓唬", "后头", "名字", "名堂", "合同", "吆喝", "叫唤",
    "口袋", "厚道", "厉害", "千斤", "包袱", "包涵", "匀称", "勤快", "动静", "动弹",
    "功夫", "力气", "前头", "刺猬", "刺激", "别扭", "利落", "利索", "利害", "分析",
    "出息", "凑合", "凉快", "冷战", "冤枉", "冒失", "养活", "关系", "先生", "兄弟",
    "便宜", "使唤", "佩服", "作坊", "体面", "位置", "似的", "伙计", "休息", "什么",
    "人家", "亲戚", "亲家", "交情", "云彩", "事情", "买卖", "主意", "丫头", "丧气",
    "两口", "东西", "东家", "世故", "不由", "不在", "下水", "下巴", "上头", "上司",
    "丈夫", "丈人", "一辈", "那个", "菩萨", "父亲", "母亲", "咕噜", "邋遢", "费用",
    "冤家", "甜头", "介绍", "荒唐", "大人", "泥鳅", "幸福", "熟悉", "计划", "扑腾",
    "蜡烛", "姥爷", "照顾", "喉咙", "吉他", "弄堂", "蚂蚱", "凤凰", "拖沓", "寒碜",
    "糟蹋", "倒腾", "报复", "逻辑", "盘缠", "喽啰", "牢骚", "咖喱", "扫把", "惦记",
}
MUST_NOT_NEURAL = {
    "男子", "女子", "分子", "原子", "量子", "莲子", "石子", "瓜子", "电子", "人人",
    "虎虎", "幺幺", "干嘛", "学子", "哈哈", "数数", "袅袅", "局地", "以下", "娃哈哈",
    "花花草草", "留得", "耕地", "想想", "熙熙", "攘攘", "卵子", "死死", "冉冉", "恳恳",
    "佼佼", "吵吵", "打打", "考考", "整整", "莘莘", "落地", "算子", "家家户户", "青青",
}
_PUNC = "：，；。？！“”‘’':,;.?!"

SplitFn = Callable[[str], List[str]]
FinalsFn = Callable[[str], List[str]]


def _tone(p: str) -> str:
    return p[-1] if p else ""


def _set(p: str, t: str) -> str:
    return p[:-1] + t if p else p


def _all_three(finals: Sequence[str]) -> bool:
    return bool(finals) and all(len(x) > 0 and x[-1] == "3" for x in finals)


def _default_split(word: str) -> List[str]:
    """Binary word split via jieba's search-mode when available; the
    reference splits on the shortest search-mode subword
    (ToneSandhi._split_word)."""
    try:
        import jieba

        subs = sorted(jieba.cut_for_search(word), key=len)
    except Exception:
        subs = [word[: len(word) // 2 or 1]]
    first = subs[0] if subs else word
    idx = word.find(first)
    if idx == 0:
        return [first, word[len(first):]]
    return [word[: -len(first)], first]


# ---------------------------------------------------------------------------
# Per-word tone modification (reference ToneSandhi.modified_tone)
# ---------------------------------------------------------------------------

def bu_sandhi(word: str, finals: List[str]) -> List[str]:
    out = list(finals)
    if len(word) == 3 and word[1] == "不":
        out[1] = _set(out[1], "5")
        return out
    for i, ch in enumerate(word):
        if ch == "不" and i + 1 < len(word) and _tone(out[i + 1]) == "4":
            out[i] = _set(out[i], "2")
    return out


def yi_sandhi(word: str, finals: List[str]) -> List[str]:
    out = list(finals)
    if "一" in word and all(c.isnumeric() for c in word if c != "一"):
        return out
    if len(word) == 3 and word[1] == "一" and word[0] == word[-1]:
        out[1] = _set(out[1], "5")
        return out
    if word.startswith("第一"):
        out[1] = _set(out[1], "1")
        return out
    for i, ch in enumerate(word):
        if ch == "一" and i + 1 < len(word):
            if _tone(out[i + 1]) == "4":
                out[i] = _set(out[i], "2")
            elif word[i + 1] not in _PUNC:
                out[i] = _set(out[i], "4")
    return out


def neural_sandhi(word: str, pos: str, finals: List[str],
                  split_fn: Optional[SplitFn] = None) -> List[str]:
    out = list(finals)
    # reduplication inside n/v/a words: 奶奶, 试试
    for j in range(1, len(word)):
        if (word[j] == word[j - 1] and pos[:1] in {"n", "v", "a"}
                and word not in MUST_NOT_NEURAL and j < len(out)):
            out[j] = _set(out[j], "5")
    ge_idx = word.find("个")
    if word and word[-1] in "吧呢哈啊呐噻嘛吖嗨呐哦哒额滴哩哟喽啰耶喔诶":
        out[-1] = _set(out[-1], "5")
    elif word and word[-1] in "的地得":
        out[-1] = _set(out[-1], "5")
    elif len(word) == 1 and word in "了着过" and pos in {"ul", "uz", "ug"}:
        out[-1] = _set(out[-1], "5")
    elif (len(word) > 1 and word[-1] in "们子" and pos in {"r", "n"}
          and word not in MUST_NOT_NEURAL):
        out[-1] = _set(out[-1], "5")
    elif len(word) > 1 and word[-1] in "上下里" and pos in {"s", "l", "f"}:
        out[-1] = _set(out[-1], "5")
    elif len(word) > 1 and word[-1] in "来去" and word[-2] in "上下进出回过起开":
        out[-1] = _set(out[-1], "5")
    elif ((ge_idx >= 1 and (word[ge_idx - 1].isnumeric()
                            or word[ge_idx - 1] in "几有两半多各整每做是"))
          or word == "个"):
        out[ge_idx] = _set(out[ge_idx], "5")
    elif word in MUST_NEURAL or word[-2:] in MUST_NEURAL:
        out[-1] = _set(out[-1], "5")
    # sub-word lexicon pass
    split = (split_fn or _default_split)(word)
    parts = [out[: len(split[0])], out[len(split[0]):]]
    for i, sub in enumerate(split):
        if (sub in MUST_NEURAL or sub[-2:] in MUST_NEURAL) and parts[i]:
            parts[i][-1] = _set(parts[i][-1], "5")
    return parts[0] + parts[1]


def three_sandhi(word: str, finals: List[str],
                 split_fn: Optional[SplitFn] = None) -> List[str]:
    out = list(finals)
    split_fn = split_fn or _default_split
    if len(word) == 2 and _all_three(out):
        out[0] = _set(out[0], "2")
    elif len(word) == 3:
        split = split_fn(word)
        if _all_three(out):
            if len(split[0]) == 2:      # 蒙古/包
                out[0] = _set(out[0], "2")
                out[1] = _set(out[1], "2")
            elif len(split[0]) == 1:    # 纸/老虎
                out[1] = _set(out[1], "2")
        else:
            parts = [out[: len(split[0])], out[len(split[0]):]]
            for i, sub in enumerate(parts):
                if _all_three(sub) and len(sub) == 2:
                    parts[i][0] = _set(parts[i][0], "2")
                elif (i == 1 and not _all_three(sub) and sub
                      and _tone(sub[0]) == "3" and parts[0]
                      and _tone(parts[0][-1]) == "3"):
                    parts[0][-1] = _set(parts[0][-1], "2")
            out = parts[0] + parts[1]
    elif len(word) == 4:                # idioms: 2 + 2
        parts = [out[:2], out[2:]]
        out = []
        for sub in parts:
            if _all_three(sub):
                sub[0] = _set(sub[0], "2")
            out += sub
    return out


def modified_tone(word: str, pos: str, finals: List[str],
                  split_fn: Optional[SplitFn] = None) -> List[str]:
    """不 -> 一 -> neutral -> third-tone, the reference ordering."""
    finals = bu_sandhi(word, finals)
    finals = yi_sandhi(word, finals)
    finals = neural_sandhi(word, pos, finals, split_fn)
    finals = three_sandhi(word, finals, split_fn)
    return finals


# ---------------------------------------------------------------------------
# Pre-merge passes over the segmentation (reference pre_merge_for_modify)
# ---------------------------------------------------------------------------

def _merge_bu(seg):
    out = []
    last = ""
    for word, pos in seg:
        if last == "不":
            word = last + word
        if word != "不":
            out.append((word, pos))
        last = word
    if last == "不":
        out.append((last, "d"))
    return out


def _merge_yi(seg):
    out = []
    i = 0
    while i < len(seg):               # V一V: 看一看 -> one word
        word, pos = seg[i]
        if (i >= 1 and word == "一" and i + 1 < len(seg)):
            last = out[-1] if out else seg[i - 1]
            if last[0] == seg[i + 1][0] and last[1] == "v" and seg[i + 1][1] == "v":
                out[-1] = (last[0] + "一" + seg[i + 1][0], last[1])
                i += 2
                continue
        out.append((word, pos))
        i += 1
    merged = []
    for word, pos in out:             # dangling 一 attaches forward
        if merged and merged[-1][0] == "一":
            merged[-1] = (merged[-1][0] + word, merged[-1][1])
        else:
            merged.append((word, pos))
    return merged


def _merge_reduplication(seg):
    out = []
    for word, pos in seg:
        if out and word == out[-1][0]:
            out[-1] = (out[-1][0] + word, out[-1][1])
        else:
            out.append((word, pos))
    return out


def _is_reduplication(word: str) -> bool:
    return len(word) == 2 and word[0] == word[1]


def _merge_three(seg, finals_fn: FinalsFn, whole_word: bool):
    """Merge adjacent short words over a third-tone boundary.

    ``whole_word``: both words entirely tone-3 (pass 1) vs only the
    boundary syllables tone-3 (pass 2)."""
    finals_list = [finals_fn(word) for word, _ in seg]
    out = []
    merged_last = [False] * len(seg)
    for i, (word, pos) in enumerate(seg):
        prev_f, cur_f = (finals_list[i - 1] if i else []), finals_list[i]
        if whole_word:
            boundary = _all_three(prev_f) and _all_three(cur_f)
        else:
            boundary = (bool(prev_f) and bool(cur_f)
                        and _tone(prev_f[-1]) == "3" and _tone(cur_f[0]) == "3")
        if i >= 1 and boundary and not merged_last[i - 1]:
            if (not _is_reduplication(seg[i - 1][0])
                    and len(seg[i - 1][0]) + len(word) <= 3 and out):
                out[-1] = (out[-1][0] + word, out[-1][1])
                merged_last[i] = True
                continue
        out.append((word, pos))
    return out


def _merge_er(seg):
    out = []
    for i, (word, pos) in enumerate(seg):
        if i >= 1 and word == "儿" and seg[i - 1][0] != "#" and out:
            out[-1] = (out[-1][0] + word, out[-1][1])
        else:
            out.append((word, pos))
    return out


def pre_merge(seg: List[Tuple[str, str]],
              finals_fn: FinalsFn) -> List[Tuple[str, str]]:
    """Reshape the (word, pos) segmentation before tone modification.

    ``finals_fn(word)``: toned pinyin syllables for a word (used by the
    continuous-third-tone merges; the reference calls lazy_pinyin)."""
    seg = _merge_bu(seg)
    seg = _merge_yi(seg)
    seg = _merge_reduplication(seg)
    seg = _merge_three(seg, finals_fn, whole_word=True)
    seg = _merge_three(seg, finals_fn, whole_word=False)
    seg = _merge_er(seg)
    return seg


# ---------------------------------------------------------------------------
# Convenience API over (word, pinyins) pairs (used by g2p_zh + tests)
# ---------------------------------------------------------------------------

def apply_sandhi(words: List[Tuple[str, List[str]]],
                 poses: Optional[List[str]] = None,
                 split_fn: Optional[SplitFn] = None
                 ) -> List[Tuple[str, List[str]]]:
    """Pre-merge + modified_tone over [(word, pinyins)]; words and their
    pinyins may merge, so the output list can be shorter."""
    poses = poses or ["n"] * len(words)
    pin = {**{w: p for (w, p) in words}}

    def finals_fn(word: str) -> List[str]:
        if word in pin:
            return pin[word]
        # merged words: concatenate known parts greedily
        out: List[str] = []
        rest = word
        while rest:
            for cand in sorted(pin, key=len, reverse=True):
                if rest.startswith(cand) and cand:
                    out.extend(pin[cand])
                    rest = rest[len(cand):]
                    break
            else:
                rest = rest[1:]
                out.append("")
        return out

    seg = pre_merge(list(zip([w for w, _ in words], poses)), finals_fn)
    result = []
    for word, pos in seg:
        finals = finals_fn(word)
        finals = [f for f in finals if f]
        if len(finals) == len(word):
            finals = modified_tone(word, pos, finals, split_fn)
        result.append((word, finals))
    return result
