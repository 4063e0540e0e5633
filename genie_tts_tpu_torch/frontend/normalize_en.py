"""English text normalization: expand numbers, currency, ordinals, dates,
times, acronyms into speakable words.

Capability parity with the reference's normalization pipeline
(``genie_tts/G2P/English/Normalization.py:258-286``),
implemented independently (no ``inflect`` dependency).
"""
from __future__ import annotations

import re

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALE = [(10 ** 12, "trillion"), (10 ** 9, "billion"), (10 ** 6, "million"),
          (10 ** 3, "thousand"), (100, "hundred")]

_ORDINAL_SPECIAL = {
    "one": "first", "two": "second", "three": "third", "five": "fifth",
    "eight": "eighth", "nine": "ninth", "twelve": "twelfth",
}


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, r = divmod(n, 10)
        return _TENS[t] + ("" if r == 0 else " " + _ONES[r])
    for value, name in _SCALE:
        if n >= value:
            head, rest = divmod(n, value)
            out = number_to_words(head) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return _ONES[0]


def ordinal_to_words(n: int) -> str:
    words = number_to_words(n)
    parts = words.rsplit(" ", 1)
    last = parts[-1]
    if "-" in last:
        head, tail = last.rsplit("-", 1)
        last = head + "-" + _ordinalize_word(tail)
    else:
        last = _ordinalize_word(last)
    parts[-1] = last
    return " ".join(parts)


def _ordinalize_word(w: str) -> str:
    if w in _ORDINAL_SPECIAL:
        return _ORDINAL_SPECIAL[w]
    if w.endswith("y"):
        return w[:-1] + "ieth"
    if w in ("hundred", "thousand", "million", "billion", "trillion"):
        return w + "th"
    return w + "th"


def digits_to_words(s: str) -> str:
    return " ".join(_ONES[int(c)] if c.isdigit() else c for c in s)


def year_to_words(y: int) -> str:
    if 1000 <= y <= 1999 or 2100 <= y <= 9999:
        head, tail = divmod(y, 100)
        if tail == 0:
            return number_to_words(head) + " hundred"
        if tail < 10:
            return number_to_words(head) + " oh " + number_to_words(tail)
        return number_to_words(head) + " " + number_to_words(tail)
    return number_to_words(y)


def _decimal_words(whole: str, frac: str) -> str:
    out = number_to_words(int(whole)) if whole else "zero"
    if frac:
        out += " point " + digits_to_words(frac)
    return out


_CURRENCY = {"$": ("dollar", "cent"), "£": ("pound", "penny"),
             "€": ("euro", "cent"), "¥": ("yen", "sen")}


def _expand_currency(m: re.Match) -> str:
    sym, whole, frac = m.group(1), m.group(2).replace(",", ""), m.group(3)
    unit, sub = _CURRENCY[sym]
    n = int(whole) if whole else 0
    out = number_to_words(n) + " " + unit + ("s" if n != 1 and unit != "yen" else "")
    if frac:
        c = int(frac)
        if c:
            sub_w = sub + ("s" if c != 1 and sub != "penny" else "")
            if c != 1 and sub == "penny":
                sub_w = "pence"
            out += " and " + number_to_words(c) + " " + sub_w
    return out


def _expand_time(m: re.Match) -> str:
    h, mnt = int(m.group(1)), int(m.group(2))
    suffix = (" " + m.group(3).replace(".", "").lower()) if m.group(3) else ""
    if mnt == 0:
        return number_to_words(h) + " o'clock" + suffix
    if mnt < 10:
        return number_to_words(h) + " oh " + number_to_words(mnt) + suffix
    return number_to_words(h) + " " + number_to_words(mnt) + suffix


# ---------------------------------------------------------------------------
# Reference-fidelity pipeline (golden-tested against the executed reference
# module, tests/test_normalize_en_golden.py). Regex shapes and precedence
# are behavior-defining and mirror Normalization.py:60-286; reference
# quirks are kept deliberately (e.g. ordinal suffixes concatenate onto the
# cardinal words: "21st" -> "twenty onest").
# ---------------------------------------------------------------------------

import unicodedata
from calendar import month_name

_MEASURES = {
    "km/h": ("kilometer per hour", "kilometers per hour"),
    "mph": ("mile per hour", "miles per hour"),
    "°C": ("degree celsius", "degrees celsius"),
    "°F": ("degree fahrenheit", "degrees fahrenheit"),
    "tbsp": ("tablespoon", "tablespoons"), "tsp": ("teaspoon", "teaspoons"),
    "km": ("kilometer", "kilometers"), "kg": ("kilogram", "kilograms"),
    "min": ("minute", "minutes"), "ft": ("foot", "feet"),
    "cm": ("centimeter", "centimeters"), "m": ("meter", "meters"),
    "L": ("liter", "liters"), "h": ("hour", "hours"), "s": ("second", "seconds"),
}
_ABBREV = [
    ("Mr", "Mister"), ("Mrs", "Missus"), ("Dr", "Doctor"),
    ("Prof", "Professor"), ("St", "Street"), ("Co", "Company"),
    ("Ltd", "Limited"), (r"e\.g", "for example"), (r"i\.e", "that is"),
]
_RE_ABBREV = [(re.compile(rf"\b{a}\.(?=[\s,.]|\Z)", re.IGNORECASE), b)
              for a, b in _ABBREV]
_UNITS_ALT = "|".join(re.escape(k) for k in
                      sorted(_MEASURES, key=len, reverse=True))
_RE_CUR_SUFFIX = re.compile(r"([£$€])([\d,.]*\d)\s*(million|billion|thousand)\b",
                            re.IGNORECASE)
_RE_PHONE = re.compile(r"(\+?\d{1,3}-)?\b(\d{3})-(?:(\d{3})-)?(\d{4})\b")
_RE_ROMAN = re.compile(
    r"\b(XIX|XVIII|XVII|XVI|XV|XIV|XIII|XII|XI|X|IX|VIII|VII|VI|V|IV|III|II)\b",
    re.IGNORECASE)
_RE_DECADE = re.compile(r"\b((?:1[89]|20)\d0)s\b")
_RE_SCORE = re.compile(r"\b(\d{1,2})-(\d{1,2})\b")
_RE_DIMENSION = re.compile(
    r"\b(\d+(?:\.\d+)?)\s*x\s*(\d+(?:\.\d+)?)(?:\s*x\s*(\d+(?:\.\d+)?))?\b")
_RE_ALNUM = re.compile(r"\b([a-zA-Z]+[0-9]+|[0-9]+[a-zA-Z]+)\b")
_RE_DATE = re.compile(r"\b(0?[1-9]|1[0-2])/([0-2]?\d|3[01])/(\d{2,4})\b")
_RE_ORDINAL_DOT = re.compile(r"\b(\d+)\. ")
_RE_COMMA_NUM = re.compile(r"(\d[\d,]+\d)")
_RE_CURRENCY = re.compile(r"([£$€])(\d*\.?\d+)|(\d*\.?\d+)\s*([£$€])")
_RE_TIME = re.compile(
    r"\b([01]?\d|2[0-3]):([0-5]\d)(?::([0-5]\d))?(\s*(?:a\.?m\.?|p\.?m\.?))?\b",
    re.IGNORECASE)
_RE_MEASURE = re.compile(rf"(?<!\w)(-?(?:\d+/\d+|\d+(?:\.\d+)?))\s*({_UNITS_ALT})\b")
_RE_FRACTION = re.compile(r"\b(\d+)/(\d+)\b")
_RE_DECIMAL = re.compile(r"(\d+\.\d+)")
_RE_ORDINAL = re.compile(r"\b\d+(st|nd|rd|th)\b")
_RE_ACRONYM = re.compile(r"\b[A-Z]{2,}\b")
_RE_NUMBER = re.compile(r"(?<!\w)-?\d+(?!\w)")
_RE_DOMAIN = re.compile(r"\b([a-z0-9-]+)\.([a-z]{2,})\b")

_ROMAN = {"ii": "two", "iii": "three", "iv": "four", "v": "five",
          "vi": "six", "vii": "seven", "viii": "eight", "ix": "nine",
          "x": "ten", "xi": "eleven", "xii": "twelve", "xiii": "thirteen",
          "xiv": "fourteen", "xv": "fifteen", "xvi": "sixteen",
          "xvii": "seventeen", "xviii": "eighteen", "xix": "nineteen"}


def _nw(s) -> str:
    """Cardinal words for a non-negative digit string (reference wording)."""
    s = str(s).strip()
    if not s.isdigit():
        return s
    return number_to_words(int(s))


def _ordinal_suffixed(num_str: str) -> str:
    """Reference _ordinal_custom: cardinal words + raw st/nd/rd/th suffix."""
    num = int(num_str)
    if 10 <= num % 100 <= 20:
        suf = "th"
    else:
        suf = {1: "st", 2: "nd", 3: "rd"}.get(num % 10, "th")
    return _nw(num_str) + suf


def _number_positive(num_str: str) -> str:
    num = int(num_str)
    if 2000 <= num < 2010:
        return f"two thousand and {_nw(str(num % 100))}"
    if 1100 <= num < 2100 and num % 100 != 0:
        return f"{_nw(str(num // 100))} {_nw(str(num % 100))}"
    return _nw(num_str)


def _x_phone(m):
    country, area, exch, line = m.groups()
    parts = []
    if country:
        words = []
        if country.startswith("+"):
            words.append("plus")
        digits = re.sub(r"\D", "", country)
        if digits:
            words.append(" ".join(_nw(d) for d in digits))
        parts.append(" ".join(words))
    parts.append(" ".join(_nw(c) for c in area))
    if exch:
        parts.append(" ".join(_nw(c) for c in exch))
    parts.append(" ".join(_nw(c) for c in line))
    return ", ".join(parts)


def _x_time(m):
    h_str, m_str, s_str, am_pm = m.groups()
    h, mnt = int(h_str), int(m_str)
    h_word = _nw(str(h if h <= 12 or not am_pm else h - 12))
    if h == 0 and am_pm:
        h_word = "twelve"
    m_word = ""
    if mnt > 0:
        m_word = f" oh {_nw(str(mnt))}" if mnt < 10 else f" {_nw(str(mnt))}"
    out = f"{h_word}{m_word}".lstrip()
    if s_str:
        out += f" and {_nw(str(int(s_str)))} seconds"
    if am_pm:
        out += " pm" if "p" in am_pm.lower() else " am"
    return out


def _x_currency(m):
    symbol, amount = ((m.group(1), m.group(2)) if m.group(1)
                      else (m.group(4), m.group(3)))
    amount = (amount or "").replace(",", "")
    if amount.startswith("."):
        amount = "0" + amount
    major = {"$": ("dollar", "dollars"), "£": ("pound", "pounds"),
             "€": ("euro", "euros")}.get(symbol, ("", ""))
    minor = {"$": ("cent", "cents"), "£": ("penny", "pence"),
             "€": ("cent", "cents")}.get(symbol, ("", ""))
    parts = amount.split(".")
    major_val = int(parts[0]) if parts[0] else 0
    minor_val = int(parts[1].ljust(2, "0")) if len(parts) > 1 and parts[1] else 0
    out = []
    if major_val > 0:
        out.append(f"{_nw(str(major_val))} "
                   f"{major[0] if major_val == 1 else major[1]}")
    if minor_val > 0:
        out.append(f"{_nw(str(minor_val))} "
                   f"{minor[0] if minor_val == 1 else minor[1]}")
    return " and ".join(out) or f"zero {major[1]}"


def _x_measure(m):
    num_str, unit = m.groups()
    neg = num_str.startswith("-")
    if neg:
        num_str = num_str[1:]
    if "/" in num_str:
        num_word = _x_fraction(_RE_FRACTION.match(num_str))
        plural = True
    else:
        num_word = _nw(num_str) if num_str.isdigit() else _x_decimal_str(num_str)
        plural = float(num_str) != 1
    unit_word = _MEASURES[unit][1] if plural else _MEASURES[unit][0]
    out = f"{num_word} {unit_word}"
    return f"minus {out}" if neg else out


def _x_fraction(m):
    n, d = int(m.group(1)), int(m.group(2))
    if d == 0:
        return m.group(0)
    common = {(1, 2): "one half", (1, 4): "one quarter", (3, 4): "three quarters"}
    if (n, d) in common:
        return common[(n, d)]
    return f"{_nw(str(n))} over {_nw(str(d))}"


def _x_decimal_str(s):
    whole, frac = s.split(".")
    return f"{_nw(whole)} point " + " ".join(_nw(d) for d in frac)


def _x_date(m):
    month, day, year = m.groups()
    y = int(year)
    if len(year) == 2:
        y += 2000 if y < 50 else 1900
    return (f"{month_name[int(month)]} {_ordinal_suffixed(day)}, "
            f"{_number_positive(str(y))}")


def _x_decade(m):
    words = _number_positive(m.group(1))
    return f"{words[:-1]}ies" if words.endswith("ty") else f"{words}s"


def _x_alnum(m):
    out = []
    for part in re.findall(r"[a-zA-Z]+|[0-9]+", m.group(0)):
        if part.isalpha():
            out.append(" ".join(part))
        else:
            out.append(" ".join(_nw(c) for c in part))
    return " ".join(out)


def normalize_english(text: str) -> str:
    """Full reference-order NSW expansion; output is lowercase ASCII."""
    text = "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")
    text = re.sub(r"@", " at ", text)
    for rx, rep in _RE_ABBREV:
        text = rx.sub(rep, text)
    text = _RE_CUR_SUFFIX.sub(
        lambda m: f"{_nw(m.group(2).replace(',', ''))} {m.group(3)} "
                  f"{ {'$': 'dollars', '£': 'pounds', '€': 'euros'}.get(m.group(1), '')}",
        text)
    text = _RE_PHONE.sub(_x_phone, text)
    text = _RE_DIMENSION.sub(
        lambda m: " by ".join(_nw(p) for p in m.groups() if p is not None), text)
    text = _RE_ROMAN.sub(lambda m: _ROMAN.get(m.group(1).lower(), m.group(1)), text)
    text = _RE_DECADE.sub(_x_decade, text)
    text = _RE_SCORE.sub(
        lambda m: f"{_nw(m.group(1))} to {_nw(m.group(2))}", text)
    text = _RE_DATE.sub(_x_date, text)
    text = _RE_TIME.sub(_x_time, text)
    text = _RE_ORDINAL_DOT.sub(lambda m: _ordinal_suffixed(m.group(1)) + ", ", text)
    text = _RE_COMMA_NUM.sub(lambda m: m.group(1).replace(",", ""), text)
    text = _RE_CURRENCY.sub(_x_currency, text)
    text = _RE_MEASURE.sub(_x_measure, text)
    text = _RE_FRACTION.sub(_x_fraction, text)
    text = _RE_DECIMAL.sub(lambda m: _x_decimal_str(m.group(1)), text)
    text = _RE_ORDINAL.sub(lambda m: _ordinal_suffixed(m.group(0)[:-2]), text)
    text = _RE_ALNUM.sub(_x_alnum, text)
    text = _RE_ACRONYM.sub(lambda m: " ".join(m.group(0)), text)
    text = _RE_NUMBER.sub(
        lambda m: (f"minus {_number_positive(m.group(0)[1:])}"
                   if m.group(0).startswith("-")
                   else _number_positive(m.group(0))), text)
    text = text.lower()
    text = re.sub(r"%", " percent", text)
    while _RE_DOMAIN.search(text):
        text = _RE_DOMAIN.sub(r"\1 dot \2", text)
    text = re.sub(r"[^a-z0-9'.,?!:;-]", " ", text)
    return re.sub(r"\s+", " ", text).strip()
