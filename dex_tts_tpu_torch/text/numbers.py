"""Self-contained English number normalization.

Behavioral equivalent of the reference's inflect-based normalizer
(reference: DEX-TTS/text/numbers.py:65-72): commas stripped from large
numbers, currency expanded, decimals read digit-group-wise around "point",
ordinals spelled out, years read in two-digit groups. Implemented from
scratch because `inflect` is not part of the runtime image.
"""

from __future__ import annotations

import re

_comma_number_re = re.compile(r"([0-9][0-9\,]+[0-9])")
_decimal_number_re = re.compile(r"([0-9]+\.[0-9]+)")
_pounds_re = re.compile(r"£([0-9\,]*[0-9]+)")
_dollars_re = re.compile(r"\$([0-9\.\,]*[0-9]+)")
_ordinal_re = re.compile(r"[0-9]+(st|nd|rd|th)")
_number_re = re.compile(r"[0-9]+")

_ONES = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_TENS = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]
_SCALES = [
    "", "thousand", "million", "billion", "trillion", "quadrillion",
    "quintillion", "sextillion", "septillion", "octillion", "nonillion",
    "decillion",
]

_ORDINAL_IRREGULAR = {
    "one": "first",
    "two": "second",
    "three": "third",
    "five": "fifth",
    "eight": "eighth",
    "nine": "ninth",
    "twelve": "twelfth",
}


def _two_digits(n: int) -> str:
    if n < 20:
        return _ONES[n]
    tens, units = divmod(n, 10)
    if units:
        return f"{_TENS[tens]}-{_ONES[units]}"
    return _TENS[tens]


def _three_digits(n: int, andword: str = "") -> str:
    hundreds, rest = divmod(n, 100)
    parts = []
    if hundreds:
        parts.append(f"{_ONES[hundreds]} hundred")
    if rest:
        if hundreds and andword:
            parts.append(andword)
        parts.append(_two_digits(rest))
    return " ".join(parts)


def number_to_words(n: int, andword: str = "") -> str:
    """Spell an integer in English; scale groups are comma-separated."""
    if n == 0:
        return "zero"
    if n < 0:
        return "minus " + number_to_words(-n, andword)
    if n >= 1000 ** len(_SCALES):  # past decillion: read digit-by-digit
        return " ".join(_ONES[int(d)] for d in str(n))
    groups = []
    scale = 0
    while n > 0:
        n, group = divmod(n, 1000)
        if group:
            words = _three_digits(group, andword)
            if _SCALES[scale]:
                words = f"{words} {_SCALES[scale]}"
            groups.append(words)
        scale += 1
    return ", ".join(reversed(groups))


def year_to_words(n: int) -> str:
    """Read a 4-digit year in two-digit groups: 1985 → nineteen eighty-five.

    Covers the reference's inflect ``group=2, zero='oh'`` call for numbers in
    (1000, 3000) (reference: DEX-TTS/text/numbers.py:50-62).
    """
    hi, lo = divmod(n, 100)
    if lo == 0:
        return f"{_two_digits(hi)} hundred"
    if lo < 10:
        return f"{_two_digits(hi)} oh {_ONES[lo]}"
    return f"{_two_digits(hi)} {_two_digits(lo)}"


def ordinal_to_words(n: int) -> str:
    """Spell an ordinal: 23 → twenty-third. Uses 'and' inside hundreds,
    matching inflect's default for the ordinal path."""
    words = number_to_words(n, andword="and")
    # Transform the final word (possibly the tail of a hyphenation).
    head, sep, last = words.rpartition(" ")
    hy_head, hy_sep, hy_last = last.rpartition("-")
    if hy_last in _ORDINAL_IRREGULAR:
        hy_last = _ORDINAL_IRREGULAR[hy_last]
    elif hy_last.endswith("y"):
        hy_last = hy_last[:-1] + "ieth"
    else:
        hy_last = hy_last + "th"
    return head + sep + hy_head + hy_sep + hy_last


def _remove_commas(m: re.Match) -> str:
    return m.group(1).replace(",", "")


def _expand_decimal_point(m: re.Match) -> str:
    return m.group(1).replace(".", " point ")


def _expand_dollars(m: re.Match) -> str:
    match = m.group(1)
    parts = match.split(".")
    if len(parts) > 2:
        return match + " dollars"
    dollars = int(parts[0]) if parts[0] else 0
    cents = int(parts[1]) if len(parts) > 1 and parts[1] else 0
    if dollars and cents:
        dollar_unit = "dollar" if dollars == 1 else "dollars"
        cent_unit = "cent" if cents == 1 else "cents"
        return f"{dollars} {dollar_unit}, {cents} {cent_unit}"
    if dollars:
        return f"{dollars} {'dollar' if dollars == 1 else 'dollars'}"
    if cents:
        return f"{cents} {'cent' if cents == 1 else 'cents'}"
    return "zero dollars"


def _expand_ordinal(m: re.Match) -> str:
    return ordinal_to_words(int(m.group(0)[:-2]))


def _expand_number(m: re.Match) -> str:
    num = int(m.group(0))
    if 1000 < num < 3000:
        if num == 2000:
            return "two thousand"
        if 2000 < num < 2010:
            return "two thousand " + _ONES[num % 100]
        if num % 100 == 0:
            return number_to_words(num // 100) + " hundred"
        return year_to_words(num)
    return number_to_words(num)


def normalize_numbers(text: str) -> str:
    text = re.sub(_comma_number_re, _remove_commas, text)
    text = re.sub(_pounds_re, r"\1 pounds", text)
    text = re.sub(_dollars_re, _expand_dollars, text)
    text = re.sub(_decimal_number_re, _expand_decimal_point, text)
    text = re.sub(_ordinal_re, _expand_ordinal, text)
    text = re.sub(_number_re, _expand_number, text)
    return text
