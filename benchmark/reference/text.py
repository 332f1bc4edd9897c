"""Plain text front end: English text to symbol ids, as DEX-TTS reads it
(DEX-TTS/text/__init__.py, cleaners.py, cmudict.py, symbols.py).

Covers the benchmark's traffic: ASCII English without digits. The
cleaner lowercases, expands the listed abbreviations and collapses
whitespace; known words become their first CMUdict pronunciation in
ARPAbet, unknown ones their letters, words separated by a space symbol,
and the blank id is put between every symbol and at both ends.
"""

from __future__ import annotations

import re

ARPABET = (
    "AA AA0 AA1 AA2 AE AE0 AE1 AE2 AH AH0 AH1 AH2 AO AO0 AO1 AO2 AW AW0 AW1 AW2 "
    "AY AY0 AY1 AY2 B CH D DH EH EH0 EH1 EH2 ER ER0 ER1 ER2 EY EY0 EY1 EY2 F G HH "
    "IH IH0 IH1 IH2 IY IY0 IY1 IY2 JH K L M N NG OW OW0 OW1 OW2 OY OY0 OY1 OY2 "
    "P R S SH T TH UH UH0 UH1 UH2 UW UW0 UW1 UW2 V W Y Z ZH"
).split()
SYMBOLS = (["_", "-"] + list("!'(),.:;? ")
           + list("ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz")
           + ["@" + p for p in ARPABET])
SYMBOL_ID = {s: i for i, s in enumerate(SYMBOLS)}
BLANK = len(SYMBOLS)  # one past the inventory; n_vocab = len(SYMBOLS) + 1

ABBREVIATIONS = [
    (re.compile(rf"\b{a}\.", re.IGNORECASE), e) for a, e in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]


def read_cmudict(path: str) -> dict[str, str]:
    """WORD → its first pronunciation with only ARPAbet phones; alternates
    ``WORD(1)`` and lines that are not entries are skipped."""
    valid = set(ARPABET)
    entries: dict[str, str] = {}
    with open(path, encoding="latin-1") as f:
        for line in f:
            if not line or not ("A" <= line[0] <= "Z" or line[0] == "'"):
                continue
            parts = line.split("  ")
            if len(parts) < 2:
                continue
            word = re.sub(r"\([0-9]+\)", "", parts[0])
            phones = parts[1].strip().split(" ")
            if all(p in valid for p in phones):
                entries.setdefault(word, " ".join(phones))
    return entries


def clean(text: str) -> str:
    if not text.isascii() or re.search(r"[0-9{}]", text):
        raise ValueError(f"the plain front end takes ASCII text without digits: {text!r}")
    text = text.lower()
    for regex, expansion in ABBREVIATIONS:
        text = regex.sub(expansion, text)
    return re.sub(r"\s+", " ", text)


def text_to_ids(text: str, cmudict: dict[str, str] | None) -> list[int]:
    """Symbol ids with the blank interspersed."""
    keep = lambda s: s in SYMBOL_ID and s not in ("_", "~")
    words = clean(text)
    if cmudict is None:
        ids = [SYMBOL_ID[c] for c in words if keep(c)]
    else:
        ids = []
        for word in words.split(" "):
            pron = cmudict.get(word.upper())
            if pron is None:
                ids += [SYMBOL_ID[c] for c in word if keep(c)]
            else:
                ids += [SYMBOL_ID["@" + p] for p in pron.split()]
            ids.append(SYMBOL_ID[" "])
        ids = ids[:-1]
    out = [BLANK] * (2 * len(ids) + 1)
    out[1::2] = ids
    return out
