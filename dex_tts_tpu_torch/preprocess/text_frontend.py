"""Preprocess-side text frontend, the FastSpeech2/MFA-style variant (a
copy of dex_tts_tpu/preprocess/text_frontend.py over the port's `text/`).

Capability equivalent of reference: DEX-TTS/preprocess/text/ (~700 LoC):
the `.lab`-transcript cleaner used by prepare_align and the *extended*
symbol inventory that adds Mandarin pinyin units and MFA silence markers to
the English set — used when aligning pinyin corpora. Unlike the main
frontend (dex_tts_tpu_torch/text), this variant has no pronunciation dictionary
and no blank interspersal; `{...}` spans are phone sequences from an
aligner (reference: DEX-TTS/preprocess/text/__init__.py:15-41).

The pinyin inventory is the standard Mandarin phonology: 23 initials and 37
finals × tones 1-5, plus the erhua marker "rr"
(reference: DEX-TTS/preprocess/text/pinyin.py:1-213 — a data list; finals
are generated here from the base×tone product instead of enumerated).
"""

from __future__ import annotations

import re

from dex_tts_tpu_torch.text import cleaners
from dex_tts_tpu_torch.text.symbols import (
    ARPABET_SYMBOLS,
    LETTERS,
    PAD,
    PUNCTUATION,
    SPECIAL,
)

MANDARIN_INITIALS = [
    "b", "c", "ch", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "q",
    "r", "s", "sh", "t", "w", "x", "y", "z", "zh",
]

# 37 base finals in the iii/uei/uen/v pinyin transcription convention used
# by the MFA Mandarin lexicon.
MANDARIN_BASE_FINALS = [
    "a", "ai", "an", "ang", "ao", "e", "ei", "en", "eng", "er",
    "i", "ia", "ian", "iang", "iao", "ie", "ii", "iii", "in", "ing",
    "iong", "iou", "o", "ong", "ou",
    "u", "ua", "uai", "uan", "uang", "uei", "uen", "uo",
    "v", "van", "ve", "vn",
]

MANDARIN_FINALS = [f + str(t) for f in MANDARIN_BASE_FINALS for t in range(1, 6)]

PINYIN_SYMBOLS = MANDARIN_INITIALS + MANDARIN_FINALS + ["rr"]

SILENCES = ["@sp", "@spn", "@sil"]

# Extended inventory: English set + @-prefixed pinyin + silences
# (reference: DEX-TTS/preprocess/text/symbols.py:10-29).
symbols = (
    [PAD]
    + list(SPECIAL)
    + list(PUNCTUATION)
    + list(LETTERS)
    + ["@" + s for s in ARPABET_SYMBOLS]
    + ["@" + s for s in PINYIN_SYMBOLS]
    + SILENCES
)

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def clean_text(text: str, cleaner_names=("english_cleaners",)) -> str:
    """Cleaner pipeline used when writing `.lab` transcripts during
    prepare_align (reference: preprocess/text/__init__.py:57-63,
    preprocess/preprocessor/ljspeech.py:37)."""
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def text_to_sequence(text: str, cleaner_names=("english_cleaners",)) -> list[int]:
    """Text (with optional {phone ...} spans from an aligner) → ids over the
    extended inventory. No dictionary, no blank — the preprocess variant
    (reference: preprocess/text/__init__.py:15-41)."""
    sequence: list[int] = []
    while len(text):
        m = _curly_re.match(text)
        if not m:
            sequence += _symbols_to_sequence(clean_text(text, cleaner_names))
            break
        sequence += _symbols_to_sequence(clean_text(m.group(1), cleaner_names))
        sequence += _phones_to_sequence(m.group(2))
        text = m.group(3)
    return sequence


def sequence_to_text(sequence: list[int]) -> str:
    result = ""
    for sid in sequence:
        if sid in ID_TO_SYMBOL:
            s = ID_TO_SYMBOL[sid]
            if len(s) > 1 and s[0] == "@":
                s = "{%s}" % s[1:]
            result += s
    return result.replace("}{", " ")


def _symbols_to_sequence(chars) -> list[int]:
    return [
        SYMBOL_TO_ID[s]
        for s in chars
        if s in SYMBOL_TO_ID and s not in ("_", "~")
    ]


def _phones_to_sequence(text: str) -> list[int]:
    # aligner phones: ARPAbet/pinyin (@-prefixed in the inventory) or
    # literal silence markers (@sp/@spn/@sil)
    out = []
    for p in text.split():
        tagged = "@" + p
        if tagged in SYMBOL_TO_ID:
            out.append(SYMBOL_TO_ID[tagged])
        elif p in SYMBOL_TO_ID:
            out.append(SYMBOL_TO_ID[p])
    return out
