"""Text frontend: text → symbol-id sequences.

Behavioral equivalent of reference: DEX-TTS/text/__init__.py:22-91 —
curly-brace ARPAbet passthrough, cleaner pipeline, optional CMUdict
phonemization wrapping known words in {ARPAbet}.
"""

from __future__ import annotations

import re

from dex_tts_tpu_torch.text import cleaners
from dex_tts_tpu_torch.text.cmudict import CMUDict
from dex_tts_tpu_torch.text.symbols import (
    BLANK_ID,
    ID_TO_SYMBOL,
    N_VOCAB,
    SYMBOL_TO_ID,
    symbols,
)

__all__ = [
    "text_to_sequence",
    "sequence_to_text",
    "symbols",
    "CMUDict",
    "BLANK_ID",
    "N_VOCAB",
]

_curly_re = re.compile(r"(.*?)\{(.+?)\}(.*)")


def get_arpabet(word: str, dictionary: CMUDict) -> str:
    prons = dictionary.lookup(word)
    if prons is not None:
        return "{" + prons[0] + "}"
    return word


def text_to_sequence(
    text: str,
    cleaner_names: list[str] | None = None,
    dictionary: CMUDict | None = None,
) -> list[int]:
    """Convert text (optionally with {ARPAbet} spans) to symbol ids."""
    cleaner_names = cleaner_names or ["english_cleaners"]
    sequence: list[int] = []
    space = _symbols_to_sequence(" ")
    while len(text):
        m = _curly_re.match(text)
        if not m:
            clean = _clean_text(text, cleaner_names)
            if dictionary is not None:
                for token in [get_arpabet(w, dictionary) for w in clean.split(" ")]:
                    if token.startswith("{"):
                        sequence += _arpabet_to_sequence(token[1:-1])
                    else:
                        sequence += _symbols_to_sequence(token)
                    sequence += space
            else:
                sequence += _symbols_to_sequence(clean)
            break
        sequence += _symbols_to_sequence(_clean_text(m.group(1), cleaner_names))
        sequence += _arpabet_to_sequence(m.group(2))
        text = m.group(3)

    # Drop the trailing word-separator space added by the dictionary path.
    if dictionary is not None and sequence and sequence[-1] == space[0]:
        sequence = sequence[:-1]
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


def _clean_text(text: str, cleaner_names: list[str]) -> str:
    for name in cleaner_names:
        cleaner = getattr(cleaners, name, None)
        if cleaner is None:
            raise ValueError(f"Unknown cleaner: {name}")
        text = cleaner(text)
    return text


def _symbols_to_sequence(chars) -> list[int]:
    return [SYMBOL_TO_ID[s] for s in chars if _should_keep(s)]


def _arpabet_to_sequence(text: str) -> list[int]:
    return _symbols_to_sequence(["@" + s for s in text.split()])


def _should_keep(s: str) -> bool:
    return s in SYMBOL_TO_ID and s not in ("_", "~")
