"""CMU pronouncing dictionary loader.

Behavioral equivalent of reference: DEX-TTS/text/cmudict.py:19-63 — parses
``WORD  P1 P2 ...`` lines, collapses ``WORD(1)`` alternates onto the same
key, and validates phones against the ARPAbet inventory.
"""

from __future__ import annotations

import re
from typing import IO

from dex_tts_tpu_torch.text.symbols import ARPABET_SYMBOLS

_VALID = set(ARPABET_SYMBOLS)
_ALT_RE = re.compile(r"\([0-9]+\)")


class CMUDict:
    def __init__(self, file_or_path: str | IO, keep_ambiguous: bool = True):
        if isinstance(file_or_path, str):
            with open(file_or_path, encoding="latin-1") as f:
                entries = _parse(f)
        else:
            entries = _parse(file_or_path)
        if not keep_ambiguous:
            entries = {w: p for w, p in entries.items() if len(p) == 1}
        self._entries = entries

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, word: str) -> list[str] | None:
        """All pronunciations of ``word`` (upper-cased), or None."""
        return self._entries.get(word.upper())


def _parse(file: IO) -> dict[str, list[str]]:
    entries: dict[str, list[str]] = {}
    for line in file:
        if not line:
            continue
        first = line[0]
        if not ("A" <= first <= "Z" or first == "'"):
            continue
        parts = line.split("  ")
        if len(parts) < 2:
            continue
        word = _ALT_RE.sub("", parts[0])
        phones = parts[1].strip().split(" ")
        if any(p not in _VALID for p in phones):
            continue
        pron = " ".join(phones)
        entries.setdefault(word, []).append(pron)
    return entries
