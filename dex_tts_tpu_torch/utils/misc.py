"""Host-side helpers."""

from __future__ import annotations


def intersperse(lst: list, item) -> list:
    """Insert ``item`` between every element (and at both ends).

    reference: DEX-TTS/src/utils.py (intersperse used by dataset at
    src/dataset.py:78-83): [a, b] -> [item, a, item, b, item].
    """
    result = [item] * (len(lst) * 2 + 1)
    result[1::2] = lst
    return result


def parse_filelist(path: str, split_char: str = "|") -> list[list[str]]:
    """Parse ``path|text|speaker(|emotion)`` filelists.

    reference: DEX-TTS/src/utils.py (parse_filelist consumed at
    src/dataset.py:16).
    """
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]
