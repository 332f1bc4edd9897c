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
