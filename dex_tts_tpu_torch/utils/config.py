"""YAML configs with attribute access (port of dex_tts_tpu/utils/config.py:
`DotDict`, `Config`, `load_config`, `set_experiment`).

The machine with the card has no PyYAML, so the port reads and writes its
configs itself: `yaml_load` is a reader for the subset of YAML that the
JAX package's presets (dex_tts_tpu/config/presets/*.yaml) use and that
``yaml.safe_dump(..., sort_keys=False)`` writes, and `yaml_dump` writes
a document that both it and PyYAML read back equal.

The subset:
  * block mappings by indentation, simple keys (plain or quoted, on one
    line) and explicit ``? key`` / ``: value`` entries with scalar keys;
  * block sequences, indentless ones under a key and nested ones
    (``- - 3``, ``- key: v``);
  * flow sequences of scalars (``[1, 2]``, ``[N, N, N]``, ``[]``) and the
    empty flow mapping ``{}``;
  * plain, single- and double-quoted scalars, over several lines too;
  * ``#`` comments, inline ones included; ``null`` and ``~``.

Plain scalars resolve as PyYAML's YAML 1.1 resolver does: ``1.0e-4`` is a
float and ``1e-4`` the string '1e-4'; yes/no/true/false/on/off in lower,
capitalised or upper case are bools, while ``N`` and ``y`` are strings;
``.inf``, ``-.inf`` and ``.nan``; ``1_000`` is 1000.

Anything else raises `ValueError` naming the line, and is never guessed:
anchors, aliases, tags, ``|``/``>`` block scalars, flow mappings that are
not empty, nested flow collections, merge keys, document markers and
directives, binary, octal, hex and sexagesimal numbers, timestamps, and
tabs outside quoted scalars and comments.
"""

from __future__ import annotations

import bisect
import copy
import math
import os
import re
from typing import Any, Mapping

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                         (?:[Tt]|[ \t]+)[0-9][0-9]?
                         :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                         (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# what PyYAML's reader refuses outside escapes
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD"
                            "\U00010000-\U0010ffff]")

_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_BLANK = " \t\n\0"  # what ends an indicator or a plain scalar's chunk
_NOT_A_NODE = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars",
               ">": "block scalars", "%": "directives", "@": "reserved indicators",
               "`": "reserved indicators", ",": "empty entries", "]": "unmatched brackets",
               "}": "unmatched braces"}


class _Unsupported(Exception):
    """A plain scalar the subset does not resolve."""


def _resolve(text: str):
    """A plain scalar's value, as PyYAML's safe_load resolves it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        if ":" in text:
            raise _Unsupported(f"sexagesimal numbers are outside the subset: {text!r}")
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * float(value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value[0] == "0" or ":" in value:
            raise _Unsupported(f"binary, octal, hex and sexagesimal ints are outside the "
                               f"subset: {text!r}")
        return sign * int(value)
    if text == "<<":
        raise _Unsupported("merge keys are outside the subset")
    if text == "=" or _TIMESTAMP.match(text):
        raise _Unsupported(f"value and timestamp scalars are outside the subset: {text!r}")
    return text


class _Parser:
    """Recursive descent over the text, one character position at a time,
    with PyYAML's scanner rules for scalars (scan_plain, scan_flow_scalar)."""

    def __init__(self, text: str, source: str):
        if text.startswith("\ufeff"):
            text = text[1:]
        text = text.replace("\r\n", "\n").replace("\r", "\n")
        self.source = source
        self.line_starts = [0] + [m.end() for m in re.finditer("\n", text)]
        self.s = text + "\0\0\0\0"
        self.i = 0
        bad = _NON_PRINTABLE.search(text) or re.search("[\x85\u2028\u2029]", text)
        if bad:
            self.error(f"character {bad.group()!r} is outside the subset", bad.start())

    # -- positions -----------------------------------------------------

    def line(self, i=None) -> int:
        return bisect.bisect_right(self.line_starts, self.i if i is None else i) - 1

    def col(self, i=None) -> int:
        i = self.i if i is None else i
        return i - self.line_starts[self.line(i)]

    def error(self, message: str, i=None):
        raise ValueError(f"{self.source}, line {self.line(i) + 1}: {message}")

    def peek(self, k: int = 0) -> str:
        return self.s[self.i + k]

    def at_entry(self, indicator: str) -> bool:
        return self.peek() == indicator and self.peek(1) in _BLANK

    # -- whitespace ----------------------------------------------------

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.i += 1
        if self.peek() == "\t":
            self.error("tabs are outside the subset")

    def skip_comment(self) -> None:
        if self.peek() == "#":
            while self.peek() not in "\n\0":
                self.i += 1

    def skip_to_content(self) -> None:
        """Past spaces, comments and line breaks, to the next content (or
        the end)."""
        while True:
            self.skip_spaces()
            self.skip_comment()
            if self.peek() != "\n":
                break
            self.i += 1
        self.check_document_marker()

    def check_document_marker(self) -> None:
        if self.col() == 0 and self.s[self.i:self.i + 3] in ("---", "...") \
                and self.peek(3) in _BLANK:
            self.error("document markers are outside the subset")

    def end_of_line(self) -> None:
        """Nothing but spaces and a comment may follow a value on its line."""
        self.skip_spaces()
        if self.peek() not in "#\n\0":
            self.error(f"unexpected {self.peek()!r} after a value")

    # -- nodes ---------------------------------------------------------

    def document(self):
        self.skip_to_content()
        if self.peek() == "\0":
            return None
        node = self.block_node(-1)
        self.skip_to_content()
        if self.peek() != "\0":
            self.error("content after the document's root node")
        return node

    def block_node(self, parent_col: int):
        """The node that starts here: a block collection at this column, or
        a flow collection or scalar that ends its line. ``parent_col``: the
        column of the block collection around it (-1 at the root)."""
        if self.at_entry("-"):
            return self.block_sequence(self.col())
        if self.at_entry("?") or self.is_simple_key():
            return self.block_mapping(self.col())
        return self.inline_value(parent_col)

    def inline_value(self, parent_col: int):
        """A flow collection or a scalar, then the end of its line."""
        ch = self.peek()
        if ch in _NOT_A_NODE:
            self.error(f"{_NOT_A_NODE[ch]} are outside the subset")
        if ch in "-?:" and self.peek(1) in _BLANK:
            self.error(f"{ch!r} entries cannot start on the line of a simple key")
        node = self.flow_collection() if ch in "[{" else self.scalar(parent_col)
        self.end_of_line()
        return node

    def entry_value(self, col: int):
        """The node after a ``-``, ``?`` or ``:`` indicator of a block
        collection at ``col``: on the same line (a compact collection, too)
        or more indented on the lines below; null if neither."""
        self.i += 1
        self.skip_spaces()
        if self.peek() not in "#\n\0":
            return self.block_node(col)
        self.skip_to_content()
        return self.block_node(col) if self.peek() != "\0" and self.col() > col else None

    def is_simple_key(self) -> bool:
        start = self.i
        try:
            if self.peek() in "'\"":
                self.quoted()
            elif self.peek() not in _NOT_A_NODE and self.peek() not in "[{#":
                self.plain_chunks(one_line=True)
            while self.peek() == " ":
                self.i += 1
            return self.i > start and self.at_entry(":")
        except ValueError:
            return False
        finally:
            self.i = start

    def simple_key(self):
        """A key on one line, plain or quoted; the position ends on its ``:``."""
        start = self.i
        if self.peek() in "'\"":
            key = self.quoted()
            if self.line() != self.line(start):
                self.error("a simple key must fit on one line")
        else:
            key = self.resolve(self.plain_chunks(one_line=True), start)
        self.skip_spaces()
        return key

    def block_mapping(self, col: int) -> dict:
        out = {}
        while True:
            if self.at_entry("?"):
                key = self.entry_value(col)
                if isinstance(key, (dict, list)):
                    self.error("collection keys are outside the subset")
                self.skip_to_content()
                has_value = self.peek() != "\0" and self.col() == col and self.at_entry(":")
                out[key] = self.entry_value(col) if has_value else None
            else:
                key = self.simple_key()
                self.i += 1  # the ":"
                self.skip_spaces()
                if self.peek() not in "#\n\0":
                    out[key] = self.inline_value(col)
                else:
                    self.skip_to_content()
                    value = None
                    if self.peek() != "\0" and self.col() > col:
                        value = self.block_node(col)
                    elif self.peek() != "\0" and self.col() == col and self.at_entry("-"):
                        value = self.block_sequence(col)  # indentless
                    out[key] = value
            self.skip_to_content()
            if self.peek() == "\0" or self.col() < col:
                return out
            if self.col() > col:
                self.error("bad indentation of a mapping entry")
            if not (self.at_entry("?") or self.is_simple_key()):
                self.error("expected a mapping key")

    def block_sequence(self, col: int) -> list:
        out = []
        while True:
            out.append(self.entry_value(col))
            self.skip_to_content()
            if self.peek() == "\0" or self.col() < col:
                return out
            if self.col() > col:
                self.error("bad indentation of a sequence entry")
            if not self.at_entry("-"):
                return out

    def flow_collection(self):
        """``[scalar, ...]`` or ``{}``."""
        if self.peek() == "{":
            self.i += 1
            self.skip_flow_blanks()
            if self.peek() != "}":
                self.error("flow mappings are outside the subset")
            self.i += 1
            return {}
        self.i += 1
        out = []
        while True:
            self.skip_flow_blanks()
            ch = self.peek()
            if ch == "]":
                self.i += 1
                return out
            if ch == "\0":
                self.error("unterminated flow sequence")
            if ch in "[{":
                self.error("nested flow collections are outside the subset")
            if ch in "?:":
                self.error("flow mappings are outside the subset")
            if ch in _NOT_A_NODE:
                self.error(f"{_NOT_A_NODE[ch]} are outside the subset")
            if ch in "'\"":
                out.append(self.quoted())
            else:
                start = self.i
                out.append(self.resolve(self.plain_chunks(flow=True), start))
            self.skip_flow_blanks()
            if self.peek() == ":":
                self.error("flow mappings are outside the subset")
            if self.peek() == ",":
                self.i += 1
            elif self.peek() != "]":
                self.error(f"expected ',' or ']', found {self.peek()!r}")

    def skip_flow_blanks(self) -> None:
        while True:
            self.skip_spaces()
            self.skip_comment()
            if self.peek() != "\n":
                return
            self.i += 1
            self.check_document_marker()

    # -- scalars -------------------------------------------------------

    def resolve(self, text: str, start: int):
        try:
            return _resolve(text)
        except _Unsupported as exc:
            self.error(str(exc), start)

    def scalar(self, parent_col: int):
        if self.peek() in "'\"":
            return self.quoted()
        start = self.i
        return self.resolve(self.plain_chunks(indent=parent_col + 1), start)

    def plain_chunks(self, indent: int = 0, flow: bool = False, one_line: bool = False) -> str:
        """PyYAML's scan_plain: chunks of non-blank text joined by their
        spaces, a line break folded into a space and n > 1 of them into
        n - 1 newlines. In block context continuation lines must reach
        column ``indent``; ``one_line`` stops at the line's end. The
        position ends after the last chunk."""
        chunks, spaces = [], []
        end = self.i
        while self.peek() != "#":
            length = 0
            while True:
                ch = self.peek(length)
                if ch in _BLANK or (ch == ":" and self.peek(length + 1) in _BLANK
                                    + (",[]{}" if flow else "")) \
                        or (flow and ch in ",?[]{}"):
                    break
                length += 1
            if not length:
                break
            chunks += spaces
            chunks.append(self.s[self.i:self.i + length])
            self.i += length
            end = self.i
            spaces = self.plain_spaces(one_line)
            if not spaces or self.peek() == "#" or (not flow and self.col() < indent):
                break
        self.i = end
        if self.peek() == "\t":
            self.error("tabs are outside the subset")
        return "".join(chunks)

    def plain_spaces(self, one_line: bool) -> list:
        length = 0
        while self.peek(length) == " ":
            length += 1
        whitespace = self.s[self.i:self.i + length]
        self.i += length
        if self.peek() != "\n":
            return [whitespace] if whitespace else []
        if one_line:
            return []
        self.i += 1
        self.check_document_marker()
        breaks = []
        while self.peek() in " \n":
            if self.peek() == "\n":
                breaks.append("\n")
                self.i += 1
                self.check_document_marker()
            else:
                self.i += 1
        return breaks or [" "]

    def quoted(self) -> str:
        """PyYAML's scan_flow_scalar: a single- or double-quoted scalar,
        line breaks folded as in a plain one; double quotes take escapes
        and escaped line breaks."""
        start = self.i
        quote = self.peek()
        double = quote == '"'
        self.i += 1
        chunks = []
        while True:
            length = 0
            while self.peek(length) not in "'\"\\\0 \t\n":
                length += 1
            chunks.append(self.s[self.i:self.i + length])
            self.i += length
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.i += 2
            elif ch == quote:
                self.i += 1
                return "".join(chunks)
            elif ch in "'\"" or (not double and ch == "\\"):
                chunks.append(ch)
                self.i += 1
            elif ch == "\\":
                ch = self.peek(1)
                self.i += 2
                if ch in _ESCAPES:
                    chunks.append(_ESCAPES[ch])
                elif ch in _ESCAPE_CODES:
                    digits = self.s[self.i:self.i + _ESCAPE_CODES[ch]]
                    if not re.fullmatch(f"[0-9A-Fa-f]{{{_ESCAPE_CODES[ch]}}}", digits):
                        self.error(f"bad escape \\{ch}{digits}")
                    chunks.append(chr(int(digits, 16)))
                    self.i += len(digits)
                elif ch == "\n":
                    chunks += self.quoted_breaks()
                else:
                    self.error(f"unknown escape \\{ch}")
            elif ch in " \t\n":
                length = 0
                while self.peek(length) in " \t":
                    length += 1
                whitespace = self.s[self.i:self.i + length]
                self.i += length
                if self.peek() == "\n":
                    self.i += 1
                    chunks += self.quoted_breaks() or [" "]
                elif self.peek() != "\0":
                    chunks.append(whitespace)
            else:
                self.error("unterminated quoted scalar", start)

    def quoted_breaks(self) -> list:
        breaks = []
        while True:
            self.check_document_marker()
            while self.peek() in " \t":
                self.i += 1
            if self.peek() != "\n":
                return breaks
            breaks.append("\n")
            self.i += 1


def yaml_load(text: str, source: str = "<string>"):
    """The YAML document ``text`` → dicts, lists and scalars, equal to
    ``yaml.safe_load(text)`` on the subset (module docstring); anything
    else raises ValueError naming ``source`` and the line."""
    return _Parser(text, source).document()


# -- writing ----------------------------------------------------------------

_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./][A-Za-z0-9_./+-]*(?: [A-Za-z0-9_./+-]+)*")


def _scalar_text(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):  # PyYAML's represent_float
        if value != value:
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(value, str):
        try:
            plain = _PLAIN_SAFE.fullmatch(value) and _resolve(value) == value
        except _Unsupported:
            plain = False
        if plain:
            return value
        out = ['"']
        for ch in value:
            code = ord(ch)
            if ch in '"\\':
                out.append("\\" + ch)
            elif 0x20 <= code <= 0x7E:
                out.append(ch)
            elif code <= 0xFF:
                out.append(f"\\x{code:02X}")
            elif code <= 0xFFFF:
                out.append(f"\\u{code:04X}")
            else:
                out.append(f"\\U{code:08X}")
        out.append('"')
        return "".join(out)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} as YAML")


def _block_lines(value, indent: int) -> list[str]:
    pad = " " * indent
    out = []
    if isinstance(value, Mapping):
        for key, item in value.items():
            key = _scalar_text(key)
            if isinstance(item, Mapping) and item:
                out += [f"{pad}{key}:"] + _block_lines(item, indent + 2)
            elif isinstance(item, (list, tuple)) and item:
                out += [f"{pad}{key}:"] + _block_lines(item, indent)  # indentless
            else:
                out.append(f"{pad}{key}: {_inline_text(item)}")
        return out
    for item in value:
        if isinstance(item, (Mapping, list, tuple)) and item:
            lines = _block_lines(item, indent + 2)
            out += [f"{pad}- {lines[0][indent + 2:]}"] + lines[1:]
        else:
            out.append(f"{pad}- {_inline_text(item)}")
    return out


def _inline_text(value) -> str:
    if isinstance(value, Mapping):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_text(value)


def yaml_dump(data) -> str:
    """A mapping or sequence of scalars, mappings and sequences (tuples
    as sequences) → YAML in block style that `yaml_load` and PyYAML's
    safe_load both read back equal. Strings that would not read back as
    themselves when plain are double-quoted with escapes."""
    if not isinstance(data, (Mapping, list, tuple)):
        raise TypeError(f"a YAML config is a mapping or a sequence, not {type(data).__name__}")
    return "\n".join(_block_lines(data, 0) if data else [_inline_text(data)]) + "\n"


# -- configs ----------------------------------------------------------------


class DotDict(dict):
    """A dict whose items are also attributes, recursively."""

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs):
        super().__init__()
        data = dict(data or {})
        data.update(kwargs)
        for key, value in data.items():
            self[key] = self._wrap(value)

    @classmethod
    def _wrap(cls, value):
        if isinstance(value, Mapping) and not isinstance(value, DotDict):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __setattr__(self, name, value):
        self[name] = self._wrap(value)

    def __setitem__(self, name, value):
        super().__setitem__(name, self._wrap(value))

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError as exc:
            raise AttributeError(name) from exc

    def __deepcopy__(self, memo):
        return DotDict({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def deep_update(self, other: Mapping[str, Any]) -> "DotDict":
        """Recursively merge ``other`` into self (other wins)."""
        for key, value in other.items():
            if key in self and isinstance(self[key], DotDict) and isinstance(value, Mapping):
                self[key].deep_update(value)
            else:
                self[key] = value
        return self

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            if isinstance(value, DotDict):
                out[key] = value.to_dict()
            elif isinstance(value, (list, tuple)):
                out[key] = [v.to_dict() if isinstance(v, DotDict) else v for v in value]
            else:
                out[key] = value
        return out


class Config(DotDict):
    """DotDict read from a YAML file path (`yaml_load`) or a plain mapping."""

    def __init__(self, source: str | Mapping[str, Any] | None = None, **kwargs):
        if isinstance(source, str):
            with open(source, encoding="utf-8") as f:
                data = yaml_load(f.read(), source) or {}
            if not isinstance(data, Mapping):
                raise ValueError(f"{source}: a config is a mapping, not {type(data).__name__}")
        else:
            data = dict(source or {})
        data.update(kwargs)
        super().__init__(data)

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write(yaml_dump(self.to_dict()))


def load_config(path: str, overrides: Mapping[str, Any] | None = None) -> Config:
    cfg = Config(path)
    if overrides:
        cfg.deep_update(overrides)
    return cfg


def set_experiment(cfg: Config, tag: str | None = None) -> Config:
    """Create the experiment directory ``{checkpoint}/{dataset}-{N}[-{tag}]``
    (N: the entries of ``checkpoint`` whose names start with the dataset)
    with ``sample/ image/ result/ eval/ ckpt/``, set ``cfg.exp_dir`` and
    write the config to ``base.yaml`` in it (reference: DEX-TTS/src/
    utils.py:15-46, named as the JAX package names it)."""
    root = cfg.get("checkpoint", "./checkpoints")
    os.makedirs(root, exist_ok=True)
    base = str(cfg.get("dataset", "exp"))
    n = len([d for d in os.listdir(root) if d.startswith(base)])
    exp_dir = os.path.join(root, f"{base}-{n}" + (f"-{tag}" if tag else ""))
    cfg.exp_dir = exp_dir
    for sub in ("sample", "image", "result", "eval", "ckpt"):
        os.makedirs(os.path.join(exp_dir, sub), exist_ok=True)
    cfg.dump(os.path.join(exp_dir, "base.yaml"))
    return cfg
