"""A reader for the subset of YAML that the repo's configs use, and a writer
whose output every YAML reader accepts.

The port does not depend on PyYAML. ``safe_load`` reads:

  * block mappings and block sequences (``- item``, ``- key: value``);
  * flow sequences and flow mappings (``[0.9, 0.95]``, ``{size: 256}``),
    nested, and spanning lines (so JSON text reads too);
  * single- and double-quoted scalars, plain scalars, comments;
  * YAML 1.1 scalar resolution as ``yaml.safe_load`` does it: ``yes``/``on``
    are booleans, ``~`` and the empty value are null, ``200_000`` and
    ``0x1f`` are integers, ``1.5e-3`` is a float but ``1e-3`` (no dot) is a
    string.

Everything else raises ``YamlSubsetError`` rather than being misread: tags,
anchors and aliases, block scalars (``|``, ``>``), complex keys, several
documents or directives, tabs in indentation, multi-line plain or quoted
scalars, merge keys and timestamps.

``dump`` writes JSON text, which is valid YAML: ``yaml.safe_load`` and this
reader both read it back.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Optional, Tuple


class YamlSubsetError(ValueError):
    pass


# YAML 1.1 implicit resolvers (PyYAML's ``resolver.py``)
_BOOL_RE = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
    r"|on|On|ON|off|Off|OFF)$")
_NULL_RE = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT_RE = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_TIMESTAMP_RE = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = {"yes", "true", "on"}


def _sexagesimal(digits: str, conv) -> Any:
    value = 0
    base = 1
    for part in reversed(digits.split(":")):
        value += conv(part) * base
        base *= 60
    return value


def _resolve_plain(text: str) -> Any:
    """A plain scalar as ``yaml.safe_load`` resolves it."""
    if _NULL_RE.match(text):
        return None
    if _BOOL_RE.match(text):
        return text.lower() in _TRUE
    if _INT_RE.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        if v[0] in "+-":
            v = v[1:]
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT_RE.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        if v[0] in "+-":
            v = v[1:]
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    if _TIMESTAMP_RE.match(text):
        raise YamlSubsetError(f"timestamp scalar {text!r} is not supported")
    if text in ("<<", "="):
        raise YamlSubsetError(f"the {text!r} key is not supported")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_LEN = {"x": 2, "u": 4, "U": 8}


class _Scanner:
    """Characters of one logical piece of text (a line, or the lines a flow
    collection spans joined by spaces) with a cursor."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def error(self, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.where}: {msg}")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def skip_spaces(self) -> None:
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def at_end(self) -> bool:
        self.skip_spaces()
        return self.i >= len(self.s)

    # -------------------------------------------------------------- #
    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise self.error("unterminated or multi-line quoted scalar")
            c = self.s[self.i]
            if q == "'":
                if c == "'":
                    if self.s[self.i + 1:self.i + 2] == "'":
                        out.append("'")
                        self.i += 2
                        continue
                    self.i += 1
                    return "".join(out)
                out.append(c)
                self.i += 1
                continue
            if c == '"':
                self.i += 1
                return "".join(out)
            if c == "\\":
                e = self.s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_LEN:
                    n = _HEX_LEN[e]
                    code = self.s[self.i + 2:self.i + 2 + n]
                    if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                        raise self.error(f"bad escape \\{e}{code}")
                    out.append(chr(int(code, 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f"unsupported escape \\{e}")
                continue
            out.append(c)
            self.i += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar up to ``: ``, `` #`` or (in a flow collection) a
        flow indicator; trailing spaces stripped."""
        start = self.i
        first = self.peek()
        if not first:
            return ""
        if first in ",]}#":
            raise self.error(f"a plain scalar cannot start with {first!r}")
        if first in "&*!|>%@`":
            raise self.error(f"{first!r} (tags, anchors, aliases, block "
                             "scalars, directives) is not supported")
        if first in "?-:" and self.s[self.i + 1:self.i + 2] in ("", " "):
            raise self.error(f"unexpected indicator {first!r}")
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if c == ":" and (nxt in ("", " ") or (flow and nxt in ",[]{}")):
                break
            if c == "#" and self.i > start and self.s[self.i - 1] == " ":
                break
            if flow and c in ",[]{}":
                break
            self.i += 1
        return self.s[start:self.i].rstrip(" ")

    def node(self, flow: bool) -> Any:
        """A flow node or a scalar (quoted or plain)."""
        self.skip_spaces()
        c = self.peek()
        if c == "[":
            return self.flow_seq()
        if c == "{":
            return self.flow_map()
        if c and c in "'\"":
            return self.quoted()
        text = self.plain(flow)
        if flow and text == "" and self.peek() not in (",", "]", "}"):
            raise self.error(f"unexpected {self.peek()!r}")
        return _resolve_plain(text)

    def flow_seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip_spaces()
            if self.peek() == "]":
                self.i += 1
                return out
            if not self.peek():
                raise self.error("unterminated flow sequence")
            item = self.node(flow=True)
            self.skip_spaces()
            if self.peek() == ":":
                raise self.error("mappings inside a flow sequence are not "
                                 "supported")
            out.append(item)
            self._flow_sep("]")

    def flow_map(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip_spaces()
            if self.peek() == "}":
                self.i += 1
                return out
            if not self.peek():
                raise self.error("unterminated flow mapping")
            if self.peek() in "[{":
                raise self.error("collection keys are not supported")
            key = self.node(flow=True)
            self.skip_spaces()
            if self.peek() != ":":
                raise self.error("flow mapping entry without ':'")
            self.i += 1
            self.skip_spaces()
            out[key] = (None if self.peek() in (",", "}")
                        else self.node(flow=True))
            self._flow_sep("}")

    def _flow_sep(self, close: str) -> None:
        self.skip_spaces()
        c = self.peek()
        if c == ",":
            self.i += 1
        elif c != close:
            raise self.error(f"expected ',' or {close!r}, got {c!r}")


def _unquoted(text: str):
    """``(index, char)`` of the characters of ``text`` outside quoted
    scalars; a quote opens one only where a scalar starts (at the start or
    after ``:``, ``-``, ``[``, ``{``, ``,`` or ``?``)."""
    i, quote = 0, ""
    while i < len(text):
        c = text[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 1
            elif c == quote and quote == "'" and text[i + 1:i + 2] == "'":
                i += 1
            elif c == quote:
                quote = ""
        elif c in "'\"" and (not text[:i].rstrip(" ")
                             or text[:i].rstrip(" ")[-1] in ":-[{,?"):
            quote = c
        else:
            yield i, c
        i += 1


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a space,
    outside quoted scalars."""
    for i, c in _unquoted(line):
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _balanced(text: str) -> bool:
    """Whether every ``[``/``{`` opened outside quotes in ``text`` is closed."""
    depth = 0
    for _, c in _unquoted(text):
        depth += (c in "[{") - (c in "]}")
    return depth <= 0


class _Line:
    __slots__ = ("no", "indent", "text")

    def __init__(self, no: int, indent: int, text: str):
        self.no, self.indent, self.text = no, indent, text


class _Parser:
    def __init__(self, text: str, name: str):
        self.name = name
        self.lines: List[_Line] = []
        for no, raw in enumerate(text.splitlines(), 1):
            body = raw.rstrip("\r")
            stripped = body.lstrip(" ")
            content = _strip_comment(stripped).rstrip(" \t")
            if not content:
                continue
            if content[0] == "\t":
                raise self.error(no, "tab in indentation")
            if len(body) == len(stripped) and (
                    content[0] == "%" or content in ("---", "...")
                    or content.startswith(("--- ", "... "))):
                raise self.error(no, "directives and document markers are "
                                 "not supported (one document only)")
            self.lines.append(_Line(no, len(body) - len(stripped), content))
        self.pos = 0

    def error(self, no: int, msg: str) -> YamlSubsetError:
        return YamlSubsetError(f"{self.name}:{no}: {msg}")

    def parse(self) -> Any:
        if not self.lines:
            return None
        first = self.lines[0]
        node = self.block(first.indent)
        if self.pos < len(self.lines):
            raise self.error(self.lines[self.pos].no,
                             "unexpected content after the document's root")
        return node

    # -------------------------------------------------------------- #
    def block(self, indent: int) -> Any:
        line = self.lines[self.pos]
        if line.text == "-" or line.text.startswith("- "):
            return self.block_seq(indent)
        if self._key_split(line) is not None:
            return self.block_map(indent)
        # a lone scalar or flow collection (the whole document, or a value
        # on the lines under its key)
        self.pos += 1
        return self.inline_value(line, line.text)

    def _key_split(self, line: _Line) -> Optional[Tuple[Any, str]]:
        """``(key, rest)`` when the line is a ``key: value`` entry."""
        text = line.text
        if text.startswith("? ") or text == "?":
            raise self.error(line.no, "complex keys are not supported")
        sc = _Scanner(text, f"{self.name}:{line.no}")
        if text[0] in "'\"":
            key = sc.quoted()
            sc.skip_spaces()
            if sc.peek() != ":" or sc.s[sc.i + 1:sc.i + 2] not in ("", " "):
                return None
        elif text[0] in "[{":
            return None
        else:
            key_text = sc.plain(flow=False)
            if sc.peek() != ":":
                return None
            key = _resolve_plain(key_text)
        sc.i += 1
        return key, sc.s[sc.i:].strip(" ")

    def block_map(self, indent: int) -> dict:
        out = {}
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent < indent:
                break
            if line.indent > indent:
                raise self.error(line.no, "bad indentation (a multi-line "
                                 "plain scalar is not supported)")
            split = self._key_split(line)
            if split is None:
                raise self.error(line.no, "expected 'key: value'")
            key, rest = split
            if isinstance(key, (list, dict)):
                raise self.error(line.no, "collection keys are not supported")
            self.pos += 1
            if rest:
                out[key] = self.inline_value(line, rest)
                continue
            # the value is on the following lines: deeper, or a sequence at
            # this indentation
            nxt = self.lines[self.pos] if self.pos < len(self.lines) else None
            if nxt is not None and (nxt.indent > indent or (
                    nxt.indent == indent and (nxt.text == "-"
                                              or nxt.text.startswith("- ")))):
                out[key] = self.block(nxt.indent)
            else:
                out[key] = None
        return out

    def block_seq(self, indent: int) -> list:
        out = []
        while self.pos < len(self.lines):
            line = self.lines[self.pos]
            if line.indent < indent:
                break
            if line.indent > indent or not (line.text == "-"
                                            or line.text.startswith("- ")):
                if line.indent == indent:
                    break  # the mapping key that follows a same-indent list
                raise self.error(line.no, "bad indentation in a sequence")
            rest = line.text[1:]
            if not rest.strip():
                self.pos += 1
                nxt = self.lines[self.pos] if self.pos < len(self.lines) else None
                out.append(self.block(nxt.indent) if nxt is not None
                           and nxt.indent > indent else None)
                continue
            # the item's content starts a block at its own column
            col = indent + 1 + (len(rest) - len(rest.lstrip(" ")))
            self.lines[self.pos] = _Line(line.no, col, rest.lstrip(" "))
            out.append(self.block(col))
        return out

    def inline_value(self, line: _Line, text: str) -> Any:
        """A value that starts on ``line`` (already consumed); a flow
        collection may continue on the following lines, which it consumes."""
        if text[0] in "[{":
            joined = text
            while not _balanced(joined):
                if self.pos >= len(self.lines):
                    raise self.error(line.no, "unterminated flow collection")
                joined += " " + self.lines[self.pos].text
                self.pos += 1
            sc = _Scanner(joined, f"{self.name}:{line.no}")
        else:
            sc = _Scanner(text, f"{self.name}:{line.no}")
        value = sc.node(flow=False)
        if not sc.at_end():
            raise sc.error(f"unexpected {sc.s[sc.i:]!r} after the value")
        return value


def safe_load(text: str, name: str = "<string>") -> Any:
    """The object ``yaml.safe_load(text)`` gives, for the supported subset;
    raises ``YamlSubsetError`` outside it."""
    return _Parser(text, name).parse()


def load_file(path) -> Any:
    with open(path, "r", encoding="utf-8") as f:
        return safe_load(f.read(), str(path))


def _float(x: float) -> str:
    """``repr(x)`` with a dot in the mantissa: YAML 1.1 reads ``1e-06`` as
    a string and ``1.0e-06`` as a float."""
    if not math.isfinite(x):
        raise ValueError(f"{x!r} has no JSON form")
    text = repr(x)
    mantissa, e, exponent = text.partition("e")
    if e and "." not in mantissa:
        text = f"{mantissa}.0e{exponent}"
    return text


def _json(obj: Any, indent: str) -> str:
    inner = indent + "  "
    if isinstance(obj, dict):
        if not obj:
            return "{}"
        items = []
        for k, v in obj.items():
            if not isinstance(k, str):
                raise TypeError(f"key {k!r}: only string keys are written")
            items.append(f"{inner}{json.dumps(k, ensure_ascii=False)}: "
                         f"{_json(v, inner)}")
        return "{\n" + ",\n".join(items) + f"\n{indent}}}"
    if isinstance(obj, (list, tuple)):
        if not obj:
            return "[]"
        return ("[\n" + ",\n".join(inner + _json(v, inner) for v in obj)
                + f"\n{indent}]")
    if obj is None or isinstance(obj, (bool, str)):
        return json.dumps(obj, ensure_ascii=False)
    if isinstance(obj, int):
        return str(int(obj))
    if isinstance(obj, float):
        return _float(obj)
    raise TypeError(f"{type(obj).__name__} has no JSON form")


def dump(obj: Any) -> str:
    """JSON text (valid YAML) of a config: nested dicts (string keys),
    lists and tuples of strings, numbers, booleans and None, with every
    float written so that a YAML 1.1 reader reads a float. Raises on what
    JSON cannot hold (non-finite floats, other objects)."""
    return _json(obj, "") + "\n"
