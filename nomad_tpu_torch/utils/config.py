"""Reader and writer of the YAML subset the experiment configs use
(``nomad_tpu/configs/*.yaml``), with no YAML library.

The subset: one ``key: value`` per line at the top level; a value is a
scalar, an inline list ``[a, b]`` or, after a bare ``key:``, a block list
of indented ``- item`` lines. Scalars follow YAML 1.1 as PyYAML's
``safe_load`` reads them: ``null``/``~``/empty, booleans (``true``,
``False``, ``yes``, ``off``, ...), decimal ints, floats with a dot,
``.inf``/``.nan``, single- or double-quoted strings, and plain strings.
A ``#`` after whitespace starts a comment. Anything else raises
``ValueError`` naming the line.
"""

from __future__ import annotations

import json
import math
import re

_BOOLS = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOLS.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE",
                                   "off", "Off", "OFF")})
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
_KEY = re.compile(r"([A-Za-z_][A-Za-z0-9_.-]*):(?:\s+(.*))?$")


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' outside quotes, at the start or
    after whitespace."""
    quote, i = None, 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == quote == "'" and line[i + 1:i + 2] == "'":
                i += 1  # '' inside single quotes
            elif ch == "\\" and quote == '"':
                i += 1  # an escape inside double quotes
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _quoted(text: str, where: str) -> str:
    if text[0] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"{where}: unterminated quoted string {text!r}")
        return text[1:-1].replace("''", "'")
    try:
        return json.loads(text)
    except json.JSONDecodeError as e:
        raise ValueError(f"{where}: unsupported double-quoted string {text!r}") from e


def parse_scalar(text: str, where: str = "value"):
    """One YAML 1.1 scalar of the subset -> None, bool, int, float or str."""
    text = text.strip()
    if text in _NULLS:
        return None
    if text[0] in "'\"":
        return _quoted(text, where)
    if text in _BOOLS:
        return _BOOLS[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text[0] == "-" else math.inf
    if _NAN.match(text):
        return math.nan
    if text[0] in "[]{}&*!|>%@`" or ": " in text:
        raise ValueError(f"{where}: {text!r} is outside the supported YAML subset")
    return text


def _split_inline(body: str, where: str) -> list:
    items, quote, start = [], None, 0
    for i, ch in enumerate(body):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == ",":
            items.append(body[start:i])
            start = i + 1
    last = body[start:]
    if last.strip() or items:
        items.append(last)
    return [parse_scalar(item, where) for item in items]


def _value(text: str, where: str):
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"{where}: unterminated inline list {text!r}")
        return _split_inline(text[1:-1], where)
    return parse_scalar(text, where)


def loads(text: str) -> dict:
    """Parse a config of the subset into a dict."""
    out: dict = {}
    block_key = None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"line {n}"
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line[0] in " \t":
            item = line.strip()
            if block_key is None or not (item == "-" or item.startswith("- ")):
                raise ValueError(f"{where}: indented line outside a block list: {raw!r}")
            if out[block_key] is None:
                out[block_key] = []
            out[block_key].append(_value(item[1:].strip(), where))
            continue
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{where}: expected 'key: value', got {raw!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        if key in out:
            raise ValueError(f"{where}: duplicate key {key!r}")
        # a bare 'key:' is null unless block-list items follow
        out[key], block_key = (_value(rest, where), None) if rest else (None, key)
    return out


def load(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return loads(f.read())


def _dump_scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value)
        if "e" in text and "." not in text:  # YAML 1.1 floats need the dot
            text = text.replace("e", ".0e")
        return text
    if isinstance(value, str):
        return json.dumps(value)
    raise TypeError(f"cannot write {type(value).__name__} {value!r} in the config subset")


def dumps(config: dict) -> str:
    """Write a flat config (scalars and lists of scalars), keys sorted as
    ``yaml.dump`` sorts them; ``loads`` reads it back equal."""
    lines = []
    for key in sorted(config):
        value = config[key]
        if not _KEY.match(f"{key}:"):
            raise ValueError(f"config key {key!r} is outside the supported YAML subset")
        if isinstance(value, (list, tuple)):
            lines.append(f"{key}: [{', '.join(_dump_scalar(v) for v in value)}]")
        else:
            lines.append(f"{key}: {_dump_scalar(value)}")
    return "\n".join(lines) + "\n"


def dump(config: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write(dumps(config))
