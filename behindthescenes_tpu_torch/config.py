"""Config system (counterpart of behindthescenes_tpu/config.py:18-103):
YAML files with Hydra-style `defaults` composition, deep merging and
`key.subkey=value` overrides.

The GPU machine has no PyYAML, so the port reads YAML with its own parser,
restricted to the subset that `configs/` uses: block mappings and block
lists (list items may be one-key mappings, `- data: synthetic`), flow
lists (`[192, 640]`, `[]`), `#` comments, quoted and plain strings, and
the scalars as YAML 1.1 resolves them (`1.0e-4` is a float, `2e-5` a
string; true/false and the other YAML 1.1 booleans; null and `~`).
Anything outside that subset (anchors, aliases, tags, block scalars, flow
mappings, multi-line scalars, YAML 1.1's octal, binary, sexagesimal and
underscored numbers, timestamps) raises ValueError naming the file and
line, so that no config is misread silently. Lists come back as lists,
as `yaml.safe_load` gives them.
"""
from __future__ import annotations

import copy
import os
import re
from typing import Optional

# The repository's own configs, for entry points run from elsewhere.
_REPO_CONFIGS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)$")
# What YAML 1.1 (PyYAML's resolvers) reads as a number, a timestamp or a
# special value beyond the forms above: refused.
_OUTSIDE = re.compile(
    r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?(?:0|[1-9][0-9_]*)$"
    r"|[-+]?0x[0-9a-fA-F_]+$|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+$"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?$"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?$"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*$"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|=$|<<$")
# Characters that may not begin a plain scalar in the subset: anchors,
# aliases, tags, block scalars, flow mappings, directives, reserved ones
# and complex keys.
_INDICATORS = set("&*!|>{}%@`?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\"}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Reader:
    """One logical line of a YAML file, read token by token."""

    def __init__(self, text: str, where: str):
        self.text = text
        self.where = where
        self.pos = 0

    def fail(self, msg: str):
        raise ValueError(f"{self.where}: {msg} (outside the YAML subset "
                         "the port reads)")

    def skip_spaces(self):
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment."""
        self.skip_spaces()
        return self.pos >= len(self.text) or self.text[self.pos] == "#"

    def expect_end(self):
        if not self.at_end():
            self.fail(f"unexpected text {self.text[self.pos:]!r}")

    def quoted(self) -> str:
        q = self.text[self.pos]
        out, i = [], self.pos + 1
        while i < len(self.text):
            c = self.text[i]
            if c == q:
                if q == "'" and self.text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                self.pos = i + 1
                return "".join(out)
            if c == "\\" and q == '"':
                e = self.text[i + 1:i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                elif e in _HEX:
                    digits = self.text[i + 2:i + 2 + _HEX[e]]
                    if not re.fullmatch(r"[0-9a-fA-F]{%d}" % _HEX[e],
                                        digits):
                        self.fail(f"bad escape \\{e}{digits}")
                    out.append(chr(int(digits, 16)))
                    i += 2 + _HEX[e]
                else:
                    self.fail(f"escape \\{e}")
                continue
            out.append(c)
            i += 1
        self.fail("a quoted scalar that does not end on its line")

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, the end of the line or, in a
        flow list, a `,` or `]`."""
        start = self.pos
        if self.text[start] in _INDICATORS or self.text[start] in "[]," or (
                self.text[start] == "-" and self.text[start + 1:start + 2]
                in ("", " ")):
            self.fail(f"{self.text[start:]!r}")
        i = start
        while i < len(self.text):
            c = self.text[i]
            if c == "#" and self.text[i - 1] == " ":
                break
            if flow and c in ",[]{}":
                break
            if c == ":" and self.text[i + 1:i + 2] in ("", " ") or \
                    flow and c == ":":
                self.fail(f"a mapping inside {self.text[start:]!r}")
            i += 1
        self.pos = i
        return self.text[start:i].rstrip(" ")

    def flow_list(self) -> list:
        self.pos += 1                                   # '['
        out = []
        while True:
            self.skip_spaces()
            if self.pos >= len(self.text) or self.text[self.pos] == "#":
                self.fail("a flow list that does not end on its line")
            if self.text[self.pos] == "]":
                self.pos += 1
                return out
            out.append(self.value(flow=True))
            self.skip_spaces()
            c = self.text[self.pos:self.pos + 1]
            if c == ",":
                self.pos += 1
            elif c != "]":
                self.fail("a flow list that does not end on its line")

    def value(self, flow: bool = False):
        """A scalar or a flow list at the cursor."""
        self.skip_spaces()
        c = self.text[self.pos]
        if c in "\"'":
            return self.quoted()
        if c == "[":
            return self.flow_list()
        return self.resolve(self.plain(flow))

    def key(self):
        """A mapping key and its ':'; None if the line holds no key."""
        save = self.pos
        c = self.text[self.pos]
        if c in "\"'":
            k = self.quoted()
        else:
            i = self.pos
            while i < len(self.text):
                if self.text[i] == ":" and \
                        self.text[i + 1:i + 2] in ("", " "):
                    break
                if self.text[i] == "#" and i > 0 and \
                        self.text[i - 1] == " ":
                    i = len(self.text)
                    break
                i += 1
            if i >= len(self.text):
                return None
            if c in _INDICATORS or c in "[]," or c == "-" and \
                    self.text[self.pos + 1:self.pos + 2] in ("", " "):
                self.fail(f"key {self.text[self.pos:i]!r}")
            k = self.resolve(self.text[self.pos:i].rstrip(" "))
            self.pos = i
        if self.text[self.pos:self.pos + 1] != ":" or \
                self.text[self.pos + 1:self.pos + 2] not in ("", " "):
            self.pos = save
            return None
        self.pos += 1
        return (k,)

    def resolve(self, s: str):
        """A plain scalar as YAML 1.1 resolves it."""
        if s in _NULL:
            return None
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        if _INT.match(s):
            return int(s)
        if _FLOAT.match(s):
            return float(s)
        if _INF.match(s):
            return float("-inf") if s[0] == "-" else float("inf")
        if _NAN.match(s):
            return float("nan")
        if _OUTSIDE.match(s):
            self.fail(f"scalar {s!r}")
        return s


def _lines(text: str, source: str):
    """(indent, content, where) of every line that holds more than a
    comment."""
    out = []
    for no, line in enumerate(text.splitlines(), 1):
        stripped = line.lstrip(" ")
        where = f"{source}:{no}"
        if not stripped or stripped.startswith("#"):
            continue
        if stripped[0] == "\t" or "\t" in line[:len(line) - len(stripped)]:
            raise ValueError(f"{where}: a tab in the indentation")
        if stripped.rstrip() in ("---", "...") or \
                stripped.startswith(("--- ", "%")):
            raise ValueError(f"{where}: document markers and directives "
                             "(outside the YAML subset the port reads)")
        out.append((len(line) - len(stripped), stripped.rstrip(" "), where))
    return out


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


class _Parser:
    def __init__(self, lines):
        self.lines = lines
        self.i = 0

    def block(self, indent: int):
        if _is_item(self.lines[self.i][1]):
            return self.sequence(indent)
        return self.mapping(indent)

    def nested(self, indent: int, allow_same_indent_list: bool):
        """The block value of a key or list item that ends its line: the
        lines indented deeper (or, for a key, a list at its own
        indentation), else null."""
        if self.i < len(self.lines):
            ind, content, _ = self.lines[self.i]
            if ind > indent:
                return self.block(ind)
            if ind == indent and allow_same_indent_list and \
                    _is_item(content):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            ind, content, where = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent or _is_item(content):
                raise ValueError(f"{where}: unexpected indentation or list "
                                 "item inside a mapping")
            r = _Reader(content, where)
            k = r.key()
            if k is None:
                r.fail(f"a line without a key: {content!r}")
            self.i += 1
            if r.at_end():
                out[k[0]] = self.nested(indent, True)
            else:
                out[k[0]] = r.value()
                r.expect_end()
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content, where = self.lines[self.i]
            if ind < indent or ind == indent and not _is_item(content):
                break
            if ind > indent:
                raise ValueError(f"{where}: unexpected indentation inside "
                                 "a list")
            rest = content[1:].lstrip(" ")
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self.nested(indent, False))
                continue
            col = ind + len(content) - len(rest)
            r = _Reader(rest, where)
            if _is_item(rest) or r.key() is not None:
                # The item's own block starts on this line, at `col`.
                self.lines[self.i] = (col, rest, where)
                out.append(self.block(col))
            else:
                self.i += 1
                out.append(r.value())
                r.expect_end()
        return out


def loads(text: str, source: str = "<string>"):
    """Parse YAML text of the subset; None for an empty document."""
    lines = _lines(text, source)
    if not lines:
        return None
    indent, content, where = lines[0]
    r = _Reader(content, where)
    if not _is_item(content) and r.key() is None:
        # A document that is one scalar or flow list.
        if len(lines) > 1:
            raise ValueError(f"{lines[1][2]}: a scalar document that goes "
                             "on past its first line")
        r.pos = 0
        out = r.value()
        r.expect_end()
        return out
    p = _Parser(lines)
    out = p.block(indent)
    if p.i != len(lines):
        raise ValueError(f"{lines[p.i][2]}: unexpected indentation")
    return out


def load_yaml(path: str):
    with open(path) as f:
        return loads(f.read(), path)


def deep_merge(base: dict, override: dict) -> dict:
    """Recursively merge `override` into `base` (override wins)."""
    out = copy.deepcopy(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _resolve_entry(entry, config_dir: str) -> dict:
    """Resolve one `defaults` list entry to a composed dict."""
    if isinstance(entry, dict):
        # e.g. {data: kitti_raw} -> configs/data/kitti_raw.yaml under key.
        (group, name), = entry.items()
        sub = load_config(os.path.join(config_dir, group, f"{name}.yaml"))
        return {group: sub} if group not in ("", None) else sub
    if entry == "_self_":
        return {}
    return load_config(os.path.join(config_dir, f"{entry}.yaml"))


def load_config(path: str, overrides: Optional[dict] = None) -> dict:
    """Load and compose a YAML config file."""
    raw = load_yaml(path) or {}
    config_dir = os.path.dirname(os.path.abspath(path))

    defaults = raw.pop("defaults", None)
    if defaults is None:
        composed = raw
    else:
        composed: dict = {}
        self_merged = False
        for entry in defaults:
            if entry == "_self_":
                composed = deep_merge(composed, raw)
                self_merged = True
            else:
                composed = deep_merge(composed, _resolve_entry(entry,
                                                               config_dir))
        if not self_merged:
            composed = deep_merge(composed, raw)
    if overrides:
        composed = deep_merge(composed, overrides)
    return composed


def parse_cli_overrides(args) -> dict:
    """Parse `key.subkey=value` CLI override strings into a nested dict.
    Each value is read as a YAML document of the subset; one outside it
    raises ValueError (PyYAML's loader keeps a malformed value as its raw
    string instead)."""
    out: dict = {}
    for arg in args:
        if "=" not in arg:
            raise ValueError(f"Override must be key=value, got: {arg}")
        key, value = arg.split("=", 1)
        value = loads(value, f"override {arg!r}")
        if isinstance(value, str):
            # YAML 1.1's float resolver rejects dotless scientific notation
            # ("2e-5" stays a string, silently breaking numeric overrides
            # like lr=2e-5). Hydra/OmegaConf accept it; so do we.
            try:
                value = int(value, 0)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def find_config(name: str, search_dirs=("configs", _REPO_CONFIGS)) -> str:
    """Locate a config by name (`-cn` style): under ./configs, then under
    the repository's configs/."""
    for d in search_dirs:
        path = os.path.join(d, f"{name}.yaml")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"Config {name!r} not found in {search_dirs}")
