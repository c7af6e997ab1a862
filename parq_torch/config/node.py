"""Config node with yacs semantics, and a reader for the YAML the configs
use (port of parq_tpu/config/node.py).

`CfgNode` keeps the JAX package's behaviour: attribute access,
`freeze`/`defrost`, `merge_from_file`, `merge_from_list` with
`ast.literal_eval` coercion to the default's type, keys unknown to the
schema tolerated from files and rejected from the command line.

PyYAML is not on every machine the port runs on, so `load_yaml` reads the
subset of YAML that configs/*.yaml use and resolves its scalars as
`yaml.safe_load` (YAML 1.1) does: nested block mappings, `#` comments,
quoted and bare scalars, `~`/`null`, booleans, decimal ints, floats with a
dot (`1e-4`, without one, stays a string, as in PyYAML; the schema's float
default then coerces it), and flow lists of scalars. Anything else (block
lists, anchors, multi-line scalars, flow mappings, tabs) raises.
"""
from __future__ import annotations

import ast
import copy
import re
from typing import Any, List

_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"([-+]?[0-9][0-9]*\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?$")
_SPECIAL_FLOAT = {f"{sign}.{inf}": float(f"{sign}inf")
                  for sign in ("", "+", "-") for inf in ("inf", "Inf", "INF")}
_SPECIAL_FLOAT.update({f".{nan}": float("nan")
                       for nan in ("nan", "NaN", "NAN")})
_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
# YAML 1.1 reads these as booleans, and ints in other bases or with
# underscores as numbers; the configs use none of them, so they raise
# instead of being guessed at.
_AMBIGUOUS = re.compile(
    r"(yes|Yes|YES|no|No|NO|on|On|ON|off|Off|OFF|y|Y|n|N"
    r"|[-+]?0[0-9_]+|[-+]?0[xXbBoO][0-9a-fA-F_]+|[-+]?[0-9][0-9_]*_[0-9_]*"
    r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?)$")
_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_]*$")


class YamlSubsetError(ValueError):
    pass


def _strip_comment(line: str) -> str:
    """The line without a trailing `# comment` (a # inside quotes, or not
    preceded by a space, is content)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(text: str, where: str):
    s = text.strip()
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        body = s[1:-1]
        if s[0] == "'":
            if "'" in body.replace("''", ""):
                raise YamlSubsetError(f"{where}: bad quoting {s!r}")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise YamlSubsetError(f"{where}: escapes are not supported: {s!r}")
        return body
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
    if s in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[s]
    if _AMBIGUOUS.match(s) or s[0] in "[]{}&*!|>%@`'\"-?,":
        raise YamlSubsetError(f"{where}: unsupported scalar {s!r}")
    if ": " in s or s.endswith(":") or " #" in s:
        raise YamlSubsetError(f"{where}: unsupported scalar {s!r}")
    return s


def _value(text: str, where: str):
    s = text.strip()
    if s.startswith("["):
        if not s.endswith("]") or "[" in s[1:] or "]" in s[:-1]:
            raise YamlSubsetError(f"{where}: only flat flow lists: {s!r}")
        inner = s[1:-1].strip()
        return [] if not inner else [_scalar(v, where)
                                     for v in inner.split(",")]
    return _scalar(s, where)


def load_yaml(text: str, name: str = "<yaml>") -> Any:
    """`yaml.safe_load(text)` for the subset described above."""
    root: dict = {}
    stack = [(-1, root)]           # (indent, mapping)
    pending = None                 # (indent, parent, key) of a `key:` line
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{no}"
        if "\t" in raw:
            raise YamlSubsetError(f"{where}: tabs are not supported")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if line.strip() in ("---", "...") or line.lstrip().startswith("- "):
            raise YamlSubsetError(f"{where}: unsupported line {raw!r}")
        indent = len(line) - len(line.lstrip(" "))
        key, sep, rest = line.strip().partition(":")
        if not sep or not _KEY.match(key) or (rest and rest[0] != " "):
            raise YamlSubsetError(f"{where}: expected `key: value`: {raw!r}")
        if pending is not None:
            p_indent, p_parent, p_key = pending
            if indent > p_indent:              # the block of `p_key:`
                node: dict = {}
                p_parent[p_key] = node
                stack.append((indent, node))
            else:
                p_parent[p_key] = None
            pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            if stack[-1][0] == -1 and not stack[-1][1]:
                stack[-1] = (indent, root)
            else:
                raise YamlSubsetError(f"{where}: bad indentation {raw!r}")
        mapping = stack[-1][1]
        if key in mapping:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        if rest.strip():
            mapping[key] = _value(rest, where)
        else:
            mapping[key] = None
            pending = (indent, mapping, key)
    return root or None


class CfgNode(dict):
    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict=None):
        super().__init__()
        self.__dict__[CfgNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no key: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(CfgNode.IMMUTABLE, False):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        self[name] = value

    def freeze(self):
        self._set_immutable(True)

    def defrost(self):
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return self.__dict__[CfgNode.IMMUTABLE]

    def _set_immutable(self, value: bool):
        self.__dict__[CfgNode.IMMUTABLE] = value
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def merge_from_file(self, path: str):
        with open(path) as f:
            loaded = load_yaml(f.read(), str(path))
        if loaded:
            self._merge_dict(loaded)

    def merge_from_list(self, opts: List[str]):
        assert len(opts) % 2 == 0, \
            f"Override list must be KEY VALUE pairs: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            dict.__setitem__(node, leaf, _coerce(value, node[leaf]))

    def _merge_dict(self, other: dict):
        for k, v in other.items():
            if k not in self:
                # keys the schema lacks are kept from files (yacs would
                # raise), so the shipped YAMLs load with their extra keys
                dict.__setitem__(self, k, CfgNode(v) if isinstance(v, dict)
                                 else _parse_scalar(v))
                continue
            cur = self[k]
            if isinstance(cur, CfgNode) and isinstance(v, dict):
                cur._merge_dict(v)
            else:
                dict.__setitem__(self, k, _coerce_loaded(v, cur))

    def to_dict(self) -> dict:
        return {k: (v.to_dict() if isinstance(v, CfgNode) else v)
                for k, v in self.items()}

    def __str__(self):
        return "\n".join(_dump(self.to_dict(), 0))


def _dump(d: dict, indent: int):
    for k, v in d.items():
        if isinstance(v, dict):
            yield " " * indent + f"{k}:"
            yield from _dump(v, indent + 2)
        else:
            yield " " * indent + f"{k}: {v!r}"


def _parse_scalar(v):
    if isinstance(v, str) and v in ("None", "~", "null"):
        return None
    return v


def _coerce_loaded(value, old):
    """A value read from a file, coerced to the default's type where
    sensible."""
    value = _parse_scalar(value)
    if value is None or old is None:
        return value
    if isinstance(old, bool):
        return bool(value)
    if isinstance(old, float) and isinstance(value, (int, float, str)):
        return float(value)
    if isinstance(old, int) and isinstance(value, (int, float)) \
            and not isinstance(value, bool):
        return int(value)
    return value


def _coerce(value: str, old):
    """A command-line string, coerced to the default's type (yacs-style
    literal eval)."""
    if value in ("None", "~", "null"):
        return None
    try:
        lit = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        lit = value
    return _coerce_loaded(lit, old)
