"""Hierarchical, freezable config node with YAML ``_BASE_`` inheritance.

Counterpart of ``pod_compare_tpu/config/node.py``. The machines this
package targets need not have PyYAML, so the configs under ``configs/``
are read by ``parse_yaml`` below: a reader for the YAML subset those files
use (nested block maps, flow lists such as ``["res3", "res4"]``, quoted and
bare scalars, ``#`` comments). Anything outside that subset raises instead
of being misread. Tuples written as strings (``STEPS: (60000, 80000)``)
become tuples at merge time through ``ast.literal_eval``, as in the JAX
package.
"""

import ast
import copy
import os
import re
from typing import Any, Dict, List, Tuple

_FROZEN = "__frozen__"
BASE_KEY = "_BASE_"


class ConfigNode(dict):
    """Attribute-access dict; nested dicts become ConfigNodes; freezable."""

    def __init__(self, init: Dict[str, Any] = None):
        super().__init__()
        object.__setattr__(self, _FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = self._convert(v)

    @classmethod
    def _convert(cls, v):
        if isinstance(v, dict) and not isinstance(v, ConfigNode):
            return cls(v)
        return v

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def __setitem__(self, name, value):
        if object.__getattribute__(self, _FROZEN):
            raise AttributeError(f"Cannot set '{name}': config is frozen")
        super().__setitem__(name, self._convert(value))

    def freeze(self):
        object.__setattr__(self, _FROZEN, True)
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()
        return self

    def merge_from_other(self, other: "ConfigNode", allow_new: bool = False):
        """Recursively merge `other` into self; unknown keys raise unless
        ``allow_new`` (catches config typos, as yacs does)."""
        for k, v in other.items():
            if k == BASE_KEY:
                continue
            if k not in self:
                if not allow_new:
                    raise KeyError(f"Non-existent config key: {k}")
                self[k] = v
            elif isinstance(self[k], ConfigNode) and isinstance(v, (dict, ConfigNode)):
                self[k].merge_from_other(ConfigNode._convert(v), allow_new=allow_new)
            else:
                self[k] = _coerce(v, self[k], k)
        return self

    def merge_from_file(self, path: str, allow_new: bool = False):
        return self.merge_from_other(load_yaml_with_base(path), allow_new=allow_new)

    def merge_from_list(self, opts):
        """Merge from a flat ``[KEY, VALUE, KEY, VALUE...]`` list (CLI opts)."""
        assert len(opts) % 2 == 0, f"Override list has odd length: {opts}"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _parse_literal(value)
            node[leaf] = _coerce(value, node[leaf], key)
        return self

    def clone(self) -> "ConfigNode":
        """An unfrozen deep copy."""
        return ConfigNode(copy.deepcopy(self.to_dict()))

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, ConfigNode) else v)
            for k, v in self.items()
        }


def _parse_literal(s: str):
    """Parse a string into a Python literal when possible."""
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def _coerce(new, old, key):
    """Allow compatible-type replacement (list<->tuple, int<->float);
    strings are literal-evaluated when the existing value is not one."""
    if isinstance(new, str) and not isinstance(old, str):
        new = _parse_literal(new)
    if old is None or new is None:
        return new
    if isinstance(new, type(old)):
        return new
    if isinstance(old, tuple) and isinstance(new, list):
        return tuple(new)
    if isinstance(old, list) and isinstance(new, tuple):
        return list(new)
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, bool) != isinstance(new, bool):
        raise TypeError(f"Type mismatch for key {key}: {type(old)} vs {type(new)}")
    if isinstance(old, (int, float)) and isinstance(new, (int, float)):
        return new
    raise TypeError(f"Type mismatch for key {key}: {type(old)} vs {type(new)}")


# ------------------------------------------------------------ YAML subset
# Plain-scalar resolution follows YAML 1.1 as PyYAML applies it.
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(
    r"^([-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?"
    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN))$"
)


def _plain_scalar(s: str):
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    if _FLOAT.match(s) and s not in (".", "+.", "-."):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t.startswith("-") else float("inf")
        if t.endswith("nan"):
            return float("nan")
        return float(t)
    return s


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quoted scalars (a quote opens one only where a value starts)."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1
            elif ch == quote and line[i + 1:i + 2] == quote == "'":
                i += 1
            elif ch == quote:
                quote = None
        elif ch in "'\"" and line[:i].rstrip()[-1:] in ("", ":", "[", ","):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _quoted(s: str, i: int) -> Tuple[str, int]:
    """Parse a quoted scalar starting at s[i]; returns (value, next index)."""
    q = s[i]
    j = i + 1
    out = []
    while j < len(s):
        ch = s[j]
        if q == "'" and ch == "'":
            if j + 1 < len(s) and s[j + 1] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and ch == "\\":
            esc = {"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}
            if j + 1 >= len(s) or s[j + 1] not in esc:
                raise ValueError(f"Unsupported escape in {s!r}")
            out.append(esc[s[j + 1]])
            j += 2
            continue
        if q == '"' and ch == '"':
            return "".join(out), j + 1
        out.append(ch)
        j += 1
    raise ValueError(f"Unterminated quoted scalar: {s!r}")


def _flow(s: str, i: int, in_list: bool = False) -> Tuple[Any, int]:
    """Parse a value (flow list, quoted or plain scalar) at s[i]; inside a
    flow list a plain scalar ends at ',' or ']'."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i < len(s) and s[i] == "[":
        items: List[Any] = []
        i += 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == "]":
                return items, i + 1
            value, i = _flow(s, i, in_list=True)
            items.append(value)
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i < len(s) and s[i] == "]":
                return items, i + 1
            else:
                raise ValueError(f"Malformed flow list: {s!r}")
    if i < len(s) and s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and not (in_list and s[j] in ",]"):
        j += 1
    return _plain_scalar(s[i:j].strip()), j


def _value(text: str):
    text = text.strip()
    if text[:1] in "{&*!|>" or text == "-" or text.startswith("- "):
        raise ValueError(f"YAML construct outside the supported subset: {text!r}")
    value, end = _flow(text, 0)
    if text[end:].strip():
        raise ValueError(f"Trailing text after value: {text!r}")
    return value


def _split_key(content: str) -> Tuple[str, str]:
    if content[:1] in "'\"":
        key, end = _quoted(content, 0)
        rest = content[end:].lstrip()
        if not rest.startswith(":"):
            raise ValueError(f"Expected ':' after key in {content!r}")
        return key, rest[1:]
    m = re.match(r"^([^:#\[\]{}]+?):(\s|$)", content)
    if not m:
        raise ValueError(f"Not a 'key: value' line: {content!r}")
    return m.group(1), content[m.end(1) + 1:]


def parse_yaml(text: str) -> Dict[str, Any]:
    """Parse the YAML subset of the repo's configs into nested dicts."""
    root: Dict[str, Any] = {}
    stack = [(0, root)]  # (indent, mapping) of the open block maps
    pending = None  # (indent, mapping, key) of a key awaiting a nested block
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        if line[indent] == "\t":
            raise ValueError(f"Tab indentation is not supported: {raw!r}")
        content = line.strip()
        if content in ("---", "..."):
            continue
        if pending is not None:
            p_indent, p_mapping, p_key = pending
            if indent > p_indent:
                p_mapping[p_key] = {}
                stack.append((indent, p_mapping[p_key]))
            else:
                p_mapping[p_key] = None
            pending = None
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"Inconsistent indentation: {raw!r}")
        mapping = stack[-1][1]
        key, rest = _split_key(content)
        if key in mapping:
            raise ValueError(f"Duplicate key {key!r}")
        if rest.strip():
            mapping[key] = _value(rest)
        else:
            pending = (indent, mapping, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root


def load_yaml_with_base(path: str) -> ConfigNode:
    """Load a YAML file, recursively resolving ``_BASE_`` inheritance."""
    with open(path, "r") as f:
        raw = parse_yaml(f.read())
    cfg = ConfigNode(raw)
    if BASE_KEY in raw:
        base_path = raw[BASE_KEY]
        if not os.path.isabs(base_path):
            base_path = os.path.join(os.path.dirname(path), base_path)
        base = load_yaml_with_base(base_path)
        base.merge_from_other(cfg, allow_new=True)
        return base
    return cfg
