"""Config loader (counterpart of scldm_tpu/config/loader.py): the subset of
Hydra / OmegaConf the reference leans on, without the dependency.

- a YAML config tree whose `defaults:` list composes group files
  (`- model: vae_base` merges configs/model/vae_base.yaml under `model`;
  `_self_` places the file's own keys; a bare entry merges a file at the top);
- `${a.b.c}` interpolation, nested (`${datamodule.dataset_params.${
  datamodule.dataset}.n_genes}`), the `${eval:'expr'}` arithmetic resolver and
  `${repo_root:}`, the directory that ships configs/ and metadata/;
- dotted command-line overrides `a.b.c=value`, the values typed as YAML.

Values resolve at `resolve()`, so overrides apply before interpolation.

The YAML is read by `parse_yaml`, a reader of the subset the repository's
configs use (block maps and lists, `{}` / `[a, b]` / `{a: 1}` flow values,
quoted strings, comments) that types every plain scalar as PyYAML's
`safe_load` does under YAML 1.1: `5e-4` and `1e-8` are strings (a YAML 1.1
float needs a dot), `1.0e-4` a float, `~` / `null` / empty None, and `yes`,
`no`, `on`, `off` booleans. A construct outside the subset (anchors,
aliases, tags, block scalars, several documents, multi-line plain scalars)
raises a ValueError; it is never guessed at.
"""

from __future__ import annotations

import copy
import math
import re
from pathlib import Path
from typing import Any, Dict, List, Tuple

_INTERP = re.compile(r"\$\{([^${}]+)\}")

# -- the YAML subset -----------------------------------------------------------

# PyYAML's YAML 1.1 implicit resolvers (resolver.py), in its order of trial
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)"
                    r"|\.(?:nan|NaN|NAN))$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+"
                  r"|[-+]?0[0-7_]+"
                  r"|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                        r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                        r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?"
                        r"(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$")
_BOOL_VALUES = {"yes": True, "true": True, "on": True, "no": False, "false": False, "off": False}
# characters that may not start a plain scalar (`-`, `?` and `:` only when a
# space follows)
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_UNSUPPORTED_START = set("&*!|>%@`?")


def _int(text: str) -> int:
    """PyYAML's `construct_yaml_int`."""
    value = text.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        digits = [int(part) for part in value.split(":")]
        out, base = 0, 1
        for d in reversed(digits):
            out += d * base
            base *= 60
        return sign * out
    return sign * int(value)


def _float(text: str) -> float:
    """PyYAML's `construct_yaml_float`."""
    value = text.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        digits = [float(part) for part in value.split(":")]
        out, base = 0.0, 1
        for d in reversed(digits):
            out += d * base
            base *= 60
        return sign * out
    return sign * float(value)


def _plain(text: str) -> Any:
    """A plain (unquoted) scalar typed as `yaml.safe_load` types it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return _BOOL_VALUES[text.lower()]
    if text[0] in "-+0123456789." and _FLOAT.match(text):
        return _float(text)
    if text[0] in "-+0123456789" and _INT.match(text):
        return _int(text)
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        raise ValueError(f"YAML value {text!r} (a timestamp, value or merge key) is outside "
                         "the supported subset")
    return text


_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\"}


class _Reader:
    """One line of YAML at a time: `text` is the line, `pos` the cursor."""

    def __init__(self, text: str, where: str):
        self.text = text
        self.pos = 0
        self.where = where

    def fail(self, why: str):
        raise ValueError(f"{self.where}: {why} in {self.text!r}")

    def skip_spaces(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def at_end(self) -> bool:
        """True at the end of the line or at a comment."""
        self.skip_spaces()
        return self.pos >= len(self.text) or self.text[self.pos] == "#"

    def quoted(self) -> str:
        quote = self.text[self.pos]
        self.pos += 1
        out = []
        while True:
            if self.pos >= len(self.text):
                self.fail("a quoted string that does not end on its line")
            ch = self.text[self.pos]
            if quote == "'" and ch == "'":
                if self.text[self.pos + 1 : self.pos + 2] == "'":
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == '"':
                self.pos += 1
                return "".join(out)
            if quote == '"' and ch == "\\":
                esc = self.text[self.pos + 1 : self.pos + 2]
                if esc in _ESCAPES:
                    out.append(_ESCAPES[esc])
                    self.pos += 2
                    continue
                lengths = {"x": 2, "u": 4, "U": 8}
                if esc in lengths:
                    digits = self.text[self.pos + 2 : self.pos + 2 + lengths[esc]]
                    out.append(chr(int(digits, 16)))
                    self.pos += 2 + lengths[esc]
                    continue
                self.fail(f"the escape \\{esc}")
            out.append(ch)
            self.pos += 1

    def plain(self, flow: bool) -> str:
        """A plain scalar up to a comment, the end of the line or (`flow`) a
        flow indicator; in block context also up to a `: ` key separator."""
        start = self.pos
        first = self.text[start]
        nxt = self.text[start + 1 : start + 2]
        if first in _INDICATORS or (first in "-?:" and nxt in ("", " ", "\t")):
            self.fail(f"a value that starts with {first!r}")
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "#" and self.text[self.pos - 1] in " \t":
                break
            if ch == ":" and self.text[self.pos + 1 : self.pos + 2] in ("", " ", "\t") + (
                    (",", "]", "}") if flow else ()):
                break
            if flow and ch in ",[]{}":
                break
            self.pos += 1
        return self.text[start:self.pos].rstrip(" \t")

    def scalar(self, flow: bool) -> Any:
        ch = self.text[self.pos]
        if ch in "'\"":
            return self.quoted()
        if ch in _UNSUPPORTED_START:
            self.fail(f"the indicator {ch!r} (anchors, aliases, tags, block scalars and "
                      "complex keys are outside the supported subset)")
        return _plain(self.plain(flow))

    def flow_node(self) -> Any:
        self.skip_spaces()
        if self.pos >= len(self.text):
            self.fail("a flow collection that does not end on its line")
        ch = self.text[self.pos]
        if ch == "[":
            return self.flow_seq()
        if ch == "{":
            return self.flow_map()
        return self.scalar(flow=True)

    def flow_seq(self) -> list:
        self.pos += 1
        out = []
        while True:
            self.skip_spaces()
            if self.text[self.pos : self.pos + 1] == "]":
                self.pos += 1
                return out
            out.append(self.flow_node())
            self.skip_spaces()
            ch = self.text[self.pos : self.pos + 1]
            if ch == ",":
                self.pos += 1
            elif ch != "]":
                self.fail("a flow sequence without ',' or ']'")

    def flow_map(self) -> dict:
        self.pos += 1
        out = {}
        while True:
            self.skip_spaces()
            if self.text[self.pos : self.pos + 1] == "}":
                self.pos += 1
                return out
            key = self.flow_node()
            self.skip_spaces()
            value = None
            if self.text[self.pos : self.pos + 1] == ":":
                self.pos += 1
                self.skip_spaces()
                if self.text[self.pos : self.pos + 1] not in (",", "}"):
                    value = self.flow_node()
            out[key] = value
            self.skip_spaces()
            ch = self.text[self.pos : self.pos + 1]
            if ch == ",":
                self.pos += 1
            elif ch != "}":
                self.fail("a flow mapping without ',' or '}'")

    def value(self) -> Any:
        """The rest of the line as one node: a flow collection or a scalar."""
        ch = self.text[self.pos]
        node = self.flow_node() if ch in "[{" else self.scalar(flow=False)
        if not self.at_end():
            self.fail("text after a value")
        return node


def _lines(text: str, where: str) -> List[Tuple[int, str, int]]:
    """(indent, content, line number) of every line that holds a node."""
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[: len(raw) - len(raw.lstrip(" \t"))]:
            raise ValueError(f"{where}:{number}: a tab in the indentation")
        stripped = raw.strip()
        if not stripped or stripped.startswith("#"):
            continue
        if stripped.startswith(("---", "...", "%")) and (
                len(stripped) == 3 or stripped[3:4] in " \t" or stripped[0] == "%"):
            raise ValueError(f"{where}:{number}: document markers and directives are outside "
                             "the supported subset")
        out.append((len(raw) - len(raw.lstrip(" ")), raw.strip(" "), number))
    return out


class _Block:
    def __init__(self, lines: List[Tuple[int, str, int]], where: str):
        self.lines = lines
        self.i = 0
        self.where = where

    def reader(self, content: str, number: int) -> _Reader:
        return _Reader(content, f"{self.where}:{number}")

    def node(self, indent: int) -> Any:
        """The block node whose lines start at exactly `indent`."""
        _, content, _ = self.lines[self.i]
        if content == "-" or content.startswith(("- ", "-\t")):
            return self.seq(indent)
        return self.map_or_scalar(indent)

    def child(self, parent_indent: int, allow_seq_at_parent: bool) -> Any:
        """The node under a key or a dash: the next lines if they are
        indented further (or, for a key, a list at the key's own indent);
        None if there are none."""
        if self.i >= len(self.lines):
            return None
        indent, content, _ = self.lines[self.i]
        is_seq = content == "-" or content.startswith(("- ", "-\t"))
        if indent > parent_indent or (allow_seq_at_parent and indent == parent_indent and is_seq):
            return self.node(indent)
        return None

    def seq(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, content, number = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{self.where}:{number}: unexpected indentation")
            if not (content == "-" or content.startswith(("- ", "-\t"))):
                break
            rest = content[1:].lstrip(" \t")
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self.child(indent, allow_seq_at_parent=False))
                continue
            # an inline node after the dash: re-read it as a line of its own,
            # indented to where it starts
            self.lines[self.i] = (indent + len(content) - len(rest), rest, number)
            out.append(self.node(indent + len(content) - len(rest)))
        return out

    def map_or_scalar(self, indent: int) -> Any:
        _, content, number = self.lines[self.i]
        r = self.reader(content, number)
        first = r.scalar(flow=False) if content[0] not in "[{" else None
        r.skip_spaces()
        is_key = r.text[r.pos : r.pos + 1] == ":" and content[0] not in "[{"
        if not is_key:
            r.pos = 0
            self.i += 1
            node = r.value()
            if self.i < len(self.lines) and self.lines[self.i][0] > indent:
                raise ValueError(f"{self.where}:{self.lines[self.i][2]}: a multi-line scalar "
                                 "is outside the supported subset")
            return node
        out: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            ind, content, number = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"{self.where}:{number}: unexpected indentation")
            if content.startswith(("- ", "-\t")) or content == "-":
                break
            r = self.reader(content, number)
            if content[0] in "[{":
                r.fail("a flow collection as a key")
            key = r.scalar(flow=False)
            r.skip_spaces()
            if r.text[r.pos : r.pos + 1] != ":":
                r.fail("a mapping entry without ':'")
            r.pos += 1
            if key in out:
                r.fail(f"the key {key!r} twice")
            self.i += 1
            if r.at_end():
                out[key] = self.child(indent, allow_seq_at_parent=True)
            else:
                out[key] = r.value()
                if self.i < len(self.lines) and self.lines[self.i][0] > indent:
                    raise ValueError(f"{self.where}:{self.lines[self.i][2]}: a multi-line "
                                     "scalar is outside the supported subset")
        return out


def parse_yaml(text: str, where: str = "<yaml>") -> Any:
    """One YAML document of the supported subset, typed as `yaml.safe_load`
    types it (None for an empty document)."""
    lines = _lines(text, where)
    if not lines:
        return None
    block = _Block(lines, where)
    node = block.node(lines[0][0])
    if block.i < len(lines):
        raise ValueError(f"{where}:{lines[block.i][2]}: text after the document's root node")
    return node


# -- composition, overrides, interpolation --------------------------------------

def _deep_merge(base: Dict, update: Dict) -> Dict:
    out = dict(base)
    for k, v in update.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str | Path, config_root: str | Path | None = None) -> Dict:
    """Load a YAML config file, composing its `defaults:` list."""
    path = Path(path)
    root = Path(config_root) if config_root else path.parent
    raw = parse_yaml(path.read_text(), str(path)) or {}

    merged: Dict = {}
    for entry in raw.pop("defaults", []) or []:
        if entry == "_self_":
            merged = _deep_merge(merged, raw)
            raw = {}
            continue
        if isinstance(entry, dict):
            ((group, name),) = entry.items()
            if name is None:
                continue
            sub = load_config(root / group / f"{name}.yaml", root)
            merged = _deep_merge(merged, {group: sub})
        else:
            # a bare include: the file merged at the top level (hydra `- vae_base`)
            sub = load_config(path.parent / f"{entry}.yaml", root)
            merged = _deep_merge(merged, sub)
    return _deep_merge(merged, raw)


def merge_overrides(cfg: Dict, overrides: List[str]) -> Dict:
    """Apply `a.b.c=value` overrides (the values typed as YAML)."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, _, val = ov.partition("=")
        node = cfg
        parts = key.strip().split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = parse_yaml(val, f"override {ov!r}")
    return cfg


def _lookup(root: Dict, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        if isinstance(node, dict):
            node = node[part]
        elif isinstance(node, list):
            node = node[int(part)]
        else:
            raise KeyError(dotted)
    return node


def _resolve_value(value: Any, root: Dict, depth: int = 0) -> Any:
    if depth > 20:
        raise RecursionError("interpolation depth exceeded (cycle?)")
    if isinstance(value, str):
        # innermost first; a whole-string match returns the typed value, so
        # `${a.${b}.c}` can resolve to a number or a dict
        while True:
            m = _INTERP.fullmatch(value.strip())
            if m:
                return _resolve_expr(m.group(1), root, depth)
            m = _INTERP.search(value)
            if not m:
                return value
            sub = _resolve_expr(m.group(1), root, depth)
            value = value[: m.start()] + str(sub) + value[m.end():]
    if isinstance(value, dict):
        return {k: _resolve_value(v, root, depth) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve_value(v, root, depth) for v in value]
    return value


def _resolve_expr(expr: str, root: Dict, depth: int) -> Any:
    if expr.startswith("eval:"):
        body = expr[len("eval:"):].strip().strip("'\"")
        body = _resolve_value(body, root, depth + 1)
        return eval(body, {"__builtins__": {}}, {})  # arithmetic only
    if expr == "repo_root:":
        # the checkout that ships configs/ and metadata/, wherever the CLI runs
        return str(Path(__file__).resolve().parents[2])
    target = _lookup(root, expr)
    return _resolve_value(target, root, depth + 1)


def resolve(cfg: Dict) -> Dict:
    """Resolve every interpolation in the tree (raises on unresolvable keys)."""
    return _resolve_value(copy.deepcopy(cfg), cfg)
