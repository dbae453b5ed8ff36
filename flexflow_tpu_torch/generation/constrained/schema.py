"""JSON-Schema -> regex, plus the matching (dependency-free) validator
(the port's copy of ``flexflow_tpu/generation/constrained/schema.py``).

The structured-output subset that tool-calling workloads actually use,
compiled to the regex dialect in automaton.py:

  {"type": "object", "properties": {...}, "required": [...]}
  {"type": "string", "maxLength": n, "pattern"?: safe literal class}
  {"type": "integer"} / {"type": "number"}
  {"type": "boolean"} / {"type": "null"}
  {"type": "array", "items": ..., "minItems": m, "maxItems": n}
  {"enum": [...]} / {"const": ...}

Canonical emission: objects serialize EVERY declared property in
declaration order with no whitespace — the standard trick (Outlines,
XGrammar) that turns JSON generation into a regular language. Every
quantifier is bounded (string/array caps below), so a well-budgeted
request always reaches the grammar's accepting state before max_new
truncates it mid-object.

``validate_json`` implements the same subset semantics the compiler
emits, so genbench/chaoscheck can assert "every constrained stream
parses AND validates" without a jsonschema dependency.
"""
from __future__ import annotations

import json
from typing import Dict, List

from .errors import GrammarError

# bounded-by-construction caps: a grammar with an unbounded quantifier
# could stream past any token budget and end truncated (= invalid JSON)
DEFAULT_MAX_STRING = 16
DEFAULT_MAX_ITEMS = 4
MAX_INT_DIGITS = 9

# characters a generated string value may contain: no quote, no
# backslash, no control chars — keeps the value regex escape-free
STRING_CHARS = "a-z0-9_ \\-"

_REGEX_SPECIALS = set("\\.[](){}|*+?")


def _esc(text: str) -> str:
    """Escape a literal for the automaton.py regex dialect."""
    return "".join(("\\" + c) if c in _REGEX_SPECIALS else c for c in text)


def schema_to_regex(schema: Dict) -> str:
    """Compile a JSON-Schema subset to a full-match regex. Raises
    :class:`GrammarError` on anything outside the subset."""
    if not isinstance(schema, dict):
        raise GrammarError(f"schema must be an object, got {type(schema).__name__}")
    if "enum" in schema:
        opts = schema["enum"]
        if not isinstance(opts, list) or not opts:
            raise GrammarError("enum must be a non-empty list")
        return "(" + "|".join(_esc(json.dumps(v, separators=(",", ":"))) for v in opts) + ")"
    if "const" in schema:
        return _esc(json.dumps(schema["const"], separators=(",", ":")))
    t = schema.get("type")
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict) or not props:
            raise GrammarError("object schema needs non-empty 'properties'")
        parts = []
        for name, sub in props.items():
            parts.append(_esc(json.dumps(str(name))) + ":" + schema_to_regex(sub))
        return "\\{" + ",".join(parts) + "\\}"
    if t == "string":
        hi = int(schema.get("maxLength", DEFAULT_MAX_STRING))
        lo = int(schema.get("minLength", 0))
        if lo < 0 or hi < lo:
            raise GrammarError(f"bad string bounds [{lo}, {hi}]")
        return f'"[{STRING_CHARS}]{{{lo},{hi}}}"'
    if t == "integer":
        return f"(-?(0|[1-9][0-9]{{0,{MAX_INT_DIGITS - 1}}}))"
    if t == "number":
        return f"(-?(0|[1-9][0-9]{{0,{MAX_INT_DIGITS - 1}}})(\\.[0-9]{{1,6}})?)"
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "array":
        item = schema_to_regex(schema.get("items", {"type": "integer"}))
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", DEFAULT_MAX_ITEMS))
        if lo < 0 or hi < lo:
            raise GrammarError(f"bad array bounds [{lo}, {hi}]")
        if hi == 0:
            return "\\[\\]"
        body = f"{item}(,{item}){{{max(0, lo - 1)},{hi - 1}}}"
        if lo == 0:
            return f"\\[({body})?\\]"
        return f"\\[{body}\\]"
    raise GrammarError(f"unsupported schema: {json.dumps(schema)[:120]}")


# ------------------------------------------------------------- validation
def validate_json(text: str, schema: Dict) -> List[str]:
    """Validate ``text`` against the schema subset. Returns a list of
    problems — empty means valid (parses as JSON and conforms)."""
    try:
        doc = json.loads(text)
    except Exception as e:
        return [f"not valid JSON: {e}"]
    return _check(doc, schema, "$")


def _check(doc, schema: Dict, path: str) -> List[str]:
    if "enum" in schema:
        return [] if doc in schema["enum"] else [f"{path}: {doc!r} not in enum"]
    if "const" in schema:
        return [] if doc == schema["const"] else [f"{path}: {doc!r} != const"]
    t = schema.get("type")
    if t == "object":
        if not isinstance(doc, dict):
            return [f"{path}: expected object"]
        probs = []
        props = schema.get("properties", {})
        for name in schema.get("required", list(props)):
            if name not in doc:
                probs.append(f"{path}.{name}: missing required property")
        for name, val in doc.items():
            if name not in props:
                probs.append(f"{path}.{name}: unexpected property")
            else:
                probs.extend(_check(val, props[name], f"{path}.{name}"))
        return probs
    if t == "string":
        if not isinstance(doc, str):
            return [f"{path}: expected string"]
        hi = int(schema.get("maxLength", DEFAULT_MAX_STRING))
        if len(doc) > hi or len(doc) < int(schema.get("minLength", 0)):
            return [f"{path}: string length {len(doc)} out of bounds"]
        return []
    if t == "integer":
        return [] if isinstance(doc, int) and not isinstance(doc, bool) else [
            f"{path}: expected integer"
        ]
    if t == "number":
        ok = isinstance(doc, (int, float)) and not isinstance(doc, bool)
        return [] if ok else [f"{path}: expected number"]
    if t == "boolean":
        return [] if isinstance(doc, bool) else [f"{path}: expected boolean"]
    if t == "null":
        return [] if doc is None else [f"{path}: expected null"]
    if t == "array":
        if not isinstance(doc, list):
            return [f"{path}: expected array"]
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", DEFAULT_MAX_ITEMS))
        probs = []
        if not (lo <= len(doc) <= hi):
            probs.append(f"{path}: {len(doc)} items out of [{lo}, {hi}]")
        item = schema.get("items", {"type": "integer"})
        for i, v in enumerate(doc):
            probs.extend(_check(v, item, f"{path}[{i}]"))
        return probs
    return [f"{path}: unsupported schema"]
