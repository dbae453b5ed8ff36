"""Regex -> character-level DFA, the grammar front-end's middle layer
(the port's copy of ``flexflow_tpu/generation/constrained/automaton.py``).

A deliberately small regex dialect — exactly what the JSON-Schema
compiler (schema.py) emits plus what structured-output patterns need:

  literals        a b c (any non-special char)
  escapes         \\. \\{ \\} \\[ \\] \\( \\) \\| \\* \\+ \\? \\\\ \\d \\w \\s
  classes         [a-z0-9_], [^abc] (ranges, negation)
  any             .  (every alphabet char except newline)
  grouping        ( ... )
  alternation     a|b
  repetition      * + ? {m} {m,} {m,n}

Matching is FULL-match (implicitly anchored both ends) — a constrained
stream is done when the automaton says the whole emission matches.

The pipeline is the textbook one: recursive-descent parse to an AST,
Thompson construction to an epsilon-NFA, subset construction to a DFA.
Negated classes and ``.`` need a closed alphabet; the caller passes the
set of characters its tokenizer vocabulary can ever produce (plus the
pattern's own literals), so the DFA is exact over everything the engine
can emit and silently rejects characters no token contains.

Pure host-side compile-time code: nothing here runs on the decode hot
path (the token-level DFA built on top caches per-state masks).
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from .errors import GrammarError

# repetition bound guard: {m,n} expands structurally, and an absurd
# bound would compile forever before the first mask is ever built
MAX_REPEAT = 256

_SPECIALS = set("\\.[](){}|*+?")
_ESCAPE_CLASSES = {
    "d": frozenset("0123456789"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
    ),
    "s": frozenset(" \t\n\r"),
}


# ------------------------------------------------------------------ parse
class _Parser:
    """Pattern string -> AST of ('lit', charset) / ('cat'|'alt', a, b) /
    ('star'|'plus'|'opt', a) / ('rep', a, lo, hi) / ('eps',) nodes."""

    def __init__(self, pattern: str, alphabet: FrozenSet[str]):
        self.p = pattern
        self.i = 0
        self.alphabet = alphabet

    def parse(self):
        node = self._alt()
        if self.i != len(self.p):
            raise GrammarError(
                f"regex parse error at position {self.i}: {self.p[self.i:]!r}"
            )
        return node

    def _alt(self):
        node = self._cat()
        while self._peek() == "|":
            self.i += 1
            node = ("alt", node, self._cat())
        return node

    def _cat(self):
        parts = []
        while self._peek() not in ("", "|", ")"):
            parts.append(self._repeat())
        if not parts:
            return ("eps",)
        node = parts[0]
        for part in parts[1:]:
            node = ("cat", node, part)
        return node

    def _repeat(self):
        node = self._atom()
        while True:
            c = self._peek()
            if c == "*":
                self.i += 1
                node = ("star", node)
            elif c == "+":
                self.i += 1
                node = ("plus", node)
            elif c == "?":
                self.i += 1
                node = ("opt", node)
            elif c == "{":
                node = ("rep", node, *self._bounds())
            else:
                return node

    def _bounds(self) -> Tuple[int, Optional[int]]:
        j = self.p.find("}", self.i)
        if j < 0:
            raise GrammarError(f"unterminated {{}} bound at {self.i}")
        body = self.p[self.i + 1 : j]
        self.i = j + 1
        try:
            if "," not in body:
                lo = hi = int(body)
            else:
                lo_s, hi_s = body.split(",", 1)
                lo = int(lo_s)
                hi = None if hi_s == "" else int(hi_s)
        except ValueError:
            raise GrammarError(f"bad repetition bound {{{body}}}") from None
        if lo < 0 or (hi is not None and hi < lo) or (hi or lo) > MAX_REPEAT:
            raise GrammarError(f"repetition bound {{{body}}} out of range")
        return lo, hi

    def _atom(self):
        c = self._peek()
        if c == "":
            raise GrammarError("unexpected end of pattern")
        if c == "(":
            self.i += 1
            node = self._alt()
            if self._peek() != ")":
                raise GrammarError(f"unbalanced '(' at {self.i}")
            self.i += 1
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            self.i += 1
            return ("lit", frozenset(self.alphabet - {"\n"}))
        if c == "\\":
            return ("lit", self._escape())
        if c in _SPECIALS:
            raise GrammarError(f"unexpected {c!r} at position {self.i}")
        self.i += 1
        return ("lit", frozenset((c,)))

    def _escape(self) -> FrozenSet[str]:
        self.i += 1
        if self.i >= len(self.p):
            raise GrammarError("dangling escape at end of pattern")
        c = self.p[self.i]
        self.i += 1
        if c in _ESCAPE_CLASSES:
            return frozenset(_ESCAPE_CLASSES[c] & self.alphabet) or frozenset(
                _ESCAPE_CLASSES[c]
            )
        return frozenset((c,))

    def _char_class(self) -> FrozenSet[str]:
        self.i += 1  # past '['
        negate = self._peek() == "^"
        if negate:
            self.i += 1
        chars: Set[str] = set()
        first = True
        while True:
            c = self._peek()
            if c == "":
                raise GrammarError("unterminated character class")
            if c == "]" and not first:
                self.i += 1
                break
            first = False
            if c == "\\":
                chars |= self._escape()
                continue
            self.i += 1
            if self._peek() == "-" and self.i + 1 < len(self.p) and self.p[self.i + 1] != "]":
                hi = self.p[self.i + 1]
                self.i += 2
                if ord(hi) < ord(c):
                    raise GrammarError(f"bad class range {c}-{hi}")
                chars |= {chr(o) for o in range(ord(c), ord(hi) + 1)}
            else:
                chars.add(c)
        if negate:
            return frozenset(self.alphabet - chars)
        return frozenset(chars)

    def _peek(self) -> str:
        return self.p[self.i] if self.i < len(self.p) else ""


# ---------------------------------------------------------- NFA (Thompson)
class _NFA:
    """Epsilon-NFA fragments: state -> [(charset, target)], eps edges."""

    def __init__(self):
        self.edges: List[List[Tuple[FrozenSet[str], int]]] = []
        self.eps: List[Set[int]] = []

    def state(self) -> int:
        self.edges.append([])
        self.eps.append(set())
        return len(self.edges) - 1

    def build(self, node) -> Tuple[int, int]:
        """Return (entry, exit) of the fragment for ``node``."""
        kind = node[0]
        if kind == "eps":
            s = self.state()
            return s, s
        if kind == "lit":
            a, b = self.state(), self.state()
            self.edges[a].append((node[1], b))
            return a, b
        if kind == "cat":
            a0, a1 = self.build(node[1])
            b0, b1 = self.build(node[2])
            self.eps[a1].add(b0)
            return a0, b1
        if kind == "alt":
            a0, a1 = self.build(node[1])
            b0, b1 = self.build(node[2])
            s, t = self.state(), self.state()
            self.eps[s] |= {a0, b0}
            self.eps[a1].add(t)
            self.eps[b1].add(t)
            return s, t
        if kind == "star":
            a0, a1 = self.build(node[1])
            s = self.state()
            self.eps[s].add(a0)
            self.eps[a1].add(s)
            return s, s
        if kind == "plus":
            return self.build(("cat", node[1], ("star", node[1])))
        if kind == "opt":
            return self.build(("alt", node[1], ("eps",)))
        if kind == "rep":
            _, inner, lo, hi = node
            parts = [inner] * lo
            if hi is None:
                parts.append(("star", inner))
            else:
                parts.extend([("opt", inner)] * (hi - lo))
            if not parts:
                return self.build(("eps",))
            tree = parts[0]
            for p in parts[1:]:
                tree = ("cat", tree, p)
            return self.build(tree)
        raise GrammarError(f"unknown AST node {kind!r}")  # pragma: no cover

    def closure(self, states: Set[int]) -> FrozenSet[int]:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in self.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)


# ------------------------------------------------------------------ DFA
class CharDFA:
    """Deterministic character automaton: ``transitions[state][char]``
    -> next state, full-match accepted at ``accepting`` states."""

    __slots__ = ("transitions", "accepting", "start", "pattern")

    def __init__(self, transitions: List[Dict[str, int]], accepting: Set[int],
                 start: int, pattern: str):
        self.transitions = transitions
        self.accepting = accepting
        self.start = start
        self.pattern = pattern

    @property
    def n_states(self) -> int:
        return len(self.transitions)

    def step(self, state: int, char: str) -> Optional[int]:
        return self.transitions[state].get(char)

    def matches(self, text: str) -> bool:
        s: Optional[int] = self.start
        for c in text:
            s = self.transitions[s].get(c)
            if s is None:
                return False
        return s in self.accepting


def compile_regex(pattern: str, alphabet: FrozenSet[str]) -> CharDFA:
    """Compile ``pattern`` to a :class:`CharDFA` over ``alphabet`` (the
    closed character set — negated classes and ``.`` complement against
    it). Raises :class:`GrammarError` on any malformed pattern."""
    # the pattern's own literal chars always belong to the universe,
    # even when no vocabulary token contains them (they then simply
    # have no token-level transition)
    universe = frozenset(alphabet) | frozenset(
        c for c in pattern if c not in _SPECIALS
    )
    ast = _Parser(pattern, universe).parse()
    nfa = _NFA()
    entry, exit_ = nfa.build(ast)
    start = nfa.closure({entry})
    ids: Dict[FrozenSet[int], int] = {start: 0}
    transitions: List[Dict[str, int]] = [{}]
    accepting: Set[int] = set()
    work = [start]
    while work:
        cur = work.pop()
        cid = ids[cur]
        if exit_ in cur:
            accepting.add(cid)
        # chars with any outgoing edge from this state set
        moves: Dict[str, Set[int]] = {}
        for s in cur:
            for charset, t in nfa.edges[s]:
                for c in charset:
                    moves.setdefault(c, set()).add(t)
        for c, targets in moves.items():
            nxt = nfa.closure(targets)
            nid = ids.get(nxt)
            if nid is None:
                nid = len(transitions)
                ids[nxt] = nid
                transitions.append({})
                work.append(nxt)
            transitions[cid][c] = nid
    return CharDFA(transitions, accepting, 0, pattern)
