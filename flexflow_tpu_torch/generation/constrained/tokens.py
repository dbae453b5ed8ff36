"""Token-level grammar machinery: the DFA the scheduler actually drives
(the port's copy of ``flexflow_tpu/generation/constrained/tokens.py``).

`TokenDFA` lifts a character-level automaton (automaton.py) onto the
tokenizer vocabulary once per grammar: for every char-DFA state and
every vocabulary token, walk the token's characters; if the whole walk
survives, the token is a single edge. Liveness pruning then removes
every edge into a state that cannot reach acceptance — so a masked
sampler can never paint itself into a dead end; `dead()` below is
defensive, reachable only under injected faults.

`MaskState` is the per-request cursor. The scheduler advances it during
host bookkeeping (a constrained slot steps sequentially, outside the
overlap pipeline: its next row needs the token just sampled), and reads
`mask_row()` — a cached `(vocab,)` float32 row of 0 / NEG — into the
engine's persistent mask buffers, which every captured step graph adds
to its logits (``engine.py``). NEG is a large finite
negative, not -inf: softmax still zeroes banned tokens, argmax still
ignores them, but the engine's isfinite ok-gate (NaN blame) keeps
working.

EOS is not a grammar character: it is allowed exactly at accepting
states and consuming it marks the stream done. Crash-replay rebuilds a
`MaskState` by re-advancing over the journaled emitted tokens
(`TokenDFA.state_after`), which is why `advance` is deliberately
deterministic and why every real advance passes through the
`generation.mask_advance` fault site.
"""
from __future__ import annotations

import itertools
import json
import threading
import time
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np

from ...runtime import faults
from .automaton import CharDFA, compile_regex
from .errors import GrammarError, MaskAdvanceError, MaskDeadEndError
from .schema import schema_to_regex

# finite so masked logits survive the engine's isfinite ok-gate; far
# below any real logit so softmax mass and argmax never land on it
NEG = -1.0e30

# single-character tokens first (ids are stable and dense), then the
# JSON keywords/punctuation runs real tokenizers merge, then filler
# pairs — a deterministic stand-in vocabulary for a repo whose prompts
# are raw token-id lists with no tokenizer
_SINGLES = '{}[]":,-. 0123456789abcdefghijklmnopqrstuvwxyz_'
_MULTIS = ("true", "false", "null", '": ', '", "', '":')


def default_vocabulary(vocab_size: int) -> Tuple[str, ...]:
    """Deterministic token-id -> string table of exactly ``vocab_size``
    entries (the engine's logits index straight into it).

    As in the JAX package, the table runs out at 1422 entries (47 single
    characters, 6 multi-character tokens, 37 x 37 filler pairs): a wider
    vocabulary gets a short table, and a grammar compiled on it fails the
    scheduler's vocabulary check. A caller at a wider vocabulary passes
    its own table."""
    toks: List[str] = list(_SINGLES) + list(_MULTIS)
    if len(toks) < vocab_size:
        filler = ("".join(p) for p in itertools.product(_SINGLES[10:], repeat=2))
        toks.extend(itertools.islice(filler, vocab_size - len(toks)))
    return tuple(toks[:vocab_size])


def decode_text(vocab: Sequence[str], ids: Sequence[int], eos_id: int) -> str:
    """Join a token-id stream back to text, skipping EOS."""
    return "".join(vocab[int(i)] for i in ids if int(i) != eos_id)


class TokenDFA:
    """A grammar compiled against one vocabulary. Immutable and shared:
    every request under the same grammar holds the same instance."""

    __slots__ = (
        "char_dfa",
        "vocab_size",
        "spec",
        "schema",
        "_step",
        "_allowed",
        "_accepting",
        "_mask_rows",
        "_rows_lock",
    )

    def __init__(self, char_dfa: CharDFA, vocabulary: Sequence[str],
                 spec: Optional[dict] = None, schema: Optional[dict] = None):
        self.char_dfa = char_dfa
        self.vocab_size = len(vocabulary)
        self.spec = spec
        self.schema = schema
        # raw token edges: for each char-state, token id -> target state
        raw: List[Dict[int, int]] = [{} for _ in range(char_dfa.n_states)]
        for tok_id, text in enumerate(vocabulary):
            if not text:
                continue
            for s in range(char_dfa.n_states):
                t: Optional[int] = s
                for c in text:
                    t = char_dfa.step(t, c)
                    if t is None:
                        break
                if t is not None:
                    raw[s][tok_id] = t
        # liveness: states that can reach acceptance over TOKEN edges
        # (char-level reachability is not enough — a state whose only
        # continuations cross token boundaries no vocabulary token
        # spans is a trap). Backward closure from accepting states.
        reverse: List[List[int]] = [[] for _ in range(char_dfa.n_states)]
        for s, edges in enumerate(raw):
            for t in edges.values():
                reverse[t].append(s)
        live = set(char_dfa.accepting)
        work = list(live)
        while work:
            s = work.pop()
            for p in reverse[s]:
                if p not in live:
                    live.add(p)
                    work.append(p)
        if char_dfa.start not in live:
            raise GrammarError(
                f"grammar {char_dfa.pattern!r} matches nothing this "
                f"vocabulary can emit"
            )
        # pruned edges: only transitions into live states survive, so a
        # masked sampler can never enter a dead end
        self._step: Tuple[Dict[int, int], ...] = tuple(
            {tok: tgt for tok, tgt in edges.items() if tgt in live}
            for edges in raw
        )
        self._allowed: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(sorted(edges)) for edges in self._step
        )
        self._accepting = frozenset(char_dfa.accepting)
        self._mask_rows: Dict[Tuple[int, int], np.ndarray] = {}
        self._rows_lock = threading.Lock()

    # ------------------------------------------------------------ queries
    @property
    def start(self) -> int:
        return self.char_dfa.start

    def step(self, state: int, token: int) -> Optional[int]:
        """Pruned transition: None means the token is banned here."""
        return self._step[state].get(int(token))

    def allowed(self, state: int) -> Tuple[int, ...]:
        return self._allowed[state]

    def accepting(self, state: int) -> bool:
        return state in self._accepting

    def exhausted(self, state: int) -> bool:
        """Accepting with no live continuation: only EOS remains."""
        return state in self._accepting and not self._allowed[state]

    def dead(self, state: int) -> bool:
        """No continuation and not accepting. Pruning makes this
        unreachable by sampling; kept as the defensive backstop."""
        return state not in self._accepting and not self._allowed[state]

    def mask_row(self, state: int, eos_id: Optional[int]) -> np.ndarray:
        """Cached additive-bias row: 0 for allowed tokens, NEG
        elsewhere; EOS (when the request has one) allowed exactly at
        accepting states."""
        key = (state, eos_id)
        row = self._mask_rows.get(key)
        if row is None:
            with self._rows_lock:
                row = self._mask_rows.get(key)
                if row is None:
                    row = np.full((self.vocab_size,), NEG, dtype=np.float32)
                    allowed = self._allowed[state]
                    if allowed:
                        row[np.asarray(allowed, dtype=np.int64)] = 0.0
                    if eos_id is not None:
                        row[eos_id] = 0.0 if state in self._accepting else NEG
                    row.setflags(write=False)
                    self._mask_rows[key] = row
        return row

    def state_after(self, tokens: Sequence[int], eos_id: Optional[int]) -> "MaskState":
        """Replay: rebuild the cursor by re-advancing over already
        emitted tokens (journal recovery, preempt-recompute, adopt)."""
        ms = MaskState(self)
        for t in tokens:
            ms.advance(int(t), eos_id)
        return ms


class MaskState:
    """Per-request automaton cursor, advanced during host bookkeeping."""

    __slots__ = ("dfa", "state", "done", "n_advanced")

    def __init__(self, dfa: TokenDFA):
        self.dfa = dfa
        self.state = dfa.start
        self.done = False
        self.n_advanced = 0

    def advance(self, token: int, eos_id: Optional[int]) -> None:
        """Consume one emitted token. Raises :class:`MaskAdvanceError`
        if the automaton refuses it (replay divergence or an injected
        ``generation.mask_advance`` fault) and :class:`MaskDeadEndError`
        from the landing state's emptiness check."""
        faults.inject(faults.GENERATION_MASK_ADVANCE, (self.state, int(token)))
        if self.done:
            raise MaskAdvanceError(
                f"token {token} after grammar completed (state {self.state})"
            )
        if eos_id is not None and int(token) == eos_id:
            if not self.dfa.accepting(self.state):
                raise MaskAdvanceError(
                    f"EOS at non-accepting grammar state {self.state}"
                )
            self.done = True
            self.n_advanced += 1
            return
        nxt = self.dfa.step(self.state, token)
        if nxt is None:
            raise MaskAdvanceError(
                f"grammar state {self.state} does not allow token {token}"
            )
        self.state = nxt
        self.n_advanced += 1
        if self.dfa.dead(self.state):
            raise MaskDeadEndError(
                f"grammar state {self.state} has an empty mask"
            )

    def mask_row(self, eos_id: Optional[int]) -> np.ndarray:
        return self.dfa.mask_row(self.state, eos_id)

    def exhausted(self) -> bool:
        return self.done or self.dfa.exhausted(self.state)

    def dead_end(self) -> bool:
        return (not self.done) and self.dfa.dead(self.state)

    def filter_draft(self, draft: Sequence[int], eos_id: Optional[int]) -> List[int]:
        """Longest draft prefix the grammar can accept, WITHOUT
        advancing this cursor and without touching the fault site (only
        real emissions count toward injected-fault triggers). The
        verify window is masked identically for draft and target, so a
        grammar-banned draft token would be rejected anyway — trimming
        it here just avoids wasting verify slots."""
        out: List[int] = []
        s = self.state
        if self.done:
            return out
        for t in draft:
            t = int(t)
            if eos_id is not None and t == eos_id:
                if self.dfa.accepting(s):
                    out.append(t)
                break
            nxt = self.dfa.step(s, t)
            if nxt is None:
                break
            out.append(t)
            s = nxt
        return out

    def states_along(self, tokens: Sequence[int], eos_id: Optional[int]) -> List[int]:
        """Grammar states after each token of an (already filtered)
        prefix walk — used to build per-position verify mask rows.
        Non-mutating; a token the grammar refuses stops the walk."""
        states: List[int] = []
        s = self.state
        for t in tokens:
            t = int(t)
            if (eos_id is not None and t == eos_id) or self.dfa.step(s, t) is None:
                break
            s = self.dfa.step(s, t)
            states.append(s)
        return states


# ------------------------------------------------------------- front end
def grammar_alphabet(vocabulary: Sequence[str]) -> FrozenSet[str]:
    """Every character any vocabulary token can emit."""
    return frozenset(c for text in vocabulary for c in text)


def compile_response_format(spec: dict, vocabulary: Sequence[str]) -> TokenDFA:
    """``response_format`` wire spec -> compiled grammar.

    Accepted shapes (anything else is a :class:`GrammarError`, which
    the HTTP layer maps to a 400):

      {"type": "json_schema", "json_schema": {...}}
      {"type": "regex", "pattern": "..."}
    """
    if not isinstance(spec, dict):
        raise GrammarError(
            f"response_format must be an object, got {type(spec).__name__}"
        )
    kind = spec.get("type")
    schema: Optional[dict] = None
    if kind == "json_schema":
        schema = spec.get("json_schema")
        if not isinstance(schema, dict):
            raise GrammarError("response_format.json_schema must be an object")
        pattern = schema_to_regex(schema)
    elif kind == "regex":
        pattern = spec.get("pattern")
        if not isinstance(pattern, str) or not pattern:
            raise GrammarError("response_format.pattern must be a non-empty string")
    else:
        raise GrammarError(
            f"response_format.type must be 'json_schema' or 'regex', "
            f"got {kind!r}"
        )
    char_dfa = compile_regex(pattern, grammar_alphabet(vocabulary))
    return TokenDFA(char_dfa, vocabulary, spec=spec, schema=schema)


def _cache_key(spec: dict) -> str:
    try:
        return json.dumps(spec, sort_keys=True, separators=(",", ":"))
    except (TypeError, ValueError) as e:
        raise GrammarError(f"response_format is not JSON-serializable: {e}") from None


class GrammarCache:
    """Per-model compile-once cache keyed by the canonical spec JSON.

    ``stats`` is duck-typed (anything with ``incr(field, n)``); the
    serving layer passes the scheduler's ConstrainedStats so cache
    hits/misses and compile seconds surface on /metrics."""

    def __init__(self, vocabulary: Sequence[str], stats=None):
        self.vocabulary = tuple(vocabulary)
        self.stats = stats
        self._lock = threading.Lock()
        self._grammars: Dict[str, TokenDFA] = {}

    def __len__(self) -> int:
        return len(self._grammars)

    def get(self, spec: dict) -> TokenDFA:
        key = _cache_key(spec)
        with self._lock:
            hit = self._grammars.get(key)
        if hit is not None:
            if self.stats is not None:
                self.stats.incr("grammar_cache_hits")
            return hit
        # compile outside the lock: grammar compilation is the slow
        # path and must not stall concurrent submits on other grammars
        faults.inject(faults.GENERATION_MASK_BUILD, key)
        t0 = time.perf_counter()
        grammar = compile_response_format(spec, self.vocabulary)
        dt = time.perf_counter() - t0
        if self.stats is not None:
            self.stats.incr("grammar_cache_misses")
            self.stats.incr("grammar_compile_seconds", dt)
        with self._lock:
            return self._grammars.setdefault(key, grammar)
