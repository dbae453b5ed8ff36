"""Typed errors for grammar-constrained decoding (the port's copy of
``flexflow_tpu/generation/constrained/errors.py``).

Two failure classes, with deliberately different blast radii:

- :class:`GrammarError` — the grammar itself is unusable (malformed
  regex, unsupported JSON-Schema construct, a pattern the tokenizer
  vocabulary cannot express). Raised at submit time, BEFORE the request
  ever touches the scheduler (an HTTP front end maps it to a 400 like
  any other bad request field).

- :class:`MaskAdvanceError` / :class:`MaskDeadEndError` — a live
  constrained stream can no longer continue (the automaton refused an
  emitted token on replay, or reached a non-accepting state with an
  empty mask). The scheduler wraps these in its standard
  PoisonedRequestError quarantine: the ONE request fails typed, the
  rest of the batch keeps streaming.
"""
from __future__ import annotations


class GrammarError(ValueError):
    """The grammar cannot be compiled against this vocabulary."""


class MaskAdvanceError(RuntimeError):
    """The token automaton could not advance over an emitted token.

    Unreachable when masks are applied (the sampler only sees allowed
    tokens) — this surfaces replay divergence or an injected
    ``generation.mask_advance`` fault."""


class MaskDeadEndError(RuntimeError):
    """A constrained stream reached a state with an empty mask.

    Compile-time liveness pruning removes every transition into a
    dead state, so this is defensive: it fires only under injected
    faults or a grammar/vocabulary mismatch."""
