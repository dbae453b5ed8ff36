"""Serving counters (port of part of ``flexflow_tpu/serving/stats.py``).

Only :class:`ConstrainedStats` is ported so far. Its
``register_gauges`` (the ``/v2/stats`` gauges and the
``flexflow_serving_constrained_*`` Prometheus families) waits for
``ServingStats``, which comes with the HTTP front end.
"""
from __future__ import annotations

import threading


class ConstrainedStats:
    """Constrained-decoding counters for one generation engine
    (``generation/constrained/``):

      grammar_cache_hits      response_format specs served from the
                              per-model compiled-grammar cache
      grammar_cache_misses    specs that compiled a new token DFA
      grammar_compile_seconds cumulative wall seconds spent compiling
                              grammars (floats accumulate)
      masked_steps            slot-steps that carried a real (non-zero)
                              grammar mask row into prefill, decode or
                              verify
      dead_end_failures       constrained streams quarantined because
                              the automaton refused an emitted token or
                              reached an empty mask (injected faults or
                              replay divergence — pruning makes natural
                              dead-ends unreachable)

    Writers: the scheduler loop thread (mask assembly/advance) and submit
    threads (the grammar cache); the lock keeps counts exact.
    """

    FIELDS = (
        "grammar_cache_hits", "grammar_cache_misses",
        "grammar_compile_seconds", "masked_steps", "dead_end_failures",
    )

    def __init__(self):
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def incr(self, field: str, n=1) -> None:
        if field not in self.FIELDS:
            raise ValueError(f"unknown constrained counter {field!r}")
        with self._lock:
            setattr(self, field, getattr(self, field) + n)
