"""Shared exponential-backoff-with-jitter delay computation (the port's
copy of ``flexflow_tpu/runtime/backoff.py``).

One formula, two consumers: the serving RetryPolicy
(``serving/resilience.py``) and the generation supervisor's restarts
(``generation/recovery.py``), so a tuning change can never silently
diverge between them.
"""
from __future__ import annotations

import random


def backoff_delay(
    attempt: int,
    *,
    base_s: float,
    max_s: float,
    jitter: float,
    rng: random.Random,
) -> float:
    """Delay before retry number ``attempt`` (1-based): exponential
    ``base_s * 2**(attempt-1)`` capped at ``max_s``, stretched by up to
    ``jitter`` fractional seeded noise."""
    delay = min(max_s, base_s * (2 ** (attempt - 1)))
    return delay * (1.0 + jitter * rng.random())
