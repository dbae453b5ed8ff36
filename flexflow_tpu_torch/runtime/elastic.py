"""Elastic training: periodic checkpoints and automatic resume and retry
(port of ``flexflow_tpu/runtime/elastic.py``).

The reference has no failure detection or elastic recovery (SURVEY.md
§5). A training loop over the rolling :class:`CheckpointManager`
(``runtime/checkpoint.py``) that

  * checkpoints every ``checkpoint_every`` steps (each step into its own
    ``step_N`` directory; a failed save deletes its partial directory, so
    it never clobbers the previous good checkpoint);
  * on a step failure (a lost device, a transport error, a poisoned
    input) restores the newest restorable checkpoint and retries, up to
    ``max_restarts`` times, after an exponential backoff with seeded
    jitter;
  * treats a non-finite loss as a failure too, rolling back to the last
    good state instead of training on from NaNs.

Each step passes through the ``elastic.step`` fault site
(``runtime/faults.py``), so the recovery paths are testable without a
real device loss. Step ``i`` trains with the key ``fold_in(rng, i)``, so
a replayed step draws the same randomness. A checkpoint holds the
weights, the state, the optimizer state and the model's strategy
(``strategy.json``), as the JAX package's.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Callable, Dict, List, Optional

import torch

from . import faults
from .backoff import backoff_delay
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class ElasticReport:
    """What happened during an elastic run."""

    steps_completed: int = 0
    restarts: int = 0
    checkpoints_saved: int = 0
    failures: List[str] = dataclasses.field(default_factory=list)
    backoffs: List[float] = dataclasses.field(default_factory=list)  # seconds slept per failure
    final_loss: float = float("nan")


class ElasticTrainer:
    """Failure-tolerant training loop around a compiled FFModel.

    ``model`` must be compiled; ``path`` is the checkpoint directory
    (rolling ``step_N`` subdirectories, the ``max_to_keep`` newest kept).
    ``fail_on_nonfinite`` turns NaN/Inf losses into recoverable failures
    (restore and retry). ``sleep`` is injectable so tests observe the
    backoffs without waiting.
    """

    def __init__(
        self,
        model,
        path: str,
        checkpoint_every: int = 50,
        max_restarts: int = 3,
        fail_on_nonfinite: bool = True,
        max_to_keep: int = 2,
        backoff_base_s: float = 0.1,
        backoff_max_s: float = 5.0,
        backoff_jitter: float = 0.25,
        seed: int = 0,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if model.executor is None:
            raise ValueError("compile() the model before elastic training")
        self.model = model
        self.path = path
        self.checkpoint_every = max(1, checkpoint_every)
        self.max_restarts = max_restarts
        self.fail_on_nonfinite = fail_on_nonfinite
        self.manager = CheckpointManager(path, max_to_keep=max_to_keep)
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.backoff_jitter = backoff_jitter
        self._rng = random.Random(f"elastic|{seed}")
        self._sleep = sleep
        self._consecutive_failures = 0

    # ----------------------------------------------------------- plumbing
    def _save(self, step: int) -> None:
        self.manager.save(self.model.executor, step, strategy=self.model.strategy)

    def _restore(self) -> Optional[int]:
        """Latest restorable step, or None when nothing is saved yet."""
        return self.manager.restore_latest(self.model.executor)

    def _backoff(self, report: ElasticReport) -> None:
        """Exponential backoff with jitter between restarts; resets after
        any successful step. Recorded per failure in the report."""
        self._consecutive_failures += 1
        delay = backoff_delay(
            self._consecutive_failures,
            base_s=self.backoff_base_s,
            max_s=self.backoff_max_s,
            jitter=self.backoff_jitter,
            rng=self._rng,
        )
        report.backoffs.append(delay)
        self._sleep(delay)

    # ---------------------------------------------------------------- run
    def run(
        self,
        batches: Callable[[int], tuple],
        num_steps: int,
        rng=None,
        on_step: Optional[Callable[[int, Dict], None]] = None,
    ) -> ElasticReport:
        """Train ``num_steps`` steps; ``batches(step)`` returns
        (inputs_list, labels) for that step (deterministic per step, so a
        restored run replays the same data). ``rng`` is a threefry key
        (``generation/prng.py``), default ``key(0)``."""
        from ..generation import prng  # the generation package imports the runtime

        rng = rng if rng is not None else prng.key(0)
        report = ElasticReport()
        step = 0
        while step < num_steps:
            try:
                faults.inject(faults.ELASTIC_STEP, step)
                inputs, labels = batches(step)
                # the step's key: folding the step index keeps replay
                # deterministic
                step_rng = prng.fold_in(rng, step)
                mets = self.model.executor.train_batch(list(inputs), labels, step_rng)
                loss = float(mets["loss"])
                if self.fail_on_nonfinite and not math.isfinite(loss):
                    raise FloatingPointError(f"non-finite loss {loss} at step {step}")
            except Exception as e:  # device loss, transport, poisoned data
                report.failures.append(f"step {step}: {e!r}")
                if report.restarts >= self.max_restarts:
                    raise RuntimeError(
                        f"elastic training exhausted {self.max_restarts} restarts"
                    ) from e
                report.restarts += 1
                self._backoff(report)
                restored = self._restore()
                if restored is not None:
                    step = restored
                else:
                    # nothing saved yet: re-initialize from scratch
                    self.model.executor.initialize(torch.Generator().manual_seed(self.model._seed))
                    step = 0
                continue
            self._consecutive_failures = 0
            report.final_loss = loss
            if on_step is not None:
                on_step(step, mets)
            step += 1
            # forward progress, not work done: replayed steps after a
            # restore don't count twice
            report.steps_completed = step
            if step % self.checkpoint_every == 0 or step == num_steps:
                try:
                    self._save(step)
                    report.checkpoints_saved += 1
                except Exception as e:
                    # a failed save must not kill the run nor poison the
                    # previous checkpoint (the manager deletes the partial
                    # step dir); the training state in memory is still
                    # good, so keep going, within the same restart budget
                    report.failures.append(f"save at step {step}: {e!r}")
                    if step >= num_steps:
                        # training itself is complete: record the failure
                        # and return the finished run
                        break
                    if report.restarts >= self.max_restarts:
                        raise RuntimeError(
                            f"elastic training exhausted {self.max_restarts} restarts"
                        ) from e
                    report.restarts += 1
                    self._backoff(report)
        return report
