"""flexlint for the port: repo-invariant static analysis of
``flexflow_tpu_torch`` (port of ``flexflow_tpu/analysis``).

Four mechanical bug classes recur in serving code: shared stats mutated
outside their lock, wall-clock / injectable-clock mixing,
stringly-typed fault-site and metric names a typo silently disables,
and host syncs inside the step bodies CUDA graphs capture. These
invariants belong to a checker that fails a run, not to anyone's
memory — this package is that checker.

Rules (ids are the suppression/baseline keys):

  clock-discipline     direct time.time()/monotonic()/perf_counter()
                       outside the whitelist (analysis/config.py)
  lock-discipline      `# guarded-by: <lock>` attributes touched
                       outside `with self.<lock>:`
  capture-discipline   host syncs inside the captured step bodies
                       (the JAX rules' jit-discipline)
  fault-site-registry  inject()/FaultPlan sites + the README's port
                       table vs runtime/faults.py::SITES
  metric-name-registry prom.py families vs the Prometheus golden file
                       + naming/label conventions

Run it: ``python -m flexflow_tpu_torch.tools.flexlint`` (exit status 1 on
findings; ``--json`` emits the machine-readable report). Suppress a
single finding with ``# flexlint: disable=<rule> — <reason>`` on the
offending line.

stdlib-only by design (``ast`` + ``re``): the linter must run before —
and regardless of — whether the package's heavy deps import.
"""
from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Sequence

from .capture import CaptureRule
from .clocks import ClockRule
from .core import (
    Context,
    Finding,
    Report,
    Rule,
    SourceFile,
    load_baseline,
    run_rules,
)
from .faultsites import FaultSiteRule, emit_site_table, parse_registry
from .locks import LockRule
from .metricnames import MetricNameRule

ALL_RULES: List[Rule] = [
    ClockRule(),
    LockRule(),
    CaptureRule(),
    FaultSiteRule(),
    MetricNameRule(),
]

DEFAULT_BASELINE = "flexflow_tpu_torch/tools/flexlint_baseline.json"


def rules_by_name(names: Optional[Sequence[str]] = None) -> List[Rule]:
    if not names:
        return list(ALL_RULES)
    by_name = {r.name: r for r in ALL_RULES}
    unknown = [n for n in names if n not in by_name]
    if unknown:
        raise KeyError(f"unknown rule(s): {', '.join(unknown)}; "
                       f"known: {', '.join(sorted(by_name))}")
    return [by_name[n] for n in names]


def analyze_repo(
    root: Path,
    rule_names: Optional[Sequence[str]] = None,
    baseline_path: Optional[Path] = None,
) -> Report:
    """Run the rule suite over the repo at ``root`` (the entrypoint of
    ``python -m flexflow_tpu_torch.tools.flexlint``)."""
    ctx = Context(root=root)
    if baseline_path is None:
        baseline_path = root / DEFAULT_BASELINE
    return run_rules(rules_by_name(rule_names), ctx,
                     load_baseline(baseline_path))


def analyze_source(
    text: str,
    relpath: str = "flexflow_tpu_torch/example.py",
    rule_names: Optional[Sequence[str]] = None,
    ctx: Optional[Context] = None,
) -> Report:
    """Run rules over one in-memory file — the fixture seam the
    per-rule tests use."""
    if ctx is None:
        ctx = Context(files=[SourceFile(relpath, text)])
    return run_rules(rules_by_name(rule_names), ctx)


__all__ = [
    "ALL_RULES",
    "CaptureRule",
    "ClockRule",
    "Context",
    "DEFAULT_BASELINE",
    "FaultSiteRule",
    "Finding",
    "LockRule",
    "MetricNameRule",
    "Report",
    "Rule",
    "SourceFile",
    "analyze_repo",
    "analyze_source",
    "emit_site_table",
    "load_baseline",
    "parse_registry",
    "rules_by_name",
    "run_rules",
]
