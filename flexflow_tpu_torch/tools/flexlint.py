#!/usr/bin/env python
"""flexlint for the port — repo-invariant static analysis of
``flexflow_tpu_torch`` (port of the JAX package's ``tools/flexlint.py``).

The gate for four bug classes: guarded state touched outside its lock,
wall-clock reads in injectable-clock code, host syncs inside the step
bodies CUDA graphs capture, and stringly-typed fault-site / Prometheus-
family names that a typo silently disables.

Usage:
  python -m flexflow_tpu_torch.tools.flexlint                  # lint, exit 1 on findings
  python -m flexflow_tpu_torch.tools.flexlint --json report.json
  python -m flexflow_tpu_torch.tools.flexlint --rules clock-discipline,lock-discipline
  python -m flexflow_tpu_torch.tools.flexlint --list-rules
  python -m flexflow_tpu_torch.tools.flexlint --emit-site-table   # the README's port table
  python -m flexflow_tpu_torch.tools.flexlint --update-baseline

Exit codes: 0 clean (suppressed/baselined findings allowed), 1 findings,
2 bad invocation.

Suppress one finding in place:  # flexlint: disable=<rule> — <reason>
Baseline: flexflow_tpu_torch/tools/flexlint_baseline.json (kept EMPTY by
policy; inline suppressions carry the reasons).

Stdlib only: the linter imports neither torch nor the rest of the
package.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from flexflow_tpu_torch import analysis as flex

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flexlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--json", metavar="FILE",
                    help="write the machine-readable report here")
    ap.add_argument("--rules", metavar="R1,R2",
                    help="run only these rules (comma-separated ids)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="baseline file (default "
                         "flexflow_tpu_torch/tools/flexlint_baseline.json)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write current findings into the baseline and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--emit-site-table", action="store_true",
                    help="print the README's port fault-site table generated "
                         "from runtime/faults.py::SITES and exit")
    ap.add_argument("--root", default=str(ROOT),
                    help="repo root (default: this checkout)")
    ap.add_argument("-q", "--quiet", action="store_true",
                    help="findings only, no summary line")
    args = ap.parse_args(argv)

    root = Path(args.root)

    if args.list_rules:
        for r in flex.ALL_RULES:
            print(f"{r.name:22s} {r.description}")
        return 0

    if args.emit_site_table:
        faults_path = root / flex.Context.FAULTS_PATH
        _, sites, err = flex.parse_registry(
            faults_path.read_text(encoding="utf-8")
        )
        if err:
            print(f"flexlint: {err}", file=sys.stderr)
            return 2
        print(flex.emit_site_table(sites))
        return 0

    rule_names = None
    if args.rules:
        rule_names = [r.strip() for r in args.rules.split(",") if r.strip()]
    baseline_path = Path(args.baseline) if args.baseline else (
        root / flex.DEFAULT_BASELINE
    )
    try:
        report = flex.analyze_repo(root, rule_names,
                                   baseline_path=baseline_path)
    except KeyError as e:
        print(f"flexlint: {e.args[0]}", file=sys.stderr)
        return 2

    if args.json:
        Path(args.json).write_text(
            json.dumps(report.to_json(), indent=2) + "\n", encoding="utf-8"
        )

    if args.update_baseline:
        # keep grandfathered findings that still fire (report.baselined)
        # alongside the new ones; entries for rules OUTSIDE this run's
        # --rules scope are preserved verbatim (they were never checked).
        # "parse" findings are emitted by EVERY run, so stale parse
        # entries age out instead of being preserved forever.
        ran = {r.name for r in flex.rules_by_name(rule_names)} | {"parse"}
        entries = {
            (f.rule, f.path, f.message): f.to_json()
            for f in report.baselined + report.findings
        }
        if baseline_path.is_file():
            old = json.loads(baseline_path.read_text(encoding="utf-8"))
            for e in old.get("findings", []):
                if e["rule"] not in ran:
                    entries.setdefault((e["rule"], e["path"], e["message"]), e)
        payload = sorted(entries.values(),
                         key=lambda e: (e["path"], e["rule"], e["message"]))
        baseline_path.write_text(json.dumps(
            {"findings": payload}, indent=2, sort_keys=True,
        ) + "\n", encoding="utf-8")
        print(f"flexlint: baselined {len(payload)} finding(s) "
              f"into {baseline_path}")
        return 0

    for f in report.findings:
        print(f.render())
    if not args.quiet:
        print(
            f"flexlint: {len(report.findings)} finding(s), "
            f"{len(report.suppressed)} suppressed, "
            f"{len(report.baselined)} baselined, "
            f"{report.files_scanned} files scanned"
        )
    return 1 if report.findings else 0


if __name__ == "__main__":
    sys.exit(main())
