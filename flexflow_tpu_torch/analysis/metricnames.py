"""metric-name-registry: Prometheus families emitted by the port's
obs/prom.py must be pinned in tests/data/prometheus_golden.txt (read,
never edited) and follow the ``flexflow_*`` naming/label conventions
(port of ``flexflow_tpu/analysis/metricnames.py``).

A renamed or typo'd family doesn't crash anything — dashboards and
alerts silently go blank. The golden file is the registry of record
(the observability suite pins the full exposition against it); this
rule closes the loop statically:

1. every literal ``flexflow_*`` family name in obs/prom.py appears in
   the golden file (as a ``# TYPE`` family),
2. every golden family follows the conventions: ``flexflow_`` prefix,
   ``[a-z0-9_]`` names, counters end ``_total``, histogram/summary
   families end ``_seconds``,
3. label names in golden samples are ``[a-z_][a-z0-9_]*``.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List

from .core import Context, Finding, Rule

_FAMILY_RE = re.compile(r"^flexflow_[a-z0-9_]+$")
_TYPE_RE = re.compile(r"^#\s*TYPE\s+(\S+)\s+(\S+)")
_SAMPLE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{([^{}]*)\})?\s")
_LABEL_RE = re.compile(r'([^=,{]+)="')
_LABEL_NAME_RE = re.compile(r"^[a-z_][a-z0-9_]*$")
# suffixes Prometheus appends to base families in sample lines
_SAMPLE_SUFFIXES = ("_bucket", "_sum", "_count")


def golden_families(golden: str) -> Dict[str, str]:
    """family -> kind from the golden file's # TYPE lines."""
    out: Dict[str, str] = {}
    for line in golden.splitlines():
        m = _TYPE_RE.match(line)
        if m:
            out[m.group(1)] = m.group(2)
    return out


class MetricNameRule(Rule):
    name = "metric-name-registry"
    description = (
        "Prometheus families in obs/prom.py must be pinned in the "
        "golden exposition file and follow flexflow_* conventions"
    )

    def run(self, ctx: Context) -> List[Finding]:
        prom = ctx.prom()
        golden = ctx.golden()
        if prom is None or golden is None:
            missing = Context.PROM_PATH if prom is None else Context.GOLDEN_PATH
            return [Finding(self.name, missing, 1, "file not found")]
        fams = golden_families(golden)
        out: List[Finding] = []
        out.extend(self._check_prom_literals(prom, fams))
        out.extend(self._check_conventions(fams))
        out.extend(self._check_labels(golden))
        return out

    def _check_prom_literals(self, prom: str, fams: Dict[str, str]) -> List[Finding]:
        """Every fully-literal family name in prom.py is golden-pinned.
        Format templates ("flexflow_serving_%s") and prefixes (trailing
        underscore) are skipped — their expansions are pinned by the
        golden test dynamically."""
        out: List[Finding] = []
        try:
            tree = ast.parse(prom)
        except SyntaxError as e:
            return [Finding(self.name, Context.PROM_PATH, e.lineno or 1,
                            f"prom module unparseable: {e.msg}")]
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant) and isinstance(node.value, str)):
                continue
            s = node.value
            if not s.startswith("flexflow_") or "%" in s or "{" in s:
                continue
            if " " in s or s.endswith("_"):
                # prose (HELP text fragments) / prefix constants used
                # with startswith — not family names
                continue
            base = s
            for suf in _SAMPLE_SUFFIXES:
                if base.endswith(suf) and base[: -len(suf)] in fams:
                    base = base[: -len(suf)]
                    break
            if not _FAMILY_RE.match(base):
                out.append(Finding(
                    self.name, Context.PROM_PATH, node.lineno,
                    f"family {s!r} violates naming convention "
                    "(lowercase [a-z0-9_] only)",
                ))
                continue
            if base not in fams:
                out.append(Finding(
                    self.name, Context.PROM_PATH, node.lineno,
                    f"family {s!r} is not pinned in the golden exposition "
                    "file; add it to tests/data/prometheus_golden.txt "
                    "(regenerate via the golden test) or fix the name",
                ))
        return out

    def _check_conventions(self, fams: Dict[str, str]) -> List[Finding]:
        out: List[Finding] = []
        for fam, kind in sorted(fams.items()):
            if not _FAMILY_RE.match(fam):
                out.append(Finding(
                    self.name, Context.GOLDEN_PATH, 1,
                    f"golden family {fam!r} violates the flexflow_* "
                    "naming convention",
                ))
                continue
            if kind == "counter" and not fam.endswith("_total"):
                out.append(Finding(
                    self.name, Context.GOLDEN_PATH, 1,
                    f"counter family {fam!r} must end in _total",
                ))
            if kind in ("histogram", "summary") and not fam.endswith("_seconds"):
                out.append(Finding(
                    self.name, Context.GOLDEN_PATH, 1,
                    f"{kind} family {fam!r} must end in _seconds "
                    "(all current timing families are in seconds)",
                ))
        return out

    def _check_labels(self, golden: str) -> List[Finding]:
        out: List[Finding] = []
        seen = set()
        for i, line in enumerate(golden.splitlines(), start=1):
            if not line or line.startswith("#"):
                continue
            m = _SAMPLE_RE.match(line)
            if m is None or not m.group(3):
                continue
            for lm in _LABEL_RE.finditer(m.group(3)):
                label = lm.group(1).strip().lstrip(",")
                if label in seen:
                    continue
                seen.add(label)
                if not _LABEL_NAME_RE.match(label):
                    out.append(Finding(
                        self.name, Context.GOLDEN_PATH, i,
                        f"label name {label!r} violates the snake_case "
                        "label convention",
                    ))
        return out
