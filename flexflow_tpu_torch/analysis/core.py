"""flexlint core (the port's): the shared visitor/runner framework the
rule modules plug into (port of ``flexflow_tpu/analysis/core.py``).

Every rule is a :class:`Rule` with a stable ``name`` (the id used in
suppression comments, baselines, and ``--rules`` filters) and a
``run(ctx)`` returning :class:`Finding` objects. The runner owns the
repo walk, suppression comments, the baseline, and JSON output; rules
own nothing but their invariant.

Suppressions: a finding on line N is suppressed by a
``# flexlint: disable=<rule>[,<rule>...]`` comment on line N (or on
line N-1 when the flagged statement has no room). Suppressions should
carry a one-line reason after the rule list — they are reviewed like
code.

Baseline: grandfathered findings are keyed ``(rule, path, message)``
(line numbers churn; messages are written to be stable). A finding in
the baseline is reported as ``baselined`` and does not fail the run;
the intended steady state of this repo is an EMPTY baseline, with
intentional exemptions carried as inline suppressions instead.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

SUPPRESS_RE = re.compile(r"#\s*flexlint:\s*disable=([a-z0-9_,\- ]+)")

# Directories scanned for per-file rules, relative to the repo root: the
# port's package (its tools included).
SCAN_DIRS: Tuple[str, ...] = ("flexflow_tpu_torch",)
_SKIP_PARTS = {"__pycache__", ".git", "build", "dist"}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation. ``path`` is repo-relative POSIX; ``message``
    is written to be stable across unrelated edits (no line numbers in
    it) so baselines survive code motion."""

    rule: str
    path: str
    line: int
    message: str

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def to_json(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class SourceFile:
    """A parsed python file plus its per-line suppression sets."""

    def __init__(self, relpath: str, text: str):
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[str] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:  # surfaced as a finding by the runner
            self.parse_error = f"syntax error: {e.msg} (line {e.lineno})"
        self._suppressions: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m:
                # split on commas AND whitespace: the documented
                # "disable=<rule> — reason" form must keep suppressing
                # when the reason is separated by a plain hyphen/space
                # (stray reason words become harmless non-rule tokens)
                rules = {r for r in re.split(r"[,\s]+", m.group(1)) if r}
                self._suppressions[i] = rules

    def suppressed(self, line: int, rule: str) -> bool:
        """A suppression comment covers its own line, or — when it is a
        comment-ONLY line — the statement below it (a trailing comment
        on the previous statement must not leak downward)."""
        rules = self._suppressions.get(line)
        if rules and (rule in rules or "all" in rules):
            return True
        above = self.line_text(line - 1).strip()
        if above.startswith("#"):
            rules = self._suppressions.get(line - 1)
            if rules and (rule in rules or "all" in rules):
                return True
        return False

    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1]
        return ""


class Context:
    """Everything a rule may need: the parsed scan set plus lazy repo
    resources (README, the Prometheus golden file, the fault-site
    registry parsed out of runtime/faults.py). Tests override the
    ``*_text`` attributes to run rules against synthetic inputs."""

    README_PATH = "README.md"
    GOLDEN_PATH = "tests/data/prometheus_golden.txt"
    FAULTS_PATH = "flexflow_tpu_torch/runtime/faults.py"
    PROM_PATH = "flexflow_tpu_torch/obs/prom.py"

    def __init__(self, root: Optional[Path] = None,
                 files: Optional[Sequence[SourceFile]] = None):
        self.root = Path(root) if root is not None else None
        self._files: Optional[List[SourceFile]] = (
            list(files) if files is not None else None
        )
        # test seams: assign to override what the repo provides
        self.readme_text: Optional[str] = None
        self.golden_text: Optional[str] = None
        self.faults_source: Optional[str] = None
        self.prom_source: Optional[str] = None

    # ------------------------------------------------------------ files
    @property
    def files(self) -> List[SourceFile]:
        if self._files is None:
            self._files = list(self._walk())
        return self._files

    def _walk(self) -> Iterable[SourceFile]:
        assert self.root is not None, "Context needs a root or explicit files"
        for d in SCAN_DIRS:
            base = self.root / d
            if not base.is_dir():
                continue
            for p in sorted(base.rglob("*.py")):
                if _SKIP_PARTS.intersection(p.parts):
                    continue
                rel = p.relative_to(self.root).as_posix()
                yield SourceFile(rel, p.read_text(encoding="utf-8"))

    def file(self, relpath: str) -> Optional[SourceFile]:
        for f in self.files:
            if f.relpath == relpath:
                return f
        return None

    # -------------------------------------------------------- resources
    def _read(self, relpath: str) -> Optional[str]:
        if self.root is None:
            return None
        p = self.root / relpath
        return p.read_text(encoding="utf-8") if p.is_file() else None

    def readme(self) -> Optional[str]:
        if self.readme_text is None:
            self.readme_text = self._read(self.README_PATH)
        return self.readme_text

    def golden(self) -> Optional[str]:
        if self.golden_text is None:
            self.golden_text = self._read(self.GOLDEN_PATH)
        return self.golden_text

    def faults(self) -> Optional[str]:
        if self.faults_source is None:
            f = self.file(self.FAULTS_PATH)
            self.faults_source = f.text if f else self._read(self.FAULTS_PATH)
        return self.faults_source

    def prom(self) -> Optional[str]:
        if self.prom_source is None:
            f = self.file(self.PROM_PATH)
            self.prom_source = f.text if f else self._read(self.PROM_PATH)
        return self.prom_source


class Rule:
    """Base class; subclasses set ``name``/``description`` and implement
    ``run``. Rules emit EVERY violation they see — suppression and
    baseline filtering happen in the runner, so ``--json`` reports can
    show suppressed counts honestly."""

    name: str = "abstract"
    description: str = ""

    def run(self, ctx: Context) -> List[Finding]:
        raise NotImplementedError


@dataclasses.dataclass
class Report:
    findings: List[Finding]          # actionable (not suppressed, not baselined)
    suppressed: List[Finding]
    baselined: List[Finding]
    files_scanned: int

    def to_json(self) -> Dict:
        return {
            "version": 1,
            "files_scanned": self.files_scanned,
            "findings": [f.to_json() for f in self.findings],
            "suppressed": [f.to_json() for f in self.suppressed],
            "baselined": [f.to_json() for f in self.baselined],
            "counts": {
                "findings": len(self.findings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
            },
        }


def load_baseline(path: Path) -> Set[Tuple[str, str, str]]:
    if not path.is_file():
        return set()
    data = json.loads(path.read_text(encoding="utf-8"))
    return {
        (e["rule"], e["path"], e["message"]) for e in data.get("findings", [])
    }


def run_rules(
    rules: Sequence[Rule],
    ctx: Context,
    baseline: Optional[Set[Tuple[str, str, str]]] = None,
) -> Report:
    """Run every rule, then split raw findings into actionable /
    suppressed / baselined. Unparseable files in the scan set become
    findings themselves (a lint that silently skips broken files hides
    exactly the files most likely to be broken)."""
    baseline = baseline or set()
    raw: List[Finding] = []
    for f in ctx.files:
        if f.parse_error is not None:
            raw.append(Finding("parse", f.relpath, 1, f.parse_error))
    for rule in rules:
        raw.extend(rule.run(ctx))
    raw.sort(key=lambda x: (x.path, x.line, x.rule, x.message))

    by_path = {f.relpath: f for f in ctx.files}
    actionable: List[Finding] = []
    suppressed: List[Finding] = []
    baselined: List[Finding] = []
    for fi in raw:
        src = by_path.get(fi.path)
        if src is not None and src.suppressed(fi.line, fi.rule):
            suppressed.append(fi)
        elif fi.key() in baseline:
            baselined.append(fi)
        else:
            actionable.append(fi)
    return Report(actionable, suppressed, baselined, len(ctx.files))


# ---------------------------------------------------------------- helpers
def attr_chain(node: ast.AST) -> Optional[str]:
    """Render ``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def call_name(node: ast.Call) -> Optional[str]:
    """The trailing identifier of the called function (``inject`` for
    both ``inject(...)`` and ``faults.inject(...)``)."""
    if isinstance(node.func, ast.Name):
        return node.func.id
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    return None


def const_str(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None
