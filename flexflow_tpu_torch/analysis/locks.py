"""lock-discipline: attributes declared ``# guarded-by: <lock>`` may
only be touched inside ``with self.<lock>:`` in the declaring class
(port of ``flexflow_tpu/analysis/locks.py``).

Why: a gauges dict mutated outside ServingStats._lock and a fleet's
folded counters read outside Fleet._lock were both point fixes found by
hand. Declaring the guard next to the attribute turns the whole class
into checked territory.

Mechanics:

* Declaration: a ``self.attr = ...`` assignment whose source line ends
  with ``# guarded-by: <lockname>`` (conventionally in ``__init__``).
* Check: every OTHER method of the class — including the bodies of
  lambdas and nested functions, which execute LATER with no lock held,
  the exact shape of the gauge bug above — must only read or write
  ``self.attr`` lexically inside ``with self.<lockname>:``.
* Exemptions: ``__init__``/``__post_init__`` (happens-before
  publication) and methods whose name ends in ``_locked`` (the
  documented called-with-lock-held convention, e.g.
  PredictionLedger._evict_one_locked).

Known limits (documented, deliberate): accesses from OUTSIDE the
declaring class and dynamic ``getattr``/``setattr`` field access are
invisible to a lexical checker; keep cross-object reads behind locked
snapshot methods.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Set

from .core import Context, Finding, Rule, SourceFile

# the marker may follow prose in the same comment ("# ring is bounded;
# guarded-by: _lock") — require only that it sits in a comment
GUARD_RE = re.compile(r"#.*guarded-by:\s*([A-Za-z_][A-Za-z0-9_]*)")
_EXEMPT_METHODS = ("__init__", "__post_init__")


def _self_name(fn: ast.AST) -> str:
    args = getattr(fn, "args", None)
    if args is not None and args.args:
        return args.args[0].arg
    return "self"


class _MethodChecker(ast.NodeVisitor):
    """Walk one method body tracking which guard locks are lexically
    held. Crossing into a Lambda or nested def RESETS the held set:
    those bodies run at some later call time, not under the enclosing
    ``with``."""

    def __init__(self, rule: "LockRule", src: SourceFile, cls: str,
                 guarded: Dict[str, str], self_name: str):
        self.rule = rule
        self.src = src
        self.cls = cls
        self.guarded = guarded
        self.self_name = self_name
        self.held: Set[str] = set()
        self.findings: List[Finding] = []

    def _is_self_attr(self, node: ast.AST, attr: str) -> bool:
        return (
            isinstance(node, ast.Attribute)
            and node.attr == attr
            and isinstance(node.value, ast.Name)
            and node.value.id == self.self_name
        )

    def visit_With(self, node: ast.With) -> None:
        acquired = set()
        # items evaluate left-to-right with earlier locks already held:
        # in `with self._lock, f(self.guarded):` the second item runs
        # under the lock, so held updates BETWEEN items
        for item in node.items:
            is_lock = False
            for lock in set(self.guarded.values()):
                if self._is_self_attr(item.context_expr, lock):
                    # a lock already held (re-entrant RLock shape) must
                    # not be released when THIS with exits — the outer
                    # with still holds it
                    if lock not in self.held:
                        acquired.add(lock)
                        self.held.add(lock)
                    is_lock = True
            if not is_lock:
                self.visit(item.context_expr)
            if item.optional_vars is not None:
                self.visit(item.optional_vars)
        for stmt in node.body:
            self.visit(stmt)
        self.held -= acquired

    def _visit_deferred(self, node: ast.AST) -> None:
        prev, self.held = self.held, set()
        self.generic_visit(node)
        self.held = prev

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_deferred(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_deferred(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._visit_deferred(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (
            isinstance(node.value, ast.Name)
            and node.value.id == self.self_name
            and node.attr in self.guarded
        ):
            lock = self.guarded[node.attr]
            if lock not in self.held:
                self.findings.append(Finding(
                    self.rule.name, self.src.relpath, node.lineno,
                    f"{self.cls}.{node.attr} is guarded-by {lock} but "
                    f"accessed outside `with self.{lock}:`",
                ))
        self.generic_visit(node)


class LockRule(Rule):
    name = "lock-discipline"
    description = (
        "attributes declared `# guarded-by: <lock>` accessed outside "
        "`with self.<lock>:` in the declaring class"
    )

    def run(self, ctx: Context) -> List[Finding]:
        out: List[Finding] = []
        for f in ctx.files:
            if f.tree is None or "guarded-by" not in f.text:
                continue
            for node in ast.walk(f.tree):
                if isinstance(node, ast.ClassDef):
                    out.extend(self._check_class(f, node))
        return out

    def _declarations(self, src: SourceFile, cls: ast.ClassDef) -> Dict[str, str]:
        """attr -> lock name, from guarded-by comments on self-attribute
        assignment lines anywhere in the class body."""
        guarded: Dict[str, str] = {}
        for node in ast.walk(cls):
            if not isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                continue
            # the comment rides the assignment line, or a comment-ONLY
            # line directly above (a trailing comment on the previous
            # statement must not leak onto this one)
            m = GUARD_RE.search(src.line_text(node.lineno))
            if not m:
                above = src.line_text(node.lineno - 1).strip()
                if above.startswith("#"):
                    m = GUARD_RE.search(above)
            if not m:
                continue
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                ):
                    guarded[t.attr] = m.group(1)
        return guarded

    def _check_class(self, src: SourceFile, cls: ast.ClassDef) -> List[Finding]:
        guarded = self._declarations(src, cls)
        if not guarded:
            return []
        out: List[Finding] = []
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if item.name in _EXEMPT_METHODS or item.name.endswith("_locked"):
                continue
            checker = _MethodChecker(
                self, src, cls.name, guarded, _self_name(item)
            )
            for stmt in item.body:
                checker.visit(stmt)
            out.extend(checker.findings)
        return out
