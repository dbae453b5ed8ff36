"""capture-discipline: host-syncing constructs inside the step bodies a
CUDA graph captures (the port's counterpart of the JAX package's
``jit-discipline``, ``flexflow_tpu/analysis/jitsafety.py``).

The serving design rests on a FIXED family of step signatures, each
captured once as a CUDA graph and replayed after that
(``generation/step_graphs.py``, ``runtime/step_graph.py``); genbench
measures that invariant, this rule keeps the code shapes that break a
capture from landing. A host sync inside a body either raises at capture
time (``.item()`` on a capturing stream) or, worse, bakes one step's
value into every replay.

Which functions are captured step bodies (the same anchors as the JAX
rule's traced bodies): a function is in scope when its name is

* the body an engine step registers through ``note_trace`` and runs:
  passed to ``<runner>.dispatch(sig, arrays, body)`` or
  ``<engine>._dispatch_step(sig, arrays, body, ...)`` (third argument or
  ``body=``) or ``<engine>._run(kind, shape, arrays, body, ...)``
  (fourth argument), or
* a body ``runtime/step_graph.py::StepGraph`` captures: passed to
  ``StepGraph(device, body, ...)`` (second argument or ``body=``) or to
  ``<executor>._step_graph(kind, body, ...)``,

either directly (``self._decode_body``) or through a local variable
named ``body`` whose assigned value names it (``kind, body = ...,
self._prefill_body``; ``body = self._train_body if ... else
self._eval_body``).

Inside such a function the rule flags:

* ``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()`` — a device to
  host copy, a sync the capture cannot hold,
* ``int(x)`` / ``float(x)`` / ``bool(x)`` on a tensor — the same sync,
* ``np.*`` / ``numpy.*`` calls — host numpy inside a captured body
  materializes on the host; use torch ops on the device,
* ``if`` / ``while`` on a tensor — Python control flow on a device
  value syncs (and freezes the branch into the graph),
* ``for`` iterating a tensor — syncs per element (or unrolls).

"Tensor" is a lexical taint: the function's parameters (``self``
excluded), spread through assignments — except through ``.shape`` /
``.dtype`` / ``.ndim`` / ``.size`` / ``len()``, which are static host
values (bucketed shapes are the engine's dispatch keys and are fine to
branch on).
"""
from __future__ import annotations

import ast
from typing import List, Optional, Set

from .core import Context, Finding, Rule, SourceFile, attr_chain, call_name

_STATIC_ATTRS = {"shape", "dtype", "ndim", "size"}
_CONCRETIZERS = {"int", "float", "bool"}
_HOST_METHODS = {"item", "cpu", "tolist", "numpy"}
_NP_ROOTS = {"np", "numpy"}
# call name -> the positional index of its step-body argument
_BODY_ARGS = {"dispatch": 2, "_dispatch_step": 2, "_run": 3, "StepGraph": 1, "_step_graph": 1}


def _param_names(args: ast.arguments) -> Set[str]:
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg is not None:
        names.add(args.vararg.arg)
    if args.kwarg is not None:
        names.add(args.kwarg.arg)
    return names


def _referenced_functions(node: Optional[ast.AST]) -> Set[str]:
    """Function names an expression refers to: ``name`` and the last
    attribute of ``self.name`` / ``obj.name`` chains."""
    out: Set[str] = set()
    if node is None:
        return out
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Name):
            out.add(n.id)
    return out


def _body_assignments(tree: ast.AST) -> Set[str]:
    """Names assigned to a local variable called ``body`` anywhere in the
    module (tuple targets included)."""
    out: Set[str] = set()
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "body":
                out |= _referenced_functions(node.value)
            elif isinstance(t, ast.Tuple) and any(
                    isinstance(el, ast.Name) and el.id == "body" for el in t.elts):
                if isinstance(node.value, ast.Tuple):
                    for el, val in zip(t.elts, node.value.elts):
                        if isinstance(el, ast.Name) and el.id == "body":
                            out |= _referenced_functions(val)
                else:  # e.g. a conditional between two tuples
                    out |= _referenced_functions(node.value)
    return out


def captured_body_names(tree: ast.AST) -> Set[str]:
    """Names of the functions the module hands to a step runner or a
    step graph as a captured body."""
    names: Set[str] = set()
    via_body_var = False
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        idx = _BODY_ARGS.get(call_name(node) or "")
        if idx is None:
            continue
        arg = node.args[idx] if len(node.args) > idx else None
        for kw in node.keywords:
            if kw.arg == "body":
                arg = kw.value
        if isinstance(arg, ast.Name) and arg.id == "body":
            via_body_var = True
        elif isinstance(arg, (ast.Name, ast.Attribute)):
            names |= _referenced_functions(arg)
    if via_body_var:
        names |= _body_assignments(tree)
    return names


class _TaintChecker(ast.NodeVisitor):
    """Single forward pass over one captured body."""

    def __init__(self, rule: "CaptureRule", src: SourceFile, fn_name: str,
                 tainted: Set[str]):
        self.rule = rule
        self.src = src
        self.fn_name = fn_name
        self.tainted = set(tainted)
        self.findings: List[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.findings.append(Finding(
            self.rule.name, self.src.relpath, node.lineno,
            f"in captured step body `{self.fn_name}`: {what}",
        ))

    def _expr_tainted(self, node: Optional[ast.AST]) -> bool:
        if node is None:
            return False
        stack = [node]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Name):
                if n.id in self.tainted:
                    return True
                continue
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                continue  # static host value
            if (
                isinstance(n, ast.Call)
                and isinstance(n.func, ast.Name)
                and n.func.id == "len"
            ):
                continue  # len() of anything is a static int
            stack.extend(ast.iter_child_nodes(n))
        return False

    def _taint_targets(self, target: ast.AST) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                self.tainted.add(n.id)

    # ------------------------------------------------------- statements
    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        if self._expr_tainted(node.value):
            for t in node.targets:
                self._taint_targets(t)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.visit(node.value)

    def visit_If(self, node: ast.If) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "Python `if` on a tensor (host sync; the branch "
                             "freezes into the graph); use torch.where")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        if self._expr_tainted(node.test):
            self._flag(node, "Python `while` on a tensor (host sync per "
                             "iteration)")
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        if self._expr_tainted(node.iter):
            self._flag(node, "Python iteration over a tensor (syncs per "
                             "element); use a batched torch op")
            self._taint_targets(node.target)
        self.generic_visit(node)

    # ------------------------------------------------------------ calls
    def visit_Call(self, node: ast.Call) -> None:
        cn = call_name(node)
        if cn in _HOST_METHODS and isinstance(node.func, ast.Attribute):
            self._flag(node, f"`.{cn}()` copies to the host (a sync the "
                             "capture cannot hold)")
        elif (
            isinstance(node.func, ast.Name)
            and node.func.id in _CONCRETIZERS
            and any(self._expr_tainted(a) for a in node.args)
        ):
            self._flag(node, f"`{node.func.id}()` on a tensor syncs the host")
        else:
            chain = attr_chain(node.func)
            if chain is not None and chain.split(".")[0] in _NP_ROOTS:
                self._flag(node, f"host numpy call `{chain}` inside a "
                                 "captured body; use torch ops on the device")
        self.generic_visit(node)

    # nested defs/lambdas run inside the same capture: their parameters
    # are device values too
    def _visit_nested(self, node) -> None:
        prev = set(self.tainted)
        self.tainted |= _param_names(node.args)
        if isinstance(node, ast.Lambda):
            self.visit(node.body)
        else:
            for stmt in node.body:
                self.visit(stmt)
        self.tainted = prev

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._visit_nested(node)

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._visit_nested(node)


class CaptureRule(Rule):
    name = "capture-discipline"
    description = (
        "host syncs (.item/.cpu/.tolist/.numpy, int()/float()/bool() on "
        "tensors, np.*, Python control flow on tensors) inside the step "
        "bodies CUDA graphs capture"
    )

    def run(self, ctx: Context) -> List[Finding]:
        out: List[Finding] = []
        for f in ctx.files:
            if f.tree is None:
                continue
            bodies = captured_body_names(f.tree)
            if not bodies:
                continue
            for node in ast.walk(f.tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if node.name not in bodies:
                    continue
                params = _param_names(node.args) - {"self", "cls"}
                checker = _TaintChecker(self, f, node.name, params)
                for stmt in node.body:
                    checker.visit(stmt)
                out.extend(checker.findings)
        return out
