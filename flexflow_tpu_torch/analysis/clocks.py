"""clock-discipline: direct wall-clock reads are forbidden outside the
whitelist — scheduler/SLO/burn-window/fleet code must use its
injectable clock (port of ``flexflow_tpu/analysis/clocks.py``).

Why this is a rule and not a review habit: an audit of the flight ring
found wall-clock and injectable-clock stamps mixed on one timeline,
which produced incoherent interleavings in every virtual-clock test
that touched it. The fix (dual stamps, scheduler-plane code on the
injected clock) only stays fixed if new code cannot silently call
``time.time()`` again.

What counts as a violation: a CALL to ``time.time`` /
``time.monotonic`` / ``time.perf_counter`` (including ``from time
import monotonic`` aliases). A bare REFERENCE as a default argument
(``clock: Callable[[], float] = time.monotonic``) is the injectable
pattern itself and is always allowed.

Exception: under ``CLOCK_STRICT_PATHS`` (the digital twin,
``flexflow_tpu_torch/sim/``) the rule runs in strict virtual-time mode —
ANY reference to a real clock, call or not, perf_counter included, is
a violation and the whitelist does not apply. The sim's determinism
contract (two replays → byte-identical event traces) dies the moment
one real stamp leaks in, and the simcheck gate's sim-vs-live bound
stops meaning anything.
"""
from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Union

from .config import CLOCK_STRICT_PATHS, CLOCK_WHITELIST
from .core import Context, Finding, Rule, SourceFile

CLOCK_FUNCS = frozenset({"time", "monotonic", "perf_counter"})


def _whitelisted(relpath: str, func: str) -> bool:
    for key, allowed in CLOCK_WHITELIST.items():
        if key.endswith("/"):
            if not relpath.startswith(key):
                continue
        elif relpath != key:
            continue
        if allowed == "*" or func in allowed:
            return True
    return False


class ClockRule(Rule):
    name = "clock-discipline"
    description = (
        "time.time()/monotonic()/perf_counter() calls outside the "
        "whitelist; use the component's injectable clock"
    )

    def run(self, ctx: Context) -> List[Finding]:
        out: List[Finding] = []
        for f in ctx.files:
            if f.tree is None:
                continue
            out.extend(self._check_file(f))
        return out

    def _check_file(self, f: SourceFile) -> List[Finding]:
        # names bound by `from time import monotonic [as m]`, and
        # module aliases from `import time [as t]` — an alias must not
        # evade the rule
        aliases: Dict[str, str] = {}
        mod_aliases = {"time"}
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in CLOCK_FUNCS:
                        aliases[a.asname or a.name] = a.name
            elif isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        mod_aliases.add(a.asname or a.name)
        if any(f.relpath.startswith(p) for p in CLOCK_STRICT_PATHS):
            return self._check_strict(f, aliases, mod_aliases)
        out: List[Finding] = []
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            func = None
            if (
                isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id in mod_aliases
                and node.func.attr in CLOCK_FUNCS
            ):
                func = node.func.attr
            elif isinstance(node.func, ast.Name) and node.func.id in aliases:
                func = aliases[node.func.id]
            if func is None or _whitelisted(f.relpath, func):
                continue
            out.append(Finding(
                self.name, f.relpath, node.lineno,
                f"direct wall-clock call time.{func}(); use the injectable "
                "clock (or whitelist the file in analysis/config.py with a "
                "reason)",
            ))
        return out

    def _check_strict(
        self,
        f: SourceFile,
        aliases: Dict[str, str],
        mod_aliases: FrozenSet[str],
    ) -> List[Finding]:
        """Strict virtual-time mode: every reference counts, imports
        included, whitelist ignored. Flagging the reference (not just
        the call) means even the injectable-default idiom is out —
        the sim has exactly one clock and it is the event loop's."""
        out: List[Finding] = []
        for node in ast.walk(f.tree):
            func = None
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in CLOCK_FUNCS:
                        out.append(Finding(
                            self.name, f.relpath, node.lineno,
                            f"real-clock import time.{a.name} under the "
                            "strict virtual-time path; the sim runs on the "
                            "event loop's virtual clock only",
                        ))
                continue
            if (
                isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in mod_aliases
                and node.attr in CLOCK_FUNCS
            ):
                func = node.attr
            elif isinstance(node, ast.Name) and node.id in aliases:
                func = aliases[node.id]
            if func is None:
                continue
            out.append(Finding(
                self.name, f.relpath, node.lineno,
                f"real-clock reference time.{func} under the strict "
                "virtual-time path (flexflow_tpu_torch/sim/ is deterministic by "
                "contract); use the event loop's virtual clock",
            ))
        return out
