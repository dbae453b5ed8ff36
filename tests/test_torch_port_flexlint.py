"""The port's flexlint (``flexflow_tpu_torch/analysis``,
``python -m flexflow_tpu_torch.tools.flexlint``) against the JAX
package's on the fixtures of ``tests/test_flexlint.py``.

Each fixture runs through both packages' rules, at a JAX path and at the
same path under ``flexflow_tpu_torch/``: the findings must be the same
(rule, line, message; paths and the regenerate hint mapped to the
port). The fault-site fixtures give both rules one registry (the JAX
package's ``faults.py`` source) and each its own README table. The
capture-discipline rule (the port's counterpart of jit-discipline, whose
anchors are JAX's jit) has its own seeded and suppressed fixtures. Then
the repo gates: the port lints clean with an empty baseline, its README
table is its registry's, and none of the port's serving tools or its
analysis package imports jax, ``flexflow_tpu`` or ``tools``.
"""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from flexflow_tpu import analysis as janalysis
from flexflow_tpu.analysis import faultsites as jfaultsites
from flexflow_tpu_torch import analysis as tanalysis
from flexflow_tpu_torch.analysis import faultsites as tfaultsites
from flexflow_tpu_torch.runtime import faults as tfaults

pytestmark = pytest.mark.torch_port

ROOT = Path(__file__).resolve().parent.parent
JAX_FAULTS = (ROOT / "flexflow_tpu/runtime/faults.py").read_text(encoding="utf-8")


def port_path(path: str) -> str:
    for a, b in (("flexflow_tpu/", "flexflow_tpu_torch/"), ("tools/", "flexflow_tpu_torch/tools/")):
        if path.startswith(a):
            return b + path[len(a):]
    return path


def port_message(msg: str) -> str:
    return (msg.replace(repr(jfaultsites.TABLE_BEGIN), repr(tfaultsites.TABLE_BEGIN))
            .replace(repr(jfaultsites.TABLE_END), repr(tfaultsites.TABLE_END))
            .replace("flexflow_tpu/sim/", "flexflow_tpu_torch/sim/")
            .replace("tools/flexlint.py --emit-site-table", tfaultsites.REGENERATE))


def both(rule, files=(), readme=None, prom=None, golden=None):
    """The rule over the fixture files in each package; returns (JAX
    findings mapped to the port, the port's findings), each as
    (rule, path, line, message) plus the suppressed count."""
    out = []
    for pkg, mapped in ((janalysis, False), (tanalysis, True)):
        srcs = [pkg.SourceFile(port_path(p) if mapped else p, t) for p, t in files]
        ctx = pkg.Context(root=ROOT, files=srcs)
        ctx.faults_source = JAX_FAULTS
        if readme is not None:
            sites = jfaultsites.parse_registry(JAX_FAULTS)[1]
            table = (tfaultsites if mapped else jfaultsites).emit_site_table(sites)
            ctx.readme_text = readme(table)
        if prom is not None:
            ctx.prom_source = prom
        if golden is not None:
            ctx.golden_text = golden
        report = pkg.run_rules(pkg.rules_by_name([rule]), ctx)
        rows = sorted((f.rule, f.path if mapped else port_path(f.path), f.line,
                       f.message if mapped else port_message(f.message))
                      for f in report.findings)
        out.append((rows, len(report.suppressed)))
    return out


TIME_CALL = "import time\n\ndef f():\n    return time.{}()\n"
LOCKED_CLASS = """import threading

class Stats:
    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0  # guarded-by: _lock

    def bump(self):
        self.count += 1

    def read_locked(self):
        return self.count

    def snapshot(self):
        with self._lock:
            return self.count

    def register(self, add_gauge):
        with self._lock:
            add_gauge("c", lambda: self.count)

    def suppressed(self):
        return self.count  # flexlint: disable=lock-discipline — test
"""

FIXTURES = {
    "clock-direct": ("clock-discipline", [("flexflow_tpu/generation/x.py", TIME_CALL.format("monotonic"))]),
    "clock-alias": ("clock-discipline", [(
        "flexflow_tpu/serving/x.py",
        "from time import perf_counter as pc\nimport time as t\n\ndef f():\n"
        "    return pc() + t.time()\n")]),
    "clock-injectable-default": ("clock-discipline", [(
        "flexflow_tpu/serving/x.py",
        "import time\n\ndef f(clock=time.monotonic):\n    return clock()\n")]),
    "clock-whitelisted": ("clock-discipline", [
        ("flexflow_tpu/search/calibration.py", TIME_CALL.format("perf_counter")),
        ("flexflow_tpu/generation/engine.py", TIME_CALL.format("perf_counter")),
        ("flexflow_tpu/generation/scheduler.py", TIME_CALL.format("time"))]),
    "clock-suppressed": ("clock-discipline", [(
        "flexflow_tpu/obs/x.py",
        "import time\n\ndef f():\n    # flexlint: disable=clock-discipline - physical time\n"
        "    return time.time()\n")]),
    "clock-strict-sim": ("clock-discipline", [(
        "flexflow_tpu/sim/x.py",
        "import time\nfrom time import perf_counter as pc\n\n"
        "def f(clock=time.monotonic):\n    return pc() + time.perf_counter()\n")]),
    "lock": ("lock-discipline", [("flexflow_tpu/obs/stats.py", LOCKED_CLASS)]),
    "site-typo": ("fault-site-registry", [(
        "flexflow_tpu/generation/x.py",
        'from ..runtime import faults\nfaults.inject("generation.decode_stpe")\n')]),
    "site-literal": ("fault-site-registry", [(
        "flexflow_tpu/generation/x.py",
        'from ..runtime import faults\nfaults.inject("generation.prefill")\n')]),
    "site-constant": ("fault-site-registry", [(
        "flexflow_tpu/generation/x.py",
        "from ..runtime import faults\nfaults.inject(faults.GENERATION_PREFILL)\n"
        "faults.inject(faults.GENERATION_DECODE_STPE)\n"
        "replica_kill(plan, 'r0', site='generation.prefil')\n")]),
    "site-plan-on": ("fault-site-registry", [(
        "tools/mychaos.py", 'plan.on("generation.decode_stpe", mode="error")\n')]),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_rule_findings_equal_jax(name):
    rule, files = FIXTURES[name]
    kw = {}
    if rule == "fault-site-registry":
        kw["readme"] = lambda table: "# x\n\n" + table + "\n"
    (jrows, jsup), (trows, tsup) = both(rule, files, **kw)
    assert trows == jrows and tsup == jsup
    if name in ("clock-direct", "clock-alias", "lock", "site-typo", "clock-strict-sim"):
        assert trows  # the fixture is a real violation in both


@pytest.mark.parametrize("drift", ["missing", "description", "markers"])
def test_readme_table_findings_equal_jax(drift):
    def readme(table):
        if drift == "missing":
            return table.replace("| `generation.decode_step` |", "| `generation.decode_stpe` |")
        if drift == "description":
            return table.replace("before a generation prefill", "before prefill")
        return "# no table\n"

    (jrows, _), (trows, _) = both("fault-site-registry", readme=readme)
    assert trows == jrows and trows


@pytest.mark.parametrize("case", ["unpinned", "counter", "label", "clean"])
def test_metric_findings_equal_jax(case):
    kw = {
        "unpinned": dict(prom='FAMILY = "flexflow_serving_requets_total"\n'),
        "counter": dict(prom="", golden="# TYPE flexflow_serving_failovers counter\n"),
        "label": dict(prom="", golden="# TYPE flexflow_serving_requests_total counter\n"
                                       'flexflow_serving_requests_total{Model="m"} 1\n'),
        "clean": {},
    }[case]
    (jrows, _), (trows, _) = both("metric-name-registry", **kw)
    # the default prom module is each package's own; the golden file is shared
    assert [r[2:] for r in trows] == [r[2:] for r in jrows]
    assert bool(trows) == (case != "clean")


CAPTURED = '''import numpy as np


class Engine:
    def _decode_body(self, x):
        n = x["tokens"].shape[0]
        if n > 4:
            pass
        {body}

    def _host_helper(self, x):
        return x.item()

    def step(self, sig, arrays):
        return self._steps.dispatch(sig, arrays, self._decode_body)

    def prefill(self, sig, arrays, prefix):
        kind, body = ("prefix", self._prefix_body) if prefix else ("full", self._full_body)
        return self._run(kind, (1,), arrays, body, "prefill", 0.0)

    def _prefix_body(self, x):
        return int(x["n"])

    def _full_body(self, x):
        return [t for t in x["tokens"].tolist()]


class Executor:
    def window(self, kind, inputs, label):
        body = self._train_body if kind == "train" else self._eval_body
        return StepGraph(self.device, body, inputs, label)

    def _train_body(self, inputs, label, key):
        while label.sum() > 0:
            pass

    def _eval_body(self, inputs, label, key):
        for row in inputs:
            pass
'''


@pytest.mark.parametrize("body,needle", [
    ("return x['tokens'].item()", "`.item()`"),
    ("return x['tokens'].cpu()", "`.cpu()`"),
    ("return x['tokens'].numpy()", "`.numpy()`"),
    ("return bool(x['ok'])", "`bool()` on a tensor"),
    ("return np.asarray(x['tokens'])", "host numpy call `np.asarray`"),
    ("if x['tokens'][0] > 0:\n            return 1", "Python `if` on a tensor"),
    ("for t in x['tokens']:\n            pass", "Python iteration over a tensor"),
])
def test_capture_discipline_seeded(body, needle):
    report = tanalysis.analyze_source(CAPTURED.format(body=body),
                                      rule_names=["capture-discipline"])
    msgs = [f.message for f in report.findings]
    # the seeded construct in the decode body, plus the anchored bodies'
    # own violations (one each); never the host helper or the shape branch
    assert sum(needle in m and "`_decode_body`" in m for m in msgs) == 1, msgs
    assert sorted({m.split("`")[1] for m in msgs}) == [
        "_decode_body", "_eval_body", "_full_body", "_prefix_body", "_train_body"]
    assert not any("_host_helper" in m for m in msgs)


def test_capture_discipline_clean_and_suppressed():
    clean = tanalysis.analyze_source(CAPTURED.format(body="return x['tokens'] + 1"),
                                     rule_names=["capture-discipline"])
    assert not any("`_decode_body`" in f.message for f in clean.findings)
    src = CAPTURED.format(
        body="return x['tokens'].item()  # flexlint: disable=capture-discipline — test")
    report = tanalysis.analyze_source(src, rule_names=["capture-discipline"])
    assert not any("`_decode_body`" in f.message for f in report.findings)
    assert len(report.suppressed) == 1


def test_port_lints_clean_with_an_empty_baseline(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "flexflow_tpu_torch.tools.flexlint", "--json", str(out)],
        capture_output=True, text=True, cwd=str(ROOT), timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    report = json.loads(out.read_text(encoding="utf-8"))
    assert report["counts"]["findings"] == 0 and report["files_scanned"] > 100
    baseline = json.loads((ROOT / tanalysis.DEFAULT_BASELINE).read_text(encoding="utf-8"))
    assert baseline["findings"] == []
    # the port's engine and executor bodies are in the capture rule's scope
    engine = (ROOT / "flexflow_tpu_torch/generation/engine.py").read_text(encoding="utf-8")
    from flexflow_tpu_torch.analysis.capture import captured_body_names
    assert {"_prefill_body", "_decode_body", "_verify_body",
            "_prefix_prefill_body"} <= captured_body_names(ast.parse(engine))
    executor = (ROOT / "flexflow_tpu_torch/runtime/executor.py").read_text(encoding="utf-8")
    assert {"_train_body", "_eval_body"} <= captured_body_names(ast.parse(executor))


def test_readme_port_table_is_the_registry():
    constants, sites, err = tfaultsites.parse_registry(
        (ROOT / "flexflow_tpu_torch/runtime/faults.py").read_text(encoding="utf-8"))
    assert err is None and sites == dict(tfaults.SITES)
    assert set(constants.values()) == set(tfaults.SITES)
    readme = (ROOT / "README.md").read_text(encoding="utf-8")
    assert tfaultsites.emit_site_table(sites) in readme
    # the JAX package's table is untouched beside it
    jsites = jfaultsites.parse_registry(JAX_FAULTS)[1]
    assert jfaultsites.emit_site_table(jsites) in readme


TOOLS = ("loadgen", "obsreport", "simfleet", "genbench", "perfwatch", "chaoscheck",
         "_durable_child", "flexlint", "_common")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_tools_and_analysis_import_no_jax():
    paths = [ROOT / f"flexflow_tpu_torch/tools/{n}.py" for n in TOOLS]
    paths += sorted((ROOT / "flexflow_tpu_torch/analysis").glob("*.py"))
    for p in paths:
        for mod in _imports(p):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flexflow_tpu", "tools"), (p, mod)
