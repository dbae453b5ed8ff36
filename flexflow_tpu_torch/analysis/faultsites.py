"""fault-site-registry: every fault-injection site name in the port's
code and docs must come from the port's ``runtime/faults.py``
canonical ``SITES`` registry (port of
``flexflow_tpu/analysis/faultsites.py``).

A typo'd ``inject("generation.decode_stpe")`` is worse than a crash: it
silently becomes a site no chaos plan ever targets, and the behavior it
was supposed to make testable goes untested. Same for a FaultPlan rule
registered on a misspelled site (it simply never fires), and for the
README site table drifting from the code.

Checks:

1. Registry self-consistency (parsed from faults.py WITHOUT importing
   it): every ``UPPER_CASE = "dotted.site"`` constant is a ``SITES``
   key and vice versa.
2. Call sites: ``inject(...)`` first args, ``replica_kill(site=...)``,
   ``FaultRule(site=...)``, and ``plan.on("<dotted site>", ...)``
   literals must be registered sites; constant references
   (``faults.GENERATION_PREFILL``) must name registry constants.
   String literals are allowed only in the registry module itself —
   production call sites reference the constants, so a rename is a
   NameError instead of a dead site.
3. The README's port fault-site table (between the ``flexlint: torch
   site-table`` markers, in the port's section; the JAX package's table
   has markers of its own) must list exactly the registry's sites with
   the registry's descriptions — regenerate it with ``python -m
   flexflow_tpu_torch.tools.flexlint --emit-site-table`` instead of
   editing it by hand.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Tuple

from .config import SITE_PREFIXES, SITE_RULE_EXCLUDE
from .core import Context, Finding, Rule, call_name, const_str

TABLE_BEGIN = ("<!-- flexlint: torch site-table begin (generated by "
               "python -m flexflow_tpu_torch.tools.flexlint --emit-site-table) -->")
TABLE_END = "<!-- flexlint: torch site-table end -->"
REGENERATE = "python -m flexflow_tpu_torch.tools.flexlint --emit-site-table"
_ROW_RE = re.compile(r"^\|\s*`([^`]+)`\s*\|\s*(.*?)\s*\|\s*$")
_SITE_SHAPE_RE = re.compile(r"^[a-z_]+(\.[a-z_]+)+$")


def parse_registry(faults_source: str) -> Tuple[Dict[str, str], Dict[str, str], Optional[str]]:
    """(constants name->site, sites site->description, error) parsed
    from the faults module source. The SITES dict literal must key on
    the constants (Name nodes), which is itself part of the contract."""
    try:
        tree = ast.parse(faults_source)
    except SyntaxError as e:
        return {}, {}, f"faults module unparseable: {e.msg}"
    constants: Dict[str, str] = {}
    sites: Dict[str, str] = {}
    sites_seen = False
    for node in tree.body:
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not isinstance(t, ast.Name):
            continue
        if t.id.isupper() and t.id != "SITES":
            v = const_str(node.value)
            # only dotted-lowercase site-shaped values are site
            # constants — an unrelated module constant (a URL, a path)
            # must not be conscripted into the registry check
            if v is not None and _SITE_SHAPE_RE.match(v):
                constants[t.id] = v
        elif t.id == "SITES":
            sites_seen = True
            d = node.value
            # allow SITES = MappingProxyType({...})
            if isinstance(d, ast.Call) and len(d.args) == 1:
                d = d.args[0]
            if not isinstance(d, ast.Dict):
                return constants, {}, "SITES must be a literal dict"
            for k, val in zip(d.keys, d.values):
                desc = const_str(val)
                if isinstance(k, ast.Name) and k.id in constants:
                    sites[constants[k.id]] = desc or ""
                else:
                    ks = const_str(k)
                    return constants, sites, (
                        f"SITES key {ks or ast.dump(k)[:40]!r} must be a "
                        "registry constant (UPPER_CASE name)"
                    )
    if not sites_seen:
        return constants, sites, "no SITES registry found in faults module"
    return constants, sites, None


def emit_site_table(sites: Dict[str, str]) -> str:
    lines = [TABLE_BEGIN, "| site | where |", "|---|---|"]
    for site, desc in sites.items():
        lines.append(f"| `{site}` | {desc} |")
    lines.append(TABLE_END)
    return "\n".join(lines)


def _readme_table(readme: str) -> Optional[Dict[str, str]]:
    """Rows of the marker-delimited site table, or None if markers are
    missing/corrupt."""
    try:
        start = readme.index(TABLE_BEGIN)
        end = readme.index(TABLE_END, start)
    except ValueError:
        return None
    rows: Dict[str, str] = {}
    for line in readme[start:end].splitlines():
        m = _ROW_RE.match(line.strip())
        if m and m.group(1) != "site":
            rows[m.group(1)] = m.group(2)
    return rows


def _looks_like_site(s: str) -> bool:
    return s.startswith(SITE_PREFIXES)


class FaultSiteRule(Rule):
    name = "fault-site-registry"
    description = (
        "fault-injection site names (inject/FaultPlan.on/replica_kill/"
        "README table) must match runtime/faults.py::SITES"
    )

    def run(self, ctx: Context) -> List[Finding]:
        out: List[Finding] = []
        faults_src = ctx.faults()
        if faults_src is None:
            return [Finding(self.name, Context.FAULTS_PATH, 1,
                            "faults module not found")]
        constants, sites, err = parse_registry(faults_src)
        if err is not None:
            return [Finding(self.name, Context.FAULTS_PATH, 1, err)]

        # 1. self-consistency: every constant registered, no orphans
        for cname, site in constants.items():
            if site not in sites:
                out.append(Finding(
                    self.name, Context.FAULTS_PATH, 1,
                    f"constant {cname} = {site!r} is not a SITES key",
                ))

        # 2. call sites
        for f in ctx.files:
            if f.tree is None or f.relpath.startswith(SITE_RULE_EXCLUDE):
                continue
            out.extend(self._check_calls(f, constants, sites))

        # 3. README table
        readme = ctx.readme()
        if readme is not None:
            out.extend(self._check_readme(sites, readme))
        return out

    def _check_site_arg(self, f, node: ast.AST, constants, sites,
                        where: str) -> Optional[Finding]:
        lit = const_str(node)
        if lit is not None:
            if lit not in sites:
                hint = ""
                if _looks_like_site(lit):
                    hint = " (unknown site — typo?)"
                return Finding(
                    self.name, f.relpath, node.lineno,
                    f"{where} uses unregistered site {lit!r}{hint}; "
                    "reference a faults.SITES constant",
                )
            return Finding(
                self.name, f.relpath, node.lineno,
                f"{where} uses string literal {lit!r}; reference the "
                "registry constant so renames cannot strand the site",
            )
        # constant reference: faults.GENERATION_PREFILL or bare name
        cname = None
        if isinstance(node, ast.Attribute):
            cname = node.attr
        elif isinstance(node, ast.Name):
            cname = node.id
        if cname is not None and cname.isupper() and cname not in constants:
            return Finding(
                self.name, f.relpath, node.lineno,
                f"{where} references unknown registry constant {cname}",
            )
        return None

    def _check_calls(self, f, constants, sites) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            cn = call_name(node)
            site_arg: Optional[ast.AST] = None
            where = None
            if cn == "inject" and node.args:
                site_arg, where = node.args[0], "inject()"
            elif cn == "replica_kill":
                for kw in node.keywords:
                    if kw.arg == "site":
                        site_arg, where = kw.value, "replica_kill(site=)"
            elif cn == "FaultRule":
                for kw in node.keywords:
                    if kw.arg == "site":
                        site_arg, where = kw.value, "FaultRule(site=)"
                if site_arg is None and node.args:
                    site_arg, where = node.args[0], "FaultRule()"
            elif cn == "on" and node.args:
                # only police .on() literals that look like fault sites;
                # .on is a common verb on other APIs
                lit = const_str(node.args[0])
                if lit is not None and _looks_like_site(lit):
                    if lit not in sites:
                        out.append(Finding(
                            self.name, f.relpath, node.args[0].lineno,
                            f"FaultPlan.on() uses unregistered site "
                            f"{lit!r} (unknown site — typo?)",
                        ))
                continue
            if site_arg is None:
                continue
            finding = self._check_site_arg(f, site_arg, constants, sites, where)
            if finding is not None:
                out.append(finding)
        return out

    def _check_readme(self, sites: Dict[str, str], readme: str) -> List[Finding]:
        rows = _readme_table(readme)
        if rows is None:
            return [Finding(
                self.name, Context.README_PATH, 1,
                "README fault-site table markers missing — wrap the table "
                f"in {TABLE_BEGIN!r} / {TABLE_END!r} and regenerate with "
                f"{REGENERATE}",
            )]
        out: List[Finding] = []
        for site in sites:
            if site not in rows:
                out.append(Finding(
                    self.name, Context.README_PATH, 1,
                    f"README site table is missing registered site {site!r}; "
                    f"regenerate with {REGENERATE}",
                ))
            elif rows[site] != sites[site]:
                out.append(Finding(
                    self.name, Context.README_PATH, 1,
                    f"README site table description for {site!r} differs "
                    f"from the registry; regenerate with {REGENERATE}",
                ))
        for site in rows:
            if site not in sites:
                out.append(Finding(
                    self.name, Context.README_PATH, 1,
                    f"README site table lists unregistered site {site!r}; "
                    f"regenerate with {REGENERATE}",
                ))
        return out
