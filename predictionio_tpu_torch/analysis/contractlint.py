"""piolint contract-drift engine (PIO401–403): names that cross
process boundaries must exist on both sides.

The reference's ``predictionio_tpu/analysis/contractlint.py`` over this
package: its catalog is the port's (``obs/__init__.py`` and the
families its modules register, ``resilience/faults.py`` ``POINTS``),
and its references are the port's own: ``chip_smoke.py`` and
``server/dashboard.py`` for both contracts, ``tests/test_torch_*.py``
for fault points.

Two string-typed contracts hold the observability story together and
fail only at smoke-runtime, if at all:

* the **metric catalog** — every ``pio_*`` family the smoke script and
  the dashboard grep out of ``/metrics`` must be registered (and carry
  the labels the reference selects on).  A renamed family breaks every
  dashboard silently; the smoke script just stops matching.
* the **fault-point registry** — every point string handed to
  ``faults.check()``/``check_shard()``/``check_tenant()``/``fired()``
  or spelled inside a ``PIO_FAULT_PLAN`` example must be registered in
  ``resilience/faults.py``; an unregistered point makes a chaos test
  silently test nothing.

The engine is whole-program: it builds the catalog from the analyzed
file set (any ``.counter/.gauge/.histogram`` call whose first argument
is a ``"pio_..."`` literal, plus the module-level ``POINTS`` tuple),
then checks references in the smoke script and the dashboard — and,
when the catalog source ``obs/__init__.py`` is in scope (i.e. a
full-tree run), sweeps ``tests/test_torch_*.py`` as plain text too.
Scoped runs (``--changed-files``) without the catalog in scope check
nothing rather than flagging every token: drift detection needs both
sides of the contract, and the gate's full-tree run always has them.

Reference grammar recognized (text-level):

* ``pio_family_name`` — must be a registered family (PIO401);
  exposition suffixes ``_bucket``/``_sum``/``_count`` normalize to the
  histogram family first.
* ``pio_family_name{label="x",other=~"y"}`` — every selected label key
  must be in the registered label set (PIO402); ``le``/``quantile``
  are always allowed (exposition-level labels).
* ``check("point.name")`` (and the shard/tenant/fired variants),
  ``FaultPlan.parse("p1:nth=2;p2")``, ``PIO_FAULT_PLAN=plan`` — every
  point must be registered (PIO403).
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Optional

from .core import _SUPPRESS_RE, Finding, SourceFile

__all__ = ["ContractEngine"]

REGISTER_METHODS = {"counter", "gauge", "histogram"}
# labels added below the registration layer: histogram exposition
# (le/quantile) and the tower merge's per-worker stamping (worker)
IMPLICIT_LABELS = {"le", "quantile", "worker"}
CATALOG_SOURCE = "predictionio_tpu_torch/obs/__init__.py"
# the files that read the catalog as a user would: both contracts
SMOKE_SOURCES = ("chip_smoke.py",
                 "predictionio_tpu_torch/server/dashboard.py")

_METRIC_RE = re.compile(r"(?<![A-Za-z0-9_])pio_[a-z][a-z0-9_]*")
_LABEL_KEY_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_LABEL_ITEM_RE = re.compile(
    r"[A-Za-z_][A-Za-z0-9_]*(?:\s*=~?\s*[\"'][^\"']*[\"'])?"
)
_CHECK_RE = re.compile(
    r"\b(?:check|check_shard|check_tenant|fired|fired_shard)"
    r"\(\s*[\"']([a-z0-9_.]+)[\"']"
)
_PLAN_RE = re.compile(
    r"(?:\bFaultPlan\.parse\(\s*[\"']([^\"']+)[\"']"
    r"|\bPIO_FAULT_PLAN\s*[=:]\s*(?:[\"']([^\"']+)[\"']|([^\s\"'`]+)))"
)


def _plan_points(plan: str):
    """Point names a PIO_FAULT_PLAN string consults (parse grammar:
    ``;``-separated ``point:opt=v,...`` rules plus ``seed=N``)."""
    for rule in plan.split(";"):
        rule = rule.strip()
        if not rule or rule.startswith("seed="):
            continue
        point = rule.split(":", 1)[0].strip()
        if point and re.fullmatch(r"[a-z0-9_.]+", point) and "." in point:
            yield point


class ContractEngine:
    """Whole-program pass over the analyzed SourceFiles; pass
    ``smoke_scope=True`` to force reference checks on every file
    (fixture tests)."""

    def __init__(self, srcs: list[SourceFile], root: Path,
                 smoke_scope: bool = False):
        self.srcs = srcs
        self.root = root
        self.smoke_scope = smoke_scope
        self.findings: list[Finding] = []
        self.metrics: dict[str, set[str]] = {}
        self.points: set[str] = set()
        self.full_scope = False

    # -- catalog construction ----------------------------------------------
    def _index(self) -> None:
        for src in self.srcs:
            if src.rel_path == CATALOG_SOURCE:
                self.full_scope = True
            for node in src.walk():
                if isinstance(node, ast.Call):
                    self._register(node)
                elif isinstance(node, ast.Assign):
                    self._points_assign(node)

    def _register(self, call: ast.Call) -> None:
        f = call.func
        name = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else None)
        if name not in REGISTER_METHODS or not call.args:
            return
        arg0 = call.args[0]
        if not (isinstance(arg0, ast.Constant)
                and isinstance(arg0.value, str)
                and arg0.value.startswith("pio_")):
            return
        labels: set[str] = set()
        for kw in call.keywords:
            if kw.arg == "labels" and isinstance(
                    kw.value, (ast.Tuple, ast.List)):
                labels = {e.value for e in kw.value.elts
                          if isinstance(e, ast.Constant)
                          and isinstance(e.value, str)}
        self.metrics.setdefault(arg0.value, set()).update(labels)

    def _points_assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            if isinstance(t, ast.Name) and t.id == "POINTS" \
                    and isinstance(node.value, (ast.Tuple, ast.List)):
                self.points.update(
                    e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str))

    # -- reference checks --------------------------------------------------
    def _emit(self, path: str, line_no: int, line: str, rule: str,
              col: int, message: str,
              src: Optional[SourceFile] = None) -> None:
        if src is not None:
            if src.suppressed(rule, line_no):
                return
        else:
            # swept text files get the same inline-suppression syntax
            m = _SUPPRESS_RE.search(line)
            if m is not None:
                codes = m.group("codes")
                if codes is None or rule in {
                        c.strip().upper() for c in codes.split(",")}:
                    return
        self.findings.append(Finding(
            rule=rule, path=path, line=line_no, col=col,
            message=message, scope="", snippet=line.strip()))

    def _check_metric_line(self, path: str, line_no: int, line: str,
                           src: Optional[SourceFile]) -> None:
        for m in _METRIC_RE.finditer(line):
            name = m.group(0)
            # construction prefixes (f"pio_hive_smoke_{n}", tmpdir
            # prefixes) and short non-metric identifiers (pio_pr
            # entity types, ~/.pio_tpu) are not references
            if name.endswith("_") or name.count("_") < 2:
                continue
            family = name
            if family not in self.metrics:
                for suffix in ("_bucket", "_sum", "_count"):
                    if family.endswith(suffix) \
                            and family[: -len(suffix)] in self.metrics:
                        family = family[: -len(suffix)]
                        break
            if family not in self.metrics:
                # grep-for-prefix is a legitimate reference idiom:
                # `grep pio_query_latency` still matches the family
                if any(reg.startswith(family) for reg in self.metrics):
                    continue
                self._emit(path, line_no, line, "PIO401", m.start(),
                           f"metric family {name!r} is not registered "
                           "in the obs catalog — rename the reference "
                           "or register the family", src)
                continue
            rest = line[m.end():]
            if not rest.startswith("{"):
                continue
            close = rest.find("}")
            if close < 0:
                continue
            items = [i.strip() for i in rest[1:close].split(",")]
            # only a well-formed selector is a label contract; prose
            # globs like {als.user_half|als.item_half} are not
            if not all(_LABEL_ITEM_RE.fullmatch(i) for i in items):
                continue
            allowed = self.metrics[family] | IMPLICIT_LABELS
            for item in items:
                key = _LABEL_KEY_RE.match(item)
                if key and key.group(0) not in allowed:
                    self._emit(
                        path, line_no, line, "PIO402", m.start(),
                        f"metric {family!r} has no label "
                        f"{key.group(0)!r} (registered: "
                        f"{sorted(self.metrics[family]) or 'none'})",
                        src)

    def _check_fault_line(self, path: str, line_no: int, line: str,
                          src: Optional[SourceFile]) -> None:
        refs: list[tuple[int, str]] = []
        for m in _CHECK_RE.finditer(line):
            # registered points are dotted (storage.write); dotless
            # strings are some local helper's argument, not a fault ref
            if "." in m.group(1):
                refs.append((m.start(), m.group(1)))
        for m in _PLAN_RE.finditer(line):
            plan = m.group(1) or m.group(2) or m.group(3) or ""
            refs.extend((m.start(), p) for p in _plan_points(plan))
        for col, point in refs:
            if point not in self.points:
                self._emit(path, line_no, line, "PIO403", col,
                           f"fault point {point!r} is not registered in "
                           "resilience/faults.py POINTS — chaos hooks "
                           "on unknown points never fire", src)

    def _scan_text(self, path: str, text: str,
                   src: Optional[SourceFile] = None,
                   metrics_too: bool = True) -> None:
        for i, line in enumerate(text.splitlines(), start=1):
            if self.metrics and metrics_too:
                self._check_metric_line(path, i, line, src)
            if self.points:
                self._check_fault_line(path, i, line, src)

    def _is_smoke(self, src: SourceFile) -> bool:
        return self.smoke_scope or src.rel_path in SMOKE_SOURCES

    def run(self) -> list[Finding]:
        self._index()
        if not (self.metrics or self.points):
            return self.findings
        for src in self.srcs:
            if self._is_smoke(src):
                self._scan_text(src.rel_path, src.text, src)
        if not self.full_scope:
            return self.findings
        # full-tree run: sweep the port's tests for fault points only
        # (tests register throwaway pio_* families of their own; their
        # contract is the fault-point registry), as plain text
        for p in sorted(self.root.glob("tests/test_torch_*.py")):
            try:
                text = p.read_text()
            except (OSError, UnicodeDecodeError):
                continue
            self._scan_text(p.relative_to(self.root).as_posix(), text,
                            metrics_too=False)
        return self.findings
