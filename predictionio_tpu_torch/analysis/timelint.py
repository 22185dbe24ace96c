"""piolint clock engine (PIO109): wall-clock durations.

The reference's ``predictionio_tpu/analysis/timelint.py`` over this
package, unchanged in what it finds.

``time.time()`` answers "what time is it", not "how long did that
take": NTP slews, steppable system clocks, and VM migrations all make a
``time.time() - t0`` delta lie by arbitrary amounts in either
direction.  Inside ``predictionio_tpu_torch/`` every duration must come
from ``time.monotonic()`` or ``time.perf_counter()``; ``time.time()``
remains correct for *timestamps* — ``start_time`` fields, hour
bucketing, records that must be comparable across machines.

Detection is the t0/dt subtraction pattern, kept deliberately narrow so
timestamps stay legal:

* a name assigned from a wall-clock call (``t0 = time.time()``) is
  *wall-tainted* within its scope (module body or one function);
* a ``BinOp(Sub)`` whose BOTH operands are wall-clock — a direct
  ``time.time()`` call or a wall-tainted name — is a finding.

``time.time() - age_s`` (deriving a cutoff timestamp) and
``time.time() > deadline`` (comparisons) are not flagged: one operand
is not wall-clock / not a subtraction.  ``cli.py`` runs this engine on
``predictionio_tpu_torch/`` files only; ``chip_smoke.py`` and
``kernel_variants.py`` keep their wall clocks (their spans are fenced
and coarse — PIO108's territory).
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Finding, SourceFile

__all__ = ["TimeEngine"]

WALL_FUNCS = {"time"}  # time.time() — the only steppable clock in `time`


class TimeEngine:
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []
        # import resolution: `import time [as t]` / `from time import
        # time [as now]`
        self.time_aliases: set[str] = set()
        self.wall_names: set[str] = set()
        for node in src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "time":
                        self.time_aliases.add(a.asname or "time")
            elif isinstance(node, ast.ImportFrom) and node.module == "time":
                for a in node.names:
                    if a.name in WALL_FUNCS:
                        self.wall_names.add(a.asname or a.name)

    def run(self) -> list[Finding]:
        scopes: list[tuple[ast.AST, str]] = [(self.src.tree, "")]
        for node in self.src.walk():
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes.append((node, node.name))
        for scope, name in scopes:
            self._check_scope(scope, name)
        return self.findings

    # -- helpers -----------------------------------------------------------
    def _is_wall_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        fn = node.func
        if isinstance(fn, ast.Name):
            return fn.id in self.wall_names
        if isinstance(fn, ast.Attribute) and fn.attr in WALL_FUNCS \
                and isinstance(fn.value, ast.Name):
            return fn.value.id in self.time_aliases
        return False

    @staticmethod
    def _own_nodes(scope: ast.AST):
        """Walk ``scope`` without descending into nested functions —
        a nested def's ``t0`` is a different variable."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _check_scope(self, scope: ast.AST, scope_name: str) -> None:
        nodes = list(self._own_nodes(scope))
        tainted: set[str] = set()
        for n in nodes:
            if isinstance(n, ast.Assign) and self._is_wall_call(n.value):
                for t in n.targets:
                    if isinstance(t, ast.Name):
                        tainted.add(t.id)

        def wallish(side: ast.AST) -> Optional[str]:
            if self._is_wall_call(side):
                return "time.time()"
            if isinstance(side, ast.Name) and side.id in tainted:
                return side.id
            return None

        for n in nodes:
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)):
                continue
            left, right = wallish(n.left), wallish(n.right)
            if left is not None and right is not None:
                f = self.src.finding(
                    "PIO109", n,
                    f"duration computed from wall clocks ({left} - "
                    f"{right}): time.time() can step backwards/forwards "
                    "under NTP — use time.perf_counter() or "
                    "time.monotonic() for deltas (wall clock stays "
                    "correct for timestamps)",
                    scope_name,
                )
                if f is not None:
                    self.findings.append(f)
