"""Shared piolint infrastructure: rule table, findings, inline
suppressions, and the accepted-findings baseline.

The reference's ``predictionio_tpu/analysis/core.py`` with the port's
rule texts: PIO101–108 describe torch's traced code and fences, PIO109
and PIO301 name this package.

Baseline identity is ``(path, rule, scope, snippet)`` — deliberately
NOT the line number, so unrelated edits above a known finding don't
churn ``analysis/baseline.json``; moving or editing the flagged line
itself surfaces it again for re-review.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

__all__ = [
    "RULES",
    "Finding",
    "SourceFile",
    "Baseline",
    "load_baseline",
]

# code -> one-line rule description; the reference's ids, each PIO1xx
# text read for torch (PIO105 and PIO107 have no torch counterpart: the
# ids stay, and the torch engine reports neither)
RULES: dict[str, str] = {
    "PIO100": "file in the gate scope does not parse",
    "PIO101": "host-device sync: .item()/.tolist() on a traced value "
              "inside torch-traced code (torch.compile, torch.jit, "
              "torch.func transforms, CUDA graph capture)",
    "PIO102": "host-device sync: float()/int()/bool() forcing a traced "
              "value inside torch-traced code",
    "PIO103": "host-device sync: np.asarray/np.array, .numpy() or "
              ".cpu() on a traced value inside torch-traced code",
    "PIO104": "trace/recompile hazard: Python if/while/assert branching "
              "on a traced value",
    "PIO105": "recompile hazard: unhashable literal (list/dict/set) "
              "bound to a static jit argument (no torch counterpart: "
              "not reported)",
    "PIO106": "trace-constant leak: string formatting (f-string/str/"
              "repr/format) of a traced value",
    "PIO107": "donated buffer reused after a donating jit call (no "
              "torch counterpart: not reported)",
    "PIO108": "timing lie: time.* span over device work without a "
              "fence (torch.cuda.synchronize, an event's or stream's "
              "synchronize, device.fence, .item/.tolist/.cpu) "
              "(chip_smoke.py/kernel_variants.py only)",
    "PIO109": "wall-clock duration: time.time() t0/dt subtraction — "
              "use monotonic()/perf_counter() "
              "(predictionio_tpu_torch/ only)",
    "PIO110": "event-loop stall: blocking call (time.sleep, blocking "
              "socket I/O, untimed queue get/put) inside a coroutine "
              "or @callback_scope loop-thread function",
    "PIO201": "lock discipline: write to a lock-guarded attribute "
              "without holding the lock",
    "PIO202": "lock discipline: read of a lock-guarded attribute "
              "without holding the lock",
    "PIO203": "lock discipline: manual .acquire() without a matching "
              "try/finally release",
    "PIO210": "deadlock hazard: lock-order inversion — two locks are "
              "acquired in opposite orders on different interprocedural "
              "paths (both witness paths printed)",
    "PIO211": "callback under lock: a user-supplied callable (on_done, "
              "weight_fn, batch_fn, fault hooks, ...) is invoked while "
              "a lock is statically held — the callee can take any "
              "lock or block, wedging every thread behind this one",
    "PIO212": "blocking under lock: time.sleep, socket/file I/O, fsync, "
              "subprocess, untimed Queue.get/put, or untimed "
              "Event.wait() inside a lock-held region",
    "PIO213": "condition-variable discipline: wait() outside a "
              "predicate loop, or notify()/notify_all() without "
              "holding the condition's lock",
    "PIO301": "engine isolation: an engine template file imports "
              "server internals (predictionio_tpu_torch.server) — "
              "engines declare components, the platform owns serving "
              "(templates/*.py excluding _-prefixed infra)",
    "PIO401": "contract drift: a pio_* metric family name referenced "
              "in smoke tools/dashboards/docs is not registered in "
              "the obs catalog",
    "PIO402": "contract drift: a pio_* metric reference names a label "
              "the registered family does not carry",
    "PIO403": "contract drift: a fault-point string (faults.check/"
              "check_shard/check_tenant/fired or a PIO_FAULT_PLAN "
              "example) is not registered in resilience/faults.py",
}


@dataclass
class Finding:
    rule: str
    path: str           # repo-relative posix path
    line: int
    col: int
    message: str
    scope: str          # qualname of the enclosing function/class ('' = module)
    snippet: str        # stripped source line (baseline identity)
    baselined: bool = False

    def identity(self) -> tuple[str, str, str, str]:
        return (self.path, self.rule, self.scope, self.snippet)

    def to_json(self) -> dict:
        return {
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "col": self.col,
            "message": self.message,
            "scope": self.scope,
            "snippet": self.snippet,
            "baselined": self.baselined,
        }

    def text(self) -> str:
        where = f" [{self.scope}]" if self.scope else ""
        tag = " (baselined)" if self.baselined else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.message}{where}{tag}")


_SUPPRESS_RE = re.compile(
    r"#\s*piolint:\s*disable(?:=(?P<codes>[A-Za-z0-9_,\s]+))?"
)


class SourceFile:
    """One parsed source file + its inline suppressions."""

    def __init__(self, path: Path, rel_path: str, text: str):
        self.path = path
        self.rel_path = rel_path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))
        self._walk_cache: Optional[list] = None
        # line -> set of suppressed codes; the sentinel "*" means all
        self.suppressions: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if not m:
                continue
            codes = m.group("codes")
            if codes is None:
                self.suppressions[i] = {"*"}
            else:
                self.suppressions[i] = {
                    c.strip().upper() for c in codes.split(",") if c.strip()
                }

    @classmethod
    def load(cls, path: Path, root: Path) -> "SourceFile":
        try:
            rel = path.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = path.as_posix()
        return cls(path, rel, path.read_text())

    def walk(self) -> list:
        """Cached flat preorder walk of the whole tree.  Every engine
        iterates the full module at least once; one traversal serves
        them all (the list is read-only by convention)."""
        if self._walk_cache is None:
            self._walk_cache = list(ast.walk(self.tree))
        return self._walk_cache

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def suppressed(self, rule: str, line: int) -> bool:
        codes = self.suppressions.get(line)
        if not codes:
            return False
        return "*" in codes or rule.upper() in codes

    def finding(self, rule: str, node: ast.AST, message: str,
                scope: str = "") -> Optional[Finding]:
        """Build a Finding unless an inline comment suppresses it."""
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        if self.suppressed(rule, line):
            return None
        return Finding(
            rule=rule, path=self.rel_path, line=line, col=col,
            message=message, scope=scope, snippet=self.snippet(line),
        )


@dataclass
class Baseline:
    """Accepted findings: the debt ledger the gate tolerates.

    Each entry carries a one-line ``justification`` — a baseline entry
    without a reason is just a muted bug.
    """

    entries: list[dict] = field(default_factory=list)

    def _keys(self) -> set[tuple[str, str, str, str]]:
        return {
            (e.get("path", ""), e.get("rule", ""), e.get("scope", ""),
             e.get("snippet", ""))
            for e in self.entries
        }

    def apply(self, findings: list[Finding]) -> None:
        """Mark findings that match a baseline entry."""
        keys = self._keys()
        for f in findings:
            f.baselined = f.identity() in keys

    @classmethod
    def from_findings(cls, findings: list[Finding],
                      justification: str = "accepted by --write-baseline",
                      ) -> "Baseline":
        seen: set[tuple] = set()
        entries = []
        for f in sorted(findings, key=lambda f: (f.path, f.rule, f.line)):
            if f.identity() in seen:
                continue
            seen.add(f.identity())
            entries.append({
                "path": f.path, "rule": f.rule, "scope": f.scope,
                "snippet": f.snippet, "justification": justification,
            })
        return cls(entries=entries)

    def save(self, path: Path) -> None:
        path.write_text(json.dumps(
            {"version": 1, "entries": self.entries}, indent=2,
        ) + "\n")


def load_baseline(path: Optional[Path]) -> Baseline:
    if path is None or not path.exists():
        return Baseline()
    data = json.loads(path.read_text())
    return Baseline(entries=list(data.get("entries", [])))
