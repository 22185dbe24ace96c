"""piolint concurrency engine (PIO2xx): per-class lock discipline.

The reference's ``predictionio_tpu/analysis/locklint.py``, unchanged
in what it finds.

The discipline is *inferred*, not declared: for every class that owns a
``threading.Lock``/``RLock``/``Condition`` attribute, any ``self._*``
attribute that is ever WRITTEN while holding that lock is treated as
lock-guarded, and every read or write of it on a code path that does
not hold the lock is a finding.  This is exactly the invariant the
drain-thread / serving-reload / stats-counter code means to maintain
but no example-based test can check: the interleaving that breaks it
may need two threads to hit a three-instruction window.

Refinements that keep the false-positive rate workable:

* ``__init__``/``__del__`` are exempt (construction and teardown
  happen-before/after sharing);
* a helper method whose every intra-class call site holds the lock is
  analyzed as lock-held itself (``StatsCollector._roll``,
  ``MicroBatcher._lead``), computed to fixpoint;
* container mutation through method calls (``self._dq.append(...)``,
  ``self.counts.update(...)``) counts as a write, since those are the
  shared-state mutations that matter for dict/deque/Counter attrs;
* nested function and class bodies inside a method are skipped — they
  execute on other threads or at other times, so the enclosing
  ``with self._lock`` proves nothing about them.

PIO203 flags manual ``.acquire()`` calls that are not immediately
followed by a ``try``/``finally`` release and are not themselves inside
a ``finally`` block (the release-around-device-call re-acquire idiom).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Optional

from .core import Finding, SourceFile

__all__ = ["LockEngine"]

LOCK_TYPES = {"Lock", "RLock", "Condition"}
# obs/scope.py instrumented drop-ins: same monitor semantics, so an
# attr built from one IS a lock for guard-discipline purposes
TIMED_LOCK_TYPES = {"TimedLock", "TimedCondition"}

# method calls on an attribute that mutate the underlying container
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "extendleft", "insert", "pop",
    "popleft", "remove", "clear", "update", "add", "discard",
    "setdefault", "sort", "reverse", "popitem",
}


def _dotted(node: ast.AST) -> Optional[list[str]]:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` -> "X" (also accepts ``cls.X``)."""
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id in ("self", "cls"):
        return node.attr
    return None


@dataclass
class _Access:
    attr: str
    write: bool
    node: ast.AST
    held: frozenset  # lock attrs held at this point


@dataclass
class _CallSite:
    method: str
    held: frozenset


class LockEngine:
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []
        self.threading_aliases: set[str] = {"threading"}
        self.lock_ctor_names: set[str] = set()  # from threading import Lock
        for node in src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.name == "threading":
                        self.threading_aliases.add(a.asname or "threading")
            elif isinstance(node, ast.ImportFrom) \
                    and node.module == "threading":
                for a in node.names:
                    if a.name in LOCK_TYPES:
                        self.lock_ctor_names.add(a.asname or a.name)

    def run(self) -> list[Finding]:
        for node in self.src.tree.body:
            if isinstance(node, ast.ClassDef):
                self._analyze_class(node)
        return self.findings

    def _emit(self, rule: str, node: ast.AST, message: str,
              scope: str) -> None:
        f = self.src.finding(rule, node, message, scope)
        if f is not None:
            self.findings.append(f)

    def _is_lock_ctor(self, value: ast.AST) -> bool:
        if not isinstance(value, ast.Call):
            return False
        parts = _dotted(value.func)
        if parts is None:
            return False
        if parts[-1] in TIMED_LOCK_TYPES:
            return True
        if len(parts) == 1:
            return parts[0] in self.lock_ctor_names
        return (parts[0] in self.threading_aliases
                and parts[-1] in LOCK_TYPES)

    # -- per-class ---------------------------------------------------------
    def _analyze_class(self, cls: ast.ClassDef) -> None:
        methods = [n for n in cls.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        if not methods:
            return
        # 1) which self attrs are locks
        lock_attrs: set[str] = set()
        for m in methods:
            for node in ast.walk(m):
                if isinstance(node, ast.Assign) \
                        and self._is_lock_ctor(node.value):
                    for t in node.targets:
                        a = _self_attr(t)
                        if a is not None:
                            lock_attrs.add(a)
        if not lock_attrs:
            return

        # 2) scan each method: accesses, call sites, acquire() discipline
        scans = {
            m.name: _MethodScan(self, cls.name, m, lock_attrs)
            for m in methods
        }
        for s in scans.values():
            s.run()

        # 3) fixpoint: methods whose every intra-class call site holds a
        # lock are lock-held throughout (>=1 call site required; __init__
        # call sites count as unlocked — it IS unlocked)
        held_methods: set[str] = set()
        changed = True
        while changed:
            changed = False
            callers: dict[str, list[_CallSite]] = {}
            for name, s in scans.items():
                for cs in s.calls:
                    eff = cs.held or (
                        frozenset(lock_attrs) if name in held_methods
                        else frozenset()
                    )
                    callers.setdefault(cs.method, []).append(
                        _CallSite(cs.method, eff)
                    )
            for name in scans:
                if name in held_methods or name == "__init__":
                    continue
                sites = callers.get(name, [])
                if sites and all(cs.held for cs in sites):
                    held_methods.add(name)
                    changed = True

        # 4) guarded set: attrs written under a lock anywhere
        guarded: dict[str, str] = {}  # attr -> lock attr that guards it
        for name, s in scans.items():
            base = (frozenset(lock_attrs) if name in held_methods
                    else frozenset())
            for acc in s.accesses:
                held = acc.held or base
                if acc.write and held and acc.attr not in lock_attrs:
                    guarded.setdefault(acc.attr, sorted(held)[0])

        # 5) violations: guarded-attr access with no lock held
        for name, s in scans.items():
            if name in ("__init__", "__new__", "__del__"):
                continue
            base = (frozenset(lock_attrs) if name in held_methods
                    else frozenset())
            for acc in s.accesses:
                if acc.attr not in guarded:
                    continue
                if acc.held or base:
                    continue
                lock = guarded[acc.attr]
                kind = "write to" if acc.write else "read of"
                rule = "PIO201" if acc.write else "PIO202"
                self._emit(
                    rule, acc.node,
                    f"{kind} {acc.attr!r} without holding self.{lock} "
                    f"(attribute is written under self.{lock} elsewhere "
                    f"in {cls.name})",
                    f"{cls.name}.{name}",
                )


class _MethodScan:
    """One pass over a method body tracking the held-lock set."""

    def __init__(self, engine: LockEngine, cls_name: str,
                 method, lock_attrs: set[str]):
        self.e = engine
        self.cls_name = cls_name
        self.method = method
        self.lock_attrs = lock_attrs
        self.accesses: list[_Access] = []
        self.calls: list[_CallSite] = []
        self._next_stmt: dict[int, ast.stmt] = {}
        self._acquire_stmts: dict[int, ast.stmt] = {}

    def run(self) -> None:
        self._walk(self.method.body, frozenset(), in_finally=False)

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _walk_pruned(node: ast.AST):
        """ast.walk that does not descend into nested defs/lambdas —
        their bodies run in another execution context, so the enclosing
        lock state proves nothing about them."""
        stack = list(ast.iter_child_nodes(node))
        yield node
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _record_expr(self, node: ast.AST, held: frozenset,
                     in_finally: bool) -> None:
        """Record attribute accesses + call sites inside an expression."""
        nodes = list(self._walk_pruned(node))
        # bases of mutator calls / subscript stores are writes, not reads
        written_bases: set[int] = set()
        for n in nodes:
            if isinstance(n, ast.Call) \
                    and isinstance(n.func, ast.Attribute) \
                    and n.func.attr in MUTATOR_METHODS \
                    and _self_attr(n.func.value) is not None:
                written_bases.add(id(n.func.value))
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.ctx, (ast.Store, ast.Del)) \
                    and _self_attr(n.value) is not None:
                written_bases.add(id(n.value))
        for n in nodes:
            if isinstance(n, ast.Call):
                # self.method(...) call site
                attr = _self_attr(n.func)
                if attr is not None:
                    self.calls.append(_CallSite(attr, held))
                if isinstance(n.func, ast.Attribute):
                    base_attr = _self_attr(n.func.value)
                    # mutator method on self.X -> write access
                    if base_attr is not None \
                            and n.func.attr in MUTATOR_METHODS:
                        self.accesses.append(
                            _Access(base_attr, True, n, held))
                    # PIO203: manual acquire on a lock attr
                    if base_attr in self.lock_attrs \
                            and n.func.attr == "acquire" \
                            and not in_finally:
                        self._check_acquire(n, base_attr, held)
            if isinstance(n, ast.Attribute):
                attr = _self_attr(n)
                if attr is None or id(n) in written_bases:
                    continue
                if isinstance(n.ctx, (ast.Store, ast.Del)):
                    self.accesses.append(_Access(attr, True, n, held))
                elif isinstance(n.ctx, ast.Load):
                    self.accesses.append(_Access(attr, False, n, held))
            if isinstance(n, ast.Subscript) \
                    and isinstance(n.ctx, (ast.Store, ast.Del)):
                attr = _self_attr(n.value)
                if attr is not None:
                    self.accesses.append(_Access(attr, True, n, held))

    def _check_acquire(self, call: ast.Call, lock_attr: str,
                       held: frozenset) -> None:
        """Flag ``self.X.acquire()`` unless the next statement is a
        try whose finally releases it."""
        stmt = self._acquire_stmts.get(id(call))
        ok = False
        if stmt is not None:
            nxt = self._next_stmt.get(id(stmt))
            if isinstance(nxt, ast.Try):
                for fin in nxt.finalbody:
                    for n in ast.walk(fin):
                        if isinstance(n, ast.Call) \
                                and isinstance(n.func, ast.Attribute) \
                                and n.func.attr == "release" \
                                and _self_attr(n.func.value) == lock_attr:
                            ok = True
        if not ok:
            self.e._emit(
                "PIO203", call,
                f"manual self.{lock_attr}.acquire() without an immediate "
                "try/finally release — an exception in between leaks the "
                "lock forever (use `with self." + lock_attr + ":`)",
                f"{self.cls_name}.{self.method.name}",
            )

    # -- statement walk ----------------------------------------------------
    def _walk(self, body: list, held: frozenset, in_finally: bool) -> None:
        # map each acquire-call expression statement to its next sibling
        # so _check_acquire can see the try/finally idiom
        for i, stmt in enumerate(body):
            if i + 1 < len(body):
                self._next_stmt[id(stmt)] = body[i + 1]
            if isinstance(stmt, ast.Expr) \
                    and isinstance(stmt.value, ast.Call):
                self._acquire_stmts[id(stmt.value)] = stmt
        for stmt in body:
            self._walk_stmt(stmt, held, in_finally)

    def _walk_stmt(self, stmt: ast.stmt, held: frozenset,
                   in_finally: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # other execution context; lock state doesn't carry
        if isinstance(stmt, ast.With):
            new_held = set(held)
            for item in stmt.items:
                attr = _self_attr(item.context_expr)
                if attr in self.lock_attrs:
                    new_held.add(attr)
                else:
                    self._record_expr(item.context_expr, held, in_finally)
            self._walk(stmt.body, frozenset(new_held), in_finally)
            return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, held, in_finally)
            for h in stmt.handlers:
                self._walk(h.body, held, in_finally)
            self._walk(stmt.orelse, held, in_finally)
            self._walk(stmt.finalbody, held, in_finally=True)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._record_expr(stmt.test, held, in_finally)
            self._walk(stmt.body, held, in_finally)
            self._walk(stmt.orelse, held, in_finally)
            return
        if isinstance(stmt, ast.For):
            self._record_expr(stmt.iter, held, in_finally)
            self._record_expr(stmt.target, held, in_finally)
            self._walk(stmt.body, held, in_finally)
            self._walk(stmt.orelse, held, in_finally)
            return
        # leaf statements: scan all contained expressions, but do not
        # descend into nested defs (handled above at statement level;
        # expressions can still contain lambdas — ignore their bodies)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            self._record_expr(child, held, in_finally)
