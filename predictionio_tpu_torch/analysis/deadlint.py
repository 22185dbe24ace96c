"""piolint deadlock engine (PIO210–213): whole-program lock analysis.

The reference's ``predictionio_tpu/analysis/deadlint.py``, unchanged
in what it finds.

`locklint.py` answers "is this attribute touched without its lock"
class by class; this engine answers the questions that need the whole
program at once — the bug class of a failed WAL group flush wedging
every later ``barrier()`` and of callbacks fired at the end of a
dispatch turn:

* **PIO210 lock-order inversion.**  Every ``with self._X`` /
  ``self._X.acquire()`` on a `threading.Lock`/`RLock`/`Condition`
  attribute is an acquisition of the class-qualified lock
  ``Class._X``.  Acquisitions reachable while another lock is held —
  directly, or through a bounded-depth interprocedural walk over
  ``self.method()`` calls and ``self._attr.method()`` calls whose
  receiver type is known from a constructor assignment
  (``self._wal = GroupCommitWAL(...)``) — become edges in a lock-order
  graph.  A cycle is a deadlock waiting for the right interleaving;
  the finding prints BOTH witness paths (file:line frames) so the fix
  is mechanical: pick one order.
* **PIO211 callback under lock.**  A user-supplied callable — a
  parameter or attribute named like a callback (``on_done``,
  ``weight_fn``, ``batch_fn``, ``*_hook``, ``*_cb``, fault hooks,
  health probes) or a local assigned from one — is invoked while a
  lock is statically held.  The callee can take any lock or block
  forever; the exact shape of the callback bugs above.
* **PIO212 blocking under lock.**  asynclint's blocking-call taxonomy
  (``time.sleep``, blocking socket I/O, untimed ``Queue.get/put``)
  plus ``os.fsync``, ``open()``, ``subprocess.*`` and untimed
  ``Event.wait()``, scoped to lock-held regions instead of coroutines.
  ``Condition.wait`` on the *held* condition is exempt — it releases
  the lock; that is PIO213's territory.
* **PIO213 condition-variable discipline.**  An untimed ``cv.wait()``
  not wrapped in a loop (a single wait is a missed-wakeup/spurious-
  wakeup bug), a ``wait``/``wait_for`` without holding the condition's
  lock, and ``notify``/``notify_all`` off-lock.  ``Condition(lock)``
  aliasing is tracked: holding ``self._lock`` counts as holding a
  ``self._cv`` built from it, and vice versa.

Precision notes shared with locklint: ``__init__``/``__del__`` are
exempt (construction happens-before sharing); explicit
``self._X.release()`` / ``.acquire()`` statements update the running
held set (the release-around-device-call idiom in
``MicroBatcher._lead`` analyzes as UNLOCKED across the device call);
nested ``def``/``lambda`` bodies are pruned (other execution context);
helper methods are analyzed with the *intersection* of the lock sets
their intra-class call sites hold, computed to fixpoint (so
``_claim_locked``-style helpers inherit the dispatcher's lock without
fabricating locks they are never actually under).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Optional

from .asynclint import (
    QUEUE_BLOCKING_METHODS,
    QUEUE_CONSTRUCTORS,
    SOCKET_BLOCKING_METHODS,
    SOCKET_CONSTRUCTORS,
    AsyncEngine,
)
from .core import Finding, SourceFile
from .locklint import LOCK_TYPES, _dotted, _self_attr

__all__ = ["DeadlockEngine"]

# parameter / attribute names that mean "someone else's code"
CALLBACK_NAME_RE = re.compile(
    r"^(?:on_[a-z0-9_]+"
    r"|[a-z0-9_]*_(?:fn|fns|hook|hooks|cb|cbs|callback|callbacks"
    r"|probe|probes)"
    r"|fn|callback|hook|probe)$"
)

SUBPROCESS_BLOCKING = {"run", "call", "check_call", "check_output",
                       "Popen"}

# interprocedural call-chain bound: deep enough for dispatcher ->
# helper -> other-class -> helper, cheap enough to stay O(methods)
MAX_CALL_DEPTH = 6


def _frame(src: SourceFile, node: ast.AST, desc: str) -> tuple:
    return (src, getattr(node, "lineno", 1), desc)


def _fmt_chain(chain: list[tuple]) -> str:
    return " -> ".join(
        f"{src.rel_path}:{line} {desc}" for src, line, desc in chain
    )


@dataclass
class _Acquire:
    lock: str            # canonical own-class lock attr
    node: ast.AST
    held: frozenset      # canonical own-class lock attrs held before


@dataclass
class _Call:
    kind: str            # "self" | "attr"
    recv: Optional[str]  # receiver attr for kind="attr"
    method: str
    node: ast.AST
    held: frozenset


@dataclass
class _Flag:
    rule: str
    node: ast.AST
    held: frozenset
    message: str         # may contain {lock}


@dataclass
class _CvEvent:
    kind: str            # "wait" | "wait_for" | "notify"
    attr: str            # the condition attribute (pre-canonical)
    node: ast.AST
    held: frozenset
    in_loop: bool
    timed: bool


class _FileCtx:
    """Per-file import/taint resolution shared by every class in it.
    One walk over the tree collects everything: asynclint's sleep/
    queue/socket taxonomy plus os/subprocess/threading resolution."""

    def __init__(self, src: SourceFile):
        self.src = src
        self.os_aliases: set[str] = set()
        self.subprocess_aliases: set[str] = set()
        self.subprocess_names: set[str] = set()
        self.event_ctor_names: set[str] = set()
        self.threading_aliases: set[str] = {"threading"}
        self.lock_ctor_names: set[str] = set()
        self.time_aliases: set[str] = set()
        self.sleep_names: set[str] = set()
        self.queue_aliases: set[str] = set()
        self.socket_aliases: set[str] = set()
        self.queue_ctor_names: set[str] = set()
        self.socket_ctor_names: set[str] = set()
        self.queues: set[str] = set()    # names/attrs built from Queue()
        self.sockets: set[str] = set()
        assigns: list[ast.Assign] = []
        for node in src.walk():
            if isinstance(node, ast.Assign):
                assigns.append(node)
            elif isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name
                    if a.name == "os":
                        self.os_aliases.add(alias)
                    elif a.name == "subprocess":
                        self.subprocess_aliases.add(alias)
                    elif a.name == "threading":
                        self.threading_aliases.add(alias)
                    elif a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "queue":
                        self.queue_aliases.add(alias)
                    elif a.name == "socket":
                        self.socket_aliases.add(alias)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "subprocess":
                    for a in node.names:
                        if a.name in SUBPROCESS_BLOCKING:
                            self.subprocess_names.add(a.asname or a.name)
                elif node.module == "threading":
                    for a in node.names:
                        if a.name in LOCK_TYPES:
                            self.lock_ctor_names.add(a.asname or a.name)
                        elif a.name == "Event":
                            self.event_ctor_names.add(a.asname or a.name)
                elif node.module == "time":
                    for a in node.names:
                        if a.name == "sleep":
                            self.sleep_names.add(a.asname or a.name)
                elif node.module == "queue":
                    for a in node.names:
                        if a.name in QUEUE_CONSTRUCTORS:
                            self.queue_ctor_names.add(a.asname or a.name)
                elif node.module == "socket":
                    for a in node.names:
                        if a.name in SOCKET_CONSTRUCTORS:
                            self.socket_ctor_names.add(a.asname or a.name)
        for n in assigns:
            kind = self._ctor_kind(n.value)
            if kind is None:
                continue
            for t in n.targets:
                name = None
                if isinstance(t, ast.Name):
                    name = t.id
                elif isinstance(t, ast.Attribute):
                    name = t.attr       # self._q = Queue() taints "_q"
                if name is not None:
                    (self.queues if kind == "queue"
                     else self.sockets).add(name)

    def _ctor_kind(self, call: ast.AST) -> Optional[str]:
        if not isinstance(call, ast.Call):
            return None
        fn = call.func
        if isinstance(fn, ast.Name):
            if fn.id in self.queue_ctor_names:
                return "queue"
            if fn.id in self.socket_ctor_names:
                return "socket"
            return None
        if isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name):
            if fn.value.id in self.queue_aliases \
                    and fn.attr in QUEUE_CONSTRUCTORS:
                return "queue"
            if fn.value.id in self.socket_aliases \
                    and fn.attr in SOCKET_CONSTRUCTORS:
                return "socket"
        return None

    def is_sleep(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in self.sleep_names
        return (isinstance(f, ast.Attribute) and f.attr == "sleep"
                and isinstance(f.value, ast.Name)
                and f.value.id in self.time_aliases)

    def ctor_name(self, value: ast.AST) -> Optional[str]:
        """The dotted-last constructor name of ``X(...)`` / ``m.X(...)``,
        or None when the value is not a call on a name."""
        if not isinstance(value, ast.Call):
            return None
        parts = _dotted(value.func)
        return parts[-1] if parts else None

    def lock_kind(self, value: ast.AST) -> Optional[str]:
        """'Lock'/'RLock'/'Condition'/'Event' for a threading ctor call."""
        if not isinstance(value, ast.Call):
            return None
        parts = _dotted(value.func)
        if parts is None:
            return None
        # obs/scope.py instrumented drop-ins keep monitor semantics
        if parts[-1] == "TimedLock":
            return "RLock"
        if parts[-1] == "TimedCondition":
            return "Condition"
        if len(parts) == 1:
            if parts[0] in self.lock_ctor_names:
                return parts[0]
            if parts[0] in self.event_ctor_names:
                return "Event"
            return None
        if parts[0] in self.threading_aliases:
            if parts[-1] in LOCK_TYPES:
                return parts[-1]
            if parts[-1] == "Event":
                return "Event"
        return None


class _ClassInfo:
    def __init__(self, ctx: _FileCtx, node: ast.ClassDef):
        self.ctx = ctx
        self.src = ctx.src
        self.node = node
        self.name = node.name
        self.bases = [p[-1] for p in
                      (_dotted(b) for b in node.bases) if p]
        self.lock_attrs: set[str] = set()
        self.cond_attrs: set[str] = set()
        self.event_attrs: set[str] = set()
        self.alias: dict[str, str] = {}      # cv attr -> underlying lock
        self.owner: dict[str, str] = {}      # lock attr -> defining class
        self.attr_types: dict[str, str] = {}
        self.cb_attrs: set[str] = set()
        self.methods: dict[str, ast.FunctionDef] = {}
        self.scans: dict[str, "_MethodScan"] = {}
        self.entry_held: dict[str, frozenset] = {}
        self._collect()

    # -- collection --------------------------------------------------------
    def _collect(self) -> None:
        for m in self.node.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[m.name] = m
        for m in self.methods.values():
            cb_params = {a.arg for a in m.args.args + m.args.kwonlyargs
                         if CALLBACK_NAME_RE.match(a.arg)}
            # param annotations type peer attrs: __init__(self, reg:
            # "TenantRegistry") ... self._reg = reg
            ann: dict[str, str] = {}
            for a in m.args.args + m.args.kwonlyargs:
                if a.annotation is None:
                    continue
                t = a.annotation
                if isinstance(t, ast.Constant) and isinstance(t.value, str):
                    name = t.value.split(".")[-1].strip()
                    if name.isidentifier():
                        ann[a.arg] = name
                else:
                    parts = _dotted(t)
                    if parts:
                        ann[a.arg] = parts[-1]
            for node in ast.walk(m):
                if not isinstance(node, ast.Assign):
                    continue
                kind = self.ctx.lock_kind(node.value)
                ctor = self.ctx.ctor_name(node.value)
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is None:
                        # self._fns[key] = weight_fn taints the dict attr
                        if isinstance(t, ast.Subscript):
                            base = _self_attr(t.value)
                            if base is not None and isinstance(
                                node.value, ast.Name
                            ) and node.value.id in cb_params:
                                self.cb_attrs.add(base)
                        continue
                    if kind in ("Lock", "RLock", "Condition"):
                        self.lock_attrs.add(attr)
                        if kind == "Condition":
                            self.cond_attrs.add(attr)
                            # Condition(self._lock) /
                            # TimedCondition(name, lock=self._lock):
                            # holding either is holding both
                            cand = None
                            for kw in node.value.keywords:
                                if kw.arg == "lock":
                                    cand = kw.value
                            if cand is None:
                                args = node.value.args
                                idx = 1 if self.ctx.ctor_name(
                                    node.value) == "TimedCondition" else 0
                                if len(args) > idx:
                                    cand = args[idx]
                            if cand is not None:
                                under = _self_attr(cand)
                                if under is not None:
                                    self.alias[attr] = under
                    elif kind == "Event":
                        self.event_attrs.add(attr)
                    elif ctor is not None and ctor[:1].isupper():
                        self.attr_types.setdefault(attr, ctor)
                    elif isinstance(node.value, ast.Name) \
                            and node.value.id in ann:
                        self.attr_types.setdefault(
                            attr, ann[node.value.id])
                    if isinstance(node.value, ast.Name) \
                            and node.value.id in cb_params:
                        self.cb_attrs.add(attr)
                    if CALLBACK_NAME_RE.match(attr):
                        self.cb_attrs.add(attr)
        # aliases of non-locks are meaningless
        self.alias = {cv: lk for cv, lk in self.alias.items()
                      if lk in self.lock_attrs}
        for attr in self.lock_attrs:
            self.owner[attr] = self.name

    def canon(self, attr: str) -> str:
        """Canonical lock identity: a Condition built on another lock
        IS that lock for held/order purposes."""
        return self.alias.get(attr, attr)

    def qual(self, attr: str) -> str:
        c = self.canon(attr)
        return f"{self.owner.get(c, self.name)}.{c}"

    def inherit(self, ancestors: list["_ClassInfo"]) -> None:
        """Fold base-class state in: a subclass shares its parent's
        locks, conditions, aliases, typed attrs and callback attrs
        (``SharedBatcher`` guards with ``MicroBatcher``'s ``_cond``)."""
        for anc in ancestors:
            self.lock_attrs |= anc.lock_attrs
            self.cond_attrs |= anc.cond_attrs
            self.event_attrs |= anc.event_attrs
            self.cb_attrs |= anc.cb_attrs
            for cv, lk in anc.alias.items():
                self.alias.setdefault(cv, lk)
            for attr, owner in anc.owner.items():
                self.owner.setdefault(attr, owner)
            for attr, t in anc.attr_types.items():
                self.attr_types.setdefault(attr, t)

    # -- analysis ----------------------------------------------------------
    def scan(self, entry: dict[str, frozenset]) -> None:
        """(Re)scan every method, seeding each walker's running held
        set with the method's entry locks so explicit ``.release()``
        statements subtract inherited holds too (``MicroBatcher._lead``
        releases around the device call a lock it was CALLED with)."""
        if not (self.lock_attrs or self.cond_attrs):
            return
        self.entry_held = entry
        for name, m in self.methods.items():
            s = _MethodScan(self, m)
            s.run(entry.get(name, frozenset()))
            self.scans[name] = s


class _MethodScan:
    """Ordered walk of one method body tracking the running held set,
    including explicit ``.release()``/``.acquire()`` statements."""

    def __init__(self, cls: _ClassInfo, fn):
        self.cls = cls
        self.ctx = cls.ctx
        self.fn = fn
        self.acquires: list[_Acquire] = []
        self.calls: list[_Call] = []
        self.flags: list[_Flag] = []
        self.cv_events: list[_CvEvent] = []
        self.cb_locals: set[str] = {
            a.arg for a in fn.args.args + fn.args.kwonlyargs
            if CALLBACK_NAME_RE.match(a.arg)
        }

    def run(self, seed: frozenset = frozenset()) -> None:
        self._walk(self.fn.body, set(seed), in_loop=False)

    # -- helpers -----------------------------------------------------------
    def _held(self, held: set) -> frozenset:
        return frozenset(self.cls.canon(a) for a in held)

    def _lock_of(self, expr: ast.AST) -> Optional[str]:
        attr = _self_attr(expr)
        if attr is not None and attr in self.cls.lock_attrs:
            return self.cls.canon(attr)
        return None

    @staticmethod
    def _pruned(node: ast.AST):
        stack = [node]
        while stack:
            n = stack.pop()
            yield n
            for c in ast.iter_child_nodes(n):
                if isinstance(c, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                    continue
                stack.append(c)

    def _mentions_cb_attr(self, expr: ast.AST) -> bool:
        for n in self._pruned(expr):
            a = _self_attr(n) if isinstance(n, ast.Attribute) else None
            if a is not None and a in self.cls.cb_attrs:
                return True
        return False

    @staticmethod
    def _untimed(call: ast.Call) -> bool:
        if call.args:
            return False
        return not any(kw.arg == "timeout" for kw in call.keywords)

    # -- statement walk ----------------------------------------------------
    def _walk(self, body: list, held: set, in_loop: bool) -> None:
        for stmt in body:
            self._stmt(stmt, held, in_loop)

    def _stmt(self, stmt: ast.stmt, held: set, in_loop: bool) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return
        if isinstance(stmt, ast.With):
            inner = set(held)
            for item in stmt.items:
                lock = self._lock_of(item.context_expr)
                if lock is not None:
                    self.acquires.append(_Acquire(
                        lock, item.context_expr, self._held(inner)))
                    inner.add(lock)
                else:
                    self._expr(item.context_expr, held, in_loop)
            self._walk(stmt.body, inner, in_loop)
            return
        if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            call = stmt.value
            if isinstance(call.func, ast.Attribute):
                lock = self._lock_of(call.func.value)
                if lock is not None and call.func.attr == "acquire":
                    self.acquires.append(_Acquire(
                        lock, call, self._held(held)))
                    held.add(lock)
                    return
                if lock is not None and call.func.attr == "release":
                    held.discard(lock)
                    return
        if isinstance(stmt, ast.Try):
            self._walk(stmt.body, held, in_loop)
            for h in stmt.handlers:
                self._walk(h.body, held, in_loop)
            self._walk(stmt.orelse, held, in_loop)
            self._walk(stmt.finalbody, held, in_loop)
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, held, in_loop)
            self._walk(stmt.body, set(held), in_loop)
            self._walk(stmt.orelse, set(held), in_loop)
            return
        if isinstance(stmt, (ast.While,)):
            self._expr(stmt.test, held, in_loop)
            self._walk(stmt.body, held, in_loop=True)
            self._walk(stmt.orelse, held, in_loop)
            return
        if isinstance(stmt, ast.For):
            self._expr(stmt.iter, held, in_loop)
            # for fn in self._hooks: taints the loop variable
            if isinstance(stmt.target, ast.Name) \
                    and self._mentions_cb_attr(stmt.iter):
                self.cb_locals.add(stmt.target.id)
            self._walk(stmt.body, held, in_loop=True)
            self._walk(stmt.orelse, held, in_loop)
            return
        if isinstance(stmt, ast.Assign):
            # fn = self._weight_fns.get(tenant) taints the local
            for t in stmt.targets:
                if isinstance(t, ast.Name) \
                        and self._mentions_cb_attr(stmt.value):
                    self.cb_locals.add(t.id)
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                continue
            self._expr(child, held, in_loop)

    # -- expression scan ---------------------------------------------------
    def _expr(self, node: ast.AST, held: set, in_loop: bool) -> None:
        h = self._held(held)
        for n in self._pruned(node):
            if isinstance(n, ast.Call):
                self._call(n, h, in_loop)

    def _call(self, call: ast.Call, held: frozenset,
              in_loop: bool) -> None:
        ctx = self.ctx
        cls = self.cls
        f = call.func
        # time.sleep / from time import sleep (asynclint resolution)
        if ctx.is_sleep(call):
            self.flags.append(_Flag(
                "PIO212", call, held,
                "time.sleep while holding {lock} makes every waiter "
                "eat the sleep — release first or move the wait to a "
                "timed Condition.wait"))
            return
        if isinstance(f, ast.Name):
            if f.id == "open":
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    "file I/O (open) while holding {lock}"))
                return
            if f.id in ctx.subprocess_names:
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"subprocess {f.id}() while holding {{lock}}"))
                return
            if f.id in self.cb_locals:
                self.flags.append(_Flag(
                    "PIO211", call, held,
                    f"user-supplied callable {f.id!r} invoked while "
                    "holding {lock} — the callee can take any lock or "
                    "block; call it after release"))
                return
            return
        if not isinstance(f, ast.Attribute):
            return
        parts = _dotted(f)
        if parts and len(parts) >= 2:
            if parts[0] in ctx.os_aliases and parts[-1] == "fsync":
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    "os.fsync while holding {lock} — a disk stall "
                    "blocks every thread behind the lock"))
                return
            if parts[0] in ctx.subprocess_aliases \
                    and parts[-1] in SUBPROCESS_BLOCKING:
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"subprocess.{parts[-1]}() while holding {{lock}}"))
                return
        self_attr = _self_attr(f)
        if self_attr is not None:
            # self.on_done(...): direct callback attr invocation
            if self_attr in cls.cb_attrs:
                self.flags.append(_Flag(
                    "PIO211", call, held,
                    f"user-supplied callable self.{self_attr} invoked "
                    "while holding {lock} — call it after release"))
            else:
                self.calls.append(_Call(
                    "self", None, self_attr, call, held))
            return
        recv_attr = _self_attr(f.value)
        meth = f.attr
        if recv_attr is not None:
            if recv_attr in cls.cond_attrs:
                if meth in ("wait", "wait_for"):
                    self.cv_events.append(_CvEvent(
                        meth, recv_attr, call, held, in_loop,
                        timed=not self._untimed(call)))
                    return
                if meth in ("notify", "notify_all"):
                    self.cv_events.append(_CvEvent(
                        "notify", recv_attr, call, held, in_loop,
                        timed=False))
                    return
            if recv_attr in cls.event_attrs and meth == "wait" \
                    and self._untimed(call):
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"untimed self.{recv_attr}.wait() while holding "
                    "{lock} — if the setter needs this lock, this "
                    "never wakes"))
                return
            if meth == "fsync":
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"self.{recv_attr}.fsync() while holding {{lock}}"))
                return
        # queue/socket taints (asynclint name- and attr-level)
        recv_name = recv_attr
        if recv_name is None and isinstance(f.value, ast.Name):
            recv_name = f.value.id
        if recv_name is not None:
            if recv_name in ctx.queues \
                    and meth in QUEUE_BLOCKING_METHODS \
                    and not AsyncEngine._has_nonblocking_kw(call):
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"untimed queue .{meth}() while holding {{lock}} — "
                    "if the peer needs this lock, this deadlocks"))
                return
            if recv_name in ctx.sockets \
                    and meth in SOCKET_BLOCKING_METHODS:
                self.flags.append(_Flag(
                    "PIO212", call, held,
                    f"blocking socket .{meth}() while holding {{lock}}"))
                return
        if recv_attr is not None:
            self.calls.append(_Call("attr", recv_attr, meth, call, held))


class DeadlockEngine:
    """Whole-program pass; hand it every SourceFile in scope at once
    (a single file is a one-file program — fixtures work unchanged)."""

    def __init__(self, srcs: list[SourceFile]):
        self.srcs = srcs
        self.findings: list[Finding] = []
        self.classes: list[_ClassInfo] = []
        # bare class name -> info; None marks an ambiguous (duplicate)
        # name we refuse to resolve through
        self.index: dict[str, Optional[_ClassInfo]] = {}
        self._acq_memo: dict[tuple[str, str], list] = {}

    def run(self) -> list[Finding]:
        for src in self.srcs:
            ctx = _FileCtx(src)
            for node in src.tree.body:
                if isinstance(node, ast.ClassDef):
                    info = _ClassInfo(ctx, node)
                    self.classes.append(info)
                    if info.name in self.index:
                        self.index[info.name] = None
                    else:
                        self.index[info.name] = info
        ancestors = {info.name: self._ancestors(info, {info.name})
                     for info in self.classes}
        for info in self.classes:
            info.inherit(ancestors[info.name])
        self._scan_to_fixpoint(ancestors)
        for info in self.classes:
            self._flag_class(info)
        self._lock_order()
        return self.findings

    def _ancestors(self, info: _ClassInfo, seen: set
                   ) -> list[_ClassInfo]:
        out: list[_ClassInfo] = []
        for base in info.bases:
            b = self.index.get(base)
            if b is not None and b.name not in seen:
                seen.add(b.name)
                out.append(b)
                out.extend(self._ancestors(b, seen))
        return out

    def _scan_to_fixpoint(self, ancestors: dict) -> None:
        """Iterate (scan with entry sets; recompute entry sets) until
        stable.  entry[m] = intersection of the ABSOLUTE held sets at
        every intra-class call site of m — own class and ancestors,
        since ``self.m()`` in a parent dispatches to the override
        (``MicroBatcher`` calls ``self._claim_locked()`` under
        ``_cond``; ``SharedBatcher._claim_locked`` runs lock-held).
        Methods nobody calls intra-class are API surface: unlocked.
        Starts from ∅ and grows one call-chain level per round, so the
        bound is the deepest helper chain, capped defensively."""
        entry: dict[str, dict[str, frozenset]] = {
            info.name: {} for info in self.classes
        }
        scanned: set[str] = set()
        for _ in range(10):
            for info in self.classes:
                # rescan only classes whose entry sets changed — most
                # converge immediately (all-∅ entries)
                if info.name in scanned \
                        and info.entry_held == entry[info.name]:
                    continue
                info.scan(entry[info.name])
                scanned.add(info.name)
            new: dict[str, dict[str, frozenset]] = {}
            for info in self.classes:
                sites: dict[str, list[frozenset]] = {}
                for holder in [info] + ancestors[info.name]:
                    for s in holder.scans.values():
                        for ev in s.calls:
                            if ev.kind == "self" \
                                    and ev.method in info.scans:
                                sites.setdefault(ev.method, []).append(
                                    ev.held)
                cur: dict[str, frozenset] = {}
                for name in info.scans:
                    if name == "__init__" or name not in sites:
                        cur[name] = frozenset()
                        continue
                    eff = sites[name][0]
                    for h in sites[name][1:]:
                        eff = eff & h
                    # only this class's own locks are meaningful seeds
                    cur[name] = eff & frozenset(
                        info.canon(a) for a in info.lock_attrs)
                new[info.name] = cur
            if new == entry:
                return
            entry = new

    # -- per-class rules (PIO211/212/213) ----------------------------------
    def _emit(self, src: SourceFile, rule: str, node: ast.AST,
              message: str, scope: str) -> None:
        f = src.finding(rule, node, message, scope)
        if f is not None:
            self.findings.append(f)

    def _flag_class(self, info: _ClassInfo) -> None:
        for name in sorted(info.scans):
            if name in ("__init__", "__new__", "__del__"):
                continue
            s = info.scans[name]
            scope = f"{info.name}.{name}"
            for fl in s.flags:
                if not fl.held:
                    continue
                lock = f"self.{sorted(fl.held)[0]}"
                self._emit(info.src, fl.rule, fl.node,
                           fl.message.format(lock=lock), scope)
            for ev in s.cv_events:
                eff = ev.held
                cv_lock = info.canon(ev.attr)
                if ev.kind == "notify":
                    if cv_lock not in eff:
                        self._emit(
                            info.src, "PIO213", ev.node,
                            f"self.{ev.attr}.notify() without holding "
                            f"self.{cv_lock} — the waiter can miss the "
                            "wakeup between its predicate check and its "
                            "wait()", scope)
                    continue
                if cv_lock not in eff:
                    self._emit(
                        info.src, "PIO213", ev.node,
                        f"self.{ev.attr}.{ev.kind}() without holding "
                        f"self.{cv_lock} (RuntimeError at runtime; "
                        "take the condition first)", scope)
                    continue
                if ev.kind == "wait" and not ev.timed and not ev.in_loop:
                    self._emit(
                        info.src, "PIO213", ev.node,
                        f"untimed self.{ev.attr}.wait() outside a "
                        "predicate loop — spurious wakeups and missed "
                        "notifies require `while not pred: cv.wait()`",
                        scope)

    # -- PIO210: lock-order graph ------------------------------------------
    def _resolve(self, info: _ClassInfo, ev: _Call
                 ) -> Optional[tuple[_ClassInfo, str]]:
        """(class, method) a call event dispatches to, when knowable."""
        if ev.kind == "self":
            return self._lookup_method(info, ev.method, set())
        tname = info.attr_types.get(ev.recv)
        if tname is None:
            return None
        target = self.index.get(tname)
        if target is None:
            return None
        return self._lookup_method(target, ev.method, set())

    def _lookup_method(self, info: _ClassInfo, method: str,
                       seen: set) -> Optional[tuple[_ClassInfo, str]]:
        if info.name in seen:
            return None
        seen.add(info.name)
        if method in info.scans:
            return (info, method)
        for base in info.bases:
            b = self.index.get(base)
            if b is not None:
                got = self._lookup_method(b, method, seen)
                if got is not None:
                    return got
        return None

    def _acquired_in(self, info: _ClassInfo, method: str,
                     depth: int, visiting: set) -> list[tuple[str, list]]:
        """Locks (qualified) acquired in ``method`` or transitively in
        resolvable callees, each with a witness chain of frames."""
        key = (info.name, method)
        if key in self._acq_memo:
            return self._acq_memo[key]
        if key in visiting or depth > MAX_CALL_DEPTH:
            return []
        visiting.add(key)
        out: dict[str, list] = {}
        s = info.scans.get(method)
        if s is not None:
            for a in s.acquires:
                q = info.qual(a.lock)
                out.setdefault(q, [_frame(
                    info.src, a.node,
                    f"{info.name}.{method} acquires {q}")])
            for ev in s.calls:
                target = self._resolve(info, ev)
                if target is None:
                    continue
                t_info, t_method = target
                frame = _frame(
                    info.src, ev.node,
                    f"{info.name}.{method} calls "
                    f"{t_info.name}.{t_method}")
                for q, chain in self._acquired_in(
                        t_info, t_method, depth + 1, visiting):
                    if q not in out or len(out[q]) > 1 + len(chain):
                        out[q] = [frame] + chain
        visiting.discard(key)
        result = sorted(out.items())
        if not visiting:
            # only outermost results are complete (an in-cycle result
            # is truncated by the visiting guard) — memoize just those
            self._acq_memo[key] = result
        return result

    def _lock_order(self) -> None:
        edges: dict[str, dict[str, list]] = {}

        def add_edge(a: str, b: str, chain: list) -> None:
            if a == b:
                return
            bucket = edges.setdefault(a, {})
            if b not in bucket or len(chain) < len(bucket[b]):
                bucket[b] = chain

        for info in self.classes:
            for name in sorted(info.scans):
                s = info.scans[name]
                for a in s.acquires:
                    q = info.qual(a.lock)
                    for h in a.held:
                        add_edge(info.qual(h), q, [_frame(
                            info.src, a.node,
                            f"{info.name}.{name} acquires {q} while "
                            f"holding {info.qual(h)}")])
                for ev in s.calls:
                    eff = ev.held
                    if not eff:
                        continue
                    target = self._resolve(info, ev)
                    if target is None:
                        continue
                    t_info, t_method = target
                    frame = _frame(
                        info.src, ev.node,
                        f"{info.name}.{name} calls "
                        f"{t_info.name}.{t_method}")
                    for q, chain in self._acquired_in(
                            t_info, t_method, 1, set()):
                        for h in eff:
                            add_edge(info.qual(h), q, [frame] + chain)

        reported: set[frozenset] = set()
        for a in sorted(edges):
            for b in sorted(edges[a]):
                path = self._find_path(edges, b, a)
                if path is None:
                    continue
                nodes = frozenset([a, b] + path)
                if nodes in reported:
                    continue
                reported.add(nodes)
                forward = edges[a][b]
                back_chain: list = []
                hops = [b] + path
                for i in range(len(hops) - 1):
                    back_chain += edges[hops[i]][hops[i + 1]]
                src, line, _ = forward[0]
                cyc = " -> ".join([a, b] + path)
                self._emit(
                    src, "PIO210", _Node(line),
                    f"lock-order inversion: {cyc}; "
                    f"path 1 [{a} then {b}]: {_fmt_chain(forward)}; "
                    f"path 2 [{b} back to {a}]: {_fmt_chain(back_chain)}"
                    " — pick one acquisition order",
                    "")

    @staticmethod
    def _find_path(edges: dict, start: str, goal: str
                   ) -> Optional[list[str]]:
        """BFS path start -> goal, returned as the node list AFTER
        start (ending with goal); None when unreachable."""
        from collections import deque

        prev: dict[str, str] = {}
        q = deque([start])
        seen = {start}
        while q:
            n = q.popleft()
            for m in edges.get(n, {}):
                if m in seen:
                    continue
                prev[m] = n
                if m == goal:
                    path = [goal]
                    while path[-1] != start:
                        path.append(prev[path[-1]])
                    return list(reversed(path))[1:]
                seen.add(m)
                q.append(m)
        return None


class _Node:
    """A minimal AST-node stand-in carrying just a location (cycle
    findings anchor to the first frame of their forward witness)."""

    def __init__(self, lineno: int):
        self.lineno = lineno
        self.col_offset = 0
