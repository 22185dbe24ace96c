"""piolint event-loop engine (PIO110): blocking calls on loop threads.

The reference's ``predictionio_tpu/analysis/asynclint.py``, unchanged
in what it finds.  The serving edge multiplexes every connection through ONE
selector loop (`server/eventloop.py`); a single blocking call inside a
loop-thread handler stalls every in-flight request at once — the
precise failure mode the event-loop rework exists to remove.  Loop-
thread code is marked: functions carrying the
``@callback_scope`` decorator (``server/eventloop.callback_scope`` —
identity at runtime, a contract for this engine), plus every ``async
def`` coroutine (awaiting blocking calls stalls the asyncio loop the
same way).

Inside that scope the engine flags:

* ``time.sleep(...)`` — resolved through import aliases like the other
  engines (``import time as t`` / ``from time import sleep``);
* blocking socket I/O — ``.recv/.send/.sendall/.accept/.connect`` on a
  name assigned from ``socket.socket(...)`` or
  ``socket.create_connection(...)`` (the taint is deliberately
  name-based and local: the loop core's own non-blocking sockets live
  in unmarked helper methods);
* ``queue.Queue``/``SimpleQueue`` ``.get()``/``.put()`` without a
  ``timeout=`` keyword (and without ``block=False``) on a name
  assigned from a queue constructor — an untimed get parks the loop
  forever if the producer died.

Deliberately NOT flagged: ``selector.select(...)`` (the loop's own
bounded wait), monotonic reads, lock acquisitions (PIO2xx territory),
and anything in nested ``def``s — an inner function defined inside a
callback is deferred work (aux pool / dispatcher), not loop-thread
code.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile

__all__ = ["AsyncEngine"]

SOCKET_BLOCKING_METHODS = {"recv", "recv_into", "send", "sendall",
                           "accept", "connect", "makefile"}
QUEUE_BLOCKING_METHODS = {"get", "put"}
QUEUE_CONSTRUCTORS = {"Queue", "SimpleQueue", "LifoQueue",
                      "PriorityQueue"}
SOCKET_CONSTRUCTORS = {"socket", "create_connection"}
MARKER_DECORATORS = {"callback_scope", "loop_callback"}


def _decorator_name(d: ast.AST) -> str:
    if isinstance(d, ast.Call):
        d = d.func
    if isinstance(d, ast.Name):
        return d.id
    if isinstance(d, ast.Attribute):
        return d.attr
    return ""


class AsyncEngine:
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []
        # import resolution: module aliases + from-imports
        self.time_aliases: set[str] = set()
        self.queue_aliases: set[str] = set()
        self.socket_aliases: set[str] = set()
        self.sleep_names: set[str] = set()
        self.queue_ctor_names: set[str] = set()
        self.socket_ctor_names: set[str] = set()
        for node in src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    alias = a.asname or a.name
                    if a.name == "time":
                        self.time_aliases.add(alias)
                    elif a.name == "queue":
                        self.queue_aliases.add(alias)
                    elif a.name == "socket":
                        self.socket_aliases.add(alias)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "time":
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
        # module-level taints (a loop class often builds its queue in
        # __init__ and drains it in a marked callback — attribute
        # taints are tracked per class too, conservatively by name)
        self.module_queues, self.module_sockets = self._taints(src.tree)

    # -- taint collection --------------------------------------------------
    def _ctor_kind(self, call: ast.AST):
        """'queue' | 'socket' | None for a constructor call node."""
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
            if (fn.value.id in self.queue_aliases
                    and fn.attr in QUEUE_CONSTRUCTORS):
                return "queue"
            if (fn.value.id in self.socket_aliases
                    and fn.attr in SOCKET_CONSTRUCTORS):
                return "socket"
        return None

    @staticmethod
    def _target_names(target: ast.AST):
        """Name or self.attr assignment targets as taintable strings."""
        if isinstance(target, ast.Name):
            yield target.id
        elif isinstance(target, ast.Attribute):
            yield target.attr  # self._q = Queue() taints "_q"

    def _taints(self, scope: ast.AST) -> tuple[set[str], set[str]]:
        queues: set[str] = set()
        sockets: set[str] = set()
        for n in ast.walk(scope):
            if isinstance(n, ast.Assign):
                kind = self._ctor_kind(n.value)
                if kind is None:
                    continue
                for t in n.targets:
                    for name in self._target_names(t):
                        (queues if kind == "queue" else sockets).add(name)
        return queues, sockets

    # -- scope walk --------------------------------------------------------
    @staticmethod
    def _own_nodes(scope: ast.AST):
        """Walk without descending into nested defs: an inner function
        is deferred work, not loop-thread code."""
        stack = list(ast.iter_child_nodes(scope))
        while stack:
            n = stack.pop()
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda, ast.ClassDef)):
                continue
            yield n
            stack.extend(ast.iter_child_nodes(n))

    def _in_scope_functions(self):
        for node in self.src.walk():
            if not isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)):
                continue
            if isinstance(node, ast.AsyncFunctionDef):
                yield node, "coroutine"
                continue
            if any(_decorator_name(d) in MARKER_DECORATORS
                   for d in node.decorator_list):
                yield node, "@callback_scope"

    def run(self) -> list[Finding]:
        for fn, kind in self._in_scope_functions():
            q_taint, s_taint = self._taints(fn)
            q_taint |= self.module_queues
            s_taint |= self.module_sockets
            for n in self._own_nodes(fn):
                if not isinstance(n, ast.Call):
                    continue
                self._check_call(n, fn.name, kind, q_taint, s_taint)
        return self.findings

    # -- checks ------------------------------------------------------------
    def _is_sleep(self, call: ast.Call) -> bool:
        f = call.func
        if isinstance(f, ast.Name):
            return f.id in self.sleep_names
        return (isinstance(f, ast.Attribute) and f.attr == "sleep"
                and isinstance(f.value, ast.Name)
                and f.value.id in self.time_aliases)

    @staticmethod
    def _receiver(call: ast.Call):
        """The name a method call's receiver resolves to: ``q.get()``
        -> 'q'; ``self._q.get()`` -> '_q'."""
        f = call.func
        if not isinstance(f, ast.Attribute):
            return None, None
        v = f.value
        if isinstance(v, ast.Name):
            return v.id, f.attr
        if isinstance(v, ast.Attribute):
            return v.attr, f.attr
        return None, None

    @staticmethod
    def _has_nonblocking_kw(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "timeout":
                return True
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True
        return False

    def _check_call(self, call: ast.Call, scope: str, kind: str,
                    q_taint: set, s_taint: set) -> None:
        if self._is_sleep(call):
            self._flag(call, scope,
                       f"time.sleep inside {kind} {scope!r} stalls every "
                       "connection on the loop — defer to the aux pool "
                       "or schedule a wakeup instead")
            return
        recv, meth = self._receiver(call)
        if recv is None:
            return
        if recv in q_taint and meth in QUEUE_BLOCKING_METHODS \
                and not self._has_nonblocking_kw(call):
            self._flag(call, scope,
                       f"queue .{meth}() without timeout inside {kind} "
                       f"{scope!r}: if the producer died this parks the "
                       "loop forever — pass timeout= or block=False")
        elif recv in s_taint and meth in SOCKET_BLOCKING_METHODS:
            self._flag(call, scope,
                       f"blocking socket .{meth}() inside {kind} "
                       f"{scope!r}: loop-thread sockets must be "
                       "non-blocking and selector-driven")

    def _flag(self, node: ast.AST, scope: str, message: str) -> None:
        f = self.src.finding("PIO110", node, message, scope)
        if f is not None:
            self.findings.append(f)
