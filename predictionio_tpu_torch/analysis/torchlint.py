"""piolint torch engine (PIO101–104, PIO106, PIO108): traced-code
hazards, found statically.

This is the counterpart of the reference's jax engine
(``predictionio_tpu/analysis/jaxlint.py``): the same forward taint over
the same syntax, with torch's tracing entry points in place of jax's.

Traced scope: every function reachable from

* a ``torch.func`` transform — ``torch.func.vmap``/``grad``/
  ``grad_and_value``/``jacrev``/``jacfwd``/``hessian``/``vjp``/``jvp``
  and ``torch.vmap`` (a ``vmap`` ``in_dims`` of ``None`` at position
  *i* leaves parameter *i* unbatched, so untraced — the counterpart of
  jax's static arguments);
* a compiler — ``torch.compile``, ``torch.jit.script``/``trace`` and
  ``torch.cuda.make_graphed_callables``;

in decorator form (``@torch.compile``, ``@torch.compile(mode=...)``,
``@functools.partial(torch.vmap, in_dims=...)``) or call form
(``g = torch.compile(f)``, ``torch.func.vmap(torch.func.grad(f))``),
and the body of every ``with torch.cuda.graph(...)`` block (a CUDA
graph capture: the enclosing function's parameters and every tensor a
torch call makes are traced there; the code around the block is not).

Taint: non-static parameters are traced values, values derived from
them are traced, and metadata reads strip the taint — the attributes
``.shape``/``.dtype``/``.device``/``.ndim``/``.is_cuda`` (and
``layout``, ``requires_grad``, ``itemsize``, ``nbytes``), the methods
``size()``/``dim()``/``numel()``/``stride()``/``element_size()``/
``is_contiguous()``/``get_device()``/``is_floating_point()``/
``is_complex()``, and the calls ``torch.is_tensor(...)``,
``torch.is_floating_point(...)``, ``torch.is_complex(...)`` and
``isinstance(...)``.  Host syncs (``.item()``/``.tolist()``: PIO101;
``float()``/``int()``/``bool()``: PIO102; ``np.asarray``/``np.array``,
``.numpy()``, ``.cpu()``: PIO103), data-dependent Python control flow
(PIO104) and string formatting of traced values (PIO106) fall out as
taint queries at specific syntax nodes.

PIO105 (unhashable static arguments) and PIO107 (donated buffers)
have no torch counterpart — torch has neither static arguments nor
buffer donation — so the catalog keeps both ids and this engine
reports neither.

Everything is module-local and first-order, as in the reference: a
callback passed into another function is not followed.  This is a
gate, not a verifier; the baseline absorbs the rare false positive.

PIO108 (unfenced timing spans) lives here too because it needs the same
"which calls queue device work" knowledge; it only runs on the files
``cli.py`` marks as measurement scope (``chip_smoke.py``,
``kernel_variants.py``).  Device work is a torch call (outside the
metadata, RNG-seeding, grad-mode and ``torch.cuda`` bookkeeping calls),
a call into the port's kernel wrappers (any name imported from
``predictionio_tpu_torch.ops``, ``_build.launch`` among them), a call
of a compiled or transformed function, and a method call or ``@`` on
a name bound from any of those.  The fences are
``torch.cuda.synchronize()``, ``.synchronize()`` on an event or a
stream, the port's ``device.fence``, ``.item()``, ``.tolist()``,
``.cpu()``, ``float()`` and ``int()``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Optional, Union

from .core import Finding, SourceFile

__all__ = ["TorchEngine"]

FuncNode = Union[ast.FunctionDef, ast.AsyncFunctionDef]

# attribute reads that yield static (trace-time) metadata, not a value
SHAPE_ATTRS = {
    "shape", "dtype", "device", "ndim", "is_cuda", "layout",
    "requires_grad", "itemsize", "nbytes",
}
# tensor methods that answer metadata
STATIC_METHODS = {
    "size", "dim", "numel", "stride", "element_size", "is_contiguous",
    "get_device", "is_floating_point", "is_complex",
}
# torch.<name>(...) calls that answer metadata
STATIC_TORCH_CALLS = {"is_tensor", "is_floating_point", "is_complex"}

# torch.func transforms whose function argument runs under tracing
TRACING_HOFS = {
    "vmap", "grad", "grad_and_value", "jacrev", "jacfwd", "hessian",
    "vjp", "jvp",
}

TIME_FUNCS = {"time", "perf_counter", "monotonic", "process_time"}

# calls that force device completion (or copy to host): a timed span
# holding one of these before the closing timer read is honest
FENCE_ATTRS = {"synchronize", "item", "tolist", "cpu", "fence"}
FENCE_NAMES = {"fence", "float", "int"}

# torch.* subtrees that are bookkeeping, not device compute
TORCH_NONCOMPUTE = {
    "cuda", "device", "dtype", "manual_seed", "seed", "no_grad",
    "inference_mode", "enable_grad", "set_grad_enabled", "backends",
    "profiler", "utils", "get_default_dtype", "set_default_dtype",
    "set_printoptions", "Size", "finfo", "iinfo", "compile", "jit",
    "func", "vmap", "Generator", "save", "load", "version", "from_numpy",
    *STATIC_TORCH_CALLS,
}

OPS_PACKAGE = "predictionio_tpu_torch.ops"


def _dotted(node: ast.AST) -> Optional[list[str]]:
    """``a.b.c`` -> ["a", "b", "c"]; None when the chain has calls etc."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _root_name(node: ast.AST) -> Optional[str]:
    """The Name at the root of ``a.b[c].d(...)``-style chains."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Call)):
        node = node.func if isinstance(node, ast.Call) else node.value
    return node.id if isinstance(node, ast.Name) else None


def _unbatched_positions(args: list, keywords: list) -> set[int]:
    """Positions a ``vmap`` leaves unbatched (``in_dims`` entries of
    ``None``), from its keyword or its second positional argument."""
    in_dims = next((kw.value for kw in keywords if kw.arg == "in_dims"),
                   args[1] if len(args) > 1 else None)
    if not isinstance(in_dims, (ast.Tuple, ast.List)):
        return set()
    return {i for i, e in enumerate(in_dims.elts)
            if isinstance(e, ast.Constant) and e.value is None}


@dataclass
class FuncInfo:
    node: FuncNode
    qualname: str
    params: list[str]
    cls: Optional[str] = None        # owning class name, if a method
    parent: Optional[FuncNode] = None  # enclosing function, if nested
    locals_map: dict[str, "FuncInfo"] = field(default_factory=dict)


@dataclass
class TraceInfo:
    """One tracing application: the traced local function and the
    parameters it leaves untraced."""
    func: FuncInfo
    static: set[str] = field(default_factory=set)


class TorchEngine:
    def __init__(self, src: SourceFile, bench_scope: bool = False):
        self.src = src
        self.bench_scope = bench_scope
        self.findings: list[Finding] = []
        self._seen: set[tuple] = set()
        self.imports = _ImportScan()
        for node in src.walk():
            if isinstance(node, ast.Import):
                self.imports.visit_Import(node)
            elif isinstance(node, ast.ImportFrom):
                self.imports.visit_ImportFrom(node)
        self.functions: dict[int, FuncInfo] = {}
        self.module_funcs: dict[str, FuncInfo] = {}
        self.class_methods: dict[str, dict[str, FuncInfo]] = {}
        self._collect_functions()
        self._parents: dict[int, ast.AST] = {}
        # every node under its innermost def (or the module), in order
        self._scope_nodes: dict[int, list[ast.AST]] = {}
        stack: list[tuple[ast.AST, ast.AST]] = [(src.tree, src.tree)]
        while stack:
            parent, scope = stack.pop()
            inner = parent if isinstance(
                parent, (ast.FunctionDef, ast.AsyncFunctionDef)) else scope
            for child in ast.iter_child_nodes(parent):
                self._parents[id(child)] = parent
                self._scope_nodes.setdefault(id(inner), []).append(child)
                stack.append((child, inner))
        self.traced: list[TraceInfo] = []
        self.wrappers: set[str] = set()  # names bound to traced callables
        # (enclosing function, with-node) of every CUDA graph capture
        self.captures: list[tuple[FuncInfo, ast.With]] = []
        self._collect_applications()

    # -- public ------------------------------------------------------------
    def run(self) -> list[Finding]:
        self._run_taint()
        if self.bench_scope:
            self._check_timing_spans()
        return self.findings

    def _emit(self, rule: str, node: ast.AST, message: str,
              scope: str = "") -> None:
        key = (rule, getattr(node, "lineno", 0),
               getattr(node, "col_offset", 0))
        if key in self._seen:
            return
        self._seen.add(key)
        f = self.src.finding(rule, node, message, scope)
        if f is not None:
            self.findings.append(f)

    # -- structure collection ---------------------------------------------
    def _collect_functions(self) -> None:
        def stmts_of(body):
            """Statements in ``body``, descending through control flow
            (if/try/with/for/while) but NOT into defs/classes."""
            for stmt in body:
                yield stmt
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.ClassDef)):
                    continue
                for attr in ("body", "orelse", "finalbody"):
                    yield from stmts_of(getattr(stmt, attr, []))
                for h in getattr(stmt, "handlers", []):
                    yield from stmts_of(h.body)

        def walk(body, qualprefix, cls, parent):
            infos = {}
            for stmt in stmts_of(body):
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    a = stmt.args
                    params = [p.arg for p in
                              a.posonlyargs + a.args + a.kwonlyargs]
                    info = FuncInfo(
                        node=stmt,
                        qualname=(qualprefix + stmt.name),
                        params=params, cls=cls, parent=parent,
                    )
                    self.functions[id(stmt)] = info
                    infos[stmt.name] = info
                    info.locals_map = walk(stmt.body, info.qualname + ".",
                                           cls, stmt)
                elif isinstance(stmt, ast.ClassDef):
                    self.class_methods[stmt.name] = walk(
                        stmt.body, qualprefix + stmt.name + ".",
                        stmt.name, None,
                    )
            return infos

        self.module_funcs = walk(self.src.tree.body, "", None, None)

    def _resolve_call(self, call: ast.Call,
                      ctx: Optional[FuncInfo]) -> Optional[FuncInfo]:
        """Resolve a call target to a module-local FuncInfo."""
        fn = call.func
        if isinstance(fn, ast.Name):
            cur = ctx
            while cur is not None:
                if fn.id in cur.locals_map:
                    return cur.locals_map[fn.id]
                cur = (self.functions.get(id(cur.parent))
                       if cur.parent is not None else None)
            return self.module_funcs.get(fn.id)
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id in ("self", "cls") and ctx is not None
                and ctx.cls is not None):
            return self.class_methods.get(ctx.cls, {}).get(fn.attr)
        return None

    def _resolve_name_func(self, name: str) -> Optional[FuncInfo]:
        if name in self.module_funcs:
            return self.module_funcs[name]
        for fi in self.functions.values():
            if fi.node.name == name:
                return fi
        return None

    def _parent_of(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(id(node))

    # -- tracing application discovery -----------------------------------
    def _tracer_kind(self, node: ast.AST) -> Optional[str]:
        """``"vmap"``, ``"transform"`` or ``"compile"`` when ``node`` is
        a tracing callable itself (``torch.compile``, ``torch.func.vmap``,
        a name imported as one), else None."""
        if isinstance(node, ast.Name):
            return self.imports.tracer_names.get(node.id)
        parts = _dotted(node)
        if parts is None or len(parts) < 2:
            return None
        root, rest = parts[0], parts[1:]
        if root in self.imports.func_aliases and len(rest) == 1 \
                and rest[0] in TRACING_HOFS:
            return "vmap" if rest[0] == "vmap" else "transform"
        if root not in self.imports.torch_aliases:
            return None
        if rest in (["vmap"], ["func", "vmap"]):
            return "vmap"
        if len(rest) == 2 and rest[0] == "func" and rest[1] in TRACING_HOFS:
            return "transform"
        if rest in (["compile"], ["jit", "script"], ["jit", "trace"],
                    ["cuda", "make_graphed_callables"]):
            return "compile"
        return None

    def _is_partial(self, node: ast.AST) -> bool:
        parts = _dotted(node)
        return parts is not None and (
            parts[-1] == "partial" or parts[0] in self.imports.partial_names)

    def _application(self, call: ast.Call) -> Optional[tuple]:
        """``(target expr, unbatched positions)`` when ``call`` applies a
        tracer to a function: ``tracer(f, ...)`` or
        ``partial(tracer, ...)(f)``."""
        if not call.args:
            return None
        kind = self._tracer_kind(call.func)
        if kind is not None:
            return call.args[0], (
                _unbatched_positions(call.args, call.keywords)
                if kind == "vmap" else set())
        static = self._partial_tracer(call.func)
        if static is not None:
            return call.args[0], static
        return None

    def _partial_tracer(self, node: ast.AST) -> Optional[set[int]]:
        """The unbatched positions when ``node`` is
        ``functools.partial(tracer, ...)``, else None."""
        if not (isinstance(node, ast.Call) and self._is_partial(node.func)
                and node.args):
            return None
        kind = self._tracer_kind(node.args[0])
        if kind is None:
            return None
        return (_unbatched_positions([], node.keywords) if kind == "vmap"
                else set())

    def _target_func(self, target: ast.AST) -> Optional[FuncInfo]:
        """The local function a tracer is applied to, through nested
        applications (``vmap(grad(f))``)."""
        if isinstance(target, ast.Name):
            return self._resolve_name_func(target.id)
        if isinstance(target, ast.Call):
            app = self._application(target)
            if app is not None:
                return self._target_func(app[0])
        return None

    def _add(self, func: Optional[FuncInfo], static_pos: set[int]) -> None:
        if func is None:
            return
        params = [p for p in func.params if p not in ("self", "cls")]
        static = {params[i] for i in static_pos if i < len(params)}
        self.traced.append(TraceInfo(func=func, static=static))

    def _collect_applications(self) -> None:
        # decorator form: @torch.compile, @torch.compile(...),
        # @functools.partial(torch.vmap, in_dims=...)
        for info in self.functions.values():
            for dec in info.node.decorator_list:
                static = None
                if self._tracer_kind(dec) is not None:
                    static = set()
                elif isinstance(dec, ast.Call):
                    kind = self._tracer_kind(dec.func)
                    if kind is not None:  # @torch.compile(mode=...)
                        static = (_unbatched_positions([], dec.keywords)
                                  if kind == "vmap" else set())
                    else:
                        static = self._partial_tracer(dec)
                if static is not None:
                    self._add(info, static)
                    self.wrappers.add(info.node.name)
        # call form, and CUDA graph captures
        for node in self.src.walk():
            if isinstance(node, ast.Call):
                app = self._application(node)
                if app is None:
                    continue
                target, static = app
                self._add(self._target_func(target), static)
                parent = self._parent_of(node)
                if isinstance(parent, ast.Assign):
                    for t in parent.targets:
                        if isinstance(t, ast.Name):
                            self.wrappers.add(t.id)
            elif isinstance(node, ast.With) and any(
                    self._is_capture(item.context_expr)
                    for item in node.items):
                owner = self._enclosing_scope(node)
                info = self.functions.get(id(owner))
                if info is not None:
                    self.captures.append((info, node))

    def _is_capture(self, expr: ast.AST) -> bool:
        if not isinstance(expr, ast.Call):
            return False
        if isinstance(expr.func, ast.Name):
            return expr.func.id in self.imports.graph_names
        parts = _dotted(expr.func)
        return (parts is not None and len(parts) == 3
                and parts[0] in self.imports.torch_aliases
                and parts[1:] == ["cuda", "graph"])

    def _enclosing_scope(self, node: ast.AST) -> ast.AST:
        cur = self._parent_of(node)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            cur = self._parent_of(cur)
        return cur if cur is not None else self.src.tree

    # -- taint analysis ----------------------------------------------------
    def _run_taint(self) -> None:
        worklist: list[tuple[FuncInfo, frozenset]] = []
        for app in self.traced:
            tainted = frozenset(
                p for p in app.func.params
                if p not in app.static and p not in ("self", "cls")
            )
            worklist.append((app.func, tainted))
        for owner, block in self.captures:
            # the whole function walked so that taint reaches the block,
            # findings and callees taken from the block alone
            walker = _TaintWalker(
                self, owner,
                {p for p in owner.params if p not in ("self", "cls")},
                region=(block.lineno, block.end_lineno or block.lineno))
            walker.run()
            worklist.extend(walker.calls_out)
        visited: set[tuple[int, frozenset]] = set()
        while worklist:
            func, tainted = worklist.pop()
            key = (id(func.node), tainted)
            if key in visited or len(visited) > 4000:
                continue
            visited.add(key)
            walker = _TaintWalker(self, func, set(tainted))
            walker.run()
            worklist.extend(walker.calls_out)

    # -- PIO108: unfenced timing spans (measurement scope) ----------------
    def _is_time_call(self, node: ast.AST) -> bool:
        if not isinstance(node, ast.Call):
            return False
        parts = _dotted(node.func)
        if parts is None:
            return False
        if len(parts) == 2 and parts[0] in self.imports.time_aliases \
                and parts[1] in TIME_FUNCS:
            return True
        return len(parts) == 1 and parts[0] in self.imports.time_names

    @staticmethod
    def _is_fence_call(node: ast.Call) -> bool:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            return fn.attr in FENCE_ATTRS
        if isinstance(fn, ast.Name):
            return fn.id in FENCE_NAMES
        return False

    def _is_torch_compute(self, node: ast.Call) -> bool:
        parts = _dotted(node.func)
        return (parts is not None and len(parts) > 1
                and parts[0] in self.imports.torch_aliases
                and not (set(parts[1:]) & TORCH_NONCOMPUTE))

    def _is_device_call(self, node: ast.Call,
                        tensors: set[str]) -> bool:
        fn = node.func
        if isinstance(fn, ast.Attribute) and (
                fn.attr in FENCE_ATTRS or fn.attr in STATIC_METHODS):
            return False
        if self._is_torch_compute(node):
            return True
        if isinstance(fn, ast.Name):
            return (fn.id in self.imports.ops_names
                    or fn.id in self.imports.ops_modules
                    or fn.id in self.wrappers)
        parts = _dotted(fn)
        if parts is not None and parts[0] in self.imports.ops_modules:
            return True
        return isinstance(fn, ast.Attribute) \
            and _root_name(fn.value) in tensors

    def _tensor_names(self, own: list[ast.AST]) -> set[str]:
        """Names a scope binds from device work, to a fixpoint: a torch
        call, a kernel wrapper, a traced callable, or a method call, an
        index or ``@`` of a name so bound."""
        tensors: set[str] = set()

        def device_valued(v: ast.AST) -> bool:
            if isinstance(v, ast.Call):
                return self._is_device_call(v, tensors)
            if isinstance(v, ast.BinOp):
                return device_valued(v.left) or device_valued(v.right)
            if isinstance(v, (ast.Subscript, ast.Attribute)):
                return (_root_name(v) in tensors
                        and not (isinstance(v, ast.Attribute)
                                 and v.attr in SHAPE_ATTRS))
            return isinstance(v, ast.Name) and v.id in tensors

        assigns = [n for n in own if isinstance(n, ast.Assign)]
        for _ in range(8):
            before = len(tensors)
            for n in assigns:
                if device_valued(n.value):
                    for t in n.targets:
                        tensors.update(x.id for x in ast.walk(t)
                                       if isinstance(x, ast.Name))
            if len(tensors) == before:
                break
        return tensors

    def _check_timing_spans(self) -> None:
        scopes: list[ast.AST] = [self.src.tree] + [
            fi.node for fi in self.functions.values()
        ]
        for scope in scopes:
            starts: list[tuple[str, int]] = []
            uses: list[tuple[str, int, ast.AST]] = []
            own = self._scope_nodes.get(id(scope), [])
            for n in own:
                if isinstance(n, ast.Assign) and self._is_time_call(n.value):
                    for t in n.targets:
                        if isinstance(t, ast.Name):
                            starts.append((t.id, n.lineno))
                if isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub) \
                        and self._is_time_call(n.left) \
                        and isinstance(n.right, ast.Name):
                    uses.append((n.right.id, n.lineno, n))
            if not uses:
                continue
            tensors = self._tensor_names(own)
            for name, use_line, use_node in uses:
                cands = [ln for (nm, ln) in starts
                         if nm == name and ln < use_line]
                if not cands:
                    continue
                t0_line = max(cands)
                device, fence = False, False
                for n in own:
                    if not (t0_line < getattr(n, "lineno", 0) <= use_line):
                        continue
                    if isinstance(n, ast.Call):
                        if self._is_fence_call(n):
                            fence = True
                        elif self._is_device_call(n, tensors):
                            device = True
                    elif isinstance(n, ast.BinOp) \
                            and isinstance(n.op, ast.MatMult) \
                            and {_root_name(n.left),
                                 _root_name(n.right)} & tensors:
                        device = True
                if device and not fence:
                    self._emit(
                        "PIO108", use_node,
                        f"timing span ({name!r} from line {t0_line}) "
                        "covers device work but no fence "
                        "(torch.cuda.synchronize, an event's "
                        "synchronize) — it measures the enqueue, not "
                        "the execution",
                    )


class _ImportScan:
    """Module import aliases the engine needs to resolve names."""

    def __init__(self):
        self.torch_aliases: set[str] = set()
        self.func_aliases: set[str] = set()  # torch.func bound to a name
        self.np_aliases: set[str] = set()
        self.time_aliases: set[str] = set()
        self.time_names: set[str] = set()    # from time import perf_counter
        self.partial_names: set[str] = set()
        # names imported as a tracer: name -> "vmap"|"transform"|"compile"
        self.tracer_names: dict[str, str] = {}
        self.graph_names: set[str] = set()   # from torch.cuda import graph
        self.ops_modules: set[str] = set()   # the port's kernel modules
        self.ops_names: set[str] = set()     # names imported from them

    @staticmethod
    def _is_ops(mod: str, level: int) -> bool:
        if level:
            return mod == "ops" or mod.startswith("ops.")
        return mod == OPS_PACKAGE or mod.startswith(OPS_PACKAGE + ".")

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            bound = a.asname or a.name.split(".")[0]
            if a.name == "torch" or (a.name.startswith("torch.")
                                     and a.asname is None):
                self.torch_aliases.add(bound)
            elif a.name == "torch.func":
                self.func_aliases.add(bound)
            elif a.name == "numpy":
                self.np_aliases.add(bound)
            elif a.name == "time":
                self.time_aliases.add(bound)
            elif self._is_ops(a.name, 0) and a.asname:
                self.ops_modules.add(a.asname)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for a in node.names:
            bound = a.asname or a.name
            if mod == "torch" and a.name == "func":
                self.func_aliases.add(bound)
            elif mod == "torch" and a.name == "vmap":
                self.tracer_names[bound] = "vmap"
            elif mod == "torch" and a.name == "compile":
                self.tracer_names[bound] = "compile"
            elif mod == "torch.func" and a.name in TRACING_HOFS:
                self.tracer_names[bound] = (
                    "vmap" if a.name == "vmap" else "transform")
            elif mod == "torch.jit" and a.name in ("script", "trace"):
                self.tracer_names[bound] = "compile"
            elif mod == "torch.cuda" and a.name == "graph":
                self.graph_names.add(bound)
            elif mod == "torch.cuda" and a.name == "make_graphed_callables":
                self.tracer_names[bound] = "compile"
            elif mod == "functools" and a.name == "partial":
                self.partial_names.add(bound)
            elif mod == "time" and a.name in TIME_FUNCS:
                self.time_names.add(bound)
            elif node.level == 0 and mod == OPS_PACKAGE.rsplit(".", 1)[0] \
                    and a.name == "ops":
                self.ops_modules.add(bound)
            elif self._is_ops(mod, node.level):
                # a kernel module (from ...ops import solve) or a
                # function of one (from ...ops.solve import f)
                if mod in ("ops", OPS_PACKAGE):
                    self.ops_modules.add(bound)
                else:
                    self.ops_names.add(bound)


class _TaintWalker:
    """Forward taint pass over one function body under one taint seed.
    With ``region`` (first, last line) it reports, and follows calls,
    only inside those lines: a CUDA graph capture block."""

    def __init__(self, engine: TorchEngine, func: FuncInfo,
                 tainted: set[str], region: Optional[tuple] = None):
        self.e = engine
        self.func = func
        self.tainted = tainted
        self.region = region
        self.calls_out: list[tuple[FuncInfo, frozenset]] = []

    def _inside(self, node: ast.AST) -> bool:
        if self.region is None:
            return True
        return self.region[0] <= getattr(node, "lineno", 0) \
            <= self.region[1]

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if self._inside(node):
            self.e._emit(rule, node, message, self.func.qualname)

    def run(self) -> None:
        # two passes so loop-carried taint reaches first-pass reads
        self._walk_body(self.func.node.body)
        self._walk_body(self.func.node.body)

    # -- statements --------------------------------------------------------
    def _walk_body(self, body: list[ast.stmt]) -> None:
        for stmt in body:
            self._walk_stmt(stmt)

    def _walk_stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # analyzed when called / scheduled separately
        if isinstance(stmt, ast.Assign):
            t = self.taint(stmt.value)
            for target in stmt.targets:
                self._bind(target, t)
        elif isinstance(stmt, ast.AnnAssign):
            if stmt.value is not None:
                self._bind(stmt.target, self.taint(stmt.value))
        elif isinstance(stmt, ast.AugAssign):
            if self.taint(stmt.value) and isinstance(stmt.target, ast.Name):
                self.tainted.add(stmt.target.id)
        elif isinstance(stmt, (ast.If, ast.While)):
            if self._branch_taint(stmt.test):
                self._emit(
                    "PIO104", stmt.test,
                    "Python control flow on a traced value: a "
                    "data-dependent guard (graph break, recompile per "
                    "value) under torch.compile, an error under vmap or "
                    "graph capture — use torch.where",
                )
            else:
                self.taint(stmt.test)
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            if self._branch_taint(stmt.test):
                self._emit(
                    "PIO104", stmt.test,
                    "assert on a traced value inside torch-traced code",
                )
        elif isinstance(stmt, ast.For):
            self._bind(stmt.target, self.taint(stmt.iter))
            self._walk_body(stmt.body)
            self._walk_body(stmt.orelse)
        elif isinstance(stmt, ast.With):
            for item in stmt.items:
                t = self.taint(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, t)
            self._walk_body(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._walk_body(stmt.body)
            for h in stmt.handlers:
                self._walk_body(h.body)
            self._walk_body(stmt.orelse)
            self._walk_body(stmt.finalbody)
        elif isinstance(stmt, ast.Return):
            if stmt.value is not None:
                self.taint(stmt.value)
        elif isinstance(stmt, ast.Expr):
            self.taint(stmt.value)
        elif isinstance(stmt, ast.Raise):
            if stmt.exc is not None:
                self.taint(stmt.exc)
        elif isinstance(stmt, ast.Delete):
            pass
        else:
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.expr):
                    self.taint(child)
                elif isinstance(child, ast.stmt):
                    self._walk_stmt(child)

    def _bind(self, target: ast.expr, tainted: bool) -> None:
        for n in ast.walk(target):
            if isinstance(n, ast.Name):
                if tainted:
                    self.tainted.add(n.id)
                else:
                    self.tainted.discard(n.id)

    def _branch_taint(self, test: ast.expr) -> bool:
        """Taint of a branch condition, with identity/None checks
        excluded: ``x is None`` / ``isinstance(x, T)`` /
        ``torch.is_tensor(x)`` inspect the Python value at trace time."""
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return False
        if isinstance(test, ast.BoolOp):
            return any(self._branch_taint(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._branch_taint(test.operand)
        return self.taint(test)

    # -- expressions -------------------------------------------------------
    def taint(self, node: Optional[ast.expr]) -> bool:
        """Evaluate taint of an expression, emitting findings for
        host-sync / formatting uses of tainted values on the way."""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            base = self.taint(node.value)
            return False if node.attr in SHAPE_ATTRS else base
        if isinstance(node, ast.Subscript):
            return self.taint(node.value) or self.taint(node.slice)
        if isinstance(node, ast.Call):
            return self._taint_call(node)
        if isinstance(node, ast.BinOp):
            return self.taint(node.left) | self.taint(node.right)
        if isinstance(node, ast.BoolOp):
            return any([self.taint(v) for v in node.values])
        if isinstance(node, ast.UnaryOp):
            return self.taint(node.operand)
        if isinstance(node, ast.Compare):
            tainted = self.taint(node.left)
            for c in node.comparators:
                tainted |= self.taint(c)
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return tainted
        if isinstance(node, ast.IfExp):
            if self._branch_taint(node.test):
                self._emit(
                    "PIO104", node.test,
                    "conditional expression on a traced value inside "
                    "torch-traced code — use torch.where",
                )
            return self.taint(node.body) | self.taint(node.orelse)
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return any([self.taint(e) for e in node.elts])
        if isinstance(node, ast.Dict):
            return any([self.taint(v) for v in node.values]
                       + [self.taint(k) for k in node.keys if k is not None])
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue) \
                        and self.taint(v.value):
                    self._emit(
                        "PIO106", v.value,
                        "f-string interpolation of a traced value: a host "
                        "sync (or a graph break) at trace time that bakes "
                        "the value's repr into the traced program",
                    )
            return False
        if isinstance(node, ast.Starred):
            return self.taint(node.value)
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            tainted = False
            for gen in node.generators:
                t = self.taint(gen.iter)
                self._bind(gen.target, t)
                tainted |= t
            if isinstance(node, ast.DictComp):
                tainted |= self.taint(node.key) | self.taint(node.value)
            else:
                tainted |= self.taint(node.elt)
            return tainted
        if isinstance(node, ast.Lambda):
            return False
        if isinstance(node, ast.NamedExpr):
            t = self.taint(node.value)
            self._bind(node.target, t)
            return t
        # fallback: any tainted child expression
        return any([self.taint(c) for c in ast.iter_child_nodes(node)
                    if isinstance(c, ast.expr)])

    def _taint_call(self, node: ast.Call) -> bool:
        fn = node.func
        arg_taints = [self.taint(a) for a in node.args]
        kw_taints = {kw.arg: self.taint(kw.value) for kw in node.keywords}
        any_tainted = any(arg_taints) or any(kw_taints.values())
        parts = _dotted(fn)

        # metadata: static under tracing ------------------------------------
        if isinstance(fn, ast.Attribute) and fn.attr in STATIC_METHODS:
            self.taint(fn.value)
            return False
        if parts is not None and len(parts) == 2 \
                and parts[0] in self.e.imports.torch_aliases \
                and parts[1] in STATIC_TORCH_CALLS:
            return False

        # host-sync checks -------------------------------------------------
        if isinstance(fn, ast.Attribute) and fn.attr in ("item", "tolist"):
            if self.taint(fn.value):
                self._emit(
                    "PIO101", node,
                    f".{fn.attr}() on a traced value inside torch-traced "
                    "code: a device->host sync (a graph break under "
                    "torch.compile, an error under vmap or capture)",
                )
            return False
        if isinstance(fn, ast.Attribute) and fn.attr in ("numpy", "cpu"):
            if self.taint(fn.value):
                self._emit(
                    "PIO103", node,
                    f".{fn.attr}() on a traced value inside torch-traced "
                    "code: a device->host copy per call (keep it a "
                    "tensor on the device, or move it outside the trace)",
                )
            return False
        if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool",
                                                  "complex"):
            if any_tainted:
                self._emit(
                    "PIO102", node,
                    f"{fn.id}() forces a traced value to a Python scalar "
                    "inside torch-traced code (a host sync and a "
                    "data-dependent guard)",
                )
            return False
        if parts is not None and parts[0] in self.e.imports.np_aliases \
                and parts[-1] in ("asarray", "array", "copy",
                                  "ascontiguousarray"):
            if any_tainted:
                self._emit(
                    "PIO103", node,
                    f"numpy {'.'.join(parts)}() on a traced value inside "
                    "torch-traced code: a device->host copy per call "
                    "(use torch equivalents, or materialize outside the "
                    "trace)",
                )
            return False
        if isinstance(fn, ast.Name) and fn.id in ("str", "repr", "format"):
            if any_tainted:
                self._emit(
                    "PIO106", node,
                    f"{fn.id}() of a traced value inside torch-traced "
                    "code leaks the trace-time repr into the traced "
                    "program",
                )
            return False
        if isinstance(fn, ast.Attribute) and fn.attr == "format" \
                and any_tainted:
            self._emit(
                "PIO106", node,
                "str.format() of a traced value inside torch-traced code",
            )
            return False

        # untainting / neutral builtins -----------------------------------
        if isinstance(fn, ast.Name) and fn.id in ("len", "isinstance",
                                                  "hasattr", "getattr",
                                                  "callable", "type",
                                                  "print", "range"):
            return False

        # propagate into module-local callees -----------------------------
        callee = self.e._resolve_call(node, self.func)
        if callee is not None and callee.node is not self.func.node \
                and self._inside(node):
            taints: set[str] = set()
            params = callee.params
            offset = 1 if params[:1] in (["self"], ["cls"]) \
                and isinstance(fn, ast.Attribute) else 0
            for i, t in enumerate(arg_taints):
                if t and i + offset < len(params):
                    taints.add(params[i + offset])
            for name, t in kw_taints.items():
                if t and name in params:
                    taints.add(name)
            # closure reads: a nested function sees our tainted locals
            if callee.parent is self.func.node:
                taints |= self.tainted
            self.calls_out.append((callee, frozenset(taints)))
        # a capture makes every tensor a torch call returns a traced one
        if self.region is not None and self.e._is_torch_compute(node):
            return True
        # method call on a tainted receiver stays tainted (.to, .sum, ...)
        recv_tainted = (isinstance(fn, ast.Attribute)
                        and self.taint(fn.value))
        return any_tainted or recv_tainted
