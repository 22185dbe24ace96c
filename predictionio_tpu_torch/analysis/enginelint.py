"""piolint engine-isolation rule (PIO301): engine files must not import
server internals.

The reference's ``predictionio_tpu/analysis/enginelint.py`` over this
package.  An engine is ONE file declaring DataSource/Algorithm(s)/
Serving + params, and the PLATFORM supplies the serving machinery (HTTP
edges, micro-batcher, routers, tenancy).  An engine module reaching
into ``predictionio_tpu_torch.server`` couples the cheap-to-write layer
to the hardest-to-change one: server internals change (threads ->
eventloop, blocking -> continuous batching), and an engine calling
them directly would break on every such change AND sidestep the
obs/resilience wiring the platform routes every query through.
Engines talk to the platform through the ``controller`` contracts and
the shared ``templates/_common.py`` helpers (which may themselves wrap
server utilities — infrastructure, underscore-prefixed, outside this
rule's scope).

Detection: any ``import``/``from ... import`` that resolves into the
``server`` package — absolute (``predictionio_tpu_torch.server[.x]``)
or relative (``from ..server import ...`` / ``from ..server.microbatch
import ...``) — anywhere in an engine module, function-level imports
included (deferring the import defers the coupling, it doesn't remove
it).  ``cli.py`` applies this engine only to engine modules:
``predictionio_tpu_torch/templates/*.py`` excluding ``_``-prefixed
infrastructure files.
"""

from __future__ import annotations

import ast

from .core import Finding, SourceFile

__all__ = ["EngineImportEngine"]


def _is_server_module(dotted: str) -> bool:
    parts = dotted.split(".")
    if parts[:2] == ["predictionio_tpu_torch", "server"]:
        return True
    # relative form: the module text after the dots ("server",
    # "server.microbatch") — the caller passes it with level noted
    return parts[0] == "server"


class EngineImportEngine:
    def __init__(self, src: SourceFile):
        self.src = src
        self.findings: list[Finding] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        f = self.src.finding(
            "PIO301", node,
            f"engine file imports server internals ({what}); "
            "engines declare components — the platform owns the "
            "serving machinery (use controller/_common APIs)",
        )
        if f is not None:
            self.findings.append(f)

    def run(self) -> list[Finding]:
        for node in self.src.walk():
            if isinstance(node, ast.Import):
                for a in node.names:
                    if _is_server_module(a.name):
                        self._flag(node, a.name)
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                if node.level == 0:
                    if _is_server_module(mod):
                        self._flag(node, mod)
                else:
                    # relative: `from ..server[...] import x` or
                    # `from .. import server`
                    if mod.split(".")[0] == "server":
                        self._flag(node, f"{'.' * node.level}{mod}")
                    elif not mod:
                        for a in node.names:
                            if a.name == "server":
                                self._flag(
                                    node, f"{'.' * node.level}server"
                                )
        return self.findings
