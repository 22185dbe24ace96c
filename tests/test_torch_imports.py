"""The port stands alone: nothing in ``predictionio_tpu_torch/``, the
examples' ``engine_torch.py`` or ``chip_smoke.py`` imports JAX, jaxlib or
the JAX package, at module level or inside a function (an AST walk over
every import statement), names a module of the JAX package in a string
(what ``python -m`` or ``import_module`` would run); the
``bin/pio-tpu-torch*`` launchers name no package but the port; and the
ingest fleet's worker processes run ``python -m predictionio_tpu_torch``."""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = sorted((ROOT / "examples").glob("*/engine_torch.py"))
FILES = sorted((ROOT / "predictionio_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
] + EXAMPLES
LAUNCHERS = sorted((ROOT / "bin").glob("pio-tpu-torch*"))
FORBIDDEN = ("jax", "jaxlib", "predictionio_tpu")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            mods.extend(a.value for a in node.args
                        if isinstance(a, ast.Constant)
                        and isinstance(a.value, str))
    return mods


# the engines that train no factor model, and what they use: numpy on the
# host, as in the reference (no tensor path, no kernel)
HOST_ONLY = ("sessions/__init__.py", "sessions/store.py", "models/markov.py",
             "e2/__init__.py", "e2/naive_bayes.py", "e2/markov_chain.py",
             "e2/cross_validation.py", "templates/trending.py",
             "templates/nextitem.py")


# piolint over the port: a pure AST pass that imports no tensor library
ANALYSIS = ("__init__", "__main__", "core", "cli", "timelint", "asynclint",
            "locklint", "deadlint", "enginelint", "contractlint",
            "torchlint")


def test_the_walk_sees_every_file():
    names = {p.relative_to(ROOT).as_posix() for p in FILES}
    assert "predictionio_tpu_torch/models/als.py" in names
    for mod in ("__main__.py", "cli/main.py", "engines/spec.py",
                "engines/discovery.py", "server/eventloop.py",
                "tools/template_gallery.py", "tools/trim.py",
                "utils/logging.py", "controller/metrics.py",
                "controller/evaluation.py", "controller/fast_eval.py",
                "workflow/evaluate.py", "workflow/fake.py",
                "storage/sharded_events.py", "server/router.py",
                "server/ingest_router.py", "resilience/faults.py",
                *(f"obs/{m}.py" for m in (
                    "__init__", "registry", "trace", "flight", "scope",
                    "timeline", "fleet", "xray", "runlog", "tower")),
                *(f"live/{m}.py" for m in (
                    "__init__", "watermark", "foldin", "apply", "daemon")),
                *(f"tenancy/{m}.py" for m in (
                    "__init__", "errors", "quota", "experiment",
                    "online_eval", "autopilot", "registry")),
                "ops/ann.py", "retrieval/__init__.py",
                "workflow/checkpoint.py",
                *(f"templates/{m}.py" for m in (
                    "similarproduct", "ecommerce", "itemsimilarity",
                    "classification", "trending", "nextitem")),
                *(f"models/{m}.py" for m in (
                    "naive_bayes", "logistic", "forest", "markov")),
                "ops/distributed_topk.py", "server/admin.py",
                "server/dashboard.py", "storage/file_metadata.py",
                "storage/bimap.py", "storage/levents.py",
                "utils/debug.py", "utils/profiling.py",
                *(f"analysis/{m}.py" for m in ANALYSIS),
                "tools/runlog.py", "tools/tracecat.py", "tools/profcat.py",
                *HOST_ONLY):
        assert f"predictionio_tpu_torch/{mod}" in names
    assert "chip_smoke.py" in names
    assert "examples/sharded-scale/engine_torch.py" in names
    assert len(EXAMPLES) == 18
    assert len(names) >= 20


# the console's packages are checked with the host tools, the package's
# `__main__` with its `__init__`
_FOLDED = {"cli": "tools", "engines": "tools", "utils": "tools",
           "__main__.py": "__init__.py"}


def _group(path: Path) -> str:
    """The file's subpackage of the port (or the file, at the top); the
    examples' modules are one group."""
    rel = path.relative_to(ROOT).parts
    if rel[0] == "examples":
        return "examples"
    name = rel[1] if len(rel) > 2 else rel[-1]
    return _FOLDED.get(name, name)


GROUPS = sorted({_group(p) for p in FILES})


# a module path of the JAX package as a whole string
_REFERENCE_MODULE = re.compile(r"^predictionio_tpu(\.\w+)*$")


def _named_modules(path: Path) -> list[str]:
    """String constants that name a module of the JAX package."""
    return [node.value for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and _REFERENCE_MODULE.match(node.value)]


@pytest.mark.parametrize("group", GROUPS)
def test_no_jax_or_reference_imports(group):
    bad = {
        p.relative_to(ROOT).as_posix(): found
        for p in FILES if _group(p) == group
        for found in [[m for m in _imported_modules(p)
                       if m.split(".")[0] in FORBIDDEN]
                      + _named_modules(p)]
        if found
    }
    assert not bad, bad


def test_the_host_engines_import_no_torch():
    found = {mod: [m for m in _imported_modules(
                 ROOT / "predictionio_tpu_torch" / mod)
                   if m.split(".")[0] in ("torch", "triton")]
             for mod in HOST_ONLY}
    assert not any(found.values()), found


def test_the_analyzer_and_the_obs_commands_import_no_torch():
    """``analysis/`` imports nothing past the standard library, and
    ``python -m`` of it, of ``tools.runlog``, of ``tools.tracecat`` and of
    ``tools.profcat`` never imports torch (the package's ``fence`` and
    ``resolve_device`` load it on first use)."""
    stdlib = set(sys.stdlib_module_names)
    found = {mod: [m for m in _imported_modules(
                 ROOT / "predictionio_tpu_torch" / "analysis" / f"{mod}.py")
                   if m.split(".")[0] not in stdlib]
             for mod in ANALYSIS}
    assert not any(found.values()), found
    probe = ("import sys, runpy; sys.argv = [sys.argv[1], '--help'];\n"
             "try:\n    runpy.run_module(sys.argv[0], run_name='__main__')\n"
             "except SystemExit:\n    pass\n"
             "print(sorted(m for m in ('torch', 'jax', 'numpy')"
             " if m in sys.modules))")
    for mod in ("predictionio_tpu_torch.analysis",
                "predictionio_tpu_torch.tools.runlog",
                "predictionio_tpu_torch.tools.tracecat",
                "predictionio_tpu_torch.tools.profcat"):
        out = subprocess.run([sys.executable, "-c", probe, mod],
                             capture_output=True, text=True, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        assert "torch" not in out.stdout.splitlines()[-1], (mod, out.stdout)
        assert "jax" not in out.stdout.splitlines()[-1], (mod, out.stdout)


# the JAX package's name where it is not the start of the port's (the
# default home both packages share, ``~/.predictionio_tpu``, is a
# directory, not the package)
_REFERENCE_NAME = re.compile(r"(?<![.\w])predictionio_tpu(?!_torch)")


def test_the_launchers_start_the_port():
    """Every ``bin/pio-tpu-torch*`` script names no package but the
    port, and each starts the port's console or another launcher of the
    port."""
    assert [p.name for p in LAUNCHERS] == [
        "pio-tpu-torch", "pio-tpu-torch-daemon", "pio-tpu-torch-shell",
        "pio-tpu-torch-start-all", "pio-tpu-torch-stop-all"]
    for p in LAUNCHERS:
        text = p.read_text()
        assert not _REFERENCE_NAME.search(text), p.name
        # the commands (comments aside) run only the port's launchers
        code = "\n".join(ln for ln in text.splitlines()
                         if not ln.lstrip().startswith("#"))
        for name in re.findall(r"pio-tpu[\w-]*", code):
            assert name.startswith("pio-tpu-torch"), (p.name, name)
    assert "exec python -m predictionio_tpu_torch" in (
        ROOT / "bin" / "pio-tpu-torch").read_text()
    assert not _REFERENCE_NAME.search("predictionio_tpu_torch.tools")
    assert not _REFERENCE_NAME.search("$HOME/.predictionio_tpu/run")
    assert _REFERENCE_NAME.search("python -m predictionio_tpu.cli")
    assert _REFERENCE_NAME.search("import predictionio_tpu\n")


def test_the_walk_catches_a_forbidden_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text(
        "import numpy\n"
        "def g():\n"
        "    from predictionio_tpu.ops import solve\n"
        "    import jax.numpy as jnp\n"
    )
    assert [m for m in _imported_modules(f)
            if m.split(".")[0] in FORBIDDEN] == [
        "predictionio_tpu.ops", "jax.numpy"]
    f.write_text('cmd = ["python", "-m", "predictionio_tpu.cli.main"]\n'
                 '"""predictionio_tpu/cli is the reference."""\n')
    assert _named_modules(f) == ["predictionio_tpu.cli.main"]


def test_fleet_workers_run_the_ports_console(tmp_path, monkeypatch):
    from predictionio_tpu_torch.server import ingest_router, router

    launched = []

    class FakePopen:
        def __init__(self, cmd, **kw):
            launched.append((cmd, kw["env"]))

    monkeypatch.setattr(router.subprocess, "Popen", FakePopen)
    spawned = ingest_router.spawn_ingest_worker(1, 2, tmp_path)
    (cmd, env), = launched
    assert cmd[:4] == [sys.executable, "-m", "predictionio_tpu_torch",
                       "eventserver"]
    assert cmd[cmd.index("--worker-index") + 1] == "1"
    assert cmd[cmd.index("--worker-count") + 1] == "2"
    assert cmd[cmd.index("--wal-dir") + 1] == str(
        tmp_path / "wal" / "worker-1")
    assert cmd[-2:] == ["--port-file", str(spawned["port_file"])]
    assert str(ROOT) in env["PYTHONPATH"].split(":")


_OFF_THE_CARD = """
import json, sys, tempfile, urllib.request
import torch
import predictionio_tpu_torch.obs
from predictionio_tpu_torch.server import EventServer, EventServerConfig
from predictionio_tpu_torch.storage import AccessKey, Storage
st = Storage({"PIO_TPU_HOME": tempfile.mkdtemp()})
md = st.get_metadata()
md.access_key_insert(AccessKey(key="k", appid=md.app_insert("a").id))
srv = EventServer(st, EventServerConfig(port=0))
srv.start_background()
base = f"http://127.0.0.1:{srv.config.port}"
ev = {"event": "rate", "entityType": "user", "entityId": "u1",
      "targetEntityType": "item", "targetEntityId": "i1",
      "properties": {"rating": 4.0}}
req = urllib.request.Request(base + "/events.json?accessKey=k",
                             data=json.dumps(ev).encode())
assert urllib.request.urlopen(req, timeout=30).status == 201
metrics = urllib.request.urlopen(base + "/metrics", timeout=30).read()
assert b'pio_events_requests_total{status="201"} 1' in metrics
srv.stop()
print(json.dumps({"cuda": torch.cuda.is_initialized(),
                  "jax": any(m.split(".")[0] in ("jax", "predictionio_tpu")
                             for m in sys.modules)}))
"""


def test_obs_and_an_event_server_stay_off_the_card():
    """Importing ``obs``, serving events and a ``/metrics`` scrape
    initialise no CUDA context and import nothing of JAX (a fresh
    interpreter: the test process has both packages loaded)."""
    p = subprocess.run([sys.executable, "-c", _OFF_THE_CARD], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert json.loads(p.stdout.splitlines()[-1]) == {"cuda": False,
                                                     "jax": False}
