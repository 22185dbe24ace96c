"""The port's ``runlog`` and ``tracecat`` commands
(``predictionio_tpu_torch/tools/runlog.py``, ``tools/tracecat.py``)
against the reference's ``tools/runlog.py`` and ``tools/tracecat.py``:
the same output on the same run manifests and span journals, written by
both packages."""

from __future__ import annotations

import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from predictionio_tpu.obs import runlog as jax_runlog
from predictionio_tpu.obs.trace import Tracer as JaxTracer
from predictionio_tpu_torch.obs import runlog as port_runlog
from predictionio_tpu_torch.obs.trace import Tracer
from predictionio_tpu_torch.tools import runlog as port_cmd
from predictionio_tpu_torch.tools import tracecat as port_cat

ROOT = Path(__file__).resolve().parents[1]


def _reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three runs under one root: two by the port's writer, one by the
    reference's; one failed, one with shard degradation events."""
    root = tmp_path_factory.mktemp("runs")
    rng = np.random.default_rng(19)
    for runlog, iid, n, status in ((port_runlog, "p-fast", 3, "completed"),
                                   (jax_runlog, "j-slow", 4, "completed"),
                                   (port_runlog, "p-failed", 2, "failed")):
        m = runlog.RunManifest(iid, kind="train", root=root,
                               meta={"engine": "recommendation"})
        for i in range(1, n + 1):
            s = float(rng.uniform(0.1, 0.5))
            m.sweep(i, s, {"user_half": s * 0.5, "item_half": s * 0.4,
                           "gram": s * 0.05}, loss=1.0 / i)
        if iid == "j-slow":
            m.event("shard_degraded", shard=1, sweep=2)
        m.finalize(status, sweeps=n, **({"reason": "nan"}
                                        if status == "failed" else {}))
    return root


def _out(main, argv, capsys) -> tuple:
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["list", "--json"],
    ["summarize", "p-fast"],
    ["summarize", "j-slow", "--sweeps"],
    ["summarize", "p-failed"],
    ["diff", "p-fast", "j-slow", "--json"],
    ["diff", "j-slow", "p-fast"],
], ids=lambda a: "-".join(a))
def test_runlog_prints_the_references_output(argv, runs, capsys):
    ref = _reference_tool("runlog")
    got = _out(port_cmd.main, ["--root", str(runs), *argv], capsys)
    want = _out(ref.main, ["--root", str(runs), *argv], capsys)
    assert got == want and got[0] == 0
    if "--json" in argv or argv[0] == "summarize":
        json.loads(got[1])


def test_runlog_list_and_a_missing_run(runs, tmp_path, capsys):
    ref = _reference_tool("runlog")

    def aged(text: str) -> str:
        return re.sub(r"\d+(\.\d)?[smh] ago", "AGE", text)

    rc, got = _out(port_cmd.main, ["--root", str(runs), "list"], capsys)
    assert rc == 0 and len(got.splitlines()) == 3
    assert aged(got) == aged(_out(ref.main, ["--root", str(runs), "list"],
                                  capsys)[1])
    empty = ["--root", str(tmp_path / "none"), "list"]
    assert _out(port_cmd.main, empty, capsys) == _out(ref.main, empty, capsys)
    for main in (port_cmd.main, ref.main):
        with pytest.raises(SystemExit, match="no readable run manifest"):
            main(["--root", str(runs), "summarize", "nope"])


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """One trace's spans in three processes' journals: a router span, a
    replica's and an event server's, by both packages' tracers."""
    d = tmp_path_factory.mktemp("spans")
    rng = np.random.default_rng(20)
    base = 5000.0
    for k, tracer in enumerate((Tracer(journal_dir=d),
                                JaxTracer(journal_dir=d),
                                Tracer(journal_dir=d))):
        for j in range(3):
            start = base + 10.0 * j + 0.01 * k
            dur = 1.0 - 0.2 * k
            tracer.record(f"hop{k}", dur, trace_id="t-cat", start=start,
                          attrs={"replica": f"replica-{k}",
                                 "segmentsMs": {"device": 3.5 * k,
                                                "queue": 1.0}})
            tracer.record("noise", float(rng.uniform(0.1, 0.2)),
                          trace_id="t-other", start=start)
        tracer.close()
    # the three tracers of this process share a pid: give the second
    # and third their own, as three processes' journals would
    for n, path in enumerate(sorted(d.glob("spans-*.jsonl*"))):
        lines = [json.loads(x) for x in path.read_text().splitlines()]
        path.write_text("".join(json.dumps({**x, "pid": 100 + n + (
            x["name"] == "hop2")}) + "\n" for x in lines))
    return d


@pytest.mark.parametrize("mode", [[], ["--json"], ["--json", "--eps",
                                                   "0.0"]],
                         ids=["text", "json", "json-eps0"])
def test_tracecat_prints_the_references_tree(mode, journals, capsys):
    ref = _reference_tool("tracecat")
    argv = ["t-cat", "--dir", str(journals), *mode]
    got = _out(port_cat.main, argv, capsys)
    assert got == _out(ref.main, argv, capsys) and got[0] == 0
    if mode:
        doc = json.loads(got[1])
        assert doc["traceId"] == "t-cat" and doc["spanCount"] == 9
        assert doc["processCount"] >= 2
    missing = ["t-none", "--dir", str(journals)]
    assert port_cat.main(missing) == ref.main(missing) == 1


def test_the_commands_run_as_modules(runs, journals):
    def run(mod, *argv):
        return subprocess.run(
            [sys.executable, "-m", f"predictionio_tpu_torch.tools.{mod}",
             *argv], capture_output=True, text=True, cwd=ROOT)

    listed = run("runlog", "--root", str(runs), "list", "--json")
    assert listed.returncode == 0
    assert [s["instanceId"] for s in json.loads(listed.stdout)] == [
        s["instanceId"] for s in map(
            jax_runlog.summarize, jax_runlog.list_runs(runs))]
    cat = run("tracecat", "t-cat", "--dir", str(journals), "--json")
    assert cat.returncode == 0 and json.loads(cat.stdout)["spanCount"] == 9
