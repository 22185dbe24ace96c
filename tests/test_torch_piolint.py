"""The port's piolint (``predictionio_tpu_torch/analysis``) against the
reference's (``predictionio_tpu/analysis``): the same findings on the
reference's fixtures and on the port's own source, and the port's gate.

* every PIO109–PIO403 fixture of ``tests/piolint_fixtures``: the
  reference's ``analyze_paths([f])`` and the port's give the same
  (rule, line, column, scope) set, and so do all engines with every
  scope forced on (the reference's own fixture runner).  The PIO301
  fixtures name the reference's server package; the port reads copies
  with ``predictionio_tpu`` renamed to ``predictionio_tpu_torch``;
* over the files of ``predictionio_tpu_torch/``, the two analyzers give
  the same PIO110 and PIO2xx findings;
* the gate scope (``predictionio_tpu_torch/``, ``chip_smoke.py``,
  ``kernel_variants.py``) has no active finding, and every entry of
  ``analysis/baseline.json`` matches a finding and gives its reason.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import pytest

from predictionio_tpu import analysis as ref
from predictionio_tpu.analysis import cli as ref_cli
from predictionio_tpu.analysis.asynclint import AsyncEngine as RefAsync
from predictionio_tpu.analysis.contractlint import (
    ContractEngine as RefContract,
)
from predictionio_tpu.analysis.deadlint import DeadlockEngine as RefDeadlock
from predictionio_tpu.analysis.enginelint import (
    EngineImportEngine as RefEngineImport,
)
from predictionio_tpu.analysis.jaxlint import JaxEngine
from predictionio_tpu.analysis.locklint import LockEngine as RefLock
from predictionio_tpu.analysis.timelint import TimeEngine as RefTime
from predictionio_tpu_torch import analysis as port
from predictionio_tpu_torch.analysis import cli as port_cli
from predictionio_tpu_torch.analysis.asynclint import AsyncEngine
from predictionio_tpu_torch.analysis.contractlint import ContractEngine
from predictionio_tpu_torch.analysis.deadlint import DeadlockEngine
from predictionio_tpu_torch.analysis.enginelint import EngineImportEngine
from predictionio_tpu_torch.analysis.locklint import LockEngine
from predictionio_tpu_torch.analysis.timelint import TimeEngine
from predictionio_tpu_torch.analysis.torchlint import TorchEngine

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "piolint_fixtures"
# the rules that read no traced code: their fixtures are the same files
# for both analyzers (PIO301's renamed)
SHARED = sorted(p for p in FIXTURES.glob("*.py")
                if int(p.stem[3:6]) >= 109)


def _key(findings) -> set:
    return {(f.rule, f.line, f.col, f.scope) for f in findings}


def _forced(path: Path, torch_side: bool) -> list:
    """Every engine of one analyzer on one file, each scope forced on
    (the reference's own fixture runner, ``tests/test_piolint.py``)."""
    src = (port if torch_side else ref).SourceFile.load(path, path.parent)
    if torch_side:
        engines = (TorchEngine(src, bench_scope=True), LockEngine(src),
                   TimeEngine(src), AsyncEngine(src),
                   EngineImportEngine(src), DeadlockEngine([src]),
                   ContractEngine([src], path.parent, smoke_scope=True))
    else:
        engines = (JaxEngine(src, bench_scope=True), RefLock(src),
                   RefTime(src), RefAsync(src), RefEngineImport(src),
                   RefDeadlock([src]),
                   RefContract([src], path.parent, smoke_scope=True))
    return [f for e in engines for f in e.run()]


@pytest.mark.parametrize("fixture", SHARED, ids=lambda p: p.stem)
def test_fixture_findings_are_the_references(fixture, tmp_path):
    mine = fixture
    if fixture.stem.startswith("pio301"):
        mine = tmp_path / fixture.name
        mine.write_text(fixture.read_text().replace(
            "predictionio_tpu", "predictionio_tpu_torch"))
    want = _forced(fixture, torch_side=False)
    got = _forced(mine, torch_side=True)
    assert _key(got) == _key(want)
    assert bool(want) == fixture.stem.endswith("_pos")
    # the two analyze_paths agree too (only the deadlock engine applies
    # at a fixture's path outside the gate's scopes)
    assert _key(port.analyze_paths([mine], mine.parent)) == _key(
        ref.analyze_paths([fixture], fixture.parent))


def test_the_ports_source_gives_the_references_lock_findings():
    """PIO110 and PIO2xx are package-agnostic: both analyzers over the
    port's files find the same hazards (before any baseline)."""
    files = sorted((ROOT / "predictionio_tpu_torch").rglob("*.py"))
    rules = ("PIO110", "PIO2")

    def keyed(findings):
        return {(f.rule, f.path, f.line, f.col, f.scope) for f in findings
                if f.rule.startswith(rules)}

    mine = keyed(port.analyze_paths(files, ROOT))
    assert mine == keyed(ref.analyze_paths(files, ROOT))
    assert {r for r, *_ in mine} >= {"PIO202", "PIO211", "PIO212"}


@pytest.fixture(scope="module")
def gate():
    findings = port.analyze_paths(port_cli.default_paths(ROOT), ROOT)
    return findings, port.load_baseline(port_cli.BASELINE_PATH)


def test_the_gate_scope_has_no_active_finding(gate):
    findings, baseline = gate
    names = {f.path for f in findings} | {
        p.relative_to(ROOT).as_posix()
        for p in port_cli.default_paths(ROOT)}
    assert {"chip_smoke.py", "kernel_variants.py",
            "predictionio_tpu_torch/analysis/torchlint.py"} <= names
    baseline.apply(findings)
    active = [f.text() for f in findings if not f.baselined]
    assert active == [], "\n".join(active)


def test_every_baseline_entry_matches_a_finding_and_gives_its_reason(gate):
    findings, baseline = gate
    keys = {f.identity() for f in findings}
    assert baseline.entries
    for e in baseline.entries:
        assert (e["path"], e["rule"], e["scope"], e["snippet"]) in keys, e
        assert len(e.get("justification", "").split()) >= 8, e


def test_strict_refuses_a_deadlock_entry_without_a_reason(tmp_path, capsys):
    p = tmp_path / "clean.py"
    p.write_text("x = 1\n")
    base = tmp_path / "base.json"
    entry = {"path": "predictionio_tpu_torch/server/x.py",
             "rule": "PIO211", "scope": "X.y", "snippet": "cb()"}
    base.write_text(json.dumps({"version": 1, "entries": [entry]}))
    assert port.main([str(p), "--baseline", str(base), "--strict"]) == 1
    assert "lacks the justification" in capsys.readouterr().out
    entry["justification"] = "bounded pure read; order is one-directional"
    base.write_text(json.dumps({"version": 1, "entries": [entry]}))
    assert port.main([str(p), "--baseline", str(base), "--strict"]) == 0
    # the gate itself passes strict review of its deadlock entries
    assert port_cli.main(["--strict", str(p)]) == 0


def test_sarif_is_the_golden_apart_from_the_names():
    """``--format sarif`` on ``pio211_pos.py``: the golden file's
    results, schema and rule table, with the port's tool name and the
    rule texts that read torch or name the port's scopes."""
    fix = FIXTURES / "pio211_pos.py"
    src = port.SourceFile.load(fix, FIXTURES)
    findings = sorted(DeadlockEngine([src]).run(),
                      key=lambda f: (f.path, f.line, f.col, f.rule))
    got = port_cli._report_sarif(findings)
    golden = json.loads((Path(__file__).parent / "golden"
                         / "piolint_pio211_pos.sarif.json").read_text())
    assert got["runs"][0]["results"] == golden["runs"][0]["results"]
    assert got["runs"][0]["tool"]["driver"]["name"] == "piolint-torch"
    rules, grules = (r["runs"][0]["tool"]["driver"]["rules"]
                     for r in (got, golden))
    assert [r["id"] for r in rules] == [r["id"] for r in grules]
    differ = {a["id"] for a, b in zip(rules, grules) if a != b}
    assert differ == {"PIO101", "PIO102", "PIO103", "PIO105", "PIO107",
                      "PIO108", "PIO109", "PIO301"}
    for doc in (got, golden):
        doc["runs"][0]["tool"]["driver"] = {}
    assert got == golden


def _git(cwd: Path, *argv: str) -> None:
    subprocess.run(
        ["git", *argv], cwd=cwd, check=True, capture_output=True,
        env={"GIT_AUTHOR_NAME": "t", "GIT_AUTHOR_EMAIL": "t@t",
             "GIT_COMMITTER_NAME": "t", "GIT_COMMITTER_EMAIL": "t@t",
             "HOME": str(cwd), "PATH": "/usr/bin:/bin:/usr/local/bin"},
    )


def test_changed_files_follows_a_staged_rename(tmp_path):
    _git(tmp_path, "init", "-q")
    (tmp_path / "old_name.py").write_text("x = 1\n")
    _git(tmp_path, "add", "old_name.py")
    _git(tmp_path, "commit", "-qm", "seed")
    _git(tmp_path, "mv", "old_name.py", "new_name.py")
    (tmp_path / "added.py").write_text("y = 2\n")
    _git(tmp_path, "add", "added.py")
    got = {p.name for p in port_cli.changed_paths(tmp_path)}
    assert got == {"new_name.py", "added.py"} == {
        p.name for p in ref_cli.changed_paths(tmp_path)}


def test_the_module_runs_with_the_references_exit_codes(tmp_path):
    """``python -m predictionio_tpu_torch.analysis``: 1 on a finding, 0
    on a clean file, the summary line by engine, the JSON report, and
    the fixture corpus skipped when a directory is named."""
    def run(*argv):
        return subprocess.run(
            [sys.executable, "-m", "predictionio_tpu_torch.analysis",
             *argv], capture_output=True, text=True, cwd=ROOT)

    bad = run(str(FIXTURES / "pio211_pos.py"))
    assert bad.returncode == 1 and "PIO211" in bad.stdout
    summary = bad.stdout.strip().splitlines()[-1]
    for bucket in ("parse", "torch", "time", "async", "lock", "deadlock",
                   "engine", "contract"):
        assert re.search(rf"\b{bucket} \d+", summary), summary
    assert re.search(r"in \d+\.\d+s$", summary)
    report = tmp_path / "r.json"
    ok = run(str(FIXTURES / "pio211_neg.py"), "--format", "json",
             "--report", str(report))
    assert ok.returncode == 0
    assert json.loads(ok.stdout) == json.loads(report.read_text())
    assert json.loads(ok.stdout)["counts"]["active"] == 0
    assert run(str(FIXTURES.parent / "golden")).returncode == 0
    assert port_cli.main([str(FIXTURES.parent)]) == 0
    listed = run("--list-rules").stdout
    assert all(code in listed for code in port.RULES)
    assert set(port.RULES) == set(ref.RULES)


def test_inline_suppressions_and_baseline_identity(tmp_path):
    body = ("import threading\n\n\n"
            "class Q:\n"
            "    def __init__(self):\n"
            "        self._lock = threading.Lock()\n"
            "        self.depth = 0\n\n"
            "    def put(self):\n"
            "        with self._lock:\n"
            "            self.depth += 1\n\n"
            "    def drain(self):\n"
            "        self.depth -= 1{}\n")
    p = tmp_path / "q.py"
    for trailer, rules in (("", ["PIO201"]),
                           ("  # piolint: disable=PIO202", ["PIO201"]),
                           ("  # piolint: disable=PIO201", []),
                           ("  # piolint: disable", [])):
        p.write_text(body.format(trailer))
        assert [f.rule for f in port.analyze_file(p, tmp_path)] == rules
        assert [f.rule for f in ref.analyze_file(p, tmp_path)] == rules
    p.write_text(body.format(""))
    base = tmp_path / "base.json"
    port.Baseline.from_findings(port.analyze_file(p)).save(base)
    p.write_text("# moved\n" + body.format(""))
    assert port.main([str(p), "--baseline", str(base)]) == 0
    assert port.main([str(p), "--baseline", str(base), "--strict"]) == 1
