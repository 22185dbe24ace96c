"""The harness end to end on the host (``--device cpu``, a tiny size):
it finds a cell's files by name, refuses what it must, reads a sound
run as correct and each fault of the timed path as not correct."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import run
from predictionio_tpu_torch.models.als import ALSTrainer

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def rehearse(capsys, cell, seed=2 ** 32 + 5, trace=0):
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds",
                   "0.1", "--trace", str(trace), "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 0
    return json.loads(out[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    got = run.load_cell(cell)
    assert got["config"]["name"] == next(
        w["config"] for w in SPEC["workloads"] if w["name"] == cell)
    assert got["traffic"]["solver"] in ("fused", "xla")
    assert set(got["limits"]) == {"factor_err", "row_err"}
    assert "setup_s" in [m["name"] for m in got["end_to_end"]]
    for m in got["end_to_end"] + got["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def test_unknown_cell_refused(capsys):
    assert run.main(["--workload", "no-such.cell", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""
    with pytest.raises(run.CellError):
        run.load_reader("no_such_metric")


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cell", ["ml20m-r64.fused", "ml20m-r64.xla"])
def test_sound_rehearsal_is_correct_and_prints_no_device_metric(
        capsys, cell):
    line = rehearse(capsys, cell, trace=1)
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 3     # warm, window and traced trains
    assert "metrics" not in line and "device" not in line
    assert set(line["read"]) <= {"staging_s", "half_ms.user",
                                 "half_ms.item", "launches_per_iter"}
    assert list(line)[-1] == "checks"


def _unchanged(self, U, V, num_iterations, lam=None):
    """A train that returns its initial factors."""
    dtype = getattr(torch, self.cfg.compute_dtype)
    return (torch.as_tensor(U).to(self.device, dtype).clone(),
            torch.as_tensor(V).to(self.device, dtype).clone())


def _half_ratings(monkeypatch):
    init = ALSTrainer.__init__

    def half(self, ratings, *args, **kwargs):
        init(self, tuple(np.asarray(a)[::2] for a in ratings), *args,
             **kwargs)

    monkeypatch.setattr(ALSTrainer, "__init__", half)


def _altered_row(monkeypatch):
    factors = ALSTrainer._factors

    def altered(self, U, V):
        out = factors(self, U, V)
        out.user_factors[0] = -out.user_factors[0] + 1.0
        return out

    monkeypatch.setattr(ALSTrainer, "_factors", altered)


FAULTS = {
    "state_unchanged": lambda mp: mp.setattr(ALSTrainer, "run", _unchanged),
    "half_the_ratings": _half_ratings,
    "answer_altered": _altered_row,
}


@pytest.mark.parametrize("cell", ["ml20m-r64.fused", "ml20m-r64.xla"])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_of_the_timed_path_is_not_correct(capsys, monkeypatch, cell,
                                                fault):
    FAULTS[fault](monkeypatch)
    line = rehearse(capsys, cell)
    assert line["correct"] is False
    assert line["failed"] == line["attempted"] >= 2


def test_a_run_as_a_process(tmp_path):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml20m-r64.xla",
         "--seed", "3000000000", "--seconds", "0.1", "--trace", "0",
         "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert out.stderr.strip().splitlines()[-1].startswith("check row_err")


def test_benchmark_alone_is_no_run(tmp_path):
    """A checkout that holds only ``BENCHMARK.json`` and the benchmark's
    folder has no program to run: no result, a code other than 0."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml20m-r64.xla",
         "--seed", "1", "--seconds", "0.1", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
