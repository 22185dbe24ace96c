"""The readings a cell's limits are set from, at the cell's own size, in
one process on the card:

* the program: one train per seed through the timed path (the same
  ``ALSTrainer.train(init=(U0, V0))`` call the window makes), held to the
  float64 reference;
* the control, put in the program's place: ``reference-tf32``, the
  reference in float32 with its products on the TF32 tensor cores, or
  ``program-tf32``, the program's own TF32 path (``matmul_precision
  "high"``; the library solver honours it, the fused kernel always
  multiplies at float32 accuracy);
* ``--faults``: the harness's faults planted at this size (the initial
  factors returned unchanged, half of every row's ratings left out, one
  row of the returned table altered).

    python3 benchmark/control.py --workload ml20m-r64.fused \\
        --seeds 1,2,3 --control-seeds 101,102,103 --faults

One JSON line per reading, then a summary line: ``lower`` is the
largest program reading of each number, ``upper`` the smallest control
reading.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark import run  # noqa: E402

CONTROLS = ("reference-tf32", "program-tf32")


def _seeds(text: str) -> list:
    return [int(s) for s in text.split(",") if s]


def half_ratings(coo):
    """Every other rating of the COO: about half of each row's."""
    return tuple(a[::2].copy() for a in coo)


def altered_row(users):
    """The user table with its first row altered."""
    out = users.copy()
    out[0] = out[0] * -1.0 + 1.0
    return out


def readings_of(cell: dict, seed: int, controls: list, faults: bool,
                program: bool, dev) -> list:
    """Every asked-for reading of one seed."""
    import torch

    from benchmark import compare

    cfg = run.cell_config(cell, dev)
    inputs = run.make_inputs(cfg, seed, dev)
    ref = run.reference_tables(cfg, inputs, dev)
    out = []

    def record(side, tables, seconds=None):
        out.append({"seed": seed, "side": side, "seconds": seconds,
                    "readings": compare.readings(*tables, *ref)})

    def program_train(coo, **overrides):
        trainer = run.make_trainer(cfg, cell["traffic"], coo, dev,
                                   **overrides)
        t0 = time.perf_counter()
        got = trainer.train(init=inputs["init"])
        return (got.user_factors, got.item_factors), (
            time.perf_counter() - t0)

    if program:
        tables, secs = program_train(inputs["coo"])
        record("program", tables, secs)
        if faults:
            record("fault:altered_row", (altered_row(tables[0]), tables[1]))
    for kind in controls:
        if kind == "reference-tf32":
            t0 = time.perf_counter()
            tables = run.reference_tables(cfg, inputs, dev,
                                          dtype=torch.float32, tf32=True)
            record(kind, tables, time.perf_counter() - t0)
        else:
            record(kind, *program_train(inputs["coo"],
                                        matmul_precision="high"))
    if faults:
        record("fault:unchanged", inputs["init"])
        record("fault:half_ratings",
               program_train(half_ratings(inputs["coo"]))[0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--control", action="append", choices=CONTROLS)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    dev = run.cell_device(args.device)
    controls = args.control or [
        "program-tf32" if cell["traffic"]["solver"] == "xla"
        else "reference-tf32"]
    rows = []
    program_seeds = _seeds(args.seeds)
    control_seeds = _seeds(args.control_seeds)
    for seed in dict.fromkeys(program_seeds + control_seeds):
        got = readings_of(cell, seed, controls if seed in control_seeds
                          else [], args.faults and seed in control_seeds,
                          seed in program_seeds, dev)
        for row in got:
            print(json.dumps(row), flush=True)
        rows += got
    from benchmark.compare import NAMES

    summary = {}
    for name in NAMES:
        prog = [r["readings"][name] for r in rows if r["side"] == "program"]
        ctrl = [r["readings"][name] for r in rows if r["side"] in CONTROLS]
        summary[name] = {"lower": max(prog, default=None),
                         "upper": min(ctrl, default=None),
                         "program_n": len(prog), "control_n": len(ctrl)}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
