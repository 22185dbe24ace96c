"""Run-manifest command: list, summarize, and diff training runs from
their persistent manifests.

The port's counterpart of the reference's ``tools/runlog.py``, over
``predictionio_tpu_torch/obs/runlog.py``.  Every training/evaluation
run writes ``$PIO_TPU_HOME/telemetry/runs/<instance_id>/run.jsonl``;
this command is the offline triage surface:

    python -m predictionio_tpu_torch.tools.runlog list [--json]
        One line per run, newest first: status, sweeps, mean sweep
        seconds, loss endpoints.

    python -m predictionio_tpu_torch.tools.runlog summarize RUN [--sweeps]
        The full triage card: per-phase totals, slowest sweep, loss
        trajectory, shard-degradation events, watchdog verdict.

    python -m predictionio_tpu_torch.tools.runlog diff A B [--json]
        Phase-level A/B — per-phase per-sweep means and the B/A
        ratio, ordered by absolute time gained.  "Why did this train
        get slower" is answered by the phase whose ratio moved, not by
        staring at two end-to-end numbers.

Runs are named by instance id (resolved under the runs root, which
``--root`` / ``PIO_TPU_RUNLOG_DIR`` / ``PIO_TPU_HOME`` control) or by
an explicit path to a run directory / ``run.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from ..obs import runlog


def _resolve(spec: str, root) -> dict:
    p = Path(spec)
    if p.exists():
        view = runlog.read_manifest(p)
    else:
        view = runlog.read_manifest(runlog.runs_root(root) / spec)
    if view is None:
        raise SystemExit(
            f"no readable run manifest for {spec!r} "
            f"(looked under {runlog.runs_root(root)})"
        )
    return view


def _fmt_age(start: float) -> str:
    age = max(time.time() - start, 0.0)
    if age < 120:
        return f"{age:.0f}s ago"
    if age < 7200:
        return f"{age / 60:.0f}m ago"
    return f"{age / 3600:.1f}h ago"


def cmd_list(args) -> int:
    views = runlog.list_runs(args.root)
    if not views:
        print(f"(no run manifests under {runlog.runs_root(args.root)})")
        return 0
    if args.json:
        print(json.dumps([runlog.summarize(v) for v in views], indent=1))
        return 0
    for v in views:
        s = runlog.summarize(v)
        loss = (
            f"loss {s['firstLoss']:.4g}->{s['lastLoss']:.4g}"
            if s["firstLoss"] is not None and s["lastLoss"] is not None
            else "no loss"
        )
        status = s["status"] + (
            f"[{s['reason']}]" if s.get("reason") else ""
        )
        mean = (
            f"{s['sweepSecondsMean']:.3f}s/sweep"
            if s["sweepSecondsMean"] is not None else "-"
        )
        print(
            f"{s['instanceId']:<18} {s['runKind']:<5} {status:<22} "
            f"sweeps {s['sweeps']:>3} {mean:>14} {loss:<28} "
            f"{_fmt_age(s['start'] or 0.0)}"
        )
    return 0


def cmd_summarize(args) -> int:
    view = _resolve(args.run, args.root)
    out = runlog.summarize(view)
    if args.sweeps:
        out["sweepRecords"] = view["sweeps"]
    if view["events"]:
        out["eventRecords"] = view["events"][-20:]
    print(json.dumps(out, indent=1))
    return 0


def cmd_diff(args) -> int:
    a = _resolve(args.run_a, args.root)
    b = _resolve(args.run_b, args.root)
    out = runlog.diff_runs(a, b)
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    print(
        f"A = {out['a']['instanceId']} "
        f"({out['a']['sweeps']} sweeps, "
        f"mean {out['a']['sweepSecondsMean']}s)"
    )
    print(
        f"B = {out['b']['instanceId']} "
        f"({out['b']['sweeps']} sweeps, "
        f"mean {out['b']['sweepSecondsMean']}s)"
    )
    ratio = out["sweepMeanRatio"]
    print(f"sweep mean B/A: {ratio if ratio is not None else '?'}")
    print(f"{'phase':<16} {'A mean':>10} {'B mean':>10} "
          f"{'delta':>10} {'B/A':>7}")
    for r in out["phases"]:
        print(
            f"{r['phase']:<16} {r['aMeanSeconds']:>10.4f} "
            f"{r['bMeanSeconds']:>10.4f} {r['deltaSeconds']:>+10.4f} "
            + (f"{r['ratio']:>7.2f}" if r["ratio"] is not None
               else f"{'new':>7}")
        )
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.tools.runlog",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--root", default=None,
                    help="runs root (default: "
                         "$PIO_TPU_HOME/telemetry/runs)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ls = sub.add_parser("list", help="one line per run, newest first")
    ls.add_argument("--json", action="store_true")
    ls.set_defaults(fn=cmd_list)
    sm = sub.add_parser("summarize", help="one run's triage card")
    sm.add_argument("run", help="instance id or path")
    sm.add_argument("--sweeps", action="store_true",
                    help="include every raw sweep record")
    sm.set_defaults(fn=cmd_summarize)
    df = sub.add_parser("diff", help="phase-level A/B of two runs")
    df.add_argument("run_a")
    df.add_argument("run_b")
    df.add_argument("--json", action="store_true")
    df.set_defaults(fn=cmd_diff)
    args = ap.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        return 0  # `runlog.py list | head` is a legal pipeline


if __name__ == "__main__":
    sys.exit(main())
