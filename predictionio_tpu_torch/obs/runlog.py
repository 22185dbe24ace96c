"""Training run manifests: a crash-tolerant JSONL journal per run.

`pio train` inherited the reference's blind spot: a Spark batch job
whose only observable surface was the training log.  The manifest closes
it — every training (and evaluation) run writes a structured journal
under ``$PIO_TPU_HOME/telemetry/runs/<instance_id>/run.jsonl`` that
answers, during OR after the run, "which sweep was slow, in which
phase, on which worker, and did the loss move?".

File contract (the crash-tolerance story):

* The **header** record is written ATOMICALLY (tmp file + rename), so
  a manifest either exists with a valid header or not at all — a crash
  during creation cannot leave a torn first line.
* Every subsequent record (``sweep`` / ``event`` / ``candidate`` /
  ``final``) is ONE appended, flushed JSON line.  A crash mid-append
  tears at most the LAST line; :func:`read_manifest` drops an
  unparsable trailing line and keeps everything before it (the
  ``StepCheckpointer`` torn-newest-step contract, applied to
  telemetry).
* A manifest without a ``final`` record is a **live** run (training in
  flight, or a crash — ``header.pid`` + mtime disambiguate for a
  human; the console renders both as "live/stale").

Record kinds (the schema table lives in docs/ARCHITECTURE.md "Tower"):

``header``     run identity: instance id, kind (train/eval), planned
               sweeps, worker count, config summary, start timestamp.
``sweep``      one training sweep: 1-based index, wall seconds, the
               per-phase decomposition (``phases`` — seconds by phase
               name, summing to ~the sweep wall), optional training
               loss (RMSE), device-memory high-water bytes,
               compile-count delta, shard events drained this sweep.
``event``      an out-of-band anomaly (shard degradation, watchdog
               warnings) with its own timestamp.
``candidate``  one evaluation-sweep candidate's score (eval runs).
``metrics``    a merged cluster registry snapshot (multi-worker runs;
               worker 0 appends one at finalize).
``final``      terminal status (completed/aborted/failed), totals,
               phase sums, abort reason.

Pure stdlib (the pio-obs contract): readable from any process and
from tests without touching a device.  The format is the reference's,
so each package's reader takes the other's manifests.
"""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path
from typing import Optional

__all__ = [
    "RunManifest",
    "list_runs",
    "read_manifest",
    "runs_root",
    "summarize",
    "diff_runs",
]

MANIFEST_NAME = "run.jsonl"


def runs_root(root: Optional[os.PathLike | str] = None) -> Path:
    """The manifest tree: ``$PIO_TPU_HOME/telemetry/runs`` (overridable
    for tests via the explicit argument or ``PIO_TPU_RUNLOG_DIR``)."""
    if root is not None:
        return Path(root)
    env = os.environ.get("PIO_TPU_RUNLOG_DIR")
    if env:
        return Path(env)
    from . import telemetry_home

    return telemetry_home() / "runs"


class RunManifest:
    """Writer for one run's journal.  Thread-safe; every append is one
    flushed line, so concurrent sweep/event writers interleave whole
    records (the GIL serializes single ``write`` calls and the file is
    opened in append mode)."""

    def __init__(self, instance_id: str, kind: str = "train",
                 meta: Optional[dict] = None,
                 root: Optional[os.PathLike | str] = None):
        self.instance_id = instance_id
        self.kind = kind
        self.dir = runs_root(root) / instance_id
        self.path = self.dir / MANIFEST_NAME
        self._lock = threading.Lock()
        self._file = None
        self._failed = False
        self.finalized = False
        header = {
            "kind": "header",
            "instanceId": instance_id,
            "runKind": kind,
            "start": time.time(),
            "pid": os.getpid(),
            **(meta or {}),
        }
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            tmp = self.dir / (MANIFEST_NAME + ".tmp")
            tmp.write_text(json.dumps(header) + "\n", encoding="utf-8")
            tmp.rename(self.path)  # atomic: header line is all-or-nothing
            self._file = open(self.path, "a", encoding="utf-8")
        except OSError:
            # telemetry must never fail a training run: a manifest that
            # cannot be written degrades to a no-op writer
            self._failed = True

    # -- writing -----------------------------------------------------------
    def append(self, record: dict) -> None:
        line = json.dumps(record) + "\n"
        with self._lock:
            if self._failed or self._file is None:
                return
            try:
                self._file.write(line)
                self._file.flush()
            except (OSError, ValueError):
                self._failed = True

    def sweep(self, index: int, seconds: float, phases: dict,
              **extra) -> None:
        """One training sweep (1-based ``index``).  ``phases`` maps
        phase name -> seconds and should sum to ~``seconds``."""
        self.append({
            "kind": "sweep",
            "i": index,
            "at": time.time(),
            "seconds": seconds,
            "phases": {k: round(v, 6) for k, v in phases.items()},
            **extra,
        })

    def event(self, event: str, **fields) -> None:
        self.append({
            "kind": "event", "event": event, "at": time.time(), **fields,
        })

    def candidate(self, index: int, **fields) -> None:
        """One evaluation candidate's outcome (eval runs)."""
        self.append({
            "kind": "candidate", "i": index, "at": time.time(), **fields,
        })

    def metrics(self, merged_state: dict, workers: list) -> None:
        """A merged cluster-registry snapshot (multi-worker runs)."""
        self.append({
            "kind": "metrics", "at": time.time(),
            "workers": workers, "state": merged_state,
        })

    def finalize(self, status: str, **fields) -> None:
        """Append the terminal record and close.  Idempotent — only the
        first call writes (an abort path and a generic error path may
        both try)."""
        with self._lock:
            if self.finalized:
                return
            self.finalized = True
        self.append({
            "kind": "final", "status": status, "at": time.time(), **fields,
        })
        self.close()

    def close(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None


# -- reading ----------------------------------------------------------------


def read_manifest(path: os.PathLike | str) -> Optional[dict]:
    """Parse one manifest (a run dir or the ``run.jsonl`` itself) into
    ``{"header", "sweeps", "events", "candidates", "metrics", "final",
    "live", "path"}``.  Torn trailing line (crash mid-append) is
    dropped; a torn line ANYWHERE else is skipped too (never happens
    under the writer contract, but a reader must not die on it).
    Returns None when there is no valid header."""
    p = Path(path)
    if p.is_dir():
        p = p / MANIFEST_NAME
    try:
        lines = p.read_text(encoding="utf-8").splitlines()
    except OSError:
        return None
    records = []
    for ln in lines:
        ln = ln.strip()
        if not ln:
            continue
        try:
            records.append(json.loads(ln))
        except json.JSONDecodeError:
            continue
    if not records or records[0].get("kind") != "header":
        return None
    out = {
        "header": records[0],
        "sweeps": [r for r in records if r.get("kind") == "sweep"],
        "events": [r for r in records if r.get("kind") == "event"],
        "candidates": [r for r in records if r.get("kind") == "candidate"],
        "metrics": [r for r in records if r.get("kind") == "metrics"],
        "final": next(
            (r for r in records if r.get("kind") == "final"), None
        ),
        "path": str(p),
    }
    out["live"] = out["final"] is None
    return out


def list_runs(root: Optional[os.PathLike | str] = None,
              limit: Optional[int] = None) -> list:
    """Parsed manifests under the runs root, newest header first."""
    base = runs_root(root)
    views = []
    try:
        dirs = [d for d in base.iterdir() if d.is_dir()]
    except OSError:
        return []
    for d in dirs:
        v = read_manifest(d)
        if v is not None:
            views.append(v)
    views.sort(key=lambda v: v["header"].get("start", 0.0), reverse=True)
    return views[:limit] if limit else views


# -- derived views -----------------------------------------------------------


def phase_totals(view: dict) -> dict:
    """Seconds per phase summed over all sweep records."""
    out: dict[str, float] = {}
    for s in view["sweeps"]:
        for k, v in (s.get("phases") or {}).items():
            out[k] = out.get(k, 0.0) + float(v)
    return out


def summarize(view: dict) -> dict:
    """One run's triage card: counts, totals, per-phase sums, slowest
    sweep, loss trajectory endpoints — what ``tools/runlog.py
    summarize`` prints and ``/train.html`` renders per row."""
    sweeps = view["sweeps"]
    seconds = [float(s.get("seconds", 0.0)) for s in sweeps]
    losses = [
        (s["i"], s["loss"]) for s in sweeps
        if s.get("loss") is not None
    ]
    slowest = None
    if sweeps:
        worst = max(sweeps, key=lambda s: float(s.get("seconds", 0.0)))
        slowest = {"i": worst["i"], "seconds": worst.get("seconds")}
    final = view["final"] or {}
    hdr = view["header"]
    planned = hdr.get("sweepsPlanned")
    if planned is None:
        # the trainer declares its budget after the header is written
        planned = next(
            (e.get("sweepsPlanned") for e in view["events"]
             if e.get("event") == "plan"), None,
        )
    return {
        "instanceId": hdr.get("instanceId"),
        "runKind": hdr.get("runKind"),
        "start": hdr.get("start"),
        "live": view["live"],
        "status": final.get("status", "live"),
        "reason": final.get("reason"),
        "sweeps": len(sweeps),
        "sweepsPlanned": planned,
        "sweepSecondsTotal": round(sum(seconds), 6),
        "sweepSecondsMean": (
            round(sum(seconds) / len(seconds), 6) if seconds else None
        ),
        "phaseTotals": {
            k: round(v, 6) for k, v in sorted(phase_totals(view).items())
        },
        "slowestSweep": slowest,
        "firstLoss": losses[0][1] if losses else None,
        "lastLoss": losses[-1][1] if losses else None,
        "events": sum(
            1 for e in view["events"] if e.get("event") != "plan"
        ),
        "candidates": len(view["candidates"]),
        "workers": hdr.get("workers"),
        "wallSeconds": final.get("wallSeconds"),
    }


def diff_runs(a: dict, b: dict) -> dict:
    """Phase-level A/B between two runs — the regression-triage view:
    per-phase total and per-sweep mean for each run plus the B/A
    ratio, ordered by how much absolute time the phase gained."""

    def per_sweep(view):
        n = max(len(view["sweeps"]), 1)
        return {k: v / n for k, v in phase_totals(view).items()}

    pa, pb = per_sweep(a), per_sweep(b)
    rows = []
    for phase in sorted(set(pa) | set(pb)):
        va, vb = pa.get(phase, 0.0), pb.get(phase, 0.0)
        rows.append({
            "phase": phase,
            "aMeanSeconds": round(va, 6),
            "bMeanSeconds": round(vb, 6),
            "deltaSeconds": round(vb - va, 6),
            "ratio": round(vb / va, 4) if va > 0 else None,
        })
    rows.sort(key=lambda r: -abs(r["deltaSeconds"]))
    sa, sb = summarize(a), summarize(b)
    return {
        "a": {"instanceId": sa["instanceId"], "sweeps": sa["sweeps"],
              "sweepSecondsMean": sa["sweepSecondsMean"]},
        "b": {"instanceId": sb["instanceId"], "sweeps": sb["sweeps"],
              "sweepSecondsMean": sb["sweepSecondsMean"]},
        "sweepMeanRatio": (
            round(sb["sweepSecondsMean"] / sa["sweepSecondsMean"], 4)
            if sa["sweepSecondsMean"] and sb["sweepSecondsMean"] else None
        ),
        "phases": rows,
    }
