"""Trace stitcher: join one trace id's spans across every process's
span journal into a single tree.

The port's counterpart of the reference's ``tools/tracecat.py``, over
``predictionio_tpu_torch/obs/trace.py`` (``collect_spans``,
``build_tree``).  The router mints (or forwards) ``X-PIO-Trace``; each
process — router, replicas, the event server on the feedback hop —
journals its spans to ``<telemetry-dir>/spans-*.jsonl`` (rotated
segments included).  This command greps ONE trace id out of all of
them and nests the spans by interval containment, so "where did this
slow fleet request go" is one command::

    python -m predictionio_tpu_torch.tools.tracecat t-4f1c9a2b \\
        [--dir ~/.predictionio_tpu/telemetry] [--json] [--eps 0.05]

Output (text mode)::

    trace t-4f1c9a2b — 4 spans across 2 processes
    └─ router.request 212.4ms  [pid 71002]  replica=replica-1
       ├─ router.forward 210.9ms  [pid 71002]  replica=replica-1
       │  └─ serve.query 208.1ms  [pid 71044]  device=201.2ms ...

Containment is wall-clock based (same machine, NTP-close hosts): a
span nests under the smallest earlier-starting span whose
``[start, start+duration]`` interval covers it within ``--eps``
seconds.  Spans that fit under nothing become additional roots (a
feedback delivery that outlives the request, say).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

from ..obs import telemetry_home
from ..obs.trace import build_tree, collect_spans


def default_dir() -> Path:
    explicit = os.environ.get("PIO_TPU_TELEMETRY_DIR")
    return Path(explicit) if explicit else telemetry_home()


def _fmt_attrs(attrs: dict) -> str:
    out = []
    for k in ("replica", "status", "instance", "engine", "worker"):
        if k in attrs:
            out.append(f"{k}={attrs[k]}")
    segs = attrs.get("segmentsMs")
    if isinstance(segs, dict) and segs:
        top = sorted(segs.items(), key=lambda kv: -kv[1])[:3]
        out.append(",".join(f"{k}={v}ms" for k, v in top))
    if attrs.get("failedReplicas"):
        out.append(f"failed={','.join(attrs['failedReplicas'])}")
    return "  ".join(out)


def render_tree(trace_id: str, roots: list[dict],
                n_spans: int, n_procs: int) -> str:
    lines = [
        f"trace {trace_id} — {n_spans} span"
        f"{'s' if n_spans != 1 else ''} across {n_procs} process"
        f"{'es' if n_procs != 1 else ''}"
    ]

    def walk(node: dict, prefix: str, last: bool) -> None:
        stem = "└─ " if last else "├─ "
        who = f"[pid {node.get('pid', '?')}"
        if node.get("worker") is not None:
            who += f" w{node['worker']}"
        who += "]"
        extra = _fmt_attrs(node.get("attrs") or {})
        lines.append(
            f"{prefix}{stem}{node['name']} "
            f"{node.get('durationSec', 0.0) * 1e3:.1f}ms  {who}"
            + (f"  {extra}" if extra else "")
        )
        child_prefix = prefix + ("   " if last else "│  ")
        kids = sorted(node["children"], key=lambda c: c["_start"])
        for j, c in enumerate(kids):
            walk(c, child_prefix, j == len(kids) - 1)

    for j, r in enumerate(roots):
        walk(r, "", j == len(roots) - 1)
    return "\n".join(lines)


def _strip(node: dict) -> dict:
    out = {k: v for k, v in node.items()
           if k not in ("children", "_start", "_end", "_journal")}
    out["children"] = [_strip(c) for c in
                       sorted(node["children"],
                              key=lambda c: c["_start"])]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m predictionio_tpu_torch.tools.tracecat",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("trace_id", help="the X-PIO-Trace id (t-...)")
    ap.add_argument("--dir", default=None,
                    help="telemetry dir holding spans-*.jsonl "
                    "(default: $PIO_TPU_TELEMETRY_DIR or "
                    "$PIO_TPU_HOME/telemetry)")
    ap.add_argument("--eps", type=float, default=0.05,
                    help="containment slack in seconds (cross-process "
                    "wall clocks; default 0.05)")
    ap.add_argument("--json", action="store_true",
                    help="machine output: {traceId, spanCount, "
                    "processCount, roots}")
    args = ap.parse_args(argv)

    journal_dir = Path(args.dir) if args.dir else default_dir()
    spans = collect_spans(args.trace_id, journal_dir)
    if not spans:
        print(f"no spans for {args.trace_id} under {journal_dir} "
              "(is journaling on? set PIO_TPU_TELEMETRY_DIR or pass "
              "--telemetry-dir to the servers)", file=sys.stderr)
        return 1
    procs = {(s.get("pid"), s.get("worker")) for s in spans}
    roots = build_tree(spans, eps=args.eps)
    if args.json:
        print(json.dumps({
            "traceId": args.trace_id,
            "spanCount": len(spans),
            "processCount": len(procs),
            "rootCount": len(roots),
            "roots": [_strip(r) for r in roots],
        }, indent=1))
    else:
        print(render_tree(args.trace_id, roots, len(spans),
                          len(procs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
