"""pio-scope fleet profiler: merge every hive process's rolling CPU
profile into ONE flamegraph, with an A/B diff mode.

The port's counterpart of the reference's ``tools/profcat.py``, over
``predictionio_tpu_torch/obs/scope.py`` (``parse_folded``,
``merge_folded``, ``render_folded``, ``flamegraph_html``): the same
flags, tables and files.  Like ``runlog`` and ``tracecat`` it imports
no torch.

Every server (router, replicas, eventserver, ingest router, dashboard)
mounts ``GET /debug/pprof?seconds=S`` — collapsed-stack text answered
non-blocking from the always-on sampler's ring, with the registered
thread role as the root frame.  This CLI fetches any number of them,
merges the folded stacks (counts sum exactly — same format, same
epoch-second buckets), and answers "where is the fleet's CPU going"
as a table, a ``.folded`` file, or a self-contained flamegraph HTML::

    python -m predictionio_tpu_torch.tools.profcat \\
        http://host:8000 http://host:8001 --top 15
    python -m predictionio_tpu_torch.tools.profcat \\
        --fleet http://router:8000 --html fleet.html
    python -m predictionio_tpu_torch.tools.profcat \\
        http://host:8000 --out after.folded
    python -m predictionio_tpu_torch.tools.profcat \\
        http://host:8000 --diff before.folded \\
        --html regress.html    # red = grew, green = shrank

``--fleet URL`` discovers the fleet from a router's ``GET /`` status
payload (serving ``replicas`` or ingest ``workers`` — both carry
``url``) and profiles the router AND every member, so one command
yields the router-vs-replica CPU split.  ``--diff`` takes a prior
``--out`` file or a live URL, enabling the before/after view across a
deploy or a config change.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.parse
import urllib.request
from pathlib import Path

from ..obs import scope


def fetch_status(url: str, timeout: float) -> dict:
    with urllib.request.urlopen(url.rstrip("/") + "/", timeout=timeout) as r:
        return json.loads(r.read().decode())


def fetch_folded(url: str, seconds: float, state: str,
                 timeout: float) -> dict[str, int]:
    qs = f"/debug/pprof?seconds={seconds:g}"
    if state:
        qs += f"&state={urllib.parse.quote(state)}"
    with urllib.request.urlopen(url.rstrip("/") + qs, timeout=timeout) as r:
        return scope.parse_folded(r.read().decode())


def discover_fleet(router_url: str, timeout: float) -> list[str]:
    """Router + every fleet member the router's status names: serving
    replicas (`router.status_json`) or ingest workers (same `Replica`
    snapshot shape).  A member without a reachable ``url`` is skipped
    with a note — a dead worker has no profile to merge."""
    urls = [router_url]
    try:
        status = fetch_status(router_url, timeout)
    except Exception as e:
        print(f"profcat: cannot read {router_url}/: {e}", file=sys.stderr)
        return urls
    for member in (status.get("replicas") or status.get("workers") or ()):
        u = member.get("url")
        if u:
            urls.append(u)
    return urls


def load_profile(source: str, seconds: float, state: str,
                 timeout: float) -> dict[str, int]:
    """A profile source is a live URL or a ``.folded`` file path."""
    if source.startswith(("http://", "https://")):
        return fetch_folded(source, seconds, state, timeout)
    return scope.parse_folded(Path(source).read_text())


def split_by_root(agg: dict[str, int]) -> dict[str, int]:
    """Samples per root frame — with per-source tagging the roots are
    ``source/role``, so this IS the router-vs-replica CPU split."""
    out: dict[str, int] = {}
    for stack, count in agg.items():
        root = stack.split(";", 1)[0]
        out[root] = out.get(root, 0) + count
    return out


def top_table(agg: dict[str, int], n: int) -> str:
    total = sum(agg.values()) or 1
    lines = [f"{'samples':>9}  {'share':>6}  stack"]
    ranked = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    for stack, count in ranked:
        lines.append(f"{count:>9}  {count / total:>6.1%}  {stack}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge /debug/pprof profiles across the hive",
    )
    ap.add_argument("sources", nargs="*", metavar="URL|FILE",
                    help="servers to profile (http://host:port) or "
                    "prior --out .folded files to merge")
    ap.add_argument("--fleet", metavar="ROUTER_URL",
                    help="discover + profile a router and every "
                    "replica/worker its GET / status names")
    ap.add_argument("--seconds", type=float, default=60.0,
                    help="ring window to read (default 60)")
    ap.add_argument("--state", default="",
                    choices=("", "running", "waiting"),
                    help="restrict to on-CPU (running) or blocked "
                    "(waiting) samples; default both")
    ap.add_argument("--timeout", type=float, default=5.0)
    ap.add_argument("--top", type=int, default=20,
                    help="stacks to print in the table (default 20)")
    ap.add_argument("--no-tag", action="store_true",
                    help="merge without per-source root tagging "
                    "(same-process A/A merges want untagged roots)")
    ap.add_argument("--out", metavar="FILE",
                    help="write the merged collapsed-stack text here "
                    "(later profcat runs accept it as a source or "
                    "--diff baseline)")
    ap.add_argument("--html", metavar="FILE",
                    help="write a self-contained flamegraph page here")
    ap.add_argument("--diff", metavar="URL|FILE",
                    help="baseline profile: the table and flamegraph "
                    "show per-frame share deltas vs it (A/B mode)")
    args = ap.parse_args(argv)

    sources = list(args.sources)
    if args.fleet:
        sources = discover_fleet(args.fleet, args.timeout) + sources
    if not sources:
        ap.error("no sources: pass URLs/files or --fleet ROUTER_URL")

    parts: list[dict[str, int]] = []
    for src in sources:
        try:
            prof = load_profile(src, args.seconds, args.state,
                                args.timeout)
        except Exception as e:
            print(f"profcat: skipping {src}: {e}", file=sys.stderr)
            continue
        if not args.no_tag and len(sources) > 1:
            # tag each source's roots so the merged graph keeps the
            # per-process split: "8001/eventloop;..." vs
            # "router/health_loop;..."
            tag = urllib.parse.urlparse(src).port \
                if src.startswith("http") else Path(src).stem
            prof = {f"{tag}/{stack}": c for stack, c in prof.items()}
        parts.append(prof)
    if not parts:
        print("profcat: no profiles fetched", file=sys.stderr)
        return 1
    agg = scope.merge_folded(parts)
    total = sum(agg.values())

    baseline = None
    if args.diff:
        try:
            baseline = load_profile(args.diff, args.seconds, args.state,
                                    args.timeout)
        except Exception as e:
            print(f"profcat: cannot load baseline {args.diff}: {e}",
                  file=sys.stderr)
            return 1

    print(f"# {len(parts)} profile(s), {total} samples, "
          f"window {args.seconds:g}s")
    roots = split_by_root(agg)
    for root, count in sorted(roots.items(), key=lambda kv: -kv[1]):
        print(f"#   {root}: {count} ({count / (total or 1):.1%})")
    print(top_table(agg, args.top))
    if baseline:
        btotal = sum(baseline.values()) or 1
        broots = split_by_root(baseline)
        print("# share delta vs baseline (by root):")
        for root in sorted(set(roots) | set(broots)):
            d = roots.get(root, 0) / (total or 1) \
                - broots.get(root, 0) / btotal
            print(f"#   {root}: {d:+.1%}")

    if args.out:
        Path(args.out).write_text(scope.render_folded(agg))
        print(f"# wrote {args.out}")
    if args.html:
        Path(args.html).write_text(scope.flamegraph_html(
            scope.render_folded(agg),
            title=f"profcat: {len(parts)} source(s), {total} samples",
            baseline=(scope.render_folded(baseline)
                      if baseline else None),
        ))
        print(f"# wrote {args.html}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
