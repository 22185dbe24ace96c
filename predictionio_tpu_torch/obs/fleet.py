"""pio-lens: fleet-wide observability primitives.

The fourth observability leg (pulse=serving, xray=compiler,
tower=training, **lens=fleet**): ``deploy --replicas N`` masks replica
failures so well that the operator can no longer see *which* replica is
eating the tail.  This module holds the process-neutral pieces the
router integration (`server/router.py`) and the dashboard build on:

* :func:`parse_prometheus` — the exposition text format parsed BACK
  into the :meth:`~predictionio_tpu_torch.obs.registry.MetricsRegistry.
  dump_state` schema, the exact inverse of
  :func:`~predictionio_tpu_torch.obs.registry.render_state`
  (property-tested: ``parse_prometheus(render_state(s)) == s``).  The
  router's health loop scrapes each replica's ``/metrics`` through
  this, then re-merges with ``registry.merge_states`` — Prometheus-
  style federation where the merged exposition is byte-compatible
  with a single process that saw every observation.
* :class:`BurnRateTracker` / :func:`install_burn_rate` — SLO burn-rate
  gauges ``pio_slo_burn_rate{window}`` derived from latency-histogram
  DELTAS against a configured SLO: burn rate 1.0 means the error
  budget (1 - objective, default objective 0.99) is being spent
  exactly at the sustainable rate; >> 1 over the short window is the
  page-now signal, >> 1 over the long window the ticket signal.
  Installed on both the replicas' end-to-end latency histogram and the
  router's forward round-trip histogram, so the 10k-QPS fleet sweep
  has an alert-ready signal without a rules engine.
* the router metric families (forward round-trip histogram, router
  timeline segment family, replica scrape-error counter) and the
  ``/debug/fleet`` payload provider hook the dashboard's
  ``fleet.html`` renders through.

Pure stdlib; importable from every layer without cycles (same
contract as the rest of ``obs/``).
"""

from __future__ import annotations

import math
import os
import re
import threading
import time
from typing import Callable, Optional, Sequence

from . import get_registry, log_buckets
from .registry import merge_states, render_state
from .timeline import register_segment_family

__all__ = [
    "BurnRateTracker",
    "BURN_WINDOWS",
    "ROUTER_SEGMENTS",
    "fleet_payload",
    "hist_quantile",
    "install_burn_rate",
    "parse_prometheus",
    "render_fleet",
    "set_fleet_provider",
    "state_counter_total",
    "state_histogram",
]

_registry = get_registry()

# -- metric families (pio-lens catalog) -------------------------------------

REPLICA_SCRAPE_ERRORS = _registry.counter(
    "pio_replica_scrape_errors_total",
    "Replica /metrics scrapes the router could not complete or parse "
    "(the last good snapshot keeps standing in the merged exposition)",
    labels=("replica",),
)
ROUTER_FORWARD_SECONDS = _registry.histogram(
    "pio_router_forward_seconds",
    "Router-observed replica round-trip time per forwarded query "
    "(connect + send + replica serve + response read)",
)
ROUTER_SEGMENT_SECONDS = _registry.histogram(
    "pio_router_segment_seconds",
    "Per-request router-path segment durations (admission/forward/"
    "replica/read/write); per-request segments sum to the handler "
    "wall time, the same accounting identity as "
    "pio_serve_segment_seconds",
    labels=("segment",),
    buckets=log_buckets(1e-6, 100.0, per_decade=4),
)
SLO_BURN_RATE = _registry.gauge(
    "pio_slo_burn_rate",
    "Error-budget burn rate per trailing window: (fraction of "
    "requests over the SLO latency) / (1 - objective); 1.0 spends "
    "the budget exactly at the sustainable rate",
    labels=("window",),
)
SLO_TARGET_SECONDS = _registry.gauge(
    "pio_slo_target_seconds",
    "The configured --slo-ms latency objective this process's burn "
    "rates are computed against (0 = no SLO configured)",
)

# the router request taxonomy (display order on fleet.html):
#   admission — loop-thread time: parse + deadline-admission decision
#   forward   — worker-pool queue wait + connect + request send
#   replica   — waiting on the replica (serve time + response headers)
#   read      — draining the response body
#   write     — socket write of the reply back to the client
ROUTER_SEGMENTS = ("admission", "forward", "replica", "read", "write")
register_segment_family("router", ROUTER_SEGMENT_SECONDS,
                        ROUTER_SEGMENTS)


# -- exposition parsing (the scrape half of federation) ---------------------

_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')
_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)$"
)
_EXEMPLAR_RE = re.compile(
    r"^# EXEMPLAR ([a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{(.*)\} "
    r'trace_id="((?:[^"\\]|\\.)*)" value=(\S+)(?: ts=(\S+))?$'
)
_ESCAPE_RE = re.compile(r"\\(.)")


def _unescape(v: str) -> str:
    return _ESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), v
    )


def _num(tok: str) -> float:
    if tok == "+Inf" or tok == "Inf":
        return float("inf")
    if tok == "-Inf":
        return float("-inf")
    if tok == "NaN":
        return float("nan")
    return float(tok)


def _parse_labels(raw: str) -> list[tuple[str, str]]:
    """``k="v"`` pairs in order; quote-aware so escaped quotes and
    commas/braces INSIDE a label value parse correctly (the naive
    split-on-comma parser in tools/obs_smoke.py stays as an
    independent cross-check)."""
    out = []
    pos = 0
    raw = raw.strip()
    while pos < len(raw):
        m = _LABEL_RE.match(raw, pos)
        if m is None:
            raise ValueError(f"malformed label block at {raw[pos:]!r}")
        out.append((m.group(1), _unescape(m.group(2))))
        pos = m.end()
        if pos < len(raw):
            if raw[pos] != ",":
                raise ValueError(
                    f"expected ',' between labels at {raw[pos:]!r}"
                )
            pos += 1
    return out


def parse_prometheus(text: str) -> dict:
    """Parse text exposition format 0.0.4 back into the
    ``dump_state()`` schema.  Strict by design — a malformed line
    raises ``ValueError`` (the router books a scrape error and keeps
    the replica's last good snapshot), every sample must be preceded by
    its ``# TYPE`` declaration, histogram children must close with a
    ``+Inf`` bucket, and cumulative bucket counts must be monotone.

    Inverse of :func:`~predictionio_tpu_torch.obs.registry.render_state` for
    states with at least one child per family (a child-less labeled
    family renders no sample lines, so its label names are not
    recoverable from text — irrelevant for merging, which unions
    children)."""
    fams: dict[str, dict] = {}
    help_pending: dict[str, str] = {}

    def fam_for_sample(name: str):
        fam = fams.get(name)
        if fam is not None and fam["kind"] != "histogram":
            return fam, None
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix):
                base = fams.get(name[: -len(suffix)])
                if base is not None and base["kind"] == "histogram":
                    return base, suffix
        if fam is not None:  # a bare histogram-family sample line
            raise ValueError(
                f"histogram family {name!r} has a bare sample line"
            )
        return None, None

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_text = rest.partition(" ")
            help_pending[name] = help_text
            continue
        if line.startswith("# TYPE "):
            parts = line.split(" ")
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line: {line!r}")
            _, _, name, kind = parts
            if kind not in ("counter", "gauge", "histogram"):
                raise ValueError(
                    f"unsupported metric kind {kind!r} in {line!r}"
                )
            fams[name] = {
                "name": name,
                "help": help_pending.get(name, ""),
                "kind": kind,
                "labelNames": None,
                "children": {},
            }
            continue
        if line.startswith("# EXEMPLAR "):
            m = _EXEMPLAR_RE.match(line)
            if m is None:
                raise ValueError(f"malformed EXEMPLAR line: {line!r}")
            fam = fams.get(m.group(1))
            if fam is None or fam["kind"] != "histogram":
                raise ValueError(
                    f"exemplar for undeclared histogram {m.group(1)!r}"
                )
            labels = _parse_labels(m.group(2))
            le = dict(labels).get("le")
            if le is None:
                raise ValueError(f"exemplar without le: {line!r}")
            key = tuple((k, v) for k, v in labels if k != "le")
            child = fam["children"].get(key)
            if child is None:
                raise ValueError(
                    f"exemplar precedes its bucket samples: {line!r}"
                )
            child.setdefault("exemplars", []).append([
                le, _unescape(m.group(3)), _num(m.group(4)),
                _num(m.group(5)) if m.group(5) is not None else 0.0,
            ])
            continue
        if line.startswith("#"):
            continue  # other comments are legal and ignored
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"malformed sample line: {line!r}")
        name, labels_raw, value_tok = m.group(1), m.group(2), m.group(3)
        labels = _parse_labels(labels_raw or "")
        fam, suffix = fam_for_sample(name)
        if fam is None:
            raise ValueError(
                f"sample {name!r} precedes its # TYPE declaration"
            )
        v = _num(value_tok)
        if fam["kind"] != "histogram":
            key = tuple(labels)
            if key in fam["children"]:
                raise ValueError(
                    f"duplicate sample for {name}{dict(labels)}"
                )
            fam["children"][key] = {
                "labels": [list(kv) for kv in labels],
                "value": v,
            }
            if fam["labelNames"] is None:
                fam["labelNames"] = [k for k, _ in labels]
            continue
        key = tuple((k, x) for k, x in labels if k != "le")
        child = fam["children"].setdefault(key, {
            "labels": [list(kv) for kv in key],
            "_cum": [],
            "_sum": None,
            "_count": None,
        })
        if suffix == "_bucket":
            le = dict(labels).get("le")
            if le is None:
                raise ValueError(f"bucket sample without le: {line!r}")
            child["_cum"].append((le, v))
        elif suffix == "_sum":
            child["_sum"] = v
        else:
            child["_count"] = v
        if fam["labelNames"] is None:
            fam["labelNames"] = [k for k, _ in key]

    families = []
    for fam in fams.values():
        children = []
        for child in fam["children"].values():
            if fam["kind"] != "histogram":
                children.append(child)
                continue
            cum = child["_cum"]
            if not cum or cum[-1][0] != "+Inf":
                raise ValueError(
                    f"histogram {fam['name']} child does not close "
                    "with a +Inf bucket"
                )
            if child["_sum"] is None or child["_count"] is None:
                raise ValueError(
                    f"histogram {fam['name']} child is missing its "
                    "_sum/_count samples"
                )
            bounds, counts, prev = [], [], 0.0
            for le, c in cum:
                if c < prev:
                    raise ValueError(
                        f"histogram {fam['name']}: cumulative bucket "
                        f"counts regressed at le={le}"
                    )
                counts.append(int(c - prev))
                prev = c
                if le != "+Inf":
                    bounds.append(float(le))
            if sorted(bounds) != bounds:
                raise ValueError(
                    f"histogram {fam['name']}: bucket bounds out of "
                    "order"
                )
            if int(child["_count"]) != int(cum[-1][1]):
                raise ValueError(
                    f"histogram {fam['name']}: _count disagrees with "
                    "the +Inf bucket"
                )
            children.append({
                "labels": child["labels"],
                "hist": {
                    "bounds": bounds,
                    "counts": counts,
                    "sum": child["_sum"],
                    "count": int(child["_count"]),
                    "exemplars": child.get("exemplars", []),
                },
            })
        families.append({
            "name": fam["name"],
            "help": fam["help"],
            "kind": fam["kind"],
            "labelNames": fam["labelNames"] or [],
            "children": children,
        })
    return {"families": sorted(families, key=lambda f: f["name"])}


# -- scraped-state readers (the /debug/fleet tail table) --------------------


def state_counter_total(state: dict, name: str,
                        where: Optional[dict] = None) -> float:
    """Sum a counter family's children, optionally filtered by a
    label-subset match (``where={"status": "ok"}``)."""
    total = 0.0
    for fam in state.get("families", ()):
        if fam["name"] != name:
            continue
        for child in fam["children"]:
            labels = {k: v for k, v in (tuple(kv) for kv
                                        in child["labels"])}
            if where and any(labels.get(k) != v
                             for k, v in where.items()):
                continue
            total += child.get("value", 0.0)
    return total


def state_histogram(state: dict, name: str) -> Optional[dict]:
    """The first histogram child of a family (the unlabeled serving
    families have exactly one), or None."""
    for fam in state.get("families", ()):
        if fam["name"] == name and fam["kind"] == "histogram":
            for child in fam["children"]:
                if "hist" in child:
                    return child["hist"]
    return None


def hist_quantile(hist: dict, q: float) -> float:
    """Percentile estimate from a parsed histogram state — the same
    in-bucket linear interpolation ``Histogram.percentile`` makes, so
    the router's per-replica tail table and a replica's own /status
    agree by construction."""
    n = hist["count"]
    if n == 0:
        return float("nan")
    bounds = hist["bounds"]
    rank = (q / 100.0) * n
    cum = 0
    for i, c in enumerate(hist["counts"]):
        if c == 0:
            continue
        if cum + c >= rank:
            if i >= len(bounds):
                return bounds[-1] if bounds else float("nan")
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i]
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
    return bounds[-1] if bounds else float("nan")


def render_fleet(tagged: Sequence[tuple]) -> str:
    """Merge ``[(worker_id, state), ...]`` with ``{replica}`` gauge
    labels and render — the router's ``GET /metrics`` body."""
    return render_state(merge_states(tagged, gauge_label="replica"))


# -- SLO burn rate ----------------------------------------------------------

BURN_WINDOWS = (("1m", 60.0), ("5m", 300.0), ("1h", 3600.0))


def _default_objective() -> float:
    try:
        v = float(os.environ.get("PIO_TPU_SLO_OBJECTIVE", 0.99))
    except ValueError:
        return 0.99
    return v if 0.0 < v < 1.0 else 0.99


class BurnRateTracker:
    """Error-budget burn rate from latency-histogram deltas.

    Keeps a ring of throttled ``(monotonic, total, good)`` samples of
    the underlying histogram (``good`` = observations in buckets whose
    upper bound is <= the SLO — the conservative side: a request in
    the bucket straddling the SLO counts as bad).  ``rate(window_s)``
    takes the delta between now and the oldest retained sample inside
    the window and answers

        ``(bad_fraction over the window) / (1 - objective)``

    so 1.0 burns the budget exactly as fast as the objective allows,
    and a 14x short-window burn is the classic page threshold.  A
    window with no traffic reads 0.0 — no requests, no budget spent.
    Sampling happens lazily at gauge-read (scrape) time, throttled to
    ``min_sample_s``, so the serving hot path never pays for it.
    """

    def __init__(self, snapshot_fn: Callable[[], dict],
                 bounds: Sequence[float], slo_s: float,
                 objective: Optional[float] = None,
                 min_sample_s: float = 1.0):
        if slo_s <= 0:
            raise ValueError(f"slo_s must be > 0, got {slo_s}")
        self.snapshot_fn = snapshot_fn
        self.bounds = tuple(bounds)
        self.slo_s = float(slo_s)
        self.objective = (objective if objective is not None
                          else _default_objective())
        if not 0.0 < self.objective < 1.0:
            raise ValueError(
                f"objective must be in (0, 1), got {self.objective}"
            )
        self.min_sample_s = min_sample_s
        self._lock = threading.Lock()
        self._ring: list[tuple[float, int, int]] = []
        self._horizon = max(w for _, w in BURN_WINDOWS) + 60.0
        # baseline sample at install time: the first window's delta is
        # "traffic since the SLO was armed", not the empty delta of a
        # single self-referential sample
        snap = self.snapshot_fn()
        self._ring.append(
            (time.monotonic() - self.min_sample_s,
             snap["count"], self._good_of(snap))
        )

    def _good_of(self, snap: dict) -> int:
        good = 0
        for b, c in zip(self.bounds, snap["counts"]):
            if b <= self.slo_s * (1.0 + 1e-9):
                good += c
        return good

    def sample(self, now: Optional[float] = None) -> None:
        now = now if now is not None else time.monotonic()
        with self._lock:
            if self._ring and now - self._ring[-1][0] < self.min_sample_s:
                return
        snap = self.snapshot_fn()  # histogram locks: taken OFF our lock
        total, good = snap["count"], self._good_of(snap)
        with self._lock:
            if self._ring and now - self._ring[-1][0] < self.min_sample_s:
                return  # a concurrent scrape sampled first
            self._ring.append((now, total, good))
            cutoff = now - self._horizon
            while len(self._ring) > 2 and self._ring[1][0] <= cutoff:
                self._ring.pop(0)

    def rate(self, window_s: float,
             now: Optional[float] = None) -> float:
        now = now if now is not None else time.monotonic()
        self.sample(now)
        with self._lock:
            if not self._ring:
                return 0.0
            cur = self._ring[-1]
            old = self._ring[0]
            for s in self._ring:
                if s[0] >= now - window_s:
                    break
                old = s
        d_total = cur[1] - old[1]
        if d_total <= 0:
            return 0.0
        bad = d_total - (cur[2] - old[2])
        frac = min(max(bad / d_total, 0.0), 1.0)
        return frac / (1.0 - self.objective)


def install_burn_rate(hist_child, slo_s: float,
                      objective: Optional[float] = None
                      ) -> BurnRateTracker:
    """Wire ``pio_slo_burn_rate{window}`` gauges to a live histogram
    child (``QUERY_LATENCY.child()`` on replicas,
    ``ROUTER_FORWARD_SECONDS.child()`` on the router).  Gauge reads
    drive the lazy sampling; installing twice repoints the gauges
    (last SLO wins — one objective per process)."""
    if math.isnan(slo_s) or slo_s <= 0:
        raise ValueError(f"slo_s must be a positive number, got {slo_s}")
    tracker = BurnRateTracker(
        hist_child.snapshot, hist_child.bounds, slo_s,
        objective=objective,
    )
    SLO_TARGET_SECONDS.child().set(slo_s)
    for name, secs in BURN_WINDOWS:
        SLO_BURN_RATE.labels(window=name).set_function(
            lambda s=secs: tracker.rate(s)
        )
    return tracker


# -- /debug/fleet payload hook (dashboard fleet.html) -----------------------

_fleet_provider: Optional[Callable[[], dict]] = None


def set_fleet_provider(fn: Optional[Callable[[], dict]]) -> None:
    """Install (or clear, with None) the in-process ``/debug/fleet``
    payload provider — a RouterServer registers itself so the
    dashboard's ``fleet.html`` (and any server's ``/debug/fleet``
    mount) can render the fleet view when a router lives in this
    process."""
    global _fleet_provider
    _fleet_provider = fn


def fleet_payload() -> Optional[dict]:
    fn = _fleet_provider
    if fn is None:
        return None
    try:
        return fn()
    except Exception:  # a broken provider must not 500 the mount
        return None
