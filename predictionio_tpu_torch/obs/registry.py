"""Process-wide metrics registry: Counter / Gauge / Histogram with
Prometheus text exposition.

The reference's operators lived in the Spark UI and the evaluation
dashboard; here every server and workflow reports into ONE process-wide
:class:`MetricsRegistry` that any of the four HTTP servers exposes at
``GET /metrics`` (Prometheus text format 0.0.4).  Design constraints,
in order:

* **Hot-path cheap.** ``Counter.inc`` / ``Histogram.observe`` sit on
  the serving request path (p50 ~0.3 ms); both are a single sharded
  lock acquisition plus one or three scalar updates.  Shards are
  selected by thread identity, so concurrent request threads touch
  disjoint locks and the instruments never serialize the very
  concurrency they are measuring.
* **Lock-discipline clean.** Every class here passes piolint's PIO2xx
  engine: shared attributes are written only under their owning lock,
  snapshots are taken under the lock and rendered outside it, and
  user callbacks (gauge functions) are invoked OFF-lock so a callback
  touching another lock (a circuit breaker's, say) cannot deadlock
  the scrape.
* **Fixed buckets.** Histograms use log-spaced immutable bucket bounds
  chosen at construction: merging across shards, exposition, and
  p50/p95/p99 derivation are all exact bucket arithmetic — no
  reservoir sampling, no decay windows, no per-observation allocation.

Pure stdlib; importable from every layer without cycles (the same
contract resilience/policy.py keeps).
"""

from __future__ import annotations

import bisect
import math
import threading
import time
from typing import Callable, Iterable, Optional, Sequence

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_latency_buckets",
    "log_buckets",
    "merge_states",
    "render_state",
]

_N_SHARDS = 8  # power of two; thread-ident hash distributes across these


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> tuple:
    """Log-spaced bucket upper bounds from ``lo`` to >= ``hi``.

    ``per_decade`` bounds per 10x; the +Inf bucket is implicit (every
    histogram always has it).  Bounds are rounded to 6 significant
    digits so the exposition's ``le`` labels stay stable across
    platforms' float printing.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError("need 0 < lo < hi")
    step = 10.0 ** (1.0 / per_decade)
    out, v = [], lo
    while v < hi * (1.0 + 1e-9):
        out.append(float(f"{v:.6g}"))
        v *= step
    return tuple(out)


def default_latency_buckets() -> tuple:
    """10 us .. ~100 s, 8 per decade: fine enough that linear
    interpolation inside a bucket recovers p50 within a few percent of
    the exact sample percentile at serving-latency scales."""
    return log_buckets(1e-5, 100.0, per_decade=8)


class _Shard:
    """One lock-striped accumulator cell.  Accessed only through a
    local variable (``shard = self._shards[i]``), which also keeps the
    lock discipline trivially checkable."""

    __slots__ = ("lock", "value", "counts", "total", "n")

    def __init__(self, n_buckets: int = 0):
        self.lock = threading.Lock()
        self.value = 0.0
        # histogram-only state (unused by counters)
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.total = 0.0
        self.n = 0


def _shard_index() -> int:
    return threading.get_ident() & (_N_SHARDS - 1)


class Counter:
    """Monotonically increasing value (Prometheus counter)."""

    kind = "counter"

    def __init__(self):
        self._shards = tuple(_Shard() for _ in range(_N_SHARDS))

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up; use a Gauge")
        shard = self._shards[_shard_index()]
        with shard.lock:
            shard.value += n

    def value(self) -> float:
        total = 0.0
        for shard in self._shards:
            with shard.lock:
                total += shard.value
        return total

    def samples(self, name: str, labels: tuple) -> list:
        return [(name, labels, self.value())]

    def state(self) -> dict:
        """Serializable snapshot for the cluster aggregator."""
        return {"value": self.value()}


class Gauge:
    """Set-anywhere value, or a callback read at scrape time.

    ``set_function`` wins over ``set`` while installed; the callback is
    invoked OUTSIDE the gauge's lock (it may read other locks — e.g. a
    circuit breaker snapshot).
    """

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self._value -= n

    def set_function(self, fn: Optional[Callable[[], float]]) -> None:
        with self._lock:
            self._fn = fn

    def value(self) -> float:
        with self._lock:
            fn = self._fn
            v = self._value
        if fn is not None:
            try:
                return float(fn())
            except Exception:
                return float("nan")  # a broken callback must not 500 /metrics
        return v

    def samples(self, name: str, labels: tuple) -> list:
        return [(name, labels, self.value())]

    def state(self) -> dict:
        return {"value": self.value()}


class Histogram:
    """Fixed log-spaced buckets with cumulative exposition and
    percentile derivation.

    ``observe`` is shard-local: bisect into the immutable bounds, one
    lock, three scalar updates.  ``snapshot`` merges shards under each
    shard's lock; percentiles interpolate linearly inside the target
    bucket (the same estimate ``histogram_quantile`` makes), so the
    numbers on ``/status`` and in Grafana agree by construction.

    *Exemplars* (pio-xray): ``observe(v, exemplar="t-...")`` remembers
    the most recent exemplar string (a trace id) per bucket, so a slow
    bucket on ``/metrics`` points at a concrete request whose span tree
    the flight recorder / journal holds.  Stored outside the shards
    (one small dict under its own lock — only callers that pass an
    exemplar pay for it) and rendered as ``# EXEMPLAR`` comment lines,
    which every 0.0.4 text parser ignores by definition.
    """

    kind = "histogram"

    def __init__(self, buckets: Optional[Sequence[float]] = None):
        bounds = tuple(buckets) if buckets is not None \
            else default_latency_buckets()
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError("bucket bounds must be strictly increasing")
        if not bounds:
            raise ValueError("need at least one bucket bound")
        self.bounds = bounds
        self._shards = tuple(
            _Shard(n_buckets=len(bounds)) for _ in range(_N_SHARDS)
        )
        self._ex_lock = threading.Lock()
        # bucket index -> (exemplar, observed value, wall timestamp)
        self._exemplars: dict[int, tuple] = {}

    def observe(self, v: float, exemplar: Optional[str] = None) -> None:
        i = bisect.bisect_left(self.bounds, v)
        shard = self._shards[_shard_index()]
        with shard.lock:
            shard.counts[i] += 1
            shard.total += v
            shard.n += 1
        if exemplar is not None:
            # last-exemplar-wins per bucket (the standard exemplar
            # semantic); wall clock is a timestamp, not a duration
            with self._ex_lock:
                self._exemplars[i] = (exemplar, v, time.time())

    def exemplar_items(self) -> list:
        """``(le_label, exemplar, value, timestamp)`` per bucket that
        has one, in bucket order."""
        with self._ex_lock:
            snap = dict(self._exemplars)
        out = []
        for i in sorted(snap):
            le = (
                _fmt_float(self.bounds[i]) if i < len(self.bounds)
                else "+Inf"
            )
            ex, v, ts = snap[i]
            out.append((le, ex, v, ts))
        return out

    def snapshot(self) -> dict:
        """Merged view: per-bucket counts (non-cumulative), sum, count."""
        counts = [0] * (len(self.bounds) + 1)
        total, n = 0.0, 0
        for shard in self._shards:
            with shard.lock:
                sc = list(shard.counts)
                total += shard.total
                n += shard.n
            for i, c in enumerate(sc):
                counts[i] += c
        return {"counts": counts, "sum": total, "count": n}

    # -- derived stats -----------------------------------------------------
    def percentile(self, q: float, snap: Optional[dict] = None) -> float:
        """Estimate the q-th percentile (q in [0, 100]) from bucket
        counts; NaN when empty.  Linear interpolation inside the target
        bucket; the +Inf bucket answers its lower bound (the last
        finite bound) — the honest cap for an unbounded tail."""
        snap = snap or self.snapshot()
        n = snap["count"]
        if n == 0:
            return float("nan")
        rank = (q / 100.0) * n
        cum = 0
        for i, c in enumerate(snap["counts"]):
            if c == 0:
                continue
            if cum + c >= rank:
                if i >= len(self.bounds):
                    return self.bounds[-1]
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i]
                frac = (rank - cum) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
            cum += c
        return self.bounds[-1]

    def percentiles(self, qs: Iterable[float]) -> dict:
        snap = self.snapshot()
        return {q: self.percentile(q, snap) for q in qs}

    def mean(self, snap: Optional[dict] = None) -> float:
        snap = snap or self.snapshot()
        return snap["sum"] / snap["count"] if snap["count"] else 0.0

    def samples(self, name: str, labels: tuple) -> list:
        snap = self.snapshot()
        out = []
        cum = 0
        for bound, c in zip(self.bounds, snap["counts"]):
            cum += c
            out.append((name + "_bucket",
                        labels + (("le", _fmt_float(bound)),), cum))
        out.append((name + "_bucket", labels + (("le", "+Inf"),),
                    snap["count"]))
        out.append((name + "_sum", labels, snap["sum"]))
        out.append((name + "_count", labels, snap["count"]))
        return out

    def state(self) -> dict:
        snap = self.snapshot()
        return {"hist": {
            "bounds": list(self.bounds),
            "counts": list(snap["counts"]),
            "sum": snap["sum"],
            "count": snap["count"],
            "exemplars": [list(t) for t in self.exemplar_items()],
        }}


def _fmt_float(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_value(v: float) -> str:
    if isinstance(v, int):
        return str(v)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n").replace('"', '\\"')


_NAME_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:")


def _check_name(name: str) -> str:
    if not name or name[0].isdigit() or any(c not in _NAME_OK for c in name):
        raise ValueError(f"invalid metric name: {name!r}")
    return name


class _Family:
    """One named metric family: HELP/TYPE plus labeled children."""

    def __init__(self, name: str, help_text: str, kind: str,
                 label_names: tuple, child_ctor: Callable):
        self.name = _check_name(name)
        self.help_text = help_text
        self.kind = kind
        self.label_names = label_names
        self._ctor = child_ctor
        self._lock = threading.Lock()
        self._children: dict[tuple, object] = {}

    def labels(self, **kv):
        """The child instrument for these label values (created on
        first use).  Label names must match the family declaration."""
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}"
            )
        key = tuple((k, str(kv[k])) for k in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._ctor()
                self._children[key] = child
        return child

    def child(self):
        """The unlabeled child (only valid for label-less families)."""
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels()")
        return self.labels()

    def children(self) -> list:
        """Sorted ``(label_items, child)`` snapshot."""
        with self._lock:
            return sorted(self._children.items())

    def collect(self) -> list:
        out = []
        for key, child in self.children():
            out += child.samples(self.name, key)
        return out


class MetricsRegistry:
    """Name -> family table with idempotent registration.

    Re-registering an existing name returns the SAME family (the
    process may build several servers that all want
    ``pio_query_latency_seconds``); a kind or label mismatch raises —
    that is a programming error, not a collision to paper over.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _register(self, name: str, help_text: str, kind: str,
                  label_names: Sequence[str], ctor: Callable) -> _Family:
        label_names = tuple(label_names)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, help_text, kind, label_names, ctor)
                self._families[name] = fam
        if fam.kind != kind or fam.label_names != label_names:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind} with "
                f"labels {fam.label_names}; got {kind}/{label_names}"
            )
        return fam

    def counter(self, name: str, help_text: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._register(name, help_text, "counter", labels, Counter)

    def gauge(self, name: str, help_text: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._register(name, help_text, "gauge", labels, Gauge)

    def histogram(self, name: str, help_text: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> _Family:
        return self._register(
            name, help_text, "histogram", labels,
            lambda: Histogram(buckets=buckets),
        )

    def families(self) -> list:
        with self._lock:
            return sorted(self._families.values(), key=lambda f: f.name)

    def collect(self) -> list:
        """Flat ``(name, label_items, value)`` sample list (all
        families) — the dashboard's live-metrics page renders this."""
        out = []
        for fam in self.families():
            out += fam.collect()
        return out

    def dump_state(self) -> dict:
        """JSON-serializable snapshot of the WHOLE registry — the
        per-worker delta the pio-tower cluster aggregator ships through
        the coordination dir each sweep (values are cumulative, so a
        re-read of the newest file always supersedes older ones and a
        worker that dies mid-run leaves its last snapshot standing)."""
        fams = []
        for fam in self.families():
            fams.append({
                "name": fam.name,
                "help": fam.help_text,
                "kind": fam.kind,
                "labelNames": list(fam.label_names),
                "children": [
                    {"labels": [list(kv) for kv in key], **child.state()}
                    for key, child in fam.children()
                ],
            })
        return {"families": fams}

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4.

        Rendering goes through :func:`render_state` so a merged
        multi-worker state (pio-tower) and a live registry produce
        byte-identical text for identical contents — the golden-merge
        test depends on there being exactly ONE renderer."""
        return render_state(self.dump_state())


# -- state rendering + cluster merge (pio-tower) ----------------------------


def render_state(state: dict) -> str:
    """Prometheus text format 0.0.4 for a :meth:`MetricsRegistry.
    dump_state` snapshot (or a :func:`merge_states` result)."""
    lines = []
    for fam in sorted(state["families"], key=lambda f: f["name"]):
        if fam["help"]:
            lines.append(f"# HELP {fam['name']} "
                         + fam["help"].replace("\n", " "))
        lines.append(f"# TYPE {fam['name']} {fam['kind']}")
        children = sorted(
            fam["children"], key=lambda c: [tuple(kv) for kv in c["labels"]]
        )
        for child in children:
            labels = tuple(tuple(kv) for kv in child["labels"])
            hist = child.get("hist")
            if hist is None:
                lines.append(_sample_line(
                    fam["name"], labels, child["value"]
                ))
                continue
            cum = 0
            for bound, c in zip(hist["bounds"], hist["counts"]):
                cum += c
                lines.append(_sample_line(
                    fam["name"] + "_bucket",
                    labels + (("le", _fmt_float(bound)),), cum,
                ))
            lines.append(_sample_line(
                fam["name"] + "_bucket", labels + (("le", "+Inf"),),
                hist["count"],
            ))
            lines.append(_sample_line(
                fam["name"] + "_sum", labels, hist["sum"]
            ))
            lines.append(_sample_line(
                fam["name"] + "_count", labels, hist["count"]
            ))
        if fam["kind"] == "histogram":
            for child in children:
                hist = child.get("hist") or {}
                base = ",".join(
                    f'{k}="{_escape_label(v)}"'
                    for k, v in (tuple(kv) for kv in child["labels"])
                )
                # ``# EXEMPLAR`` comment lines: legal-by-construction
                # in text format 0.0.4 (parsers skip comments), yet a
                # ``grep t-xxxx`` on a scrape finds the trace id a slow
                # bucket points at
                for le, ex, v, ts in hist.get("exemplars", ()):
                    lbl = (base + "," if base else "") + f'le="{le}"'
                    lines.append(
                        f"# EXEMPLAR {fam['name']}_bucket{{{lbl}}} "
                        f'trace_id="{_escape_label(str(ex))}" '
                        f"value={_fmt_value(v)} ts={_fmt_value(ts)}"
                    )
    return "\n".join(lines) + "\n"


def _sample_line(name: str, label_items: tuple, value) -> str:
    if label_items:
        lbl = ",".join(
            f'{k}="{_escape_label(v)}"' for k, v in label_items
        )
        return f"{name}{{{lbl}}} {_fmt_value(value)}"
    return f"{name} {_fmt_value(value)}"


def merge_states(tagged: Sequence[tuple],
                 gauge_label: str = "worker") -> dict:
    """Merge per-worker registry snapshots into one cluster state.

    ``tagged`` is ``[(worker_id, state), ...]``.  Merge semantics (the
    table in docs/ARCHITECTURE.md "Tower"):

    * **counters** sum exactly across workers (same labels = one
      child);
    * **histograms** add bucket-wise: identical bucket ladders are
      required (the eager family catalog guarantees it), counts merge
      elementwise, sum/count add — so percentile re-derivation on the
      merged exposition is exact bucket arithmetic over the union of
      observations, byte-identical to a single process that saw them
      all; per-bucket exemplars keep the newest timestamp;
    * **gauges** are NOT summable (a per-worker queue depth summed is
      a lie); every gauge child instead gains a ``gauge_label`` label
      (``worker`` for the pio-tower cluster merge, ``replica`` for the
      pio-lens fleet merge) so the merged view shows each process's
      value side by side.  A gauge family that ALREADY carries that
      label name (the router's own ``pio_replica_up{replica=}``) keeps
      its labels untouched — the attribution it wants is already
      there, and a duplicate label name would be grammar-invalid.

    A kind/label/bucket mismatch raises ``ValueError`` — that is a
    schema drift bug, not a collision to paper over.
    """
    fams: dict[str, dict] = {}
    for worker, state in tagged:
        for fam in state["families"]:
            name = fam["name"]
            tag_gauges = (
                fam["kind"] == "gauge"
                and gauge_label not in fam["labelNames"]
            )
            mine = fams.get(name)
            if mine is None:
                mine = {
                    "name": name,
                    "help": fam["help"],
                    "kind": fam["kind"],
                    "labelNames": list(fam["labelNames"]),
                    "children": {},
                }
                if tag_gauges:
                    mine["labelNames"] = (
                        mine["labelNames"] + [gauge_label]
                    )
                fams[name] = mine
            elif mine["kind"] != fam["kind"]:
                raise ValueError(
                    f"metric {name!r}: kind mismatch across workers "
                    f"({mine['kind']} vs {fam['kind']})"
                )
            for child in fam["children"]:
                labels = tuple(tuple(kv) for kv in child["labels"])
                if fam["kind"] == "gauge":
                    if tag_gauges:
                        labels = labels + ((gauge_label, str(worker)),)
                    mine["children"][labels] = {
                        "labels": [list(kv) for kv in labels],
                        "value": child["value"],
                    }
                    continue
                have = mine["children"].get(labels)
                if have is None:
                    merged = {
                        "labels": [list(kv) for kv in labels],
                    }
                    if "hist" in child:
                        h = child["hist"]
                        merged["hist"] = {
                            "bounds": list(h["bounds"]),
                            "counts": list(h["counts"]),
                            "sum": h["sum"],
                            "count": h["count"],
                            "exemplars": [list(t) for t in
                                          h.get("exemplars", ())],
                        }
                    else:
                        merged["value"] = child["value"]
                    mine["children"][labels] = merged
                    continue
                if "hist" in child:
                    h, hv = child["hist"], have["hist"]
                    if list(h["bounds"]) != list(hv["bounds"]):
                        raise ValueError(
                            f"metric {name!r}: bucket ladder mismatch "
                            "across workers"
                        )
                    hv["counts"] = [
                        a + b for a, b in zip(hv["counts"], h["counts"])
                    ]
                    hv["sum"] += h["sum"]
                    hv["count"] += h["count"]
                    by_le = {e[0]: e for e in hv.get("exemplars", ())}
                    for e in h.get("exemplars", ()):
                        cur = by_le.get(e[0])
                        if cur is None or e[3] >= cur[3]:
                            by_le[e[0]] = list(e)
                    hv["exemplars"] = [
                        by_le[le] for le in sorted(
                            by_le,
                            key=lambda s: (
                                float("inf") if s == "+Inf" else float(s)
                            ),
                        )
                    ]
                else:
                    have["value"] += child["value"]
    return {"families": [
        {**f, "children": list(f["children"].values())}
        for f in sorted(fams.values(), key=lambda f: f["name"])
    ]}
