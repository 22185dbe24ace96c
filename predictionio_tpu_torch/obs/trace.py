"""Trace propagation + span recording.

A *trace id* names one logical request as it crosses processes: minted
at the serving edge (or supplied by the client via the ``X-PIO-Trace``
header), carried through ``DeliveryQueue`` payload headers to the event
server, and stamped on every span recorded while the id is in scope.
A *span* is one named, timed unit of work (``serve.query``,
``events.write``, ``als.gram``, ``eval.sweep`` ...) with a wall-clock
start timestamp and a monotonic-clock duration.

Spans land in a bounded in-memory ring (cheap, always on — the
dashboard and tests read it) and, when a journal directory is
configured (``--telemetry-dir`` or ``PIO_TPU_TELEMETRY_DIR``), are also
appended as JSON lines to ``<dir>/spans-<pid>.jsonl`` so a slow query
can be grepped by trace id across every involved process after the
fact.

Clock discipline: ``start`` is ``time.time()`` (a timestamp — it must
be comparable across machines), ``duration_s`` comes from
``time.perf_counter()`` deltas (PIO109: wall clocks never measure
durations).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from pathlib import Path
from typing import Iterator, Optional

__all__ = [
    "Span",
    "TRACE_HEADER",
    "Tracer",
    "build_tree",
    "collect_spans",
    "current_trace_id",
    "new_trace_id",
    "trace_scope",
]

TRACE_HEADER = "X-PIO-Trace"


def new_trace_id() -> str:
    # os.urandom beats uuid4 ~8x and this runs on the serving hot path
    # for every request that didn't bring its own id
    return "t-" + os.urandom(8).hex()


_scope = threading.local()


class trace_scope:
    """Bind ``trace_id`` to this thread for the duration of the block
    (spans recorded inside inherit it).  ``None`` keeps any outer
    scope's id — call sites don't branch.

    A slotted class rather than a generator contextmanager: this wraps
    every served query, and the generator machinery costs ~1.4 us
    against ~0.2 us for plain __enter__/__exit__.
    """

    __slots__ = ("trace_id", "_prev")

    def __init__(self, trace_id: Optional[str]):
        self.trace_id = trace_id

    def __enter__(self) -> Optional[str]:
        self._prev = getattr(_scope, "trace_id", None)
        tid = self.trace_id if self.trace_id is not None else self._prev
        _scope.trace_id = tid
        return tid

    def __exit__(self, *exc) -> None:
        _scope.trace_id = self._prev


def current_trace_id() -> Optional[str]:
    return getattr(_scope, "trace_id", None)


class Span:
    __slots__ = ("name", "trace_id", "start", "duration_s", "attrs")

    def __init__(self, name: str, trace_id: Optional[str], start: float,
                 duration_s: float, attrs: Optional[dict] = None):
        self.name = name
        self.trace_id = trace_id
        self.start = start
        self.duration_s = duration_s
        self.attrs = attrs or {}

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "traceId": self.trace_id,
            "start": self.start,
            "durationSec": self.duration_s,
            "pid": os.getpid(),
            **({"attrs": self.attrs} if self.attrs else {}),
        }


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_worker() -> Optional[int]:
    """The process's cluster worker index, when launched as one
    (``PIO_TPU_PROCESS_INDEX`` — the multihost harness stamps it per
    spawned worker; a caller that knows its index passes it to
    :meth:`Tracer.set_process_index`).  ``None`` in single-process land."""
    v = os.environ.get("PIO_TPU_PROCESS_INDEX")
    if v is None:
        return None
    try:
        return int(v)
    except ValueError:
        return None


class Tracer:
    """Bounded span ring + optional JSONL journal.

    The journal is **rotated**, not unbounded: once the active segment
    exceeds ``max_segment_bytes`` it is renamed to
    ``spans-<pid>.jsonl.1`` (older segments shift to ``.2`` ... and the
    oldest beyond ``keep_segments`` is deleted), and writing continues
    into a fresh active file.  A serving process that stays up for
    weeks therefore holds at most ``(keep_segments + 1) *
    max_segment_bytes`` of journal on disk instead of growing without
    bound.  Env overrides: ``PIO_TPU_TELEMETRY_SEGMENT_BYTES`` /
    ``PIO_TPU_TELEMETRY_KEEP``.
    """

    def __init__(self, capacity: int = 4096,
                 journal_dir: Optional[Path] = None,
                 max_segment_bytes: Optional[int] = None,
                 keep_segments: Optional[int] = None):
        self._lock = threading.Lock()
        self._ring: collections.deque[Span] = collections.deque(
            maxlen=capacity
        )
        self._journal_dir = Path(journal_dir) if journal_dir else None
        self._journal = None
        self._journal_failed = False
        self._journal_bytes = 0
        self._rotations = 0
        self._segment_cap = (
            max_segment_bytes if max_segment_bytes is not None
            else _env_int("PIO_TPU_TELEMETRY_SEGMENT_BYTES", 16 << 20)
        )
        self._keep = (
            keep_segments if keep_segments is not None
            else _env_int("PIO_TPU_TELEMETRY_KEEP", 3)
        )
        self._worker = _env_worker()
        self.dropped_journal_writes = 0

    # -- configuration -----------------------------------------------------
    def configure(self, journal_dir: Optional[os.PathLike | str],
                  max_segment_bytes: Optional[int] = None,
                  keep_segments: Optional[int] = None) -> None:
        """(Re)point the JSONL journal; ``None`` disables it.  The
        rotation knobs keep their current values unless given."""
        with self._lock:
            if self._journal is not None:
                try:
                    self._journal.close()
                except OSError:
                    pass
            self._journal = None
            self._journal_failed = False
            self._journal_bytes = 0
            self._journal_dir = Path(journal_dir) if journal_dir else None
            if max_segment_bytes is not None:
                self._segment_cap = max_segment_bytes
            if keep_segments is not None:
                self._keep = keep_segments

    def set_process_index(self, worker: Optional[int]) -> None:
        """Stamp this process's cluster worker index into the journal
        filename (``spans-w<k>-<pid>.jsonl``) and every span record —
        a cluster run's journals merge and grep by worker instead of
        by opaque pid.  An open journal is closed so the next write
        reopens under the stamped name."""
        with self._lock:
            self._worker = worker
            if self._journal is not None:
                try:
                    self._journal.close()
                except OSError:
                    pass
                self._journal = None
                self._journal_bytes = 0

    def _journal_name(self) -> str:
        if self._worker is not None:
            return f"spans-w{self._worker}-{os.getpid()}.jsonl"
        return f"spans-{os.getpid()}.jsonl"

    def journal_path(self) -> Optional[Path]:
        with self._lock:
            d = self._journal_dir
            name = self._journal_name()
        return d / name if d else None

    def _journal_write(self, span: Span) -> None:
        # lock held by the caller (record); failures disable the
        # journal rather than poisoning the hot path with IO errors
        if self._journal_failed or self._journal_dir is None:
            return
        if self._journal is None:
            try:
                self._journal_dir.mkdir(parents=True, exist_ok=True)
                path = self._journal_dir / self._journal_name()
                self._journal = open(path, "a", encoding="utf-8")
                try:
                    self._journal_bytes = path.stat().st_size
                except OSError:
                    self._journal_bytes = 0
            except OSError:
                self._journal_failed = True
                self.dropped_journal_writes += 1
                return
        try:
            doc = span.to_json()
            if self._worker is not None:
                doc["worker"] = self._worker
            line = json.dumps(doc) + "\n"
            self._journal.write(line)
            self._journal.flush()
            self._journal_bytes += len(line)
        except (OSError, ValueError):
            self.dropped_journal_writes += 1
            return
        if self._segment_cap and self._journal_bytes >= self._segment_cap:
            self._rotate_locked()

    def _rotate_locked(self) -> None:
        """Shift the segment chain and start a fresh active file.
        Caller holds ``self._lock``.  Rotation failures disable the
        journal (same contract as open failures) — they must never
        raise into ``record`` on the serving path."""
        try:
            self._journal.close()
        except OSError:
            pass
        self._journal = None
        self._journal_bytes = 0
        base = self._journal_dir / self._journal_name()
        try:
            oldest = base.with_name(base.name + f".{self._keep}")
            if self._keep <= 0:
                # keep-0: the capped active segment is simply discarded
                base.unlink(missing_ok=True)
            else:
                oldest.unlink(missing_ok=True)
                for k in range(self._keep - 1, 0, -1):
                    seg = base.with_name(base.name + f".{k}")
                    if seg.exists():
                        seg.rename(base.with_name(base.name + f".{k + 1}"))
                base.rename(base.with_name(base.name + ".1"))
            self._rotations += 1
        except OSError:
            self._journal_failed = True

    # -- recording ---------------------------------------------------------
    def record(self, name: str, duration_s: float,
               trace_id: Optional[str] = None,
               attrs: Optional[dict] = None,
               start: Optional[float] = None) -> Span:
        """Record an already-measured span.  ``trace_id=None`` takes the
        thread's current scope id (possibly still None — spans outside
        any request are legal)."""
        span = Span(
            name=name,
            trace_id=trace_id if trace_id is not None else current_trace_id(),
            start=start if start is not None else time.time(),
            duration_s=duration_s,
            attrs=attrs,
        )
        with self._lock:
            self._ring.append(span)
            self._journal_write(span)
        return span

    @contextlib.contextmanager
    def span(self, name: str, attrs: Optional[dict] = None,
             trace_id: Optional[str] = None) -> Iterator[dict]:
        """Time the enclosed block and record it.  The yielded dict is
        the span's attrs — callers may add keys mid-flight.  An escaping
        exception still records the span, with ``error`` set."""
        a = dict(attrs or {})
        started = time.time()
        t0 = time.perf_counter()
        try:
            yield a
        except BaseException as e:
            a["error"] = type(e).__name__
            raise
        finally:
            self.record(
                name, time.perf_counter() - t0,
                trace_id=trace_id, attrs=a, start=started,
            )

    # -- reading -----------------------------------------------------------
    def spans(self, trace_id: Optional[str] = None,
              name: Optional[str] = None,
              limit: Optional[int] = None) -> list[Span]:
        """Newest-last snapshot of the ring, optionally filtered."""
        with self._lock:
            out = list(self._ring)
        if trace_id is not None:
            out = [s for s in out if s.trace_id == trace_id]
        if name is not None:
            out = [s for s in out if s.name == name]
        if limit is not None:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def stats(self) -> dict:
        with self._lock:
            depth = len(self._ring)
            cap = self._ring.maxlen
            journaling = self._journal_dir is not None \
                and not self._journal_failed
            dropped = self.dropped_journal_writes
            seg_bytes = self._journal_bytes
            seg_cap = self._segment_cap
            keep = self._keep
            rotations = self._rotations
        return {
            "depth": depth,
            "capacity": cap,
            "journaling": journaling,
            "droppedJournalWrites": dropped,
            "segmentBytes": seg_bytes,
            "segmentCapBytes": seg_cap,
            "keepSegments": keep,
            "rotations": rotations,
        }

    def close(self) -> None:
        with self._lock:
            if self._journal is not None:
                try:
                    self._journal.close()
                except OSError:
                    pass
                self._journal = None


# -- cross-process stitching (the reference's tools/tracecat.py) -----------


def collect_spans(trace_id: str,
                  journal_dir: os.PathLike | str) -> list[dict]:
    """Every journaled span of ``trace_id`` across all processes'
    journals in ``journal_dir`` (active files AND rotated ``.N``
    segments); torn trailing lines are skipped like the runlog reader
    skips them.  The stitching half of the reference's
    ``tools/tracecat.py``; :func:`build_tree` nests the result."""
    journal_dir = Path(journal_dir)
    spans = []
    if not journal_dir.is_dir():
        return spans
    for path in sorted(journal_dir.glob("spans-*.jsonl*")):
        try:
            text = path.read_text(encoding="utf-8", errors="replace")
        except OSError:
            continue
        for line in text.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn trailing line of a live journal
            if doc.get("traceId") == trace_id:
                doc["_journal"] = path.name
                spans.append(doc)
    return spans


def build_tree(spans: list[dict], eps: float = 0.05) -> list[dict]:
    """Nest spans by interval containment; returns the root list.
    Each node gains a ``children`` list, ordered by start time."""
    nodes = []
    for s in spans:
        start = float(s.get("start", 0.0))
        dur = float(s.get("durationSec", 0.0))
        nodes.append({**s, "_start": start, "_end": start + dur,
                      "children": []})
    # wider intervals first so a child scans candidate parents from
    # the tightest enclosing one backwards
    nodes.sort(key=lambda n: (n["_start"], -(n["_end"] - n["_start"])))
    roots = []
    for i, n in enumerate(nodes):
        parent = None
        for cand in reversed(nodes[:i]):
            if (cand["_start"] <= n["_start"] + eps
                    and n["_end"] <= cand["_end"] + eps
                    and cand is not n):
                parent = cand
                break
        (parent["children"] if parent is not None else roots).append(n)
    return roots
