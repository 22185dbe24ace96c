"""pio-pulse: per-request lifecycle timeline decomposition.

The latency histogram says *how slow* a request was; the flight
recorder says *which* requests were slow; this module says **where the
time went** — every served query carries a :class:`Timeline` of
monotonic segment durations

    ``parse -> auth -> queue_wait -> batch_wait -> device -> serialize
    -> write``

captured with cheap ``perf_counter`` stamps threaded through
``server/http_base.py`` (request edge + socket write),
``server/serving.py`` (decode/admission/serialize) and
``server/microbatch.py`` (per-entry enqueue/claim/run stamps — the
batcher credits the caller's timeline with exactly the queue-wait,
accumulation-wait and device time its entry experienced).  Segment
durations aggregate into the ``pio_serve_segment_seconds{segment}``
histogram family (the event-server ingest path gets the parallel
``pio_events_segment_seconds{segment}``: parse/auth/store_write/reply),
and the per-request segment dict rides the ``serve.query`` span attrs,
so a flight-recorder worst-N entry decomposes into *which segment ate
the time* without any extra capture machinery.

Concurrency saturation is first-class: ``pio_serve_inflight`` (requests
between decode and reply), ``pio_microbatch_queue_depth`` (entries
parked behind the in-flight batch), ``pio_microbatch_batch_size`` /
``pio_microbatch_wait_seconds`` histograms and the
``pio_microbatch_role_total{role}`` leader/follower split together
answer "is the batcher widening concurrency or just queueing it" — the
evidence layer the ROADMAP item-2 async front-end rework must beat.

Accounting invariant: a finished timeline's segments SUM to the
measured end-to-end wall time of the regions it covered (residual time
inside a composite region — e.g. condition-variable wake latency after
a batched device call — is attributed to the region's final segment,
never dropped), so per-segment means read off ``/metrics`` reconcile
with the end-to-end latency histogram instead of silently leaking tail
time.  ``tests/test_timeline.py`` holds the property test.

On-demand deep dive: :func:`capture_profile` (mounted at
``GET /debug/profile?seconds=S`` on every port server) records a
``torch.profiler`` trace with CPU and CUDA activities into
``$PIO_TPU_HOME/telemetry/profiles/``; while a capture is live, the
serving path and the micro-batcher wrap their work in
``torch.profiler.record_function`` scopes (:class:`annotate` — a no-op
boolean check otherwise), so timeline segments appear as named rows in
the trace next to the CUDA kernels they launched.

Pure stdlib at import; torch loads inside an active capture only.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from pathlib import Path
from typing import Optional, Sequence, Tuple

from . import get_registry, log_buckets, telemetry_home

__all__ = [
    "EVENT_SEGMENTS",
    "ProfileBusy",
    "SERVE_SEGMENTS",
    "Timeline",
    "annotate",
    "capture_profile",
    "current_timeline",
    "exit_process",
    "mark",
    "on_profiler_thread",
    "profiles_dir",
    "profiling_active",
    "register_segment_family",
    "timeline_scope",
]

_registry = get_registry()

# the segment taxonomies (docs/ARCHITECTURE.md "Pulse" lists semantics);
# order here is display order on /pulse.html
SERVE_SEGMENTS = (
    "parse", "auth", "queue_wait", "batch_wait", "device", "serialize",
    "write",
)
EVENT_SEGMENTS = ("parse", "auth", "store_write", "reply")

SERVE_SEGMENT_SECONDS = _registry.histogram(
    "pio_serve_segment_seconds",
    "Per-request serving-path segment durations (parse/auth/queue_wait/"
    "batch_wait/device/serialize/write); per-request segments sum to "
    "the end-to-end handler time",
    labels=("segment",),
)
EVENTS_SEGMENT_SECONDS = _registry.histogram(
    "pio_events_segment_seconds",
    "Per-request event-ingest segment durations "
    "(parse/auth/store_write/reply)",
    labels=("segment",),
)
SERVE_INFLIGHT = _registry.gauge(
    "pio_serve_inflight",
    "Queries currently inside predict_json (decode -> serialize): the "
    "serving edge's concurrency saturation gauge",
)
MICROBATCH_QUEUE_DEPTH = _registry.gauge(
    "pio_microbatch_queue_depth",
    "Entries waiting in the micro-batcher's pending list (parked "
    "behind the in-flight batch)",
)
MICROBATCH_BATCH_SIZE = _registry.histogram(
    "pio_microbatch_batch_size",
    "Dispatched micro-batch sizes (pre-padding: what actually "
    "coalesced)",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256, 512),
)
MICROBATCH_WAIT_SECONDS = _registry.histogram(
    "pio_microbatch_wait_seconds",
    "Per-batch wait from first claim to device dispatch (the "
    "accumulation-window cost)",
    buckets=log_buckets(1e-6, 10.0, per_decade=4),
)
MICROBATCH_ROLE_TOTAL = _registry.counter(
    "pio_microbatch_role_total",
    "Requests by batcher role: the leader ran the device call on its "
    "own thread, a follower's result came from another thread's batch, "
    "a dispatched request rode the continuous dispatcher (pio-surge "
    "event-loop edge — no request thread involved)",
    labels=("role",),
)
MICROBATCH_ADMISSION_TOTAL = _registry.counter(
    "pio_microbatch_admission_total",
    "Deadline-aware admission outcomes (pio-surge): rejected = the "
    "edge answered a structured 503 up front because the estimated "
    "queue+service time exceeded the request deadline; expired = "
    "claimed from the queue already past its deadline and completed "
    "without ever reaching the device",
    labels=("outcome",),
)
MICROBATCH_TENANTS_PER_BATCH = _registry.histogram(
    "pio_microbatch_tenants_per_batch",
    "Distinct tenants coalesced into one shared-batcher dispatcher "
    "claim (pio-confluence): >1 means cross-tenant traffic rode one "
    "dispatcher turn instead of competing per-tenant device queues — "
    "the mixing evidence the hive_smoke gate asserts",
    buckets=(1, 2, 4, 8, 16, 32),
)

# children cached at import: .labels() is a dict build + lock per call
# (~1.5 us), too hot for per-request use — and materializing them keeps
# the /metrics schema complete (zero-valued) from the first scrape
_SEGMENT_CHILDREN = {
    "serve": {
        s: SERVE_SEGMENT_SECONDS.labels(segment=s) for s in SERVE_SEGMENTS
    },
    "events": {
        s: EVENTS_SEGMENT_SECONDS.labels(segment=s)
        for s in EVENT_SEGMENTS
    },
}
def register_segment_family(family: str, histogram_family,
                            segments) -> None:
    """Attach a new timeline family (pio-lens adds ``router``):
    ``Timeline(family)`` instances booked via :meth:`Timeline.finish`
    observe into ``histogram_family{segment=...}`` children, cached
    here once like the serve/events families above."""
    _SEGMENT_CHILDREN[family] = {
        s: histogram_family.labels(segment=s) for s in segments
    }


SERVE_INFLIGHT.child()
MICROBATCH_QUEUE_DEPTH.child()
MICROBATCH_BATCH_SIZE.child()
MICROBATCH_WAIT_SECONDS.child()
MICROBATCH_TENANTS_PER_BATCH.child()
MICROBATCH_ROLE_TOTAL.labels(role="leader")
MICROBATCH_ROLE_TOTAL.labels(role="follower")
MICROBATCH_ROLE_TOTAL.labels(role="dispatched")
MICROBATCH_ADMISSION_TOTAL.labels(outcome="rejected")
MICROBATCH_ADMISSION_TOTAL.labels(outcome="expired")


class Timeline:
    """Monotonic per-request segment accumulator.

    ``mark(seg)`` closes the region since the previous boundary and
    books it under ``seg``; ``add_block(parts, residual_to)`` closes a
    composite region whose interior was measured elsewhere (the
    batcher's entry stamps), crediting the measured parts and the
    residual — wake latency, lock handoff — to ``residual_to`` so the
    segment sum still equals the region's wall time.  Single-threaded
    by construction (one request, one timeline, marked only from the
    thread carrying the request), hence no lock.
    """

    __slots__ = ("family", "segments", "t0", "_last")

    def __init__(self, family: str = "serve"):
        self.family = family
        self.segments: dict[str, float] = {}
        self.t0 = self._last = time.perf_counter()

    def mark(self, segment: str) -> None:
        now = time.perf_counter()
        self.segments[segment] = (
            self.segments.get(segment, 0.0) + (now - self._last)
        )
        self._last = now

    def add_block(self, parts: Sequence[Tuple[str, float]],
                  residual_to: str) -> None:
        now = time.perf_counter()
        total = max(now - self._last, 0.0)
        parts = [(seg, max(dur, 0.0)) for seg, dur in parts]
        acc = sum(dur for _, dur in parts)
        if acc > total:
            # interior stamps can only exceed the region by clock
            # jitter (they are taken inside it); scale proportionally
            # so the sum identity holds UNCONDITIONALLY — the identity
            # is what makes /metrics segment means reconcile with e2e
            scale = total / acc if acc > 0 else 0.0
            parts = [(seg, dur * scale) for seg, dur in parts]
            acc = total
        segs = self.segments
        for seg, dur in parts:
            segs[seg] = segs.get(seg, 0.0) + dur
        segs[residual_to] = segs.get(residual_to, 0.0) + (total - acc)
        self._last = now

    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    def snapshot_ms(self) -> dict:
        """Rounded-ms view for span attrs / flight records (small JSON,
        human-scannable next to durationSec)."""
        return {k: round(v * 1e3, 3) for k, v in self.segments.items()}

    def finish(self) -> dict:
        """Observe every booked segment into this family's histogram
        children and return the raw segment dict (seconds)."""
        children = _SEGMENT_CHILDREN.get(self.family)
        if children is not None:
            for seg, dur in self.segments.items():
                child = children.get(seg)
                if child is not None:
                    child.observe(dur)
        return dict(self.segments)


# -- thread-local scope (the trace_scope pattern) ---------------------------

_local = threading.local()


def current_timeline() -> Optional[Timeline]:
    return getattr(_local, "tl", None)


class timeline_scope:
    """Bind a timeline to this thread for the duration of the block
    (the micro-batcher and nested marks find it via
    :func:`current_timeline`).  Slotted like ``trace_scope``: this
    wraps every served query."""

    __slots__ = ("tl", "_prev")

    def __init__(self, tl: Optional[Timeline]):
        self.tl = tl

    def __enter__(self) -> Optional[Timeline]:
        self._prev = getattr(_local, "tl", None)
        _local.tl = self.tl
        return self.tl

    def __exit__(self, *exc) -> None:
        _local.tl = self._prev


def mark(segment: str) -> None:
    """Mark a boundary on the thread's current timeline; free no-op
    when no timeline is in scope (direct library calls, tests)."""
    tl = getattr(_local, "tl", None)
    if tl is not None:
        tl.mark(segment)


# -- on-demand torch.profiler capture --------------------------------------


class _ProfilerThread:
    """The one thread of the process on which every ``torch.profiler``
    session starts and stops: each ``/debug/profile`` capture, whichever
    request thread asked for it, and each ``utils.profiling``
    ``profile_trace`` block, whichever thread runs the block.

    Started on first use; it lives until interpreter exit, where an
    ``atexit`` hook stops and joins it, so no profiler work is left on a
    thread of its own when the interpreter and torch's native state are
    torn down.  A call made on this thread runs inline."""

    def __init__(self):
        self._lock = threading.Lock()
        self._jobs = None
        self._thread: Optional[threading.Thread] = None
        # a session has run in this process (see exit_process)
        self.used = False

    def call(self, fn):
        """``fn()`` on the profiler thread: its result, or its exception
        raised here."""
        with self._lock:
            self.used = True
            if self._thread is threading.current_thread():
                return fn()
            if self._thread is None:
                import atexit
                import queue

                self._jobs = queue.SimpleQueue()
                self._thread = threading.Thread(
                    target=self._loop, args=(self._jobs,),
                    name="pio-profiler", daemon=True)
                self._thread.start()
                atexit.register(self.stop)
            jobs = self._jobs
        box: dict = {}
        done = threading.Event()
        jobs.put((fn, box, done))
        done.wait()
        if "error" in box:
            raise box["error"]
        return box.get("value")

    @staticmethod
    def _loop(jobs) -> None:
        while True:
            job = jobs.get()
            if job is None:
                return
            fn, box, done = job
            try:
                box["value"] = fn()
            except BaseException as e:  # noqa: BLE001 — raised by call()
                box["error"] = e
            finally:
                done.set()

    def stop(self) -> None:
        """Stop and join the thread (a later call starts a new one)."""
        with self._lock:
            thread, jobs = self._thread, self._jobs
            self._thread = self._jobs = None
        if thread is not None:
            jobs.put(None)
            thread.join()


_profiler_thread = _ProfilerThread()


def on_profiler_thread(fn):
    """Run ``fn()`` on the process's profiler thread (see
    :class:`_ProfilerThread`) and return its result."""
    return _profiler_thread.call(fn)


def exit_process(code: int) -> None:
    """End the process with exit code ``code`` (the console's way out).

    A process in which a ``torch.profiler`` session ran ends through
    ``os._exit`` once the profiler thread is joined and logging and the
    standard streams are flushed: on the H100 the interpreter's own
    teardown of torch's native profiler state aborts such a process
    (``terminate called without an active exception``, exit code -6)
    when another thread is still in device work at exit (PERF.md §6).
    Every other process ends through ``sys.exit``."""
    if not _profiler_thread.used:
        sys.exit(code)
    import logging

    _profiler_thread.stop()
    logging.shutdown()
    for stream in (sys.stdout, sys.stderr):
        try:
            stream.flush()
        except (OSError, ValueError):
            pass
    os._exit(code)


class ProfileBusy(RuntimeError):
    """A capture is already in flight (one per process — concurrent
    profiler sessions are not supported)."""


_capture_lock = threading.Lock()
_profiling = False  # bare bool read on the hot path (GIL-atomic)


def profiling_active() -> bool:
    return _profiling


class annotate:
    """``torch.profiler.record_function`` bridge: a named scope that
    appears in the trace while a :func:`capture_profile` is live and
    costs one module-bool check otherwise."""

    __slots__ = ("name", "_cm")

    def __init__(self, name: str):
        self.name = name
        self._cm = None

    def __enter__(self) -> "annotate":
        if _profiling:
            import torch.profiler

            self._cm = torch.profiler.record_function(self.name)
            self._cm.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self._cm is not None:
            cm, self._cm = self._cm, None
            cm.__exit__(*exc)


def profiles_dir() -> Path:
    return telemetry_home() / "profiles"


def capture_profile(seconds: float,
                    out_dir: Optional[os.PathLike | str] = None) -> dict:
    """Blocking on-demand profiler capture (``GET /debug/profile``).

    Records, on the process's profiler thread (:func:`on_profiler_thread`;
    the caller waits), a ``torch.profiler`` trace with CPU and CUDA
    activities for ``seconds`` (clamped to [0.05, 60] — a scrape typo
    must not wedge a handler thread for an hour) into ``trace.json``
    (Chrome trace
    format) in a fresh timestamped directory under
    ``telemetry/profiles/``, with :class:`annotate` scopes live.
    Raises :class:`ProfileBusy` when a capture is already running, and
    ``RuntimeError`` when the process has no CUDA device or the trace
    holds no CUDA kernel: a capture that could not see the card must be
    loud, never a CPU-only artifact (the HTTP mount answers 500)."""
    seconds = min(max(float(seconds), 0.05), 60.0)
    if not _capture_lock.acquire(blocking=False):
        raise ProfileBusy("a profile capture is already running")
    try:
        import json

        import torch
        from torch.profiler import ProfilerActivity, profile

        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: a profile would hold no "
                               "device activity")
        base = Path(out_dir) if out_dir is not None else profiles_dir()
        stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
        target = base / f"{stamp}-pid{os.getpid()}"
        target.mkdir(parents=True, exist_ok=True)
        trace = target / "trace.json"

        def capture() -> None:
            global _profiling
            prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
            )
            prof.start()
            _profiling = True
            try:
                time.sleep(seconds)
            finally:
                _profiling = False
                # the kernels launched in the window end before the
                # session does
                torch.cuda.synchronize()
                prof.stop()
            prof.export_chrome_trace(str(trace))

        on_profiler_thread(capture)
        with open(trace, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sorted({
            e["name"] for e in events
            if e.get("cat") == "kernel" and "name" in e
        })
        if not kernels:
            raise RuntimeError(
                f"profile capture recorded no CUDA kernel in {seconds:g} s "
                f"({len(events)} trace events, {trace})"
            )
        files = sorted(
            str(p.relative_to(target))
            for p in target.rglob("*") if p.is_file()
        )
        total = sum((target / f).stat().st_size for f in files)
        return {
            "dir": str(target),
            "seconds": seconds,
            "files": files,
            "totalBytes": total,
            "cudaKernels": kernels,
        }
    finally:
        _capture_lock.release()
