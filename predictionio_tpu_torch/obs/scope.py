"""pio-scope: always-on CPU sampling profiler + lock-contention lens.

The fifth observability leg (pulse = request lifecycle, xray =
compiler/device, tower = training, lens = fleet): *where does the CPU
actually go, and which lock do threads queue on?*  The serving router
is a single event loop, the ingest fleet time-slices one GIL-bound
core per worker — at saturation the question that decides what to fix
is per-thread attribution, continuously, in production, at an
overhead too small to argue about.

Three pieces:

* **Sampling profiler.**  A daemon thread wakes at ``PIO_TPU_SCOPE_HZ``
  (default ~67 Hz — deliberately not a divisor of common periodic
  work) and snapshots every thread's Python stack via
  ``sys._current_frames()`` — no tracing hooks, no interpreter
  switches, cost proportional to thread count x stack depth.  Each
  sample is folded into Brendan-Gregg collapsed-stack form
  (``role;file:fn;file:fn``), classified running/waiting by its leaf
  frame (a thread parked in ``threading.py:wait`` is idle, not hot),
  and aggregated into a bounded time-bucketed ring (1 s buckets,
  ``window_s`` deep) so ``GET /debug/pprof?seconds=S`` answers from
  history instantly — it never blocks to "collect for S seconds".
  Threads are keyed by **role**: spawn sites call
  :func:`register_thread_role` ("eventloop", "microbatch_dispatcher",
  "wal_committer", "foldin_runner", "health_loop", "ingest_worker",
  ...); unregistered threads fall back to "main"/"other" so the
  profile is total, not just the instrumented part.  Every sample also
  books ``pio_cpu_thread_samples_total{role,state}`` — the role-level
  CPU split as plain counters, scrapeable without parsing stacks — and
  the sampler self-measures into ``pio_profile_overhead_ratio``
  (cumulative sampling time / wall time, THE number that keeps
  "always-on" honest).

* **Lock-contention lens.**  ``sys._current_frames`` cannot see who
  blocks on which ``threading.Lock`` (the C-level wait has no Python
  frame of its own), so the hot locks are wrapped instead:
  :class:`TimedLock` / :class:`TimedCondition` are drop-ins whose fast
  path is one extra non-blocking ``acquire(False)`` attempt (tens of
  ns).  Only the *contended* path — the one that was going to block
  anyway — pays for timing: every contended wait books
  ``pio_lock_wait_seconds{lock}``, and hold times book
  ``pio_lock_hold_seconds{lock}`` for contended acquisitions plus a
  1-in-``sample_every`` sample of uncontended ones (enough to estimate
  the hold distribution without two clock reads per acquisition).

* **Shared rendering.**  :func:`flamegraph_html` turns folded text
  into a dependency-free zoomable icicle flamegraph (inline JS, no
  CDN) — the dashboard's ``/prof.html`` and ``tools.profcat`` emit
  the same template, so a fleet-merged profile and a single process's
  look identical.

Sampling is a *statistical* profile: a 67 Hz sampler attributes CPU
shares accurately over seconds, not individual microsecond events.
The lock lens is a *proxy*: it measures queueing on the wrapped locks,
not the GIL itself — but on a GIL-bound process the wrapped monitor
queues are where the GIL's effects surface as ordering.

Pure stdlib (this module is imported by the event server, piolint
runs, every storage layer); no torch, no package-internal imports
outside ``obs``.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from typing import Iterable, Optional

from . import get_registry, log_buckets

__all__ = [
    "ScopeProfiler",
    "TimedCondition",
    "TimedLock",
    "ensure_started",
    "flamegraph_html",
    "get_profiler",
    "merge_folded",
    "parse_folded",
    "profiler_running",
    "register_thread_role",
    "set_enabled",
    "thread_roles",
]

_registry = get_registry()

CPU_THREAD_SAMPLES = _registry.counter(
    "pio_cpu_thread_samples_total",
    "Sampling-profiler thread samples by registered role and "
    "leaf-frame state (running = on CPU or runnable, waiting = parked "
    "in a known blocking frame); at a fixed rate the per-role share "
    "of running samples IS the per-role CPU share",
    labels=("role", "state"),
)
PROFILE_OVERHEAD = _registry.gauge(
    "pio_profile_overhead_ratio",
    "Self-measured profiler cost: cumulative time spent taking+folding "
    "samples divided by wall time since the sampler started (the "
    "always-on budget is <= 0.05)",
)
LOCK_WAIT_SECONDS = _registry.histogram(
    "pio_lock_wait_seconds",
    "Time a thread spent blocked acquiring a scope-wrapped hot lock "
    "(contended acquisitions only — the uncontended fast path books "
    "nothing); per logical lock name, not per instance",
    labels=("lock",),
    buckets=log_buckets(1e-6, 10.0, per_decade=4),
)
LOCK_HOLD_SECONDS = _registry.histogram(
    "pio_lock_hold_seconds",
    "Outermost hold duration of a scope-wrapped hot lock (every "
    "contended acquisition + a 1-in-N sample of uncontended ones)",
    labels=("lock",),
    buckets=log_buckets(1e-6, 10.0, per_decade=4),
)


# -- thread roles -----------------------------------------------------------

_roles_lock = threading.Lock()
_roles: dict[int, str] = {}


def register_thread_role(role: str,
                         thread: Optional[threading.Thread] = None) -> None:
    """Tag the calling thread (or ``thread``, if started) with a role
    for profiler attribution.  Idempotent; last registration wins.
    Call it first thing inside the thread's target — a not-yet-started
    Thread has no ident to key on."""
    ident = thread.ident if thread is not None else threading.get_ident()
    if ident is None:
        raise ValueError(
            "thread has no ident yet (not started); register from "
            "inside the thread's target instead"
        )
    with _roles_lock:
        _roles[int(ident)] = str(role)


def thread_roles() -> dict[int, str]:
    """Snapshot of the ident -> role table (debug/status surfaces)."""
    with _roles_lock:
        return dict(_roles)


def _prune_roles(live_idents: Iterable[int]) -> None:
    """Drop registrations for dead threads (per-connection HTTP
    handler threads come and go; the table must not grow forever)."""
    live = set(live_idents)
    with _roles_lock:
        for ident in [i for i in _roles if i not in live]:
            del _roles[ident]


# -- stack folding ----------------------------------------------------------

# a thread whose LEAF frame is one of these is parked, not computing:
# blocking C calls (lock.acquire, select, socket recv, sleep) have no
# Python frame of their own, so the caller's frame is the evidence
_WAIT_FILES = frozenset((
    "threading.py", "queue.py", "selectors.py", "socketserver.py",
    "socket.py", "ssl.py", "subprocess.py", "connection.py",
))
_WAIT_NAMES = frozenset((
    "wait", "wait_for", "select", "poll", "accept", "sleep", "join",
    "recv", "recv_into", "readinto", "settimeout", "getaddrinfo",
    "_wait_for_tstate_lock",
))

_MAX_DEPTH = 64


def _fold(frame) -> tuple[str, str]:
    """``(state, folded)`` for one thread's frame: collapsed-stack
    frames root-first, ``file:function`` per level, sanitized for the
    folded grammar (no ';' or ' ' inside a frame)."""
    parts: list[str] = []
    f = frame
    while f is not None and len(parts) < _MAX_DEPTH:
        code = f.f_code
        fn = code.co_filename
        base = fn.rsplit("/", 1)[-1].rsplit("\\", 1)[-1]
        parts.append(f"{base}:{code.co_name}")
        f = f.f_back
    if f is not None:
        parts.append("(deeper)")
    leaf_file, _, leaf_name = parts[0].partition(":")
    state = (
        "waiting"
        if leaf_file in _WAIT_FILES or leaf_name in _WAIT_NAMES
        else "running"
    )
    parts.reverse()
    folded = ";".join(parts).replace(" ", "_")
    return state, folded


# -- folded-text helpers (shared with profcat) ------------------------------

def parse_folded(text: str) -> dict[str, int]:
    """``{"root;frame;frame": count}`` from collapsed-stack text;
    malformed lines are skipped (merging tolerates partial fetches)."""
    out: dict[str, int] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        stack, _, count = line.rpartition(" ")
        if not stack:
            continue
        try:
            out[stack] = out.get(stack, 0) + int(count)
        except ValueError:
            continue
    return out


def merge_folded(parts: Iterable[dict[str, int]]) -> dict[str, int]:
    out: dict[str, int] = {}
    for p in parts:
        for stack, count in p.items():
            out[stack] = out.get(stack, 0) + count
    return out


def render_folded(agg: dict[str, int]) -> str:
    return "".join(
        f"{stack} {count}\n" for stack, count in sorted(agg.items())
    )


# -- the profiler -----------------------------------------------------------

class ScopeProfiler:
    """See module docstring.  One per process (:func:`get_profiler`);
    tests build private instances and drive :meth:`record_samples`
    directly for deterministic ring contents."""

    def __init__(self, hz: Optional[float] = None, window_s: int = 120,
                 max_keys_per_bucket: int = 4096):
        self.hz = float(hz) if hz else _env_hz()
        self.window_s = int(window_s)
        self.max_keys_per_bucket = int(max_keys_per_bucket)
        # ring of (epoch_second, {(role, state, folded): count});
        # one lock guards ring structure AND bucket dicts — writers
        # are the sampler (one thread), readers copy under the lock
        # and aggregate outside it
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque()
        self._state_lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        # overhead accounting: written only by the sampler thread,
        # read by the gauge callback (float reads are atomic in
        # CPython; a torn read here would still be a valid ratio)
        self._cost_s = 0.0
        self._started_mono: Optional[float] = None
        self._samples = 0
        # (role, state) -> counter child, resolved once (labels() is
        # a dict+lock round trip; 67 Hz x threads would feel it)
        self._children: dict[tuple[str, str], object] = {}

    # -- capture -----------------------------------------------------------
    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample of every thread; returns threads sampled.
        Public for tests and for one-shot CLI probes."""
        t0 = time.perf_counter()
        frames = sys._current_frames()
        # the sampler profiling itself is pure noise; and its own frame
        # in the dict would close a cycle (the frame's locals hold the
        # dict) that keeps every sampled frame, with the locals of each
        # thread's calls, alive until the cyclic collector runs
        frames.pop(threading.get_ident(), None)
        main_ident = threading.main_thread().ident
        with _roles_lock:
            roles = dict(_roles)
        items: list[tuple[str, str, str]] = []
        for ident, frame in frames.items():
            role = roles.get(ident)
            if role is None:
                role = "main" if ident == main_ident else "other"
            state, folded = _fold(frame)
            items.append((role, state, folded))
        self.record_samples(items, now=now)
        # single-writer (sampler thread) overhead accounting; a torn
        # float read by the gauge is still a valid ratio
        self._cost_s += time.perf_counter() - t0  # piolint: disable=PIO201
        self._samples += 1
        return len(items)

    def record_samples(self, items: Iterable[tuple[str, str, str]],
                       now: Optional[float] = None) -> None:
        """Fold ``(role, state, folded)`` samples into the ring bucket
        for ``now`` and book the role/state counters.  The
        deterministic entry point: tests drive it with synthetic
        stacks and pinned clocks."""
        items = list(items)
        sec = int(now if now is not None else time.time())
        with self._lock:
            if not self._ring or self._ring[-1][0] != sec:
                self._ring.append((sec, {}))
                cutoff = sec - self.window_s
                while self._ring and self._ring[0][0] <= cutoff:
                    self._ring.popleft()
            bucket = self._ring[-1][1]
            for role, state, folded in items:
                key = (role, state, folded)
                if key not in bucket and (
                    len(bucket) >= self.max_keys_per_bucket
                ):
                    key = (role, state, "(truncated)")
                bucket[key] = bucket.get(key, 0) + 1
        for role, state, _ in items:
            child = self._children.get((role, state))
            if child is None:
                child = CPU_THREAD_SAMPLES.labels(role=role, state=state)
                self._children[(role, state)] = child
            child.inc()

    # -- query -------------------------------------------------------------
    def _window(self, lo_sec: int, hi_sec: int) -> dict:
        """Merged ``{(role, state, folded): count}`` over ring buckets
        with ``lo_sec <= epoch_second <= hi_sec``.  Bucket dicts are
        copied under the lock, merged outside it."""
        with self._lock:
            picked = [
                dict(bucket) for sec, bucket in self._ring
                if lo_sec <= sec <= hi_sec
            ]
        agg: dict = {}
        for bucket in picked:
            for key, count in bucket.items():
                agg[key] = agg.get(key, 0) + count
        return agg

    def collapsed(self, seconds: float = 60.0,
                  state: Optional[str] = None,
                  role: Optional[str] = None,
                  now: Optional[float] = None) -> str:
        """Collapsed-stack text for the trailing ``seconds`` window
        (non-blocking — pure ring read).  Lines are
        ``role;file:fn;... count`` with the role as the root frame;
        ``state``/``role`` filter, ``state=None`` merges running and
        waiting samples of the same stack."""
        hi = int(now if now is not None else time.time())
        lo = hi - max(0, int(seconds) - 1)  # N buckets = N seconds
        agg = self._window(lo, hi)
        out: dict[str, int] = {}
        for (r, s, folded), count in agg.items():
            if state is not None and s != state:
                continue
            if role is not None and r != role:
                continue
            stack = f"{r};{folded}"
            out[stack] = out.get(stack, 0) + count
        return render_folded(out)

    def role_totals(self, seconds: float = 60.0,
                    now: Optional[float] = None) -> dict:
        """``{role: {state: samples}}`` over the window — the CPU-split
        table bench_serving --profile stamps per sweep point."""
        hi = int(now if now is not None else time.time())
        lo = hi - max(0, int(seconds) - 1)
        out: dict[str, dict[str, int]] = {}
        for (r, s, _), count in self._window(lo, hi).items():
            d = out.setdefault(r, {})
            d[s] = d.get(s, 0) + count
        return out

    def dominant_stacks(self, t_start: float, t_end: float,
                        top: int = 3,
                        state: str = "running") -> list[dict]:
        """Top folded stacks sampled during a wall window — the flight
        recorder's "what was the process doing while this request was
        slow" annotation.  Buckets are 1 s wide, so the window is
        widened to the covering buckets; a sub-millisecond request
        under load still joins ~one bucket's worth of samples."""
        agg = self._window(int(t_start), int(t_end))
        picked: dict[str, int] = {}
        total = 0
        for (r, s, folded), count in agg.items():
            if state is not None and s != state:
                continue
            total += count
            stack = f"{r};{folded}"
            picked[stack] = picked.get(stack, 0) + count
        ranked = sorted(picked.items(), key=lambda kv: (-kv[1], kv[0]))
        return [
            {
                "stack": stack,
                "count": count,
                "share": round(count / total, 4) if total else 0.0,
            }
            for stack, count in ranked[:top]
        ]

    def overhead_ratio(self) -> float:
        # lock-free gauge read of the single-writer accounting fields:
        # a stale or torn value is still a valid instantaneous ratio
        started = self._started_mono  # piolint: disable=PIO202
        if started is None:
            return 0.0
        wall = time.monotonic() - started
        return self._cost_s / wall if wall > 0 else 0.0  # piolint: disable=PIO202

    def stats(self) -> dict:
        with self._lock:
            buckets = len(self._ring)
        with self._state_lock:
            running = self._thread is not None
        return {
            "running": running,
            "hz": self.hz,
            "windowSec": self.window_s,
            "buckets": buckets,
            "samples": self._samples,
            "overheadRatio": round(self.overhead_ratio(), 5),
            "roles": sorted(set(thread_roles().values())),
        }

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        """Idempotent; installs the overhead gauge and spawns the
        sampler daemon."""
        with self._state_lock:
            if self._thread is not None:
                return
            self._stop_evt = threading.Event()
            self._started_mono = time.monotonic()
            self._cost_s = 0.0
            t = threading.Thread(
                target=self._loop, args=(self._stop_evt,),
                name="scope-sampler", daemon=True,
            )
            self._thread = t
        PROFILE_OVERHEAD.child().set_function(self.overhead_ratio)
        t.start()

    def stop(self) -> None:
        with self._state_lock:
            t = self._thread
            self._thread = None
            if t is None:
                return
            self._stop_evt.set()
        t.join(timeout=2.0)

    def _loop(self, stop_evt: threading.Event) -> None:
        # the event arrives as an argument so a stop()/start() pair
        # can never hand this (old) loop the NEW event
        register_thread_role("scope_sampler")
        interval = 1.0 / max(self.hz, 0.1)
        next_t = time.monotonic()
        n = 0
        while True:
            next_t += interval
            delay = next_t - time.monotonic()
            if delay < -1.0:
                # fell behind (suspend, GC storm): resynchronize
                # instead of burning CPU catching up on stale ticks
                next_t = time.monotonic() + interval
                delay = interval
            if stop_evt.wait(max(delay, 0.0)):
                return
            try:
                self.sample_once()
            except Exception:
                continue  # a weird frame must never kill the sampler
            n += 1
            if n % 256 == 0:
                _prune_roles(sys._current_frames().keys())


def _env_hz() -> float:
    try:
        hz = float(os.environ.get("PIO_TPU_SCOPE_HZ", "67"))
    except ValueError:
        hz = 67.0
    return min(max(hz, 1.0), 250.0)


_profiler = ScopeProfiler()
_enabled = True


def get_profiler() -> ScopeProfiler:
    return _profiler


def set_enabled(enabled: bool) -> None:
    """``--no-profiler`` / ``PIO_TPU_SCOPE=0``: stops the sampler (and
    keeps :func:`ensure_started` a no-op).  The lock lens keeps
    booking — TimedLock's cost lives on the contended path only, and
    losing the contention evidence is never what an opt-out means."""
    global _enabled
    _enabled = bool(enabled)
    if not _enabled:
        _profiler.stop()


def profiler_running() -> bool:
    return _profiler._thread is not None


def ensure_started() -> bool:
    """Start the always-on sampler unless opted out (``--no-profiler``
    flag via :func:`set_enabled`, or ``PIO_TPU_SCOPE=0`` in the
    environment — the knob subprocess fleets inherit).  Every server
    boot path calls this; returns True when the sampler runs."""
    if not _enabled or os.environ.get("PIO_TPU_SCOPE", "1").lower() in (
        "0", "off", "false", "no"
    ):
        return False
    _profiler.start()
    return True


# -- lock-contention lens ---------------------------------------------------

class TimedLock:
    """Drop-in ``threading.Lock`` / ``RLock`` (``reentrant=True``) that
    books contention into ``pio_lock_wait_seconds{lock=name}`` and
    hold times into ``pio_lock_hold_seconds{lock=name}``.

    Fast path: one non-blocking ``acquire(False)`` attempt — success
    means no contention and nothing is booked except a
    1-in-``sample_every`` hold sample.  Failure falls through to a
    timed blocking acquire; that wait (and the subsequent hold) is
    always booked — the contended path was going to park the thread
    anyway, two clock reads are free by comparison.

    Implements the full lock protocol ``threading.Condition`` needs
    (``_is_owned`` / ``_release_save`` / ``_acquire_restore``), so
    ``TimedCondition(name, lock=TimedLock(...))`` times both monitor
    entry and the post-notify reacquisition queue.  Reentrant holds
    are timed outermost-only (a nested with-block is not a second
    hold).
    """

    sample_every = 16  # uncontended hold sampling period

    def __init__(self, name: str, reentrant: bool = False):
        self.name = str(name)
        self._inner = threading.RLock() if reentrant else threading.Lock()
        self._m_wait = LOCK_WAIT_SECONDS.labels(lock=self.name)
        self._m_hold = LOCK_HOLD_SECONDS.labels(lock=self.name)
        self._local = threading.local()
        # incremented only while holding _inner, so plain int is safe
        self._acqs = 0

    # -- core protocol -----------------------------------------------------
    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._inner.acquire(False):
            self._note_acquired(contended=False)
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        got = self._inner.acquire(True, timeout)
        if got:
            self._m_wait.observe(time.perf_counter() - t0)
            self._note_acquired(contended=True)
        return got

    def release(self) -> None:
        local = self._local
        depth = getattr(local, "depth", 0) - 1
        if depth < 0:
            raise RuntimeError(f"release of un-acquired TimedLock "
                               f"{self.name!r}")
        local.depth = depth
        book = None
        if depth == 0:
            self._acqs += 1  # still holding: increments serialize
            if local.contended or self._acqs % self.sample_every == 0:
                book = time.perf_counter() - local.t_hold
        self._inner.release()
        if book is not None:
            # booked OFF-lock: the registry shard lock never nests
            # inside the wrapped lock, and the waiter behind us is
            # already running
            self._m_hold.observe(book)

    def __enter__(self) -> "TimedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def _note_acquired(self, contended: bool) -> None:
        local = self._local
        depth = getattr(local, "depth", 0)
        local.depth = depth + 1
        if depth == 0:
            local.contended = contended
            local.t_hold = time.perf_counter()

    # -- Condition protocol ------------------------------------------------
    def _is_owned(self) -> bool:
        inner = self._inner
        owned = getattr(inner, "_is_owned", None)
        if owned is not None:
            return owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _release_save(self):
        """Full release for ``Condition.wait`` — closes out the hold
        (whatever the reentrant depth) and remembers it for restore."""
        local = self._local
        depth = getattr(local, "depth", 0)
        self._acqs += 1
        book = None
        if local.contended or self._acqs % self.sample_every == 0:
            book = time.perf_counter() - local.t_hold
        local.depth = 0
        save = getattr(self._inner, "_release_save", None)
        state = save() if save is not None else self._inner.release()
        if book is not None:
            self._m_hold.observe(book)
        return (state, depth)

    def _acquire_restore(self, saved) -> None:
        """Reacquire after a ``Condition.wait`` wakeup.  The time spent
        here is pure monitor-reacquisition queueing (the notify wait
        itself already ended), so it always books as lock wait."""
        state, depth = saved
        t0 = time.perf_counter()
        restore = getattr(self._inner, "_acquire_restore", None)
        if restore is not None:
            restore(state)
        else:
            self._inner.acquire()
        self._m_wait.observe(time.perf_counter() - t0)
        local = self._local
        local.depth = depth
        local.contended = True
        local.t_hold = time.perf_counter()


class TimedCondition(threading.Condition):
    """``threading.Condition`` over a :class:`TimedLock` monitor: entry
    contention, post-notify reacquisition queueing, and hold times all
    book under ``lock=name``.  Pass ``lock=`` to share an existing
    :class:`TimedLock` (the WAL's cv shares its commit lock)."""

    def __init__(self, name: str, lock: Optional[TimedLock] = None):
        if lock is None:
            lock = TimedLock(name, reentrant=True)
        super().__init__(lock)
        self.name = str(name)


# -- flamegraph template ----------------------------------------------------

_FLAME_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{font:13px system-ui,sans-serif;margin:16px;background:#fafafa}
h1{font-size:16px;margin:0 0 2px}
#meta{color:#666;margin-bottom:10px}
#fg{border:1px solid #ddd;background:#fff;position:relative}
.fr{position:absolute;height:17px;overflow:hidden;white-space:nowrap;
 font-size:11px;line-height:17px;padding:0 3px;box-sizing:border-box;
 border:1px solid rgba(255,255,255,.7);cursor:pointer;
 text-overflow:ellipsis}
.fr:hover{filter:brightness(.85)}
#crumb{margin:8px 0;color:#444;min-height:1.2em}
a{color:#06c;text-decoration:none}
.neg{outline:2px solid #2a7}
.pos{outline:2px solid #c33}
</style></head><body>
<h1>__TITLE__</h1>
<div id="meta"></div>
<div id="crumb"></div>
<div id="fg"></div>
<script>
var FOLDED = __FOLDED__;
var BASELINE = __BASELINE__;
function parse(text){var m={};text.split("\\n").forEach(function(l){
  l=l.trim();if(!l||l[0]=="#")return;var i=l.lastIndexOf(" ");
  if(i<0)return;var n=parseInt(l.slice(i+1),10);if(isNaN(n))return;
  var s=l.slice(0,i);m[s]=(m[s]||0)+n;});return m;}
function tree(m){var root={name:"all",value:0,base:0,kids:{}};
  Object.keys(m).forEach(function(stack){var n=m[stack];
    root.value+=n;var cur=root;
    stack.split(";").forEach(function(f){
      var k=cur.kids[f]||(cur.kids[f]={name:f,value:0,base:0,kids:{}});
      k.value+=n;cur=k;});});
  return root;}
function addBase(root,m){Object.keys(m).forEach(function(stack){
  var n=m[stack];root.base+=n;var cur=root;
  stack.split(";").every(function(f){var k=cur.kids[f];
    if(!k)return false;k.base+=n;cur=k;return true;});});}
function color(name){var h=0;for(var i=0;i<name.length;i++)
  h=(h*31+name.charCodeAt(i))>>>0;
  return "hsl("+(h%360)+",62%,"+(68+(h>>9)%14)+"%)";}
var W,fg=document.getElementById("fg"),
    crumb=document.getElementById("crumb"),ROOT,TOTB;
function render(node,path){fg.innerHTML="";W=fg.clientWidth||900;
  var maxd=0;
  function depth(n,d){if(d>maxd)maxd=d;
    Object.keys(n.kids).forEach(function(k){depth(n.kids[k],d+1);});}
  depth(node,0);fg.style.height=((maxd+1)*17+2)+"px";
  function row(n,x,w,d){if(w<0.5)return;
    var e=document.createElement("div");e.className="fr";
    e.style.left=x+"px";e.style.top=(d*17)+"px";e.style.width=w+"px";
    e.style.background=color(n.name);
    var pct=(100*n.value/node.value).toFixed(1);
    var t=n.name+" — "+n.value+" samples ("+pct+"%)";
    if(BASELINE!==null&&TOTB>0){
      var shareA=n.value/ROOT.value,shareB=n.base/TOTB,
          d2=shareA-shareB;
      t+=" | baseline "+(100*shareB).toFixed(1)+"% ("+
         (d2>=0?"+":"")+(100*d2).toFixed(1)+"pp)";
      if(d2>0.02)e.className+=" pos";else if(d2<-0.02)e.className+=" neg";}
    e.title=t;e.textContent=n.name;
    e.onclick=function(ev){ev.stopPropagation();
      render(n,path.concat([n.name]));};
    fg.appendChild(e);
    var cx=x,kids=Object.keys(n.kids).map(function(k){return n.kids[k];})
      .sort(function(a,b){return b.value-a.value;});
    kids.forEach(function(k){var kw=w*k.value/n.value;
      row(k,cx,kw,d+1);cx+=kw;});}
  row(node,0,W,0);
  crumb.innerHTML=path.length>1
    ?path.map(function(p,i){return "<a href='#' data-i='"+i+"'>"+p+
      "</a>";}).join(" &gt; ")
    :"click a frame to zoom";
  crumb.querySelectorAll("a").forEach(function(a){
    a.onclick=function(ev){ev.preventDefault();
      var i=+a.getAttribute("data-i"),n=ROOT,pp=["all"];
      for(var j=1;j<=i;j++){n=n.kids[path[j]];pp.push(path[j]);}
      render(n,pp);};});}
var m=parse(FOLDED);ROOT=tree(m);TOTB=0;
if(BASELINE!==null){var mb=parse(BASELINE);
  TOTB=Object.keys(mb).reduce(function(a,k){return a+mb[k];},0);
  addBase(ROOT,mb);}
document.getElementById("meta").textContent=ROOT.value+
  " samples"+(BASELINE!==null?(" · diff vs baseline ("+TOTB+
  " samples): red = grew >2pp, green = shrank >2pp"):"")+
  " · widths are sample shares · roles are root frames";
render(ROOT,["all"]);
window.onresize=function(){render(ROOT,["all"]);};
</script></body></html>
"""


def flamegraph_html(folded: str, title: str = "pio-scope profile",
                    baseline: Optional[str] = None) -> str:
    """Self-contained flamegraph page for collapsed-stack text; with
    ``baseline`` folded text the page renders share deltas per frame
    (the profcat A/B diff view).  No external assets — servable from
    an air-gapped dashboard or written to a file by profcat."""
    import json as _json

    return (
        _FLAME_PAGE
        .replace("__TITLE__", title.replace("<", "&lt;"))
        .replace("__FOLDED__", _json.dumps(folded))
        .replace("__BASELINE__",
                 _json.dumps(baseline) if baseline is not None else "null")
    )
