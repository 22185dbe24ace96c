"""pio-xray in the port: build + device observability.

Port of ``predictionio_tpu/obs/xray.py``.  The reference hooks
``jax.monitoring`` for XLA compiles and reads ``jax.devices()``; the
port has no tracing compiler, so each family counts what happens on
the card:

* **Builds.**  ``pio_jit_compiles_total{fn}`` and
  ``pio_jit_compile_seconds`` book the builds that really happen: the
  first-use ``nvcc`` build of the kernel library (``ops/_build.py``)
  and the ``g++`` build of the native host runtime (``native/``), each
  through :func:`note_build`.  ``fn`` is the :func:`instrument`-ed
  entry point in flight on the building thread, ``"untracked"``
  outside one (the reference's attribution).  There is no persistent
  compilation cache, so ``pio_compile_cache_events_total`` stays at
  zero, and no cost analysis, so ``pio_jit_fn_cost`` stays empty.
* **Call signatures.**  :func:`instrument` wraps an entry point and
  fingerprints every call's arg signature (shapes / dtypes / static
  kwargs).  A new signature — with its **delta** against the previous
  one and the current trace id — lands in the bounded ring that
  ``GET /debug/xray`` serves.  On the card a new signature compiles
  nothing (the kernels are built once per library), so it is not
  booked as a compile.
* **Device memory.**  :func:`sample_devices_once` sets
  ``pio_device_memory_bytes{device="cuda:I",stat}`` for every CUDA
  device this process has used, from ``torch.cuda.memory_stats`` and
  ``torch.cuda.mem_get_info``:

  ==================== =============================================
  ``stat``              source
  ==================== =============================================
  ``bytes_in_use``      ``memory_stats()["allocated_bytes.all.current"]``
  ``peak_bytes_in_use`` ``memory_stats()["allocated_bytes.all.peak"]``
  ``bytes_limit``       ``mem_get_info()[1]`` (the card's total memory)
  ==================== =============================================

  A process that never initialised CUDA samples nothing and never
  initialises it (``memory_stats`` answers ``{}`` before then), so an
  event server or an ingest worker stays off the card.
  :func:`start_sampler` runs it on a daemon thread; ``deploy`` and
  ``train`` start it, as in the reference.

No module-level torch import: ``obs`` stays importable from processes
that never touch the card; torch loads inside the sampler.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Callable, Optional

from . import get_registry, log_buckets
from .trace import current_trace_id

__all__ = [
    "device_high_water",
    "install",
    "instrument",
    "jit_stats",
    "note_build",
    "recompile_events",
    "sample_devices_once",
    "set_sample_period",
    "start_sampler",
    "stop_sampler",
    "total_backend_compiles",
    "xray_payload",
]

_registry = get_registry()

JIT_COMPILES = _registry.counter(
    "pio_jit_compiles_total",
    "XLA backend compiles attributed to the instrumented entry point "
    "that dispatched them (fn=\"untracked\" for compiles outside any "
    "tracked call)",
    labels=("fn",),
)
JIT_COMPILE_SECONDS = _registry.histogram(
    "pio_jit_compile_seconds",
    "XLA backend compile wall time per compile "
    "(/jax/core/compile/backend_compile_duration)",
    buckets=log_buckets(1e-3, 1000.0, per_decade=4),
)
COMPILE_CACHE_EVENTS = _registry.counter(
    "pio_compile_cache_events_total",
    "jax persistent-compilation-cache events (request/hit/miss): "
    "hit/request ~= 1 is a warm start, ~= 0 a cold one",
    labels=("kind",),
)
DEVICE_MEMORY = _registry.gauge(
    "pio_device_memory_bytes",
    "Per-device memory from device.memory_stats() (stat=bytes_in_use/"
    "peak_bytes_in_use/bytes_limit) or, on backends without allocator "
    "stats, summed live-array bytes (stat=live_bytes)",
    labels=("device", "stat"),
)
JIT_FN_COST = _registry.gauge(
    "pio_jit_fn_cost",
    "cost_analysis() estimate for the most recent compile of an "
    "instrumented fn (kind=flops/bytes_accessed; PIO_TPU_XRAY_COST=1)",
    labels=("fn", "kind"),
)

# the full schema appears on every process's first scrape (pio-obs
# contract); the unlabeled histogram child must exist for its ladder
JIT_COMPILE_SECONDS.child()


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


# -- call-signature fingerprinting ----------------------------------------


def _key_leaf(x):
    """Hashable structural key for one argument (cheap — runs on every
    instrumented call)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return ("arr", tuple(shape), str(dtype))
    if isinstance(x, (tuple, list)):
        return tuple(_key_leaf(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _key_leaf(v)) for k, v in sorted(x.items()))
    if isinstance(x, (int, float, bool, str, bytes, type(None))):
        return x
    return (type(x).__name__, repr(x)[:64])


def _sig_key(args: tuple, kwargs: dict) -> tuple:
    return (
        tuple(_key_leaf(a) for a in args),
        tuple((k, _key_leaf(v)) for k, v in sorted(kwargs.items())),
    )


def _describe_leaf(x) -> str:
    """Human descriptor for the recompile ring (runs only on new
    signatures)."""
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        return f"{dtype}[{','.join(str(d) for d in shape)}]"
    if isinstance(x, (tuple, list)):
        inner = ",".join(_describe_leaf(v) for v in x)
        return f"({inner})"
    if isinstance(x, dict):
        inner = ",".join(
            f"{k}={_describe_leaf(v)}" for k, v in sorted(x.items())
        )
        return f"{{{inner}}}"
    r = repr(x)
    return r if len(r) <= 64 else r[:61] + "..."


def _describe_call(args: tuple, kwargs: dict) -> tuple:
    """``((label, descriptor), ...)`` — positional args by index,
    static/keyword args by name."""
    out = [(f"arg{i}", _describe_leaf(a)) for i, a in enumerate(args)]
    out += [(k, _describe_leaf(v)) for k, v in sorted(kwargs.items())]
    return tuple(out)


def signature_delta(old: Optional[tuple], new: tuple) -> Optional[dict]:
    """What changed between two described signatures — the payload an
    operator reads to learn which arg's shape churned."""
    if old is None:
        return None
    od, nd = dict(old), dict(new)
    changed = [
        {"arg": k, "from": od[k], "to": nd[k]}
        for k in nd if k in od and od[k] != nd[k]
    ]
    added = [{"arg": k, "value": nd[k]} for k in nd if k not in od]
    removed = [{"arg": k, "value": od[k]} for k in od if k not in nd]
    return {"changed": changed, "added": added, "removed": removed}


# -- state ------------------------------------------------------------------

_tl = threading.local()  # .fn = name of the instrumented call in flight


class _XrayState:
    """All mutable pio-xray bookkeeping under one lock (none of it is
    on a sub-microsecond path; compiles and new signatures are rare)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._installed = False
        self._fns: dict[str, dict] = {}
        self._ring: collections.deque = collections.deque(
            maxlen=_env_int("PIO_TPU_XRAY_RING", 64)
        )
        self._devices: list = []
        self._devices_at: Optional[float] = None
        self._sampler: Optional[threading.Thread] = None
        self._sampler_stop: Optional[threading.Event] = None
        self._sample_period = _env_float("PIO_TPU_XRAY_SAMPLE_S", 10.0)

    # -- fn tracking -------------------------------------------------------
    def _fn_state_locked(self, name: str) -> dict:
        st = self._fns.get(name)
        if st is None:
            st = {
                "calls": 0,
                "signatures": set(),
                "last_described": None,
                "backend_compiles": 0,
                "compile_seconds_total": 0.0,
                "last_compile_seconds": None,
            }
            self._fns[name] = st
        return st

    def observe_call(self, name: str, key: tuple) -> bool:
        """Count one call; True when the signature is (probably) new —
        the caller then builds the pretty descriptors and calls
        :meth:`register_signature`, which re-checks atomically."""
        with self._lock:
            st = self._fn_state_locked(name)
            st["calls"] += 1
            return key not in st["signatures"]

    def register_signature(self, name: str, key: tuple,
                           described: tuple) -> Optional[dict]:
        """Atomically admit a new signature; returns the ring entry
        (None when a concurrent call already registered it)."""
        with self._lock:
            st = self._fn_state_locked(name)
            if key in st["signatures"]:
                return None
            prev = st["last_described"]
            st["signatures"].add(key)
            st["last_described"] = described
            nth = len(st["signatures"])
            entry = {
                "fn": name,
                "at": time.time(),
                "traceId": current_trace_id(),
                "kind": "compile" if nth == 1 else "recompile",
                "nthSignature": nth,
                "signature": [
                    {"arg": k, "value": v} for k, v in described
                ],
                "delta": signature_delta(prev, described),
            }
            self._ring.append(entry)
            return entry

    def note_backend_compile(self, name: Optional[str],
                             duration_s: float) -> None:
        with self._lock:
            st = self._fn_state_locked(name or "untracked")
            st["backend_compiles"] += 1
            st["compile_seconds_total"] += duration_s
            st["last_compile_seconds"] = duration_s

    # -- misc notes --------------------------------------------------------
    def set_devices(self, devices: list) -> None:
        with self._lock:
            self._devices = list(devices)
            self._devices_at = time.time()

    def set_sample_period(self, period_s: float) -> None:
        with self._lock:
            self._sample_period = float(period_s)

    # -- install / sampler lifecycle --------------------------------------
    def claim_install(self) -> bool:
        """True when this call won the (single) install slot."""
        with self._lock:
            if self._installed:
                return False
            self._installed = True
            return True

    def installed(self) -> bool:
        with self._lock:
            return self._installed

    def sampler_slot(self) -> Optional[threading.Event]:
        """Claim the sampler slot; None when one is already running or
        sampling is disabled (period <= 0)."""
        with self._lock:
            if self._sampler is not None and self._sampler.is_alive():
                return None
            if self._sample_period <= 0:
                return None
            self._sampler_stop = threading.Event()
            return self._sampler_stop

    def set_sampler(self, thread: Optional[threading.Thread]) -> None:
        with self._lock:
            self._sampler = thread

    def sampler_state(self) -> tuple:
        with self._lock:
            return self._sampler_stop, self._sample_period

    # -- snapshots ---------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            fns = {
                name: {
                    "calls": st["calls"],
                    "signatures": len(st["signatures"]),
                    "backendCompiles": st["backend_compiles"],
                    "compileSecondsTotal": round(
                        st["compile_seconds_total"], 6),
                    "lastCompileSeconds": st["last_compile_seconds"],
                }
                for name, st in self._fns.items()
            }
            return {
                "installed": self._installed,
                "fns": fns,
                "recompiles": list(self._ring),
                "devices": list(self._devices),
                "devicesSampledAt": self._devices_at,
            }

    def reset_for_tests(self) -> None:
        with self._lock:
            self._fns = {}
            self._ring.clear()


_STATE = _XrayState()


# -- build hooks ----------------------------------------------------------


def install() -> bool:
    """Mark build observability active (idempotent).  The port's build
    hooks (:func:`note_build`) need no registration; the flag keeps the
    reference's ``/debug/xray`` ``monitoring.installed`` field."""
    _STATE.claim_install()
    return _STATE.installed()


def note_build(seconds: float) -> None:
    """Book one real build (``nvcc`` of the kernel library, ``g++`` of
    the native runtime) into ``pio_jit_compile_seconds`` and
    ``pio_jit_compiles_total{fn}``, attributed to the instrumented
    call in flight on this thread (``"untracked"`` outside one)."""
    fn = getattr(_tl, "fn", None)
    JIT_COMPILE_SECONDS.child().observe(seconds)
    JIT_COMPILES.labels(fn=fn or "untracked").inc()
    _STATE.note_backend_compile(fn, seconds)


# -- instrumented entry points ---------------------------------------------


class _Instrumented:
    """Callable wrapper around an entry point: fingerprints each call,
    feeds the signature ring, and attributes any build fired during
    the call to ``name`` via a thread-local."""

    __slots__ = ("_fn", "_name", "__wrapped__")

    def __init__(self, fn: Callable, name: str):
        self._fn = fn
        self._name = name
        self.__wrapped__ = fn

    def __call__(self, *args, **kwargs):
        name = self._name
        if _STATE.observe_call(name, key := _sig_key(args, kwargs)):
            _STATE.register_signature(
                name, key, _describe_call(args, kwargs)
            )
        prev = getattr(_tl, "fn", None)
        _tl.fn = name
        try:
            return self._fn(*args, **kwargs)
        finally:
            _tl.fn = prev

    def __repr__(self) -> str:
        return f"<xray.instrument({self._name!r}) of {self._fn!r}>"


def instrument(name: str) -> Callable[[Callable], Callable]:
    """Decorator: ``instrument("als.half_iteration")(f)``.

    Instrumented seams (grep for ``xray.instrument(`` to re-derive):
    ``als.half_iteration`` and ``als.phase_probe`` (models/als.py), the
    reference's names for the same functions."""

    def deco(fn: Callable) -> Callable:
        install()
        return _Instrumented(fn, name)

    return deco


# -- device sampling --------------------------------------------------------

# (reference stat name, torch.cuda.memory_stats key)
_MEM_STATS = (
    ("bytes_in_use", "allocated_bytes.all.current"),
    ("peak_bytes_in_use", "allocated_bytes.all.peak"),
)


def sample_devices_once() -> list:
    """One sampling pass over the CUDA devices this process has used;
    sets the ``pio_device_memory_bytes`` gauges and caches the snapshot
    for ``/debug/xray``.  Never initialises CUDA: before the process
    has touched the card, nothing is sampled.  Safe to call from tests
    and scrape handlers."""
    import torch

    out = []
    if torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            if not stats:
                continue  # a device this process never allocated on
            picked = {
                ref: int(stats[key]) for ref, key in _MEM_STATS
                if key in stats
            }
            picked["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
            label = f"cuda:{i}"
            for stat, v in picked.items():
                DEVICE_MEMORY.labels(device=label, stat=stat).set(float(v))
            out.append({
                "device": label,
                "kind": torch.cuda.get_device_name(i),
                "source": "memory_stats",
                "stats": picked,
            })
    _STATE.set_devices(out)
    return out


def set_sample_period(period_s: float) -> None:
    """Sampler cadence; <= 0 disables future :func:`start_sampler`
    calls (running samplers stop at their next tick)."""
    _STATE.set_sample_period(period_s)
    if period_s <= 0:
        stop_sampler()


def start_sampler(period_s: Optional[float] = None) -> bool:
    """Start the daemon device sampler (idempotent — one per process,
    registered at server/workflow boot like the breaker gauges).
    Returns True when a sampler is running after the call."""
    if period_s is not None:
        _STATE.set_sample_period(period_s)
    stop = _STATE.sampler_slot()
    if stop is None:
        _stop, period = _STATE.sampler_state()
        return period > 0 and _stop is not None and not _stop.is_set()

    def loop():
        while True:
            try:
                sample_devices_once()
            except Exception:
                pass  # a flaky backend must not kill the sampler
            _ignored, period = _STATE.sampler_state()
            if period <= 0 or stop.wait(max(period, 0.05)):
                return

    t = threading.Thread(
        target=loop, name="pio-xray-sampler", daemon=True
    )
    _STATE.set_sampler(t)
    t.start()
    return True


def stop_sampler() -> None:
    stop, _period = _STATE.sampler_state()
    if stop is not None:
        stop.set()
    _STATE.set_sampler(None)


# -- read side --------------------------------------------------------------


def jit_stats() -> dict:
    return _STATE.snapshot()["fns"]


def total_backend_compiles() -> int:
    """Builds booked so far, all fns + untracked — pio-tower diffs this
    per sweep (a sweep that built a library is a sweep whose wall time
    lies about steady state)."""
    snap = _STATE.snapshot()
    return sum(st["backendCompiles"] for st in snap["fns"].values())


def device_high_water() -> Optional[int]:
    """Max bytes across devices from the most recent sample:
    ``peak_bytes_in_use``, else the current in-use figure — the single
    high-water number a run manifest records per sweep."""
    snap = _STATE.snapshot()
    best: Optional[int] = None
    for s in snap["devices"]:
        stats = s.get("stats") or {}
        v = stats.get("peak_bytes_in_use")
        if v is None:
            v = stats.get("bytes_in_use")
        if v is not None and (best is None or v > best):
            best = int(v)
    return best


def recompile_events() -> list:
    return _STATE.snapshot()["recompiles"]


def xray_payload() -> dict:
    """The ``GET /debug/xray`` document, in the reference's schema.
    Builds from cached state only — serving a scrape never touches a
    device.  The port has no compilation cache: ``compileCache`` is
    always empty."""
    from .flight import get_flight_recorder

    snap = _STATE.snapshot()
    exemplars = [
        {"le": le, "traceId": ex, "value": v, "at": ts}
        for le, ex, v, ts in _query_latency_exemplars()
    ]
    return {
        "monitoring": {
            "installed": snap["installed"],
            "installError": None,  # the port's hooks cannot fail
        },
        "jit": snap["fns"],
        "recompiles": snap["recompiles"],
        "compileCache": {"dir": None, "events": {}},
        "devices": {
            "sampledAt": snap["devicesSampledAt"],
            "samples": snap["devices"],
        },
        "flight": get_flight_recorder().summary(spans=True),
        "latencyExemplars": exemplars,
    }


def _query_latency_exemplars() -> list:
    from . import QUERY_LATENCY

    return QUERY_LATENCY.child().exemplar_items()
