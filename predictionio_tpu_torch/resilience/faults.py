"""Deterministic fault injection: named points in the real code paths.

Production code calls :func:`check` at each named boundary; with no
plan armed that is one module-global load and a ``None`` compare — the
happy path costs nothing.  Tests (or an operator reproducing an
incident) arm a plan programmatically or through the ``PIO_FAULT_PLAN``
environment variable and the *real* serving/ingestion/restore code
executes its degradation paths.

Injection points instrumented in this codebase::

    storage.write      event-server storage inserts
    storage.read       event-server storage scans
    device.dispatch    serving predict just before the device call
    http.feedback      feedback-event delivery (delivery queue send)
    http.remote_log    remote error-log delivery (delivery queue send)
    reload.load_model  engine (re)load of trained components
    dist.shard_delay   a factor/item shard is SLOW this half/hop
                       (straggler; consulted via :func:`fired_shard`)
    dist.shard_drop    a shard's data is unavailable for ONE half/hop
                       (transient loss; consulted via :func:`fired_shard`)
    dist.worker_kill   a worker dies; its shard is gone for the REST of
                       the run (sticky — the coded orchestration in
                       ``parallel/coded.py`` remembers the kill)
    dist.exchange_torn the sharded-COO file exchange tears mid-publish
                       (`parallel/ingest.exchange_ratings_by_owner`)
    train.nan          the ALS sweep loop poisons the factor tables
                       with NaN after the targeted sweep (consulted via
                       :func:`fired` — the pio-tower convergence
                       watchdog must turn it into a typed abort)
    tenant.dispatch    the per-tenant serving path just before device
                       work (pio-hive; consulted via
                       :func:`check_tenant` — a ``tenant=app/variant``
                       option scopes the rule to ONE tenant, the
                       isolation-chaos selector)
    store.shard_down   one event-store shard is unreachable (pio-levee;
                       consulted via :func:`check_shard` with a
                       ``shard=I`` selector — writes to that shard get
                       a structured 503, scans stall only that cursor
                       component; other shards don't even count calls)
    wal.torn           the ingest WAL append tears mid-record (the
                       group-commit leader dies between write and
                       fsync; consulted via :func:`check_shard` —
                       ``shard=I`` scopes the tear to one shard's log;
                       replay on restart must drop exactly the torn
                       tail)

Plan grammar (``;``-separated rules, ``,``-separated options)::

    PIO_FAULT_PLAN="storage.write:nth=1,times=2,exc=operational"
    PIO_FAULT_PLAN="seed=7;http.feedback:prob=0.5;device.dispatch:delay=0.05"
    PIO_FAULT_PLAN="dist.shard_delay:shard=1,delay=0.2,times=1"

Options per rule:

* ``nth=N``   — first firing call (1-based, default 1)
* ``times=T`` — stop after T firings (default: unlimited)
* ``prob=P``  — fire each eligible call with probability P from a
  seeded per-point RNG (same plan + seed => same firing sequence)
* ``delay=S`` — sleep S seconds when firing (without ``exc``: a pure
  slowdown, the way to exercise deadlines)
* ``exc=NAME`` — exception to raise: ``fault`` (default,
  :class:`InjectedFault`), ``operational`` (sqlite3.OperationalError),
  ``oserror``, ``timeout``, ``urlerror``
* ``shard=I`` — the target shard of a ``dist.*`` rule (0-based mesh
  shard index, default 0); returned by :func:`fired_shard` so the
  distributed orchestration knows WHICH shard to degrade
* ``tenant=APP/VARIANT`` — scope the rule to one tenant's calls at a
  :func:`check_tenant` boundary (other tenants don't even count calls)

Two consultation styles:

* :func:`check` — raise-or-sleep, for I/O boundaries whose degradation
  is an exception path (the original six points; ``dist.exchange_torn``).
* :func:`fired_shard` — ask-and-degrade, for the distributed
  orchestration: counts the call, applies the rule's delay, and returns
  the target shard id instead of raising — the caller's job is to serve
  that shard from parity, not to unwind.
"""

from __future__ import annotations

import os
import random
import sqlite3
import threading
import time
import urllib.error
from typing import Optional

__all__ = ["InjectedFault", "FaultRule", "FaultPlan", "POINTS",
           "arm", "disarm", "armed", "check", "check_shard",
           "check_tenant", "fired", "fired_shard"]

POINTS = (
    "storage.write",
    "storage.read",
    "device.dispatch",
    "http.feedback",
    "http.remote_log",
    "reload.load_model",
    "dist.shard_delay",
    "dist.shard_drop",
    "dist.worker_kill",
    "dist.exchange_torn",
    "train.nan",
    "tenant.dispatch",
    "store.shard_down",
    "wal.torn",
)


class InjectedFault(RuntimeError):
    """The default exception a firing injection point raises."""


def _make_exc(name: str, msg: str) -> BaseException:
    if name == "fault":
        return InjectedFault(msg)
    if name == "operational":
        return sqlite3.OperationalError(msg)
    if name == "oserror":
        return OSError(msg)
    if name == "timeout":
        return TimeoutError(msg)
    if name == "urlerror":
        return urllib.error.URLError(msg)
    raise ValueError(f"unknown fault exception kind {name!r}")


class FaultRule:
    def __init__(self, point: str, nth: int = 1,
                 times: Optional[int] = None, prob: Optional[float] = None,
                 delay: Optional[float] = None, exc: Optional[str] = None,
                 seed: Optional[int] = None, shard: Optional[int] = None,
                 tenant: Optional[str] = None):
        if point not in POINTS:
            raise ValueError(
                f"unknown injection point {point!r}; known: {POINTS}"
            )
        if nth < 1:
            # nth is 1-based ("first firing call"); 0 would silently mean
            # the same as 1, and a negative value is always a typo
            raise ValueError(f"nth must be >= 1 (1-based), got {nth}")
        if times is not None and times < 1:
            raise ValueError(f"times must be >= 1, got {times}")
        if shard is not None and shard < 0:
            raise ValueError(f"shard must be >= 0, got {shard}")
        if exc is not None:
            _make_exc(exc, "probe")  # validate the name at parse time
        self.point = point
        self.nth = nth
        self.shard = shard
        # pio-hive: a `tenant=app/variant` rule fires only for that
        # tenant's calls (the per-tenant isolation chaos selector);
        # None matches every tenant
        self.tenant = tenant
        self.times = times
        self.prob = prob
        self.delay = delay
        # a pure-delay rule raises nothing; otherwise default InjectedFault
        self.exc = exc if exc is not None else (
            None if delay is not None else "fault"
        )
        # per-point RNG stream: a rule's firing sequence depends only on
        # its own call order, not on when OTHER points were checked
        self._rng = random.Random(f"{seed}:{point}")
        self.calls = 0
        self.fires = 0

    def hit(self) -> tuple[bool, Optional[BaseException]]:
        """Count one call; decide whether this call fires and what (if
        anything) to raise.  Caller holds the plan lock."""
        self.calls += 1
        if self.calls < self.nth:
            return False, None
        if self.times is not None and self.fires >= self.times:
            return False, None
        if self.prob is not None and self._rng.random() >= self.prob:
            return False, None
        self.fires += 1
        exc = None if self.exc is None else _make_exc(
            self.exc,
            f"injected fault at {self.point} (call {self.calls})",
        )
        return True, exc


class FaultPlan:
    """A set of rules, at most one per point, plus the firing log."""

    def __init__(self, rules: list[FaultRule]):
        seen: set[str] = set()
        for r in rules:
            if r.point in seen:
                # silently keeping the LAST rule (the old dict-build
                # behavior) made a mistyped two-rule plan test only half
                # of what the operator thought it armed
                raise ValueError(
                    f"duplicate rule for injection point {r.point!r}; "
                    "a plan holds at most one rule per point"
                )
            seen.add(r.point)
        self._rules = {r.point: r for r in rules}
        self._lock = threading.Lock()
        # (point, call_index) per firing — the observable sequence a
        # determinism test compares across identically-seeded runs
        self.log: list[tuple[str, int]] = []

    @classmethod
    def parse(cls, spec: str, seed: Optional[int] = None) -> "FaultPlan":
        rules = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if ":" not in part:
                if part in POINTS:
                    # a bare point name is a rule with defaults (fires
                    # every call with the point's default exception)
                    rules.append(FaultRule(part, seed=seed))
                    continue
                k, _, v = part.partition("=")
                if k.strip() != "seed":
                    raise ValueError(f"bad fault rule {part!r}")
                seed = int(v)
                continue
            point, _, opts = part.partition(":")
            kw: dict = {}
            for opt in opts.split(","):
                if not opt.strip():
                    continue
                k, _, v = opt.partition("=")
                k = k.strip()
                if k in ("nth", "times", "shard"):
                    kw[k] = int(v)
                elif k in ("prob", "delay"):
                    kw[k] = float(v)
                elif k == "exc":
                    kw[k] = v.strip()
                elif k == "seed":
                    kw[k] = int(v)
                elif k == "tenant":
                    kw[k] = v.strip()
                else:
                    raise ValueError(f"unknown fault option {k!r}")
            kw.setdefault("seed", seed)
            rules.append(FaultRule(point.strip(), **kw))
        return cls(rules)

    def hit(self, point: str, tenant: Optional[str] = None,
            shard: Optional[int] = None) -> None:
        rule = self._rules.get(point)
        if rule is None:
            return
        if rule.tenant is not None and tenant != rule.tenant:
            # a tenant-scoped rule is invisible to other tenants' calls
            # (not even counted: nth/times describe the TARGET tenant's
            # call sequence, which is what makes isolation plans
            # deterministic under interleaved multi-tenant traffic)
            return
        if rule.shard is not None and shard is not None \
                and shard != rule.shard:
            # same scoping for shard-addressed boundaries (pio-levee
            # ``store.shard_down`` / ``wal.torn``): a ``shard=I`` rule
            # only counts the TARGET shard's calls, so nth/times stay
            # deterministic while other shards' traffic interleaves
            return
        with self._lock:
            fired, exc = rule.hit()
            if fired:
                self.log.append((point, rule.calls))
        if not fired:
            return
        if rule.delay:
            time.sleep(rule.delay)  # outside the lock: other points flow
        if exc is not None:
            raise exc

    def hit_shard(self, point: str,
                  max_wait: Optional[float] = None
                  ) -> Optional[tuple[int, float]]:
        """Ask-and-degrade consultation: count one call; when the rule
        fires, return ``(target shard, injected lag)`` instead of
        raising.  The distributed caller degrades that shard (parity
        serve / frozen writes) rather than unwinding — a straggler is
        not an exception, it is a slower answer.

        ``max_wait`` caps how long this host actually SLEEPS waiting on
        the simulated straggler (the caller's hop budget); the returned
        lag is the rule's FULL delay, so the caller can tell "answered
        late but in budget" from "missed the budget — stop waiting and
        serve parity".  ``None`` waits the delay out in full."""
        rule = self._rules.get(point)
        if rule is None:
            return None
        with self._lock:
            fired, _ = rule.hit()
            if fired:
                self.log.append((point, rule.calls))
        if not fired:
            return None
        lag = rule.delay or 0.0
        wait = lag if max_wait is None else min(lag, max(max_wait, 0.0))
        if wait:
            time.sleep(wait)  # outside the lock: other points flow
        return (rule.shard if rule.shard is not None else 0), lag

    def counters(self) -> dict:
        with self._lock:
            return {
                p: {"calls": r.calls, "fires": r.fires}
                for p, r in self._rules.items()
            }


_plan: Optional[FaultPlan] = None


def arm(plan_or_spec, seed: Optional[int] = None) -> FaultPlan:
    """Activate a plan (replacing any armed one) and return it."""
    global _plan
    plan = (plan_or_spec if isinstance(plan_or_spec, FaultPlan)
            else FaultPlan.parse(plan_or_spec, seed=seed))
    _plan = plan
    return plan


def disarm() -> None:
    global _plan
    _plan = None


def armed() -> Optional[FaultPlan]:
    return _plan


def check(point: str) -> None:
    """The instrumented boundary.  No plan armed => one global load."""
    plan = _plan
    if plan is None:
        return
    plan.hit(point)


def fired_shard(point: str,
                max_wait: Optional[float] = None
                ) -> Optional[tuple[int, float]]:
    """Distributed instrumented boundary (``dist.shard_delay`` /
    ``dist.shard_drop`` / ``dist.worker_kill``): returns ``(shard id,
    injected lag)`` when the armed rule fires, else None.  The host
    sleeps at most ``max_wait`` of the lag (its hop budget) — see
    :meth:`FaultPlan.hit_shard`.  No plan armed => one global load."""
    plan = _plan
    if plan is None:
        return None
    return plan.hit_shard(point, max_wait=max_wait)


def check_shard(point: str, shard: int) -> None:
    """Shard-scoped instrumented boundary (``store.shard_down`` /
    ``wal.torn``): a rule carrying ``shard=I`` fires only for calls
    addressing that shard — how a chaos plan takes down ONE shard of
    the sharded event store while its siblings keep accepting.  A rule
    without the option behaves like :func:`check`.  No plan armed =>
    one global load."""
    plan = _plan
    if plan is None:
        return
    plan.hit(point, shard=shard)


def check_tenant(point: str, tenant: str) -> None:
    """Tenant-scoped instrumented boundary (``tenant.dispatch``): a
    rule carrying ``tenant=app/variant`` fires only for that tenant's
    calls — how a chaos plan opens ONE tenant's breaker while its
    neighbors keep serving.  A rule without the option behaves like
    :func:`check`.  No plan armed => one global load."""
    plan = _plan
    if plan is None:
        return
    plan.hit(point, tenant=tenant)


def fired(point: str) -> bool:
    """Ask-style boolean consultation for points whose degradation is
    an in-band state change rather than an exception or a shard id
    (``train.nan``: the sweep loop poisons its own factors when the
    rule fires).  Counts the call and applies any rule delay; no plan
    armed => one global load."""
    plan = _plan
    if plan is None:
        return False
    return plan.hit_shard(point) is not None


# operator workflow: arm from the environment at import, so any entry
# point (CLI deploy/eventserver, a test subprocess) picks the plan up
# without code changes
_env_spec = os.environ.get("PIO_FAULT_PLAN")
if _env_spec:
    arm(_env_spec)
del _env_spec
