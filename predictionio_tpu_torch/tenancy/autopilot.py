"""pio-pilot autopilot: experiments that conclude themselves.

Port of ``predictionio_tpu/tenancy/autopilot.py``.  The online eval
keeps a per-(app, variant) conversion table fresh (``online_eval.py``);
this module closes the loop:

* **SPRT**: Wald's sequential probability-ratio test over the Bernoulli
  conversion stream.  Each tick recomputes the log-likelihood-ratio walk
  of the provisional leader against a plug-in null (the best
  challenger's observed rate, Laplace-smoothed) and that rate lifted by
  ``min_lift``, against the ``log((1-beta)/alpha)`` /
  ``log(beta/(1-alpha))`` thresholds.  A ``min_samples`` floor on both
  variants gates the walk.
* **Guardrail**: a variant whose tenant breaker is not closed, or whose
  serving error ratio crosses ``error_ratio``, is vetoed from leadership
  and ramped down; a ``pio_slo_burn_rate`` window past
  ``burn_threshold`` freezes all ramping.
* **Bounded ramp**: traffic moves toward the winner at most
  ``max_step`` weight a tick and every loser keeps ``min_weight``.
  Weights land through an injectable ``apply_weights`` callable
  (in-process ``registry.set_weights`` by default, a real ``POST
  /tenants/weights`` when the caller wires one).

Every decision (ramp / veto / conclude / hold) is a run-manifest event
(``kind="autopilot"``) and shows at ``GET /debug/experiments``.
"""

from __future__ import annotations

import logging
import math
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Callable, Optional

from ..obs import (
    BREAKER_STATE_VALUES,
    EXPERIMENT_DECISIONS_TOTAL,
    EXPERIMENT_LLR,
    EXPERIMENT_STATE,
    TENANT_QUERIES_TOTAL,
)

__all__ = [
    "AutoPilot",
    "AutopilotConfig",
    "SprtResult",
    "autopilot_payload",
    "set_autopilot",
    "sprt_llr",
    "sprt_test",
    "step_weights",
]

logger = logging.getLogger(__name__)

# EXPERIMENT_STATE gauge encoding
STATE_COLLECTING = 0.0
STATE_RAMPING = 1.0
STATE_CONCLUDED = 2.0
STATE_FROZEN = 3.0

_EPS = 1e-9
_P_CLAMP = 1e-6


@dataclass(frozen=True)
class AutopilotConfig:
    # SPRT error bounds: alpha = P(accept lift | none), beta = P(miss
    # a real lift)
    alpha: float = 0.05
    beta: float = 0.20
    # the lift worth detecting: H1 puts the leader at
    # challenger_rate * (1 + min_lift)
    min_lift: float = 0.20
    # both leader and challenger need this many impressions before the
    # walk can conclude anything
    min_samples: int = 200
    # ramp bounds: at most max_step weight moves per tick, and every
    # variant keeps min_weight (the loser is ramped down, never zeroed)
    max_step: float = 0.10
    min_weight: float = 0.05
    # guardrails: freeze all ramping when any pio_slo_burn_rate window
    # exceeds burn_threshold; veto a variant whose error ratio (over
    # its tenant-serving outcomes) crosses error_ratio with at least
    # min_errors failures, or whose breaker is not closed
    burn_threshold: float = 1.0
    error_ratio: float = 0.5
    min_errors: int = 5

    def __post_init__(self) -> None:
        if not 0 < self.alpha < 1 or not 0 < self.beta < 1:
            raise ValueError("alpha/beta must be in (0, 1)")
        if self.min_lift <= 0:
            raise ValueError("minLift must be > 0")
        if not 0 < self.max_step <= 1:
            raise ValueError("maxStep must be in (0, 1]")
        if not 0 <= self.min_weight < 0.5:
            raise ValueError("minWeight must be in [0, 0.5)")

    @classmethod
    def from_doc(cls, doc: dict) -> "AutopilotConfig":
        """Manifest/JSON knobs (camelCase, all optional)."""
        aliases = {
            "alpha": "alpha", "beta": "beta", "minLift": "min_lift",
            "minSamples": "min_samples", "maxStep": "max_step",
            "minWeight": "min_weight",
            "burnThreshold": "burn_threshold",
            "errorRatio": "error_ratio", "minErrors": "min_errors",
        }
        kw = {}
        for k, v in (doc or {}).items():
            field = aliases.get(k, k)
            if field in cls.__dataclass_fields__:
                kw[field] = type(cls.__dataclass_fields__[field].default)(v)
        return cls(**kw)


# -- SPRT core (pure math, directly unit-testable) --------------------------


def sprt_llr(n: int, c: int, p0: float, p1: float) -> float:
    """Wald log-likelihood ratio after ``n`` Bernoulli trials with
    ``c`` successes, H1: p = p1 vs H0: p = p0."""
    p0 = min(max(p0, _P_CLAMP), 1.0 - _P_CLAMP)
    p1 = min(max(p1, _P_CLAMP), 1.0 - _P_CLAMP)
    return (c * math.log(p1 / p0)
            + (n - c) * math.log((1.0 - p1) / (1.0 - p0)))


@dataclass(frozen=True)
class SprtResult:
    decision: str  # "accept_h1" | "accept_h0" | "continue"
    llr: float
    upper: float
    lower: float


def sprt_test(n: int, c: int, p0: float, p1: float,
              alpha: float = 0.05, beta: float = 0.20) -> SprtResult:
    """One SPRT verdict from cumulative counts.  The walk is
    recomputed closed-form every tick (the plug-in null may move as
    the challenger's rate converges), which keeps the controller
    stateless across restarts."""
    upper = math.log((1.0 - beta) / alpha)
    lower = math.log(beta / (1.0 - alpha))
    llr = sprt_llr(n, c, p0, p1)
    if llr >= upper:
        decision = "accept_h1"
    elif llr <= lower:
        decision = "accept_h0"
    else:
        decision = "continue"
    return SprtResult(decision=decision, llr=llr, upper=upper,
                      lower=lower)


def step_weights(weights: dict[str, float], toward: str,
                 max_step: float, min_weight: float,
                 only_from: Optional[set[str]] = None
                 ) -> dict[str, float]:
    """One bounded ramp step: move at most ``max_step`` of the
    (normalized) traffic mass toward ``toward``, taken proportionally
    from the other variants' headroom above ``min_weight`` (or only
    from ``only_from`` when set — the veto ramp-down).  Total mass is
    preserved, no variant drops below ``min_weight``, and when nothing
    can move the input comes back unchanged (the minimal-move
    contract: only |w - w'| traffic re-assigns, per Experiment's
    sticky-interval layout)."""
    total = sum(weights.values())
    if toward not in weights or total <= 0:
        return dict(weights)
    norm = {k: v / total for k, v in weights.items()}
    donors = {
        k: max(norm[k] - min_weight, 0.0)
        for k in norm
        if k != toward and (only_from is None or k in only_from)
    }
    headroom = sum(donors.values())
    take = min(max_step, headroom)
    if take <= _EPS:
        return dict(weights)
    out = dict(norm)
    for k, h in donors.items():
        out[k] -= take * (h / headroom)
    out[toward] += take
    return {k: round(v, 9) for k, v in out.items()}


# -- the controller ----------------------------------------------------------


class AutoPilot:
    """Per-app experiment controller over a :class:`TenantRegistry`.

    ``tick()`` is driven by the serving edge's online-eval loop (or a
    test/smoke harness); it reads the registry's online-eval table and
    live experiment weights, runs guardrails + SPRT, and applies at
    most one bounded weight step per app via ``apply_weights``.
    """

    def __init__(self, registry, config: Optional[AutopilotConfig] = None,
                 apply_weights: Optional[Callable[[str, dict], object]] = None,
                 manifest_id: Optional[str] = None,
                 burn_rate_fn: Optional[Callable[[], float]] = None):
        self.registry = registry
        self.config = config or AutopilotConfig()
        self._apply = apply_weights or (
            lambda app, weights: registry.set_weights(app, weights)
        )
        self.manifest_id = (
            manifest_id or f"pilot-{uuid.uuid4().hex[:8]}"
        )
        self._manifest = None
        self._burn_rate_fn = burn_rate_fn or self._max_burn_rate
        self._lock = threading.Lock()
        # app -> {"state": float, "last": dict, "decisions": [..tail]}
        self._apps: dict[str, dict] = {}
        self.ticks = 0

    # -- guardrail inputs --------------------------------------------------
    @staticmethod
    def _max_burn_rate() -> float:
        """Worst window of the fleet's pio_slo_burn_rate gauges (0.0
        when the SLO tracker isn't installed)."""
        try:
            from ..obs.fleet import SLO_BURN_RATE

            worst = 0.0
            for _labels, child in SLO_BURN_RATE.children():
                v = child.value()
                if not math.isnan(v):
                    worst = max(worst, v)
            return worst
        except Exception:
            return 0.0

    def _breaker_state(self, app: str, variant: str) -> str:
        try:
            rt = self.registry._runtimes.get((app, variant))
        except AttributeError:
            rt = None
        if rt is None:
            return "closed"
        return rt.breaker.state

    def _error_counts(self, app: str, variant: str) -> tuple[float, float]:
        """(failures, total) from the per-tenant serving outcome
        counters — the client-visible evidence a variant is broken."""
        total = 0.0
        failures = 0.0
        for labels, child in TENANT_QUERIES_TOTAL.children():
            kv = dict(labels)
            if kv.get("app") != app or kv.get("variant") != variant:
                continue
            v = child.value()
            total += v
            if kv.get("status") in ("error", "timeout", "rejected"):
                failures += v
        return failures, total

    def _veto_reason(self, app: str, variant: str) -> Optional[str]:
        breaker = self._breaker_state(app, variant)
        if BREAKER_STATE_VALUES.get(breaker, 0.0) > 0.0:
            return f"breaker_{breaker.replace('-', '_')}"
        failures, total = self._error_counts(app, variant)
        if (failures >= self.config.min_errors and total > 0
                and failures / total >= self.config.error_ratio):
            return "error_ratio"
        return None

    # -- one controller pass ----------------------------------------------
    def tick(self) -> dict:
        """Run guardrails + SPRT + at most one ramp step per app;
        returns :meth:`payload`.  Never raises — a broken tick must
        not take down the serving loop that drives it."""
        try:
            snap = self.registry.online.snapshot()
            apps = self.registry.apps()
        except Exception:
            logger.exception("autopilot tick: registry unavailable")
            return self.payload()
        burn = self._burn_rate_fn()
        for app in apps:
            try:
                self._tick_app(app, snap, burn)
            except Exception:
                logger.exception("autopilot tick failed for app %s", app)
        with self._lock:
            self.ticks += 1
        return self.payload()

    def _tick_app(self, app: str, snap: dict, burn: float) -> None:
        cfg = self.config
        try:
            weights = self.registry.experiment(app).weights()
        except Exception:
            return
        if len(weights) < 2:
            return
        stats = {}
        for variant in weights:
            cell = snap.get(f"{app}/{variant}", {})
            stats[variant] = {
                "impressions": int(cell.get("impressions", 0)),
                "conversions": int(cell.get("conversions", 0)),
                "rate": float(cell.get("rate", 0.0)),
            }
        vetoes = {
            v: reason for v in sorted(weights)
            if (reason := self._veto_reason(app, v)) is not None
        }

        frozen = burn > cfg.burn_threshold
        if frozen:
            self._decide(
                app, "hold", state=STATE_FROZEN, stats=stats,
                weights=weights, vetoes=vetoes, burn=burn,
                reason="burn_rate",
            )
            return

        eligible = [v for v in sorted(weights) if v not in vetoes]
        new_weights = None
        # a vetoed variant holding traffic is ramped down first —
        # safety moves outrank significance moves
        if vetoes and eligible:
            total = sum(weights.values()) or 1.0
            over = {
                v: weights[v] / total - cfg.min_weight
                for v in vetoes
            }
            if max(over.values()) > 1e-6:
                target = max(
                    eligible,
                    key=lambda v: (stats[v]["rate"], v),
                )
                new_weights = step_weights(
                    weights, target, cfg.max_step, cfg.min_weight,
                    only_from=set(vetoes),
                )
                self._apply_weights(app, new_weights)
                self._decide(
                    app, "veto", state=STATE_RAMPING, stats=stats,
                    weights=new_weights, vetoes=vetoes, burn=burn,
                    reason=";".join(
                        f"{v}:{r}" for v, r in sorted(vetoes.items())
                    ),
                    target=target,
                )
                return

        if len(eligible) < 2:
            self._decide(
                app, "hold", state=STATE_COLLECTING, stats=stats,
                weights=weights, vetoes=vetoes, burn=burn,
                reason="single_variant" if vetoes else "no_variants",
            )
            return

        ranked = sorted(
            eligible, key=lambda v: (stats[v]["rate"], v), reverse=True,
        )
        leader, challenger = ranked[0], ranked[1]
        ln, lc = (stats[leader]["impressions"],
                  stats[leader]["conversions"])
        cn, cc = (stats[challenger]["impressions"],
                  stats[challenger]["conversions"])
        if min(ln, cn) < cfg.min_samples:
            self._decide(
                app, "hold", state=STATE_COLLECTING, stats=stats,
                weights=weights, vetoes=vetoes, burn=burn,
                reason="min_samples", leader=leader,
                challenger=challenger,
            )
            return

        # plug-in null: the challenger's Laplace-smoothed rate; H1
        # lifts it by min_lift
        p0 = (cc + 1.0) / (cn + 2.0)
        p1 = min(p0 * (1.0 + cfg.min_lift), 1.0 - _P_CLAMP)
        res = sprt_test(ln, lc, p0, p1, alpha=cfg.alpha, beta=cfg.beta)
        EXPERIMENT_LLR.labels(app=app, variant=leader).set(res.llr)

        if res.decision == "accept_h1":
            new_weights = step_weights(
                weights, leader, cfg.max_step, cfg.min_weight,
            )
            moved = any(
                abs(new_weights[v]
                    - weights[v] / (sum(weights.values()) or 1.0))
                > 1e-6
                for v in weights
            )
            if moved:
                self._apply_weights(app, new_weights)
                self._decide(
                    app, "ramp", state=STATE_RAMPING, stats=stats,
                    weights=new_weights, vetoes=vetoes, burn=burn,
                    leader=leader, challenger=challenger, sprt=res,
                )
            else:
                # the winner already holds every ramp-able point —
                # the experiment has concluded itself
                self._decide(
                    app, "conclude", state=STATE_CONCLUDED,
                    stats=stats, weights=weights, vetoes=vetoes,
                    burn=burn, leader=leader, challenger=challenger,
                    sprt=res,
                )
        elif res.decision == "accept_h0":
            self._decide(
                app, "hold", state=STATE_COLLECTING, stats=stats,
                weights=weights, vetoes=vetoes, burn=burn,
                reason="no_lift", leader=leader,
                challenger=challenger, sprt=res,
            )
        else:
            self._decide(
                app, "hold", state=STATE_COLLECTING, stats=stats,
                weights=weights, vetoes=vetoes, burn=burn,
                reason="collecting", leader=leader,
                challenger=challenger, sprt=res,
            )

    def _apply_weights(self, app: str, weights: dict) -> None:
        try:
            self._apply(app, weights)
        except Exception:
            logger.exception(
                "autopilot weight update failed for app %s", app
            )

    # -- bookkeeping -------------------------------------------------------
    def _decide(self, app: str, decision: str, *, state: float,
                stats: dict, weights: dict, vetoes: dict, burn: float,
                reason: Optional[str] = None,
                leader: Optional[str] = None,
                challenger: Optional[str] = None,
                target: Optional[str] = None,
                sprt: Optional[SprtResult] = None) -> None:
        EXPERIMENT_DECISIONS_TOTAL.labels(app=app, decision=decision).inc()
        EXPERIMENT_STATE.labels(app=app).set(state)
        record = {
            "at": time.time(),
            "decision": decision,
            "state": state,
            "reason": reason,
            "leader": leader,
            "challenger": challenger,
            "target": target,
            "weights": dict(weights),
            "vetoes": dict(vetoes),
            "burnRate": round(burn, 6),
            "stats": stats,
        }
        if sprt is not None:
            record["llr"] = round(sprt.llr, 6)
            record["upper"] = round(sprt.upper, 6)
            record["lower"] = round(sprt.lower, 6)
        with self._lock:
            cell = self._apps.setdefault(
                app, {"state": STATE_COLLECTING, "decisions": []}
            )
            # a concluded experiment stays concluded (the gauge keeps
            # reporting 2 even while holds keep streaming)
            if cell["state"] != STATE_CONCLUDED or decision in (
                "ramp", "conclude", "veto",
            ):
                cell["state"] = state
            cell["last"] = record
            cell["decisions"].append(record)
            del cell["decisions"][:-50]
            sticky_state = cell["state"]
        if sticky_state == STATE_CONCLUDED:
            EXPERIMENT_STATE.labels(app=app).set(STATE_CONCLUDED)
        manifest = self._ensure_manifest()
        if manifest is not None:
            manifest.event(
                "decision", app=app,
                **{k: v for k, v in record.items() if k != "at"},
            )

    def _ensure_manifest(self):
        if self._manifest is None:
            try:
                from ..obs.runlog import RunManifest

                self._manifest = RunManifest(
                    self.manifest_id, kind="autopilot",
                    meta={
                        "alpha": self.config.alpha,
                        "beta": self.config.beta,
                        "minLift": self.config.min_lift,
                        "minSamples": self.config.min_samples,
                        "maxStep": self.config.max_step,
                        "minWeight": self.config.min_weight,
                        "startedAt": time.time(),
                    },
                )
            except Exception:
                logger.exception("autopilot manifest unavailable")
                return None
        return self._manifest

    def payload(self) -> dict:
        """The ``GET /debug/experiments`` document."""
        with self._lock:
            apps = {
                app: {
                    "state": cell["state"],
                    "stateName": _state_name(cell["state"]),
                    "last": cell.get("last"),
                    "decisions": list(cell["decisions"][-10:]),
                }
                for app, cell in sorted(self._apps.items())
            }
            ticks = self.ticks
        try:
            weights = {
                app: self.registry.experiment(app).weights()
                for app in self.registry.apps()
            }
        except Exception:
            weights = {}
        return {
            "enabled": True,
            "manifestId": self.manifest_id,
            "ticks": ticks,
            "config": {
                "alpha": self.config.alpha,
                "beta": self.config.beta,
                "minLift": self.config.min_lift,
                "minSamples": self.config.min_samples,
                "maxStep": self.config.max_step,
                "minWeight": self.config.min_weight,
                "burnThreshold": self.config.burn_threshold,
            },
            "weights": weights,
            "apps": apps,
        }

    def close(self) -> None:
        m = self._manifest
        if m is not None:
            with self._lock:
                ticks = self.ticks
            m.finalize("completed", ticks=ticks)


def _state_name(state: float) -> str:
    return {
        STATE_COLLECTING: "collecting",
        STATE_RAMPING: "ramping",
        STATE_CONCLUDED: "concluded",
        STATE_FROZEN: "frozen",
    }.get(state, "unknown")


# -- module-level hook (the fleet_payload pattern): the serving edge
# reads whichever autopilot this process installed ----------------------

_current: Optional[AutoPilot] = None


def set_autopilot(pilot: Optional[AutoPilot]) -> None:
    global _current
    _current = pilot


def autopilot_payload() -> Optional[dict]:
    pilot = _current
    if pilot is None:
        return None
    try:
        return pilot.payload()
    except Exception:
        logger.exception("autopilot payload failed")
        return None
