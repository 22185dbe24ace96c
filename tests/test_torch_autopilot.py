"""The port's autopilot against the JAX package's, on the CPU.

``sprt_llr``, ``sprt_test`` and ``step_weights`` on the same seeded
inputs agree within 1e-12 (the decisions exactly), and ``AutopilotConfig``
refuses the same knobs.  Then one script of 20 online-eval snapshots
(two apps, one with three variants; a breaker that opens, a variant
whose serving errors pass the error ratio, a burn-rate window past its
threshold) goes through both packages' ``AutoPilot`` on stub registries:
every tick's decisions, states, weights and manifest events are equal,
apart from their timestamps.

Both packages' ``pio_slo_burn_rate`` gauges are cleared for each test
and restored after it: a burn-rate tracker another test installed on
the same worker would otherwise freeze the controller.
"""

import json
import math
import uuid

import numpy as np
import pytest

from predictionio_tpu.obs import (
    TENANT_QUERIES_TOTAL as JAX_TENANT_QUERIES_TOTAL,
)
from predictionio_tpu.obs import fleet as jax_fleet
from predictionio_tpu.obs.runlog import read_manifest as jax_read_manifest
from predictionio_tpu.tenancy import autopilot as jax_autopilot
from predictionio_tpu_torch.obs import TENANT_QUERIES_TOTAL, fleet
from predictionio_tpu_torch.obs.runlog import read_manifest
from predictionio_tpu_torch.tenancy import autopilot

PACKAGES = {"jax": jax_autopilot, "port": autopilot}
BURN = {"jax": jax_fleet.SLO_BURN_RATE, "port": fleet.SLO_BURN_RATE}
QUERIES = {"jax": JAX_TENANT_QUERIES_TOTAL, "port": TENANT_QUERIES_TOTAL}


@pytest.fixture(autouse=True)
def cleared_burn_rates():
    saved = []
    for fam in BURN.values():
        for _, child in fam.children():
            saved.append((child, child._fn, child._value))
            child.set_function(None)
            child.set(0.0)
    yield
    for child, fn, value in saved:
        child.set_function(fn)
        child.set(value)


def test_sprt_and_ramp_math_equal():
    rng = np.random.default_rng(0)
    for _ in range(2000):
        n = int(rng.integers(0, 5000))
        c = int(rng.integers(0, n + 1))
        p0, p1 = rng.uniform(-0.1, 1.1, 2)
        alpha, beta = rng.uniform(0.01, 0.4, 2)
        got = autopilot.sprt_llr(n, c, p0, p1)
        want = jax_autopilot.sprt_llr(n, c, p0, p1)
        assert math.isclose(got, want, rel_tol=1e-12, abs_tol=1e-12)
        g = autopilot.sprt_test(n, c, p0, p1, alpha=alpha, beta=beta)
        w = jax_autopilot.sprt_test(n, c, p0, p1, alpha=alpha, beta=beta)
        assert g.decision == w.decision
        for f in ("llr", "upper", "lower"):
            assert math.isclose(getattr(g, f), getattr(w, f),
                                rel_tol=1e-12, abs_tol=1e-12)
    for _ in range(2000):
        k = int(rng.integers(1, 5))
        names = [f"v{j}" for j in range(k)]
        weights = dict(zip(names, rng.uniform(0, 1, k).round(3).tolist()))
        toward = str(rng.choice(names + ["ghost"]))
        only = (None if rng.random() < 0.5
                else set(rng.choice(names, int(rng.integers(1, k + 1)),
                                    replace=False).tolist()))
        step, floor = float(rng.uniform(0.01, 1.0)), float(
            rng.uniform(0, 0.49))
        got = autopilot.step_weights(weights, toward, step, floor, only)
        want = jax_autopilot.step_weights(weights, toward, step, floor, only)
        assert got.keys() == want.keys()
        for v in got:
            assert abs(got[v] - want[v]) <= 1e-12


@pytest.mark.parametrize("knobs", [
    {}, {"alpha": 0.0}, {"beta": 1.0}, {"minLift": 0}, {"maxStep": 1.5},
    {"minWeight": 0.5}, {"minSamples": "40", "maxStep": 0.2, "junk": 1},
])
def test_config_from_doc_equal(knobs):
    def make(mod):
        try:
            return vars(mod.AutopilotConfig.from_doc(knobs))
        except ValueError as e:
            return str(e)

    assert make(autopilot) == make(jax_autopilot)


class _Breaker:
    state = "closed"


class _Runtime:
    def __init__(self):
        self.breaker = _Breaker()


class _Experiment:
    def __init__(self, weights):
        self.w = dict(weights)

    def weights(self):
        return dict(self.w)


class _Online:
    def __init__(self):
        self.snap = {}

    def snapshot(self):
        return dict(self.snap)


class StubRegistry:
    """What ``AutoPilot`` reads of a ``TenantRegistry``: the online-eval
    snapshot, the apps and their weights, the runtimes' breakers; and
    ``set_weights``, which the controller's default apply calls."""

    def __init__(self, experiments: dict):
        self.online = _Online()
        self._exps = {a: _Experiment(w) for a, w in experiments.items()}
        self._runtimes = {(a, v): _Runtime() for a, w in experiments.items()
                          for v in w}

    def apps(self):
        return sorted(self._exps)

    def experiment(self, app):
        return self._exps[app]

    def set_weights(self, app, weights):
        self._exps[app].w.update({k: float(v) for k, v in weights.items()})
        return {"weights": self._exps[app].weights()}


def _script(app_err: str, seed: int = 1) -> list:
    """20 ticks: per tick the cumulative online-eval table, the breaker
    states, serving outcomes to book and a burn rate."""
    rng = np.random.default_rng(seed)
    rates = {("shop", "control"): 0.05, ("shop", "treatment"): 0.14,
             (app_err, "a"): 0.10, (app_err, "b"): 0.08,
             (app_err, "c"): 0.20}
    cum = {k: [0, 0] for k in rates}
    ticks = []
    for t in range(20):
        for k, r in rates.items():
            n = int(rng.integers(20, 60))
            cum[k][0] += n
            cum[k][1] += int(rng.binomial(n, r))
        snap = {f"{a}/{v}": {
            "impressions": i, "conversions": c,
            "rate": round(c / i, 6) if i else 0.0}
            for (a, v), (i, c) in cum.items()}
        ticks.append({
            "snap": snap,
            "open": {("shop", "treatment")} if t in (6, 7) else set(),
            "errors": 4 if t in (11, 12) else 0,
            "burn": 2.5 if t == 9 else 0.0,
        })
    return ticks


def _strip(doc):
    """A payload or decision record without its timestamps."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items()
                if k not in ("at", "manifestId")}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def test_the_same_snapshots_give_the_same_decisions(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_RUNLOG_DIR", str(tmp_path / "runs"))
    # an app name of its own: the error counters are process-wide
    app_err = f"blaze-{uuid.uuid4().hex[:8]}"
    experiments = {"shop": {"control": 0.5, "treatment": 0.5},
                   app_err: {"a": 1.0, "b": 1.0, "c": 1.0}}
    regs = {n: StubRegistry(experiments) for n in PACKAGES}
    cfg = dict(min_samples=150, max_step=0.1, min_weight=0.05,
               min_lift=0.2, min_errors=5, error_ratio=0.5)
    pilots = {n: mod.AutoPilot(regs[n], mod.AutopilotConfig(**cfg),
                               manifest_id=f"pilot-{n}")
              for n, mod in PACKAGES.items()}
    trail = []
    try:
        for tick in _script(app_err):
            got = {}
            for n, pilot in pilots.items():
                reg = regs[n]
                reg.online.snap = tick["snap"]
                for key, rt in reg._runtimes.items():
                    rt.breaker.state = ("open" if key in tick["open"]
                                        else "closed")
                fam = QUERIES[n]
                fam.labels(app=app_err, variant="c", status="ok").inc(2)
                if tick["errors"]:
                    fam.labels(app=app_err, variant="c",
                               status="error").inc(tick["errors"])
                BURN[n].labels(window="5m").set(tick["burn"])
                got[n] = _strip(pilot.tick())
            assert got["port"] == got["jax"]
            trail.append(got["port"])
    finally:
        for pilot in pilots.values():
            pilot.close()
    last = [a["last"] for t in trail for a in t["apps"].values()]
    # the script reaches every kind of decision and the freeze
    assert {"hold", "ramp", "veto"} <= {d["decision"] for d in last}
    assert {"burn_rate", "min_samples"} <= {d["reason"] for d in last}
    views = {"jax": jax_read_manifest(tmp_path / "runs" / "pilot-jax"),
             "port": read_manifest(tmp_path / "runs" / "pilot-port")}
    assert _strip(views["port"]["events"]) == _strip(views["jax"]["events"])
    # one manifest event a decision, 20 ticks of 2 apps
    assert len(views["port"]["events"]) == 40
    assert json.dumps(regs["port"]._exps["shop"].w, sort_keys=True) == (
        json.dumps(regs["jax"]._exps["shop"].w, sort_keys=True))


def test_installed_autopilot_payload_equal(tmp_path, monkeypatch):
    """``set_autopilot`` / ``autopilot_payload``: nothing installed is
    None in both; an installed controller's payload is its own."""
    monkeypatch.setenv("PIO_TPU_RUNLOG_DIR", str(tmp_path / "runs"))
    for mod in PACKAGES.values():
        mod.set_autopilot(None)
    assert autopilot.autopilot_payload() is None
    assert jax_autopilot.autopilot_payload() is None
    got = {}
    for n, mod in PACKAGES.items():
        pilot = mod.AutoPilot(StubRegistry({"shop": {"a": 1.0, "b": 3.0}}))
        mod.set_autopilot(pilot)
        try:
            got[n] = _strip(mod.autopilot_payload())
        finally:
            mod.set_autopilot(None)
            pilot.close()
    assert got["port"] == got["jax"]
    assert got["port"]["weights"] == {"shop": {"a": 1.0, "b": 3.0}}
