"""The port's training observability against the JAX package's, on the
CPU: phase spans, the pio-tower watchdog and run manifests, ``train.nan``
and the console's observability options.

From the same ratings and the same initial factors (the JAX trainer's,
carried across), both trainers under ``PIO_TPU_TRACE_ALS=1`` record the
same spans and phase observations, and still land on the same factors
(the probes write nothing).  Under ``train.nan:nth=2`` both abort on
sweep 2 with ``nan_factors``.  The consoles take the same observability
options with the same output.  Every test restores the process-wide
state it touches (tracer journal, flight capacity, sampler period,
profiler switch, burn-rate gauges, fault plan).
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import predictionio_tpu.obs as jax_obs
import predictionio_tpu_torch.obs as port_obs
from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.obs import runlog as jax_runlog
from predictionio_tpu.obs import tower as jax_tower
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch.cli.main import main
from predictionio_tpu_torch.convert import factors_from_jax
from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
from predictionio_tpu_torch.obs import runlog as port_runlog
from predictionio_tpu_torch.obs import tower as port_tower
from predictionio_tpu_torch.resilience import faults as port_faults
from test_torch_cli import Pair, pair  # noqa: F401
from test_torch_cli_engine import _engine_json, _rated_app, _wait_port

PACKAGES = {
    "port": (port_obs, port_tower, port_faults, ALSTrainer, ALSConfig),
    "jax": (jax_obs, jax_tower, jax_faults, JaxALSTrainer, JaxALSConfig),
}


@pytest.fixture(autouse=True)
def _obs_state():
    """Restore what these tests (and the consoles' options) change."""
    saved = [(obs, obs.get_flight_recorder()._capacity,
              obs.xray._STATE.sampler_state()[1]) for obs in (port_obs,
                                                              jax_obs)]
    yield
    for obs, capacity, period in saved:
        obs.get_tracer().configure(None)
        obs.set_metrics_enabled(True)
        obs.get_flight_recorder().set_capacity(capacity)
        obs.xray.set_sample_period(period)
        obs.scope.set_enabled(True)
        for _, child in obs.fleet.SLO_BURN_RATE.children():
            child.set_function(None)
            child.set(0.0)
        obs.fleet.SLO_TARGET_SECONDS.child().set(0.0)
    port_faults.disarm()
    jax_faults.disarm()


def _toy(n_users=30, n_items=20, seed=6):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 3))
    V = rng.normal(size=(n_items, 3))
    u, i = np.nonzero(rng.random((n_users, n_items)) < 0.4)
    v = (U @ V.T)[u, i].astype(np.float32)
    return u.astype(np.int32), i.astype(np.int32), v, n_users, n_items


def _phase_counts(obs) -> dict:
    fam = next(f for f in obs.get_registry().dump_state()["families"]
               if f["name"] == "pio_train_phase_seconds")
    return {c["labels"][0][1]: c["hist"]["count"] for c in fam["children"]}


@pytest.mark.parametrize("solver", ["pallas", "fused"])
def test_traced_halves_emit_the_references_spans(solver, monkeypatch):
    monkeypatch.setenv("PIO_TPU_TRACE_ALS", "1")
    u, i, v, nu, ni = _toy()
    kw = dict(rank=4, num_iterations=2, lam=0.1, solver=solver)
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw))
    U0, V0 = (np.asarray(a) for a in ref.init_factors())
    got = {}
    for name, (obs, _, _, trainer_cls, cfg_cls) in PACKAGES.items():
        tr = (ref if name == "jax" else
              trainer_cls((u, i, v), nu, ni, cfg_cls(**kw), device="cpu"))
        start = factors_from_jax(U0, V0, "cpu") if name == "port" else (
            U0, V0)
        obs.get_tracer().clear()
        before = _phase_counts(obs)
        U, V = tr.run(*start, 2)
        spans = [(s.name, s.attrs["side"], s.attrs["iteration"])
                 for s in obs.get_tracer().spans()
                 if s.name.startswith("als.")]
        after = _phase_counts(obs)
        delta = {k: n - before.get(k, 0) for k, n in after.items()
                 if n != before.get(k, 0)}
        got[name] = (sorted(spans), delta, np.asarray(U), np.asarray(V))
    assert got["port"][:2] == got["jax"][:2]
    assert len(got["port"][0]) == 2 * 2 * 3
    for k in (2, 3):
        np.testing.assert_allclose(got["port"][k], got["jax"][k],
                                   rtol=1e-4, atol=1e-4)


def test_train_nan_aborts_both_on_the_same_sweep(tmp_path):
    u, i, v, nu, ni = _toy(seed=7)
    kw = dict(rank=4, num_iterations=4, lam=0.1)
    got = {}
    for name, (obs, tower, faults, trainer_cls, cfg_cls) in PACKAGES.items():
        aborts = obs.get_registry().dump_state()
        tr = trainer_cls((u, i, v), nu, ni, cfg_cls(**kw),
                         **({"device": "cpu"} if name == "port" else {}))
        session = tower.TowerSession(f"nan-{name}", kind="train",
                                     manifest_root=tmp_path).start()
        faults.arm("train.nan:nth=2,times=1")
        with pytest.raises(tower.ConvergenceError) as ei:
            tr.run(*tr.init_factors(), 4)
        faults.disarm()
        view = port_runlog.read_manifest(session.manifest.path)
        final = view["final"]
        booked = [c for f in obs.get_registry().dump_state()["families"]
                  if f["name"] == "pio_train_aborts_total"
                  for c in f["children"]]
        before = [c for f in aborts["families"]
                  if f["name"] == "pio_train_aborts_total"
                  for c in f["children"]]
        n_before = sum(c["value"] for c in before
                       if c["labels"] == [["reason", "nan_factors"]])
        n_after = sum(c["value"] for c in booked
                      if c["labels"] == [["reason", "nan_factors"]])
        got[name] = (ei.value.reason, str(ei.value), final["status"],
                     final["sweeps"], len(view["sweeps"]), n_after - n_before)
    assert got["port"] == got["jax"]
    assert got["port"][0] == "nan_factors" and got["port"][2:] == (
        "aborted", 2, 2, 1)


def test_each_trainer_opens_its_own_watchdog_window(tmp_path):
    """The tower's loss window starts afresh with every trainer, also
    where a new trainer gets a freed one's ``id`` (the trainers of an
    eval's folds: the last fold's low final losses before the next
    fold's early ones read as a divergence, and aborted the eval)."""
    u, i, v, nu, ni = _toy(seed=7)
    cfg = ALSConfig(rank=4, num_iterations=2, lam=0.1)
    first = ALSTrainer((u, i, v), nu, ni, cfg, device="cpu")
    token, addr = first.tower_source, id(first)
    assert first.tower_source == token
    del first
    for _ in range(200):
        again = ALSTrainer((u, i, v), nu, ni, cfg, device="cpu")
        if id(again) == addr:
            break
    assert again.tower_source != token
    # a falling window of one trainer, then a rising one of the next:
    # no divergence (the same rise within one trainer is one)
    session = port_tower.TowerSession("windows", kind="eval",
                                      manifest_root=tmp_path).start()
    try:
        # 0.3 then 0.4 .. 0.7 in one window would be a 2.3x ramp
        for loss in (4.0, 2.0, 1.0, 0.3):
            port_tower.record_sweep(0.01, {}, loss=loss, source=token)
        for loss in (0.4, 0.5, 0.6, 0.7):
            port_tower.record_sweep(0.01, {}, loss=loss,
                                    source=again.tower_source)
        with pytest.raises(port_tower.ConvergenceError, match="diverging"):
            port_tower.record_sweep(0.01, {}, loss=1.5,
                                    source=again.tower_source)
    finally:
        session.finalize("completed")


def test_setup_starts_at_the_train_run_span(tmp_path):
    """Time spent between the session's start and the ``train.run`` span
    (the engine instance's metadata commits) is no part of the port's
    ``setupSeconds``: setup, sweeps and tail cover the span alone.  The
    reference's setup starts with its session and carries that time.

    A process's first ``record_sweep`` pays a one-time cost (the lazy
    import of its framework and its backend's start, about 2.6 s for
    either package started alone) that falls inside ``trainRunSeconds``
    and inside no part of it, so it would shrink the excess of whichever
    package paid it first.  One throwaway session per package, under a
    root of its own, pays it before the timed ones."""
    for kind, tower in (("port", port_tower), ("jax", jax_tower)):
        warm = tower.TowerSession(f"warm-{kind}",
                                  manifest_root=tmp_path / "warm").start()
        warm.record_sweep(0.0, {"user_half": 0.0})
        warm.note_train_run(0.0)
        warm.finalize("completed")
    excess = {}
    for kind, tower, runlog in (("port", port_tower, port_runlog),
                                ("jax", jax_tower, jax_runlog)):
        root = tmp_path / kind
        session = tower.TowerSession(f"setup-{kind}",
                                     manifest_root=root).start()
        time.sleep(0.2)  # the instance row's insert and update
        t_run = time.perf_counter()
        time.sleep(0.05)  # read and prepare
        for _ in range(2):
            t = time.perf_counter()
            time.sleep(0.01)
            session.record_sweep(time.perf_counter() - t,
                                 {"user_half": time.perf_counter() - t})
        time.sleep(0.02)
        session.note_train_run(time.perf_counter() - t_run)
        session.finalize("completed")
        final = runlog.read_manifest(runlog.runs_root(root) / f"setup-{kind}"
                                     / runlog.MANIFEST_NAME)["final"]
        excess[kind] = (final["setupSeconds"] + final["sweepSecondsTotal"]
                        + final["tailSeconds"] - final["trainRunSeconds"])
    assert abs(excess["port"]) < 0.01, excess
    assert excess["jax"] >= 0.19, excess


def test_console_train_observed_as_the_references(pair, tmp_path):
    """``train --telemetry-dir`` on both consoles: the same output, a
    span journal with ``train.run``, and a completed run manifest whose
    setup, sweeps and tail cover the ``train.run`` span; each package's
    runlog reads the other's manifest."""
    _rated_app(pair)
    ej = _engine_json(pair, tmp_path)
    rc, out = pair.run("train", "--engine-json", ej, "--telemetry-dir",
                       "{home}/telemetry", "--xray-sample-s", "0",
                       "--no-profiler")
    assert rc == 0
    views = {}
    for kind, runlog in (("torch", port_runlog), ("jax", jax_runlog)):
        journal = list((pair.homes[kind] / "telemetry").glob("spans-*"))
        names = {json.loads(x)["name"] for f in journal
                 for x in f.read_text().splitlines()}
        assert {"train.run", "train.save_models"} <= names, kind
        iid = pair.storage[kind].get_metadata().engine_instance_get_all()[
            0].id
        views[kind] = runlog.read_manifest(
            runlog.runs_root() / iid / runlog.MANIFEST_NAME)
    for kind, view in views.items():
        final = view["final"]
        assert final["status"] == "completed" and final["sweeps"] == 2
        sweeps = sum(s["seconds"] for s in view["sweeps"])
        for s in view["sweeps"]:
            assert sum(s["phases"].values()) <= s["seconds"] * 1.02
        # the reference's setup runs from the session's start, which
        # precedes the train.run span by the instance row's insert; the
        # port's runs from the span's start, so its sum falls short of
        # the span by the book-keeping between sweeps only (the 2% check
        # is the card's, at ML-20M, where the span takes seconds)
        total = final["setupSeconds"] + sweeps + final["tailSeconds"]
        excess = total - final["trainRunSeconds"]
        assert -0.01 <= excess <= 0.05, (kind, final)
    for reader in (port_runlog, jax_runlog):
        s = [reader.summarize(v) for v in views.values()]
        assert [x["status"] for x in s] == ["completed", "completed"]
        assert reader.diff_runs(views["torch"], views["jax"])


def test_console_train_nan_aborts_as_the_reference(pair, tmp_path):
    _rated_app(pair)
    ej = _engine_json(pair, tmp_path)
    got = {}
    for kind, faults, tower in (("torch", port_faults, port_tower),
                                ("jax", jax_faults, jax_tower)):
        faults.arm("train.nan:nth=2,times=1")
        with pytest.raises(tower.ConvergenceError) as ei:
            pair.one(kind, "train", "--engine-json", ej)
        faults.disarm()
        (rec,) = pair.storage[kind].get_metadata().engine_instance_get_all()
        view = port_runlog.read_manifest(
            port_runlog.runs_root() / rec.id / port_runlog.MANIFEST_NAME)
        got[kind] = (ei.value.reason, rec.status, view["final"]["status"],
                     view["final"]["sweeps"])
    assert got["torch"] == got["jax"] == (
        "nan_factors", "FAILED", "aborted", 2)


def test_console_deploy_takes_the_observability_options(pair, tmp_path):
    _rated_app(pair)
    ej = _engine_json(pair, tmp_path)
    assert pair.one("torch", "train", "--engine-json", ej)[0] == 0
    pf = tmp_path / "port"
    rcs = []
    argv = ["deploy", "--engine-json", ej.format(kind="torch"), "--ip",
            "127.0.0.1", "--port", "0", "--port-file", str(pf),
            "--slo-ms", "250", "--flight-capacity", "3",
            "--xray-sample-s", "0", "--no-profiler"]
    thread = threading.Thread(
        target=lambda: rcs.append(main(argv, storage=pair.storage["torch"],
                                       device="cpu")),
        daemon=True)
    thread.start()
    port = _wait_port(pf, thread)
    base = f"http://127.0.0.1:{port}"
    for k in range(5):
        req = urllib.request.Request(
            base + "/queries.json",
            data=json.dumps({"user": f"u{k}", "num": 3}).encode())
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
    time.sleep(0.05)
    with urllib.request.urlopen(base + "/metrics", timeout=60) as r:
        text = r.read().decode()
    assert 'pio_slo_burn_rate{window="5m"}' in text
    assert "pio_slo_target_seconds 0.25" in text
    with urllib.request.urlopen(base + "/debug/flight", timeout=60) as r:
        flight = json.loads(r.read())
    assert flight["capacity"] == 3 and len(flight["worst"]) == 3
    rc, _ = pair.one("torch", "undeploy", "--port", str(port))
    thread.join(timeout=30)
    assert rc == 0 and rcs == [0] and not thread.is_alive()
