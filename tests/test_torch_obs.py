"""The port's observability layer (``obs/``) and fault plans
(``resilience/faults.py``) against the JAX package's, on the CPU.

The same operations, drawn from a seed with numpy, go to both packages'
registries, fault plans, watchdogs, burn-rate trackers and run
manifests; what each exposes must be equal: the exposition text byte
for byte, the merged cluster state, the firing sequence of a plan, the
watchdog's verdict, the burn-rate gauges, and each package's manifests
read by the other's ``runlog``.
"""

import ast
import time
from pathlib import Path

import numpy as np
import pytest

import predictionio_tpu.obs as jax_obs
import predictionio_tpu_torch.obs as port_obs
from predictionio_tpu.obs import fleet as jax_fleet
from predictionio_tpu.obs import registry as jax_registry
from predictionio_tpu.obs import runlog as jax_runlog
from predictionio_tpu.obs import tower as jax_tower
from predictionio_tpu.obs import xray as jax_xray
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch.obs import fleet as port_fleet
from predictionio_tpu_torch.obs import registry as port_registry
from predictionio_tpu_torch.obs import runlog as port_runlog
from predictionio_tpu_torch.obs import timeline as port_timeline
from predictionio_tpu_torch.obs import tower as port_tower
from predictionio_tpu_torch.obs import xray as port_xray
from predictionio_tpu_torch.resilience import faults as port_faults
from predictionio_tpu_torch.server.http_base import observability_response

ROOT = Path(__file__).resolve().parents[1]
PACKAGES = {
    "port": (port_registry, port_fleet, port_faults, port_tower,
             port_runlog),
    "jax": (jax_registry, jax_fleet, jax_faults, jax_tower, jax_runlog),
}


def _drive_registry(reg_mod, seed: int):
    """A fresh registry after a seeded sequence of operations on every
    instrument kind (labeled and not, custom buckets and default)."""
    rng = np.random.default_rng(seed)
    reg = reg_mod.MetricsRegistry()
    c = reg.counter("pio_queries_total", "Serving queries by outcome",
                    labels=("status",))
    g = reg.gauge("pio_serve_inflight", "in flight")
    h = reg.histogram("pio_query_latency_seconds", "latency")
    hl = reg.histogram("pio_train_phase_seconds", "phases",
                       labels=("phase",),
                       buckets=reg_mod.log_buckets(1e-4, 1e4, per_decade=4))
    for _ in range(400):
        op = int(rng.integers(4))
        if op == 0:
            c.labels(status=str(rng.choice(["ok", "error", "timeout"]))
                     ).inc(float(rng.integers(1, 4)))
        elif op == 1:
            g.child().set(float(rng.normal()))
        elif op == 2:
            h.child().observe(float(rng.lognormal(-5, 2)))
        else:
            hl.labels(phase=str(rng.choice(["als.gather", "als.gram"]))
                      ).observe(float(rng.lognormal(-3, 1)))
    return reg


def test_registries_expose_and_merge_as_the_reference():
    text = {}
    merged = {}
    for name, (reg_mod, fleet, *_rest) in PACKAGES.items():
        regs = [_drive_registry(reg_mod, seed) for seed in (0, 1)]
        text[name] = regs[0].render_prometheus()
        state = reg_mod.merge_states(
            [(f"w{i}", r.dump_state()) for i, r in enumerate(regs)],
            gauge_label="worker",
        )
        merged[name] = reg_mod.render_state(state)
        # the parser is the exact inverse of the renderer
        assert reg_mod.render_state(fleet.parse_prometheus(
            merged[name])) == merged[name]
    assert text["port"] == text["jax"]
    assert merged["port"] == merged["jax"]
    assert "pio_query_latency_seconds_bucket" in text["port"]


def _reference_obs_catalog() -> set:
    """Family names the reference's ``obs`` modules register (every
    ``*.counter/gauge/histogram("name", ...)`` call in their source)."""
    names = set()
    for path in (ROOT / "predictionio_tpu" / "obs").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "attr", "") in (
                        "counter", "gauge", "histogram")
                    and node.args and isinstance(node.args[0], ast.Constant)
                    and str(node.args[0].value).startswith("pio_")):
                names.add(node.args[0].value)
    return names


def test_the_catalog_is_the_references():
    def families(reg):
        return {f["name"]: f for f in reg.dump_state()["families"]}

    port = families(port_obs.get_registry())
    ref = families(jax_obs.get_registry())
    catalog = _reference_obs_catalog()
    assert len(catalog) > 80
    assert catalog <= set(port)
    for name, fam in port.items():
        assert name in ref, name
        for key in ("help", "kind", "labelNames"):
            assert fam[key] == ref[name][key], (name, key)
    for name in ("QUERY_LATENCY", "EVENT_WRITE_LATENCY",
                 "WAL_FSYNC_SECONDS", "WAL_COMMIT_ROWS"):
        assert (getattr(port_obs, name).child().bounds
                == getattr(jax_obs, name).child().bounds)


PLANS = [
    "storage.write:nth=2,times=3,exc=operational",
    "seed=7;storage.read:prob=0.4;device.dispatch:prob=0.25,exc=timeout",
    "reload.load_model:nth=3;train.nan:nth=2,times=1",
    "wal.torn:shard=1,times=2;store.shard_down:shard=2,nth=2",
]


def _fire_sequence(faults, spec: str, seed: int) -> list:
    """Which calls fire under ``spec``: a seeded walk over the points,
    recording each call's outcome (exception type or None)."""
    rng = np.random.default_rng(seed)
    faults.arm(spec)
    out = []
    try:
        for _ in range(120):
            point = str(rng.choice(["storage.write", "storage.read",
                                    "device.dispatch",
                                    "reload.load_model", "train.nan",
                                    "wal.torn", "store.shard_down"]))
            shard = int(rng.integers(4))
            try:
                if point == "train.nan":
                    out.append((point, faults.fired(point)))
                    continue
                if point in ("wal.torn", "store.shard_down"):
                    faults.check_shard(point, shard)
                else:
                    faults.check(point)
                out.append((point, shard, None))
            except Exception as e:
                out.append((point, shard, type(e).__name__, str(e)))
        out.append(sorted(faults.armed().counters().items()))
    finally:
        faults.disarm()
    return out


@pytest.mark.parametrize("spec", PLANS)
def test_one_plan_fires_on_the_same_calls(spec):
    assert _fire_sequence(port_faults, spec, 3) == _fire_sequence(
        jax_faults, spec, 3)
    assert port_faults.POINTS == jax_faults.POINTS


def test_plan_grammar_errors_raise_as_the_reference():
    for bad in ("nowhere.at.all:nth=1",  # piolint: disable=PIO403
                "storage.write:nth=x", "storage.write:exc=nope",
                "storage.write;storage.write:times=2"):
        errors = []
        for faults in (port_faults, jax_faults):
            with pytest.raises(Exception) as ei:
                faults.FaultPlan.parse(bad)
            errors.append((type(ei.value), str(ei.value)))
        assert errors[0] == errors[1], bad


def test_the_watchdog_decides_as_the_reference():
    rng = np.random.default_rng(5)
    runs = [
        [(0.1, 1.0, True), (0.1, 0.9, True), (0.1, float("nan"), True)],
        [(0.1, 1.0, True), (0.1, 1.0, False)],
        [(0.1, 1.0 * 1.3 ** k, True) for k in range(8)],
        [(0.1, float(v), True) for v in rng.uniform(0.5, 1.0, 12)],
        [(5.0, 1.0, True)],
    ]
    for sweeps in runs:
        verdicts = []
        for tower in (port_tower, jax_tower):
            w = tower.Watchdog(divergence_window=4, divergence_ratio=2.0,
                               stall_limit_s=2.0)
            got = None
            for i, (secs, loss, finite) in enumerate(sweeps, 1):
                try:
                    w.check(i, secs, loss, finite)
                except tower.ConvergenceError as e:
                    got = (i, e.reason, str(e))
                    break
            verdicts.append(got)
        assert verdicts[0] == verdicts[1], sweeps


def _write_run(runlog, root, iid: str, seconds: list) -> None:
    m = runlog.RunManifest(iid, kind="train", root=root,
                           meta={"engine": "recommendation"})
    for i, s in enumerate(seconds, 1):
        m.sweep(i, s, {"user_half": s * 0.5, "item_half": s * 0.4},
                loss=1.0 / i)
    m.finalize("completed", sweeps=len(seconds), wallSeconds=sum(seconds))


def test_each_runlog_reads_the_others_manifests(tmp_path):
    _write_run(port_runlog, tmp_path, "p1", [0.2, 0.3, 0.25])
    _write_run(jax_runlog, tmp_path, "j1", [0.2, 0.3, 0.25])
    views = {}
    for name, runlog in (("port", port_runlog), ("jax", jax_runlog)):
        runs = {v["header"]["instanceId"]: v
                for v in runlog.list_runs(root=tmp_path)}
        assert set(runs) == {"p1", "j1"}
        sums = {iid: runlog.summarize(v) for iid, v in runs.items()}
        for s in sums.values():
            del s["instanceId"], s["start"]
        assert sums["p1"] == sums["j1"]
        views[name] = (sums["p1"], runlog.diff_runs(runs["p1"], runs["j1"]))
    assert views["port"] == views["jax"]


def test_burn_rate_gauges_equal_the_references():
    rng = np.random.default_rng(11)
    lat = rng.lognormal(-4.5, 1.2, 600)
    t0 = time.monotonic()
    rates = []
    for reg_mod, fleet in ((port_registry, port_fleet),
                           (jax_registry, jax_fleet)):
        h = reg_mod.Histogram()
        tr = fleet.BurnRateTracker(h.snapshot, h.bounds, 0.02,
                                   objective=0.99, min_sample_s=0.0)
        got = []
        for k, chunk in enumerate(np.array_split(lat, 12)):
            for v in chunk:
                h.observe(float(v))
            now = t0 + 30.0 * (k + 1)
            got.append([tr.rate(w, now) for _, w in fleet.BURN_WINDOWS])
        rates.append(got)
    assert rates[0] == rates[1]
    assert port_fleet.BURN_WINDOWS == jax_fleet.BURN_WINDOWS


def test_device_reads_stay_off_the_card_here():
    # no CUDA device has been used: the sampler reads nothing and the
    # /debug/xray document keeps the reference's schema
    assert port_xray.sample_devices_once() == []
    assert port_xray.device_high_water() is None
    assert set(port_xray.xray_payload()) == set(jax_xray.xray_payload())
    # a profile capture that cannot see a card fails; it never writes
    # a CPU-only trace
    with pytest.raises(RuntimeError, match="CUDA"):
        port_timeline.capture_profile(0.05)
    code, payload, _ = observability_response("/debug/profile",
                                              "seconds=0.05")
    assert code == 500 and "CUDA" in payload["message"]


def test_spans_stitch_across_journals_as_tracecat(tmp_path):
    """The port's ``collect_spans``/``build_tree`` (library code of the
    reference's ``tools/tracecat.py``) nest one trace's spans from both
    packages' journals as tracecat does."""
    import importlib.util

    from predictionio_tpu.obs.trace import Tracer as JaxTracer
    from predictionio_tpu_torch.obs.trace import (
        Tracer, build_tree, collect_spans,
    )

    spec = importlib.util.spec_from_file_location(
        "tracecat", ROOT / "tools" / "tracecat.py")
    tracecat = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tracecat)
    rng = np.random.default_rng(8)
    for t0, tracer in ((1000.0, Tracer(journal_dir=tmp_path)),
                       (2000.0, JaxTracer(journal_dir=tmp_path))):
        t = t0
        for k in range(6):
            start = t + float(rng.uniform(0, 0.3))
            tracer.record(f"outer{k}", 1.0, trace_id="t-stitch", start=start)
            tracer.record(f"inner{k}", 0.4, trace_id="t-stitch",
                          start=start + 0.2, attrs={"k": k})
            tracer.record("other", 0.1, trace_id="t-else", start=start)
            t += 2.0
        tracer.close()
    got = collect_spans("t-stitch", tmp_path)
    assert len(got) == 24
    want = tracecat.collect_spans("t-stitch", tmp_path)
    assert got == want

    def shape(nodes):
        return sorted((n["name"], shape(n["children"])) for n in nodes)

    assert shape(build_tree(got)) == shape(tracecat.build_tree(want))
    assert all(len(r["children"]) == 1 for r in build_tree(got))


def test_a_stack_sample_keeps_no_frame_alive():
    """A sample of a thread's stack must not outlive the sample: the
    locals of the calls it saw (a tenant's model, say) are freed when
    those calls return, without waiting for the cyclic collector (the
    reference's ``sample_once`` keeps its own frame in the frames dict
    it holds, a cycle that keeps every sampled frame alive)."""
    import gc
    import threading
    import weakref

    from predictionio_tpu_torch.obs.scope import ScopeProfiler

    class Payload:
        pass

    ready, go = threading.Event(), threading.Event()
    refs = []

    def work():
        payload = Payload()
        refs.append(weakref.ref(payload))
        ready.set()
        go.wait(10)

    prof = ScopeProfiler(hz=67)
    gc.disable()
    try:
        t = threading.Thread(target=work)
        t.start()
        assert ready.wait(10)
        assert prof.sample_once() >= 1
        go.set()
        t.join(10)
        assert not t.is_alive()
        assert refs[0]() is None
    finally:
        gc.enable()
