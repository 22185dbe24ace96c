"""The port's coded (parity) shards against the JAX package's, under the
same ``PIO_FAULT_PLAN``.

Mirrors ``tests/test_chaos_distributed.py:86-254``: every scenario arms
the same deterministic plan in both packages' fault modules, trains the
reference on ``make_mesh(4)`` and the port on four CPU shards from the
reference's padded initial factors, and holds the port to the
reference's factors (1e-4 of their scale: the parity rebuild and the
frozen rows are the same arithmetic) and to the reference's own bounds
(the straggler RMSE within 1% of the clean train).
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSTrainer as JaxALSTrainer,
)
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu.parallel.coded import (
    build_coded_gather as jax_coded_gather,
    build_parity_fn as jax_parity_fn,
)
from predictionio_tpu.parallel.mesh import data_sharding
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSTrainer,
    rmse,
    train_als,
)
from predictionio_tpu_torch.obs import SHARD_DEGRADED_TOTAL, get_tracer
from predictionio_tpu_torch.obs import runlog, tower
from predictionio_tpu_torch.parallel import (
    ParityExhausted,
    build_coded_gather,
    build_parity_fn,
    make_mesh,
)
from predictionio_tpu_torch.parallel.mesh import shard_put
from predictionio_tpu_torch.resilience import faults

D = 4
BASE = dict(rank=4, num_iterations=8, lam=0.1, seed=3)
CODED = dict(factor_placement="sharded", coded_shards=True)


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    n_u, n_i, nnz = 60, 40, 900
    u = rng.integers(0, n_u, nnz).astype(np.int32)
    i = rng.integers(0, n_i, nnz).astype(np.int32)
    v = rng.integers(1, 6, nnz).astype(np.float32)
    return u, i, v, n_u, n_i


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=["cpu"] * D)


@pytest.fixture(scope="module")
def init(problem, meshes):
    u, i, v, n_u, n_i = problem
    tr = JaxALSTrainer((u, i, v), n_u, n_i, JaxALSConfig(**BASE, **CODED),
                       mesh=meshes[0])
    return tuple(torch.from_numpy(np.array(a, np.float32))
                 for a in tr.init_factors())


@pytest.fixture(scope="module")
def clean(problem, init):
    """The port's replicated train from the same (unpadded) start."""
    u, i, v, n_u, n_i = problem
    f = train_als((u, i, v), n_u, n_i, ALSConfig(**BASE), device="cpu",
                  init=(init[0][:n_u], init[1][:n_i]))
    return f, rmse(f, u, i, v, device="cpu")


def _degraded_total() -> float:
    return sum(c.value() for _, c in SHARD_DEGRADED_TOTAL.children())


def _coded_train(problem, meshes, init, plan=None, **extra):
    """The port's coded train and the reference's under ``plan``."""
    u, i, v, n_u, n_i = problem
    if plan:
        faults.arm(plan)
    tr = ALSTrainer((u, i, v), n_u, n_i, ALSConfig(**BASE, **CODED, **extra),
                    mesh=meshes[1])
    try:
        got = tr.train(init=init)
    finally:
        faults.disarm()
    if plan:
        jax_faults.arm(plan)
    ref = JaxALSTrainer((u, i, v), n_u, n_i,
                        JaxALSConfig(**BASE, **CODED, **extra),
                        mesh=meshes[0])
    try:
        U, V = ref.run(*(a.numpy() for a in init), BASE["num_iterations"])
    finally:
        jax_faults.disarm()
    for g, w in ((got.user_factors, np.asarray(U)[:n_u]),
                 (got.item_factors, np.asarray(V)[:n_i])):
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    assert tr.shard_health.degraded_polls == ref.shard_health.degraded_polls
    assert tr.shard_health.killed == ref.shard_health.killed
    return tr, got, rmse(got, u, i, v, device="cpu")


def test_parity_and_coded_gather_match_jax(meshes):
    jm, tm = meshes
    x = np.arange(D * 3 * 2, dtype=np.float32).reshape(D * 3, 2)
    xj = jax.device_put(x, data_sharding(jm, 2))
    par_j = jax_parity_fn(jm)(xj)
    par_t = build_parity_fn(tm)(shard_put(x, tm))
    np.testing.assert_array_equal(par_t[0].numpy(), np.asarray(par_j))
    ok = np.array([1, 0, 1, 1], np.float32)
    want = np.asarray(jax_coded_gather(jm)(xj, par_j, ok))
    got = build_coded_gather(tm)(shard_put(x, tm), par_t, ok)[0].numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)   # the hole rebuilt exactly


def test_clean_coded_matches_replicated(problem, meshes, init, clean):
    ref, _ = clean
    tr, got, _ = _coded_train(problem, meshes, init)
    assert tr.coded and tr.shard_health.degraded_polls == 0
    np.testing.assert_allclose(got.user_factors, ref.user_factors,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.item_factors, ref.item_factors,
                               rtol=1e-4, atol=1e-4)


def test_straggler_parity_serve_rmse_within_1pct(problem, meshes, init,
                                                 clean):
    _, r_clean = clean
    before = _degraded_total()
    n_spans = len(get_tracer().spans())
    tr, _, r = _coded_train(
        problem, meshes, init,
        plan="dist.shard_delay:nth=7,times=1,shard=2,delay=0.05",
    )
    assert r <= 1.01 * r_clean, (r, r_clean)
    assert tr.shard_health.degraded_polls == 1
    assert _degraded_total() == before + 1
    assert SHARD_DEGRADED_TOTAL.labels(shard="2").value() >= 1
    spans = [s for s in get_tracer().spans()[n_spans:]
             if s.name == "dist.parity_serve"]
    assert spans and spans[0].attrs["shard"] == 2


def test_straggler_within_hop_budget_is_tolerated(problem, meshes, init,
                                                  clean):
    ref, _ = clean
    tr, got, _ = _coded_train(
        problem, meshes, init,
        plan="dist.shard_delay:nth=3,times=1,shard=1,delay=0.01",
        shard_hop_budget_s=5.0,
    )
    assert tr.shard_health.degraded_polls == 0
    np.testing.assert_allclose(got.user_factors, ref.user_factors,
                               rtol=1e-4, atol=1e-4)


def test_dead_worker_mid_sweep(problem, meshes, init, clean):
    _, r_clean = clean
    before = _degraded_total()
    tr, _, r = _coded_train(problem, meshes, init,
                            plan="dist.worker_kill:nth=15,shard=1")
    assert r <= 1.01 * r_clean, (r, r_clean)
    assert tr.shard_health.killed == {1}
    # killed at poll 15 of 16: the last two halves degrade
    assert tr.shard_health.degraded_polls == 2
    assert _degraded_total() == before + 2


def test_two_holes_raise_parity_exhausted(problem, meshes, init):
    u, i, v, n_u, n_i = problem
    faults.arm("dist.worker_kill:nth=1,shard=2;"
               "dist.shard_drop:nth=1,shard=1")
    tr = ALSTrainer((u, i, v), n_u, n_i, ALSConfig(**BASE, **CODED),
                    mesh=meshes[1])
    with pytest.raises(ParityExhausted, match="parity"):
        tr.train(init=init)


def test_chaos_plan_is_deterministic(problem, meshes, init):
    plan = "dist.shard_drop:nth=5,times=1,shard=3"
    _, f1, r1 = _coded_train(problem, meshes, init, plan=plan)
    _, f2, r2 = _coded_train(problem, meshes, init, plan=plan)
    assert r1 == r2
    np.testing.assert_array_equal(f1.user_factors, f2.user_factors)


def test_shard_events_land_in_manifest(problem, meshes, init, tmp_path,
                                       monkeypatch):
    """A degradation during a tracked run lands in the run manifest
    (the reference's ``tests/test_tower.py:419``)."""
    monkeypatch.setenv("PIO_TPU_RUNLOG_DIR", str(tmp_path / "runs"))
    u, i, v, n_u, n_i = problem
    faults.arm("dist.shard_delay:nth=3,times=1,shard=1,delay=0.01")
    s = tower.TowerSession("coded").start()
    try:
        ALSTrainer((u, i, v), n_u, n_i,
                   ALSConfig(**dict(BASE, num_iterations=4), **CODED),
                   mesh=meshes[1]).train(init=init)
        s.finalize("completed")
    except BaseException as e:
        s.finalize_error(e)
        raise
    view = runlog.read_manifest(runlog.runs_root() / "coded")
    degr = [e for e in view["events"] if e["event"] == "shard_degraded"]
    assert degr and degr[0]["shard"] == 1
    assert any(sw.get("shardEvents") for sw in view["sweeps"])

