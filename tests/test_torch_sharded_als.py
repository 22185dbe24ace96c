"""The port's sharded ALS trainer against the JAX package's.

The reference runs ``factor_placement="sharded"`` on ``make_mesh(4)``
(four of the conftest's eight virtual CPU devices); the port runs the
same ratings on a mesh of four CPU shards in one process, where each
shard's GJ and fused solves take their plain versions.  Both start from
the reference's padded initial factors (``init_factors`` pads the rows
to a multiple of four with zeros).

Tolerances, as in ``tests/test_torch_als.py``: each iteration starts
both packages from the same factors and the solved factors agree within
1e-4 of their scale; full trains from the same start land within 1e-5
in training RMSE.  A bf16 gather is held to the port's own single-device
bf16 train at 1e-4 and to the reference at the reference's own bf16
bound for sharded against replicated (2e-2, ``tests/test_als.py``).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSFactors as JaxALSFactors,
    ALSTrainer as JaxALSTrainer,
    rmse as jax_rmse,
    sweep_train_als as jax_sweep_train_als,
)
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSTrainer,
    rmse,
    sweep_train_als,
)
from predictionio_tpu_torch.parallel import make_mesh
from predictionio_tpu_torch.workflow.checkpoint import StepCheckpointer

D = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=["cpu"] * D)


def _toy(n_users=37, n_items=23, density=0.4, seed=0, implicit=False):
    """Ratings from a rank-3 model; 37 x 23 does not divide by 4, so
    both tables carry padding rows."""
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 3))
    V = rng.normal(size=(n_items, 3))
    mask = rng.random((n_users, n_items)) < density
    u, i = np.nonzero(mask)
    v = (U @ V.T)[u, i].astype(np.float32)
    if implicit:
        v = np.abs(v) + 0.5
    return u.astype(np.int32), i.astype(np.int32), v, n_users, n_items


def _rel_close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


CASES = {
    "explicit": dict(),
    "implicit": dict(implicit=True, alpha=1.5, weighted_lambda=False),
    "pallas": dict(solver="pallas"),
    "fused": dict(solver="fused"),
    "fused-implicit": dict(solver="fused", implicit=True, alpha=1.5),
    "grouped": dict(gather_mode="grouped"),
    "subspace": dict(solver_mode="subspace", subspace_size=2,
                     solver="pallas"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_per_half_and_rmse_match_jax(meshes, case):
    jm, tm = meshes
    kw = dict(rank=4, num_iterations=2, lam=0.05,
              factor_placement="sharded", **CASES[case])
    u, i, v, nu, ni = _toy(seed=3, implicit=kw.get("implicit", False))
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw), mesh=jm)
    port = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), mesh=tm)
    assert ref.sharded and port.sharded and port.staging == "sharded"
    assert port.solver == ref.solver
    U0, V0 = (np.asarray(a) for a in ref.init_factors())
    assert U0.shape == tuple(port.init_factors()[0].shape) == (40, 4)

    Ur, Vr = U0, V0
    for _ in range(kw["num_iterations"]):
        Ur_next, Vr_next = (np.asarray(a) for a in ref.run(Ur, Vr, 1))
        Ut, Vt = port.run(_t(Ur), _t(Vr), 1)
        _rel_close(Ut.numpy(), Ur_next, 1e-4)   # user half
        _rel_close(Vt.numpy(), Vr_next, 1e-4)   # item half
        Ur, Vr = Ur_next, Vr_next

    got = port.train(init=(_t(U0), _t(V0)))
    assert got.user_factors.shape == (nu, 4)
    assert got.report["placement"] == "sharded"
    assert got.report["shards"] == D
    want_rmse = jax_rmse(JaxALSFactors(Ur[:nu], Vr[:ni]), u, i, v)
    got_rmse = rmse(got, u, i, v, device="cpu")
    assert abs(got_rmse - want_rmse) <= 1e-5, (got_rmse, want_rmse)


def test_bf16_gather_matches_single_device_and_reference(meshes):
    jm, tm = meshes
    u, i, v, nu, ni = _toy(seed=5, implicit=True)
    kw = dict(rank=4, num_iterations=2, lam=0.05, implicit=True, alpha=1.5,
              gather_dtype="bfloat16")
    sh = dict(kw, factor_placement="sharded")
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**sh), mesh=jm)
    U0, V0 = (np.asarray(a) for a in ref.init_factors())
    want = ref.train()
    got = ALSTrainer((u, i, v), nu, ni, ALSConfig(**sh),
                     mesh=tm).train(init=(_t(U0), _t(V0)))
    one = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), device="cpu"
                     ).train(init=(_t(U0[:nu]), _t(V0[:ni])))
    _rel_close(got.user_factors, one.user_factors, 1e-4)
    _rel_close(got.item_factors, one.item_factors, 1e-4)
    _rel_close(got.user_factors, want.user_factors, 2e-2)
    _rel_close(got.item_factors, want.item_factors, 2e-2)


def test_sharded_sweep_matches_jax(meshes):
    """The sharded sweep trains one λ after another on one staging, as
    the reference's does (``tests/test_als.py:859``)."""
    jm, tm = meshes
    u, i, v, nu, ni = _toy(seed=2)
    kw = dict(rank=4, num_iterations=2, factor_placement="sharded")
    lams = (0.01, 0.1)
    want = jax_sweep_train_als((u, i, v), nu, ni, JaxALSConfig(**kw), lams,
                               mesh=jm)
    U0, V0 = (np.asarray(a) for a in JaxALSTrainer(
        (u, i, v), nu, ni, JaxALSConfig(**kw), mesh=jm).init_factors())
    got = sweep_train_als((u, i, v), nu, ni, ALSConfig(**kw), lams,
                          mesh=tm, init=(_t(U0), _t(V0)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _rel_close(g.user_factors, w.user_factors, 1e-4)
        _rel_close(g.item_factors, w.item_factors, 1e-4)


def test_checkpointed_resume_of_sharded_tables(meshes, tmp_path):
    """A sharded train saves its padded tables; a new trainer resumes
    from the latest step to the uninterrupted result (the reference's
    ``tests/test_checkpoint.py:83`` on the sharded placement)."""
    _, tm = meshes
    u, i, v, nu, ni = _toy(seed=1)
    kw = dict(rank=4, lam=0.05, solver="pallas", factor_placement="sharded")
    cfg = ALSConfig(num_iterations=4, **kw)
    whole = ALSTrainer((u, i, v), nu, ni, cfg, mesh=tm).train()
    ck = StepCheckpointer(tmp_path / "ck")
    ALSTrainer((u, i, v), nu, ni, ALSConfig(num_iterations=2, **kw),
               mesh=tm).train(checkpointer=ck, checkpoint_every=1)
    assert ck.all_steps() == [1, 2]
    again = ALSTrainer((u, i, v), nu, ni, cfg, mesh=tm)
    got = again.train(checkpointer=ck, checkpoint_every=2)
    assert ck.last_restored_step == 2 and ck.all_steps() == [1, 2, 4]
    assert np.array_equal(got.user_factors, whole.user_factors)
    assert np.array_equal(got.item_factors, whole.item_factors)


def test_coo_is_sharded_by_owning_rows(meshes):
    """Each shard holds only the rating slices of the rows it solves,
    as the reference's ``_plan_shard_layout`` (``tests/test_als.py:751``)."""
    jm, tm = meshes
    u, i, v, nu, ni = _toy(n_users=61, n_items=29, seed=7)
    cfg = dict(rank=4, num_iterations=1, factor_placement="sharded")
    port = ALSTrainer((u, i, v), nu, ni, ALSConfig(**cfg), mesh=tm)
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**cfg), mesh=jm)
    assert port.coo_shard_entries == ref.coo_shard_entries
    assert port.coo_shard_entries < len(v)
    side = port._user_side
    for s, shard in enumerate(side["shards"]):
        for rows, starts, counts in shard["buckets"]:
            for r, st, c in zip(rows.tolist(), starts.tolist(),
                                counts.tolist()):
                if r >= 64:           # bucket padding: no ratings
                    assert c == 0
                    continue
                got = sorted(shard["c_sorted"][st:st + c].tolist())
                assert got == sorted(i[u == r].tolist())


def test_a_mesh_of_one_shard_is_the_replicated_path():
    """``models/als.py:1265,1279-1285`` of the reference: a one-device
    mesh is no mesh, so sharded placement trains replicated."""
    u, i, v, nu, ni = _toy(seed=4)
    cfg = ALSConfig(rank=4, num_iterations=1, factor_placement="sharded",
                    coded_shards=True)
    tr = ALSTrainer((u, i, v), nu, ni, cfg,
                    mesh=make_mesh(devices=["cpu"]))
    assert tr.mesh is None and not tr.sharded and not tr.coded
    assert tr.coo_shard_entries is None
    assert tr.init_factors()[0].shape == (nu, 4)


def test_convert_carries_padded_tables_into_shards_and_back(meshes):
    """``convert.factors_from_jax`` splits the reference's padded
    sharded tables into the port's per-shard blocks (each the reference
    shard's rows) and ``factors_to_jax`` joins them back bit for bit."""
    from predictionio_tpu_torch.convert import (
        factors_from_jax,
        factors_to_jax,
    )

    jm, tm = meshes
    u, i, v, nu, ni = _toy(seed=6)
    ref = JaxALSTrainer((u, i, v), nu, ni,
                        JaxALSConfig(rank=4, factor_placement="sharded"),
                        mesh=jm)
    U0, V0 = ref.init_factors()
    Us, Vs = factors_from_jax(np.asarray(U0), np.asarray(V0), mesh=tm)
    assert len(Us) == len(Vs) == D
    for blk, shard in zip(Us, sorted(U0.addressable_shards,
                                     key=lambda sh: sh.index[0].start)):
        assert blk.numpy().tobytes() == np.asarray(shard.data).tobytes()
    Ub, Vb = factors_to_jax(Us, Vs, mesh=tm)
    assert Ub.tobytes() == np.asarray(U0).tobytes()
    assert Vb.tobytes() == np.asarray(V0).tobytes()
