"""The port's ALS trainer against the JAX package's, from the same start.

Both packages get the same ratings (numpy, fixed seeds) and the same
initial factors (the JAX trainer's ``init_factors``, carried across with
``convert.factors_from_jax``).  The JAX side runs its Pallas kernels in
interpret mode on the CPU, as its own tests do; the port runs on the CPU,
where its kernel wrappers take their plain PyTorch versions.

Tolerances: each iteration starts both packages from the same factors,
and the solved factors must agree within 1e-4 of their scale (the two
do the same f32 arithmetic in another summation order; rank <= 6
systems with λ >= 0.05 are well conditioned).  Full trains from the same
start must land within 1e-5 in training RMSE.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSFactors as JaxALSFactors,
    ALSTrainer as JaxALSTrainer,
    rmse as jax_rmse,
)
from predictionio_tpu_torch.convert import factors_from_jax
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSFactors,
    ALSTrainer,
    build_bucket_layout,
    rmse,
    train_als,
)
from predictionio_tpu_torch.storage import Ratings, StringIndex


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _toy(n_users=40, n_items=25, density=0.4, seed=0, implicit=False):
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


CASES = [
    (solver, implicit, weighted)
    for solver in ("pallas", "fused")
    for implicit in (False, True)
    for weighted in (False, True)
]


@pytest.mark.parametrize("solver,implicit,weighted", CASES)
def test_per_half_and_rmse_match_jax(solver, implicit, weighted):
    u, i, v, nu, ni = _toy(seed=3, implicit=implicit)
    kw = dict(rank=5, num_iterations=3, lam=0.05, implicit=implicit,
              alpha=1.5, weighted_lambda=weighted, solver=solver)
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw))
    assert ref.solver == solver
    port = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), device="cpu")
    assert port.solver == solver
    U0, V0 = (np.asarray(a) for a in ref.init_factors())

    Ur, Vr = U0, V0
    for _ in range(kw["num_iterations"]):
        Ur_next, Vr_next = (np.asarray(a) for a in ref.run(Ur, Vr, 1))
        Ut, Vt = port.run(*factors_from_jax(Ur, Vr, "cpu"), 1)
        _rel_close(Ut.numpy(), Ur_next, 1e-4)   # user half
        _rel_close(Vt.numpy(), Vr_next, 1e-4)   # item half
        Ur, Vr = Ur_next, Vr_next

    got = port.train(init=factors_from_jax(U0, V0, "cpu"))
    assert len(got.report["half_seconds"]) == 2 * kw["num_iterations"]
    want_rmse = jax_rmse(JaxALSFactors(Ur, Vr), u, i, v)
    got_rmse = rmse(got, u, i, v, device="cpu")
    assert abs(got_rmse - want_rmse) <= 1e-5, (got_rmse, want_rmse)


def test_xla_solver_matches_jax():
    """The library path (``solver="xla"``: Cholesky) from the same start."""
    u, i, v, nu, ni = _toy(seed=4)
    kw = dict(rank=4, num_iterations=2, lam=0.1)
    ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw))
    U0, V0 = (np.asarray(a) for a in ref.init_factors())
    Ur, Vr = (np.asarray(a) for a in ref.run(U0, V0, 2))
    got = train_als((u, i, v), nu, ni, ALSConfig(**kw), device="cpu",
                    init=factors_from_jax(U0, V0, "cpu"))
    _rel_close(got.user_factors, Ur, 1e-4)
    _rel_close(got.item_factors, Vr, 1e-4)


def test_bf16_gather_close_to_f32():
    """bf16 gather operands with f32 sums: ~bf16 operand noise, not f32
    parity (the reference's own bound for this mode is 10%)."""
    u, i, v, nu, ni = _toy(seed=5)
    kw = dict(rank=5, num_iterations=2, lam=0.1)
    tr = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), device="cpu")
    init = tr.init_factors()
    ref = tr.train(init=init)
    for solver in ("pallas", "fused"):
        got = train_als((u, i, v), nu, ni, ALSConfig(
            solver=solver, gather_dtype="bfloat16", **kw),
            device="cpu", init=init)
        np.testing.assert_allclose(
            got.user_factors, ref.user_factors, rtol=0.1, atol=0.1
        )


def test_device_staging_matches_host_staging():
    u, i, v, nu, ni = _toy(seed=6)
    v = np.round(np.abs(v) * 2) / 2          # half-star codes
    cfg = ALSConfig(rank=4, num_iterations=2, lam=0.1, solver="fused")
    host = ALSTrainer((u, i, v), nu, ni, cfg, staging="host", device="cpu")
    dev = ALSTrainer((u, i, v), nu, ni, cfg, staging="device", device="cpu")
    assert dev.staged_transfer_bytes < u.nbytes + i.nbytes + v.nbytes
    init = host.init_factors()
    a, b = host.train(init=init), dev.train(init=init)
    np.testing.assert_allclose(a.user_factors, b.user_factors,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.item_factors, b.item_factors,
                               rtol=1e-5, atol=1e-5)


def test_ratings_input_and_report():
    u, i, v, nu, ni = _toy(seed=7)
    ratings = Ratings(
        user_ix=u, item_ix=i, rating=v,
        users=StringIndex([f"u{k}" for k in range(nu)]),
        items=StringIndex([f"i{k}" for k in range(ni)]),
    )
    f = train_als(ratings, cfg=ALSConfig(rank=3, num_iterations=2,
                                         solver="pallas"), device="cpu")
    assert f.user_factors.shape == (nu, 3)
    assert f.report["solver"] == "pallas"
    assert f.report["staging"] == "host"
    assert len(f.report["sweep_losses"]) == 2
    assert f.report["sweep_losses"][1] <= f.report["sweep_losses"][0]


def test_bucket_layout_is_the_references():
    from predictionio_tpu.models.als import (
        build_bucket_layout as jax_layout,
    )

    u, i, v, nu, _ = _toy(seed=8, n_users=300, density=0.3)
    a = build_bucket_layout(u, i, v, nu, 8, max_per_row=6, max_entries=64)
    b = jax_layout(u, i, v, nu, 8, max_per_row=6, max_entries=64)
    np.testing.assert_array_equal(a.col_sorted, b.col_sorted)
    np.testing.assert_array_equal(a.val_sorted, b.val_sorted)
    assert [x.k for x in a.buckets] == [x.k for x in b.buckets]
    for x, y in zip(a.buckets, b.buckets):
        np.testing.assert_array_equal(x.rows, y.rows)
        np.testing.assert_array_equal(x.starts, y.starts)
        np.testing.assert_array_equal(x.counts, y.counts)
