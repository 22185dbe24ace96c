"""The port's iALS++ subspace sweep and grouped gather against the JAX
package's, on the CPU.

The block sweep, whole trains from the same initial factors (the JAX
trainer's ``init_factors``) and the ``stop_after="gram"`` probe get the
same numpy inputs in both packages.  The JAX side runs its Pallas solve
in interpret mode, as its own tests do; the port's ``"pallas"`` solver
takes the SPD solve kernel's plain version on CPU tensors.

Tolerances: the sweep's factors within 1e-4 of their scale (the same f32
arithmetic in another summation order, on systems with a ridge of at
least 0.05); per-half factors of a train within 1e-4 of their scale, and
its training RMSE within 1e-5.  ``subspace_size >= rank`` must give the
full mode's factors bit for bit, and the grouped gather the row
gather's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.models.als import (
    ALSConfig as JaxALSConfig,
    ALSFactors as JaxALSFactors,
    ALSTrainer as JaxALSTrainer,
    _half_phase_probe as jax_half_phase_probe,
    _subspace_sweep as jax_subspace_sweep,
    rmse as jax_rmse,
)
from predictionio_tpu_torch.convert import factors_from_jax
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSTrainer,
    _half_phase_probe,
    _subspace_sweep,
    rmse,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _toy(n_users=40, n_items=25, density=0.45, seed=0, implicit=False):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(n_users, 4))
    V = rng.normal(size=(n_items, 4))
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


@pytest.mark.parametrize("rank,block", [(8, 4), (10, 4), (16, 16)])
def test_block_sweep_matches_jax(rank, block):
    rng = np.random.default_rng(rank)
    b, k = 12, 16
    for implicit in (False, True):
        counts = rng.integers(1, k + 1, b)
        maskf = (np.arange(k)[None, :] < counts[:, None]).astype(np.float32)
        Vm = (rng.normal(size=(b, k, rank)) * maskf[..., None]).astype(
            np.float32)
        val = (rng.normal(size=(b, k)) * maskf).astype(np.float32)
        x0 = rng.normal(size=(b, rank)).astype(np.float32) * 0.3
        reg = (0.05 * np.maximum(counts, 1)).astype(np.float32)
        cw = gram = None
        if implicit:
            val = np.abs(val) + maskf
            cw = (1.5 * val * maskf).astype(np.float32)
            Y = rng.normal(size=(30, rank)).astype(np.float32)
            gram = (Y.T @ Y).astype(np.float32)
        want = jax_subspace_sweep(
            jnp.asarray(Vm), jnp.asarray(val), jnp.asarray(maskf),
            jnp.asarray(x0), jnp.asarray(reg),
            None if cw is None else jnp.asarray(cw),
            None if gram is None else jnp.asarray(gram),
            jax.lax.Precision.HIGHEST, "xla", block,
        )

        def t(a):
            return None if a is None else torch.from_numpy(a)

        for solver in ("xla", "pallas"):
            got = _subspace_sweep(t(Vm), t(val), t(maskf), t(x0), t(reg),
                                  t(cw), t(gram), solver, block)
            _rel_close(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_train_matches_jax(solver):
    for implicit in (False, True):
        u, i, v, nu, ni = _toy(seed=3, implicit=implicit)
        kw = dict(rank=10, num_iterations=2, lam=0.05, implicit=implicit,
                  alpha=1.5, solver=solver, solver_mode="subspace",
                  subspace_size=4)
        ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw))
        port = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), device="cpu")
        U0, V0 = (np.asarray(a) for a in ref.init_factors())
        Ur, Vr = U0, V0
        for _ in range(kw["num_iterations"]):
            Ur_next, Vr_next = (np.asarray(a) for a in ref.run(Ur, Vr, 1))
            Ut, Vt = port.run(*factors_from_jax(Ur, Vr, "cpu"), 1)
            _rel_close(Ut.numpy(), Ur_next, 1e-4)   # user half
            _rel_close(Vt.numpy(), Vr_next, 1e-4)   # item half
            Ur, Vr = Ur_next, Vr_next
        got = port.train(init=factors_from_jax(U0, V0, "cpu"))
        want_rmse = jax_rmse(JaxALSFactors(Ur, Vr), u, i, v)
        got_rmse = rmse(got, u, i, v, device="cpu")
        assert abs(got_rmse - want_rmse) <= 1e-5, (got_rmse, want_rmse)


@pytest.mark.parametrize("size", [6, 9])
def test_subspace_at_or_above_rank_is_the_full_solve(size):
    u, i, v, nu, ni = _toy(seed=5)
    base = dict(rank=6, num_iterations=2, lam=0.05, solver="pallas")
    full = ALSTrainer((u, i, v), nu, ni, ALSConfig(**base), device="cpu")
    init = full.init_factors()
    want = full.train(init=init)
    got = ALSTrainer((u, i, v), nu, ni, ALSConfig(
        **base, solver_mode="subspace", subspace_size=size),
        device="cpu").train(init=init)
    assert np.array_equal(got.user_factors, want.user_factors)
    assert np.array_equal(got.item_factors, want.item_factors)


@pytest.mark.parametrize("gather_dtype", ["float32", "bfloat16"])
def test_grouped_gather_equals_the_row_gather(gather_dtype):
    # the config accepts the reference's slab gather, which takes the
    # row gather's rows: the factors are the row gather's
    u, i, v, nu, ni = _toy(n_users=45, n_items=37, seed=6)
    for mode in ({}, {"solver_mode": "subspace", "subspace_size": 2}):
        base = dict(rank=5, num_iterations=2, lam=0.05, solver="pallas",
                    gather_dtype=gather_dtype, **mode)
        row = ALSTrainer((u, i, v), nu, ni, ALSConfig(**base), device="cpu")
        init = row.init_factors()
        want = row.train(init=init)
        got = ALSTrainer((u, i, v), nu, ni, ALSConfig(
            **base, gather_mode="grouped"), device="cpu").train(init=init)
        assert np.array_equal(got.user_factors, want.user_factors)
        assert np.array_equal(got.item_factors, want.item_factors)


def test_gram_probe_matches_jax():
    for implicit in (False, True):
        u, i, v, nu, ni = _toy(seed=7, implicit=implicit)
        kw = dict(rank=8, num_iterations=1, lam=0.05, implicit=implicit,
                  solver="xla", solver_mode="subspace", subspace_size=3)
        ref = JaxALSTrainer((u, i, v), nu, ni, JaxALSConfig(**kw))
        port = ALSTrainer((u, i, v), nu, ni, ALSConfig(**kw), device="cpu")
        U0, V0 = (np.asarray(a) for a in ref.init_factors())
        side = ref._user_side
        want = float(jax_half_phase_probe(
            jnp.asarray(U0), jnp.asarray(V0), side["c_sorted"],
            side["v_sorted"], side["buckets"], jnp.float32(0.05),
            jnp.float32(1.0), ks=side["ks"], implicit=implicit,
            weighted_lambda=True, precision="highest", solver="xla",
            solver_mode="subspace", subspace_size=3, stop_after="gram"))
        Ut, Vt = factors_from_jax(U0, V0, "cpu")
        got = float(_half_phase_probe(
            Ut, Vt, port._user_side, 0.05, 1.0, stop_after="gram",
            **port._half_options()))
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (got, want)
        # the probe writes nothing
        assert torch.equal(Ut, factors_from_jax(U0, V0, "cpu")[0])


def test_gj_plan_packs_block_systems_as_the_kernel_accepts():
    """The subspace sweep's B×B systems (16, and a narrower tail) at
    every batch size a bucket can give: the plan passes the checks
    ``csrc/gj_solve.cu`` ``pio_gj_solve`` makes before it launches, and
    covers the batch with whole warps."""
    from predictionio_tpu_torch.ops.solve import gj_plan

    def smem(rp, systems):
        return 4 * systems * (rp * (rp + 1) + 2 * (rp + 4))

    sizes = list(range(1, 4097)) + [65_535, 138_493, 1 << 20, 4 << 20]
    for r in (16, 12, 4):
        for sms in (132, 114):
            for b in sizes:
                p = gj_plan(r, b, sms)
                assert p.rank_pad == 16
                ts = 8
                most = 16  # 128 threads, 19,968 B of shared memory
                assert 32 // ts <= p.systems <= most
                assert p.systems & (p.systems - 1) == 0
                assert p.threads == p.systems * ts and p.threads % 32 == 0
                assert p.blocks == -(-b // p.systems)
                assert p.smem_bytes == smem(16, p.systems) <= 48 * 1024
