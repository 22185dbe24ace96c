"""The port's batched SPD solve against the JAX package's and NumPy's.

On the CPU ``spd_solve_batched`` runs its plain PyTorch version, the same
lock-step Gauss-Jordan elimination as the JAX package's Pallas kernel,
which runs here in interpret mode (as ``tests/test_solve.py`` runs it).
Inputs come from numpy with fixed seeds.

Tolerances: against the JAX kernel 1e-5 of the solution's scale (the
same f32 steps; only the rounding of fused operations may differ);
against ``np.linalg.solve`` in float64 1e-4 (f32 elimination of
well-conditioned systems, condition number below ~20 here).
"""

import numpy as np
import pytest
import torch

from predictionio_tpu.ops.solve import spd_solve_batched as jax_solve
from predictionio_tpu_torch.ops.solve import (
    GJ_RANKS,
    MAX_RANK,
    cholesky_solve_batched,
    gj_plan,
    gj_rows_per_thread,
    spd_solve_batched,
    spd_solve_reference,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(rng, B, R, reg=0.5):
    G = rng.normal(size=(B, R, R)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", G, G) / R + reg * np.eye(R)
    return A.astype(np.float32), rng.normal(size=(B, R)).astype(np.float32)


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


@pytest.mark.parametrize("R,B", [(4, 5), (10, 13), (16, 3), (64, 7)])
def test_matches_jax_kernel_and_numpy(R, B):
    rng = np.random.default_rng(100 * R + B)
    A, b = _spd(rng, B, R)
    x = spd_solve_batched(torch.from_numpy(A), torch.from_numpy(b))
    assert x.shape == (B, R) and x.dtype == torch.float32
    _close(x.numpy(), np.asarray(jax_solve(A, b)), 1e-5)
    want = np.linalg.solve(A.astype(np.float64), b[..., None].astype(
        np.float64))[..., 0]
    _close(x.numpy(), want, 1e-4)


def test_two_i_solves_to_half():
    """The reference probe's known answer: 2I x = 1 => x = 0.5."""
    A = torch.eye(10).expand(9, 10, 10) * 2.0
    x = spd_solve_batched(A.contiguous(), torch.ones(9, 10))
    assert torch.equal(x, torch.full((9, 10), 0.5))


def test_alias_and_plain_version_on_cpu():
    rng = np.random.default_rng(3)
    A, b = _spd(rng, 6, 8)
    At, bt = torch.from_numpy(A), torch.from_numpy(b)
    assert cholesky_solve_batched is spd_solve_batched
    assert torch.equal(spd_solve_batched(At, bt), spd_solve_reference(At, bt))


def test_ill_conditioned_but_regularized():
    """ALS's regime: a rank-deficient Gram plus a small ridge."""
    rng = np.random.default_rng(4)
    R, B = 12, 5
    V = rng.normal(size=(B, 3, R)).astype(np.float32)   # rank 3 Gram
    A = np.einsum("bkr,bks->brs", V, V) + 0.1 * np.eye(R, dtype=np.float32)
    b = rng.normal(size=(B, R)).astype(np.float32)
    x = spd_solve_batched(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    _close(x, np.asarray(jax_solve(A, b)), 1e-5)
    np.testing.assert_allclose(
        np.einsum("brs,bs->br", A.astype(np.float64), x), b,
        rtol=1e-3, atol=1e-3,
    )


def test_rejects_non_square():
    with pytest.raises(ValueError, match="B, R, R"):
        spd_solve_batched(torch.zeros(2, 3, 4), torch.zeros(2, 3))


def test_zero_systems_solve_to_zero_like_the_jax_kernel():
    """The clamped pivot: an all-zero system gives x = 0 in both
    packages (the CUDA kernel clamps the same way)."""
    A = np.zeros((3, 17, 17), np.float32)
    b = np.zeros((3, 17), np.float32)
    x = spd_solve_batched(torch.from_numpy(A), torch.from_numpy(b))
    assert torch.equal(x, torch.zeros(3, 17))
    np.testing.assert_array_equal(np.asarray(jax_solve(A, b)), 0.0)


def test_gj_plan_accounting():
    """csrc/gj_solve.cu's launch plan for every rank 1..128: the padded
    rank is the least compiled one covering R; a system takes RP / (rows
    a thread) threads, two rows a thread up to rank 64; a block is whole
    warps, a power of two of systems within 128 threads and 48 KB of
    shared memory, or one system of more than a warp (rank 128); its
    shared memory (each system's [RP, RP+1] triangle and two step vectors
    of RP + 4 floats) fits an H100 block; the grid covers the batch, and
    a small batch takes as many SMs as it can."""
    for r in range(1, MAX_RANK + 1):
        for b in (1, 7, 131, 132, 1031, 65_536, 138_493):
            for sms in (1, 114, 132):
                p = gj_plan(r, b, sms)
                assert p.rank_pad in GJ_RANKS and p.rank_pad >= r
                assert p.rank_pad == 16 or p.rank_pad // 2 < r
                h = gj_rows_per_thread(p.rank_pad)
                assert h == (1 if p.rank_pad == 128 else 2)
                ts = p.rank_pad // h
                assert p.threads == p.systems * ts
                assert p.threads % 32 == 0 and p.threads <= 128
                assert p.systems & (p.systems - 1) == 0
                assert p.smem_bytes == 4 * p.systems * (
                    p.rank_pad * (p.rank_pad + 1) + 2 * (p.rank_pad + 4))
                assert p.smem_bytes <= 232_448
                if p.systems > 1:
                    assert ts <= 32 and p.smem_bytes <= 48 * 1024
                assert p.blocks * p.systems >= b > (p.blocks - 1) * p.systems
                if p.systems > max(1, 32 // ts):
                    # half as many systems a block would not fit the SMs
                    assert -(-b // (p.systems // 2)) > sms
    with pytest.raises(ValueError, match="rank"):
        gj_plan(MAX_RANK + 1, 4)
