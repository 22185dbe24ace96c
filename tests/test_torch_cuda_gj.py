"""The Gauss-Jordan CUDA kernel against its plain PyTorch version, on the card.

These kernels have no CPU mode, so every test here needs an NVIDIA GPU
and ``nvcc`` (Hopper, ``sm_90a``) and skips without one.  Run them on the
card with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
GPU machine need not have.)  Inputs are made with numpy from fixed seeds.

Tolerance: the kernel (root-free Cholesky of the lower triangle) and
the plain version (Gauss-Jordan) solve the same systems in f32 by other
steps, so results agree to a few f32 ulps amplified by the systems'
conditioning: 1e-4 of the solution's scale for the well-conditioned
systems here, and 1e-3 against a float64 solve.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.solve import (
    gj_plan,
    sm_count,
    spd_solve_batched,
    spd_solve_reference,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _spd(rng, B, R, reg=0.5):
    G = rng.normal(size=(B, R, R)).astype(np.float32)
    A = np.einsum("bij,bkj->bik", G, G) / R + reg * np.eye(R, dtype=np.float32)
    b = rng.normal(size=(B, R)).astype(np.float32)
    return A.astype(np.float32), b


def _close(got, want, tol):
    got = got.double().cpu()
    want = want.double().cpu()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("R", [1, 5, 10, 16, 17, 33, 64, 65, 100, 128])
def test_gj_kernel_matches_plain(dev, R):
    for B in (1, 7, 1031):
        rng = np.random.default_rng(R * 1000 + B)
        A, b = _spd(rng, B, R)
        At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        before = _build.LAUNCHES["gj_solve"]
        x = spd_solve_batched(At, bt)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["gj_solve"] == before + 1
        _close(x, spd_solve_reference(At, bt), 1e-4)
        _close(x, torch.from_numpy(
            np.linalg.solve(A, b[..., None])[..., 0]), 1e-3)


def _als_systems(rng, B, R, m=2000, lam=0.01):
    """Normal equations as ALS-WR builds them: the Gram of the factor
    rows a user rated (33..64 of them, N(0, 1) / sqrt(R) rows) plus
    ``lam * n * I``, and ``sum r v``."""
    V = rng.normal(size=(m, R)) / np.sqrt(R)
    n = rng.integers(33, 65, size=B)
    A = np.empty((B, R, R))
    b = np.empty((B, R))
    for k in range(B):
        rows = V[rng.integers(0, m, size=n[k])]
        r = rng.integers(1, 11, size=n[k]) * 0.5
        A[k] = rows.T @ rows + lam * n[k] * np.eye(R)
        b[k] = r @ rows
    return A.astype(np.float32), b.astype(np.float32)


def test_gj_kernel_boundaries_zero_and_als_systems(dev):
    """Every padded-rank boundary, a batch of zero systems (x = 0
    exactly, as the clamped pivot gives) and ALS-built systems, each
    against the plain version and a float64 solve, one launch a call."""
    rng = np.random.default_rng(5)
    cases = [_spd(rng, B, R) for R in (16, 17, 32, 33, 64, 65, 127, 128)
             for B in (3, 1031)]
    cases.append(_als_systems(rng, 700, 64))
    for A, b in cases:
        At, bt = torch.from_numpy(A).to(dev), torch.from_numpy(b).to(dev)
        before = _build.LAUNCHES["gj_solve"]
        x = spd_solve_batched(At, bt)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["gj_solve"] == before + 1
        _close(x, spd_solve_reference(At, bt), 1e-4)
        _close(x, torch.from_numpy(np.linalg.solve(
            A.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]),
            1e-3)
    for R in (16, 33, 64, 128):
        zero = torch.zeros((37, R, R), device=dev)
        x = spd_solve_batched(zero, torch.zeros((37, R), device=dev))
        torch.cuda.synchronize()
        assert torch.equal(x, torch.zeros_like(x))
        assert torch.equal(spd_solve_reference(zero, torch.zeros_like(x)), x)


def test_gj_kernel_two_i_is_half(dev):
    A = (2 * torch.eye(64, device=dev)).expand(300, 64, 64).contiguous()
    x = spd_solve_batched(A, torch.ones(300, 64, device=dev))
    torch.cuda.synchronize()
    assert torch.allclose(x, torch.full_like(x, 0.5))


def test_gj_kernel_rejects_bad_inputs(dev):
    A = torch.eye(8, device=dev).expand(4, 8, 8)
    with pytest.raises(ValueError, match="contiguous"):
        spd_solve_batched(A, torch.ones(4, 8, device=dev))
    with pytest.raises(TypeError, match="float32"):
        spd_solve_batched(A.contiguous().double(),
                          torch.ones(4, 8, device=dev))
    with pytest.raises(ValueError, match="rank"):
        spd_solve_batched(torch.eye(129, device=dev)[None].contiguous(),
                          torch.ones(1, 129, device=dev))
    # the entry point recomputes the plan and refuses one that differs;
    # a refused launch raises and is not counted
    A = torch.eye(64, device=dev).expand(300, 64, 64).contiguous()
    b = torch.ones(300, 64, device=dev)
    x = torch.empty_like(b)
    plan = gj_plan(64, 300, sm_count(dev.index or 0))
    for bad in (plan._replace(rank_pad=128), plan._replace(blocks=1),
                plan._replace(threads=plan.threads * 2),
                plan._replace(systems=3, threads=192, blocks=100),
                plan._replace(smem_bytes=plan.smem_bytes + 4)):
        before = _build.LAUNCHES["gj_solve"]
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.launch("pio_gj_solve", "gj_solve", dev, A.data_ptr(),
                          b.data_ptr(), x.data_ptr(), 300, 64, *bad)
        assert _build.LAUNCHES["gj_solve"] == before
    _build.launch("pio_gj_solve", "gj_solve", dev, A.data_ptr(),
                  b.data_ptr(), x.data_ptr(), 300, 64, *plan)
    torch.cuda.synchronize()
    assert torch.equal(x, b)


