"""The Gauss-Jordan CUDA kernel against its plain PyTorch version, on the card.

These kernels have no CPU mode, so every test here needs an NVIDIA GPU
and ``nvcc`` (Hopper, ``sm_90a``) and skips without one.  Run them on the
card with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
GPU machine need not have.)  Inputs are made with numpy from fixed seeds.

Tolerance: the kernel and the plain version do the same f32 arithmetic
in another order (per-thread running sums and FMAs against blocked
einsums), so results agree to a few f32 ulps of the Gram entries,
amplified by the systems' conditioning: 1e-4 of the solution's scale
for the well-conditioned systems here, 1e-3 where K runs to 1e5.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.solve import (
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


