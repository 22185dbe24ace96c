"""Batched SPD solve: the Hopper Gauss-Jordan kernel and its plain version.

Port of ``predictionio_tpu/ops/solve.py``.  ``spd_solve_batched`` solves
``A[i] x[i] = b[i]`` for a batch of symmetric positive definite systems
by augmented Gauss-Jordan elimination without pivoting, the method of
the TPU kernel (safe because ALS always solves ``Gram + reg*I`` with
``reg > 0``).  On a CUDA tensor it launches ``csrc/gj_solve.cu`` (one
thread block per system, see the note there); on a CPU tensor it runs
:func:`spd_solve_reference`, the same lock-step elimination in plain
PyTorch.  There is no path that skips the kernel on the card.
"""

from __future__ import annotations

import torch

from ._build import launch

__all__ = [
    "MAX_RANK",
    "cholesky_solve_batched",
    "spd_solve_batched",
    "spd_solve_reference",
]

# the reference elimination's pivot clamp (predictionio_tpu/ops/solve.py)
_EPS = 1e-20

# the kernels' largest rank (csrc/gj.cuh kMaxRank)
MAX_RANK = 128


def spd_solve_reference(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch augmented Gauss-Jordan, lock-step over the batch.

    The same steps as the TPU kernel: per pivot, extract the pivot row,
    clamp the pivot to ``_EPS``, normalise, remove the pivot column from
    every other row; after R steps column R is x.
    A: [B, R, R], b: [B, R] -> x: [B, R], all float32."""
    B, R, _ = A.shape
    M = torch.cat([A, b[:, :, None]], dim=2).to(torch.float32)
    eps = torch.tensor(_EPS, dtype=M.dtype, device=M.device)
    for p in range(R):
        pr = M[:, p, :]
        d = pr[:, p]
        prn = pr / torch.where(d.abs() > eps, d, eps)[:, None]
        col = M[:, :, p].clone()
        col[:, p] = 0.0
        M = M - col[:, :, None] * prn[:, None, :]
        M[:, p, :] = prn
    return M[:, :, R].contiguous()


def _check_cuda(name: str, t: torch.Tensor, shape: tuple,
                device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def spd_solve_batched(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``A[i] x[i] = b[i]`` for a batch of SPD systems.

    A: [B, R, R] float32, b: [B, R] float32 -> x: [B, R] float32.  CPU
    tensors take the plain version; CUDA tensors launch the kernel
    (R <= 128, contiguous float32 on one device) or raise."""
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"A must be [B, R, R], got {tuple(A.shape)}")
    if A.device.type == "cpu" and b.device.type == "cpu":
        return spd_solve_reference(A, b)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    B, R, _ = A.shape
    if R > MAX_RANK:
        raise ValueError(f"rank {R} exceeds the kernel's maximum {MAX_RANK}")
    _check_cuda("A", A, (B, R, R), A.device)
    _check_cuda("b", b, (B, R), A.device)
    x = torch.empty((B, R), dtype=torch.float32, device=A.device)
    launch("pio_gj_solve", "gj_solve", A.device,
           A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R)
    return x


# the reference's historical name (its first kernel factorised by Cholesky)
cholesky_solve_batched = spd_solve_batched
