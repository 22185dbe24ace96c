"""Batched SPD solve: the Hopper register-resident kernel and its plain version.

Port of ``predictionio_tpu/ops/solve.py``.  ``spd_solve_batched`` solves
``A[i] x[i] = b[i]`` for a batch of symmetric positive definite systems
(ALS always solves ``Gram + reg*I`` with ``reg > 0``).  On a CUDA tensor
it launches ``csrc/gj_solve.cu``: each system's rows sit in registers,
two a thread up to rank 64 and one at 128, and a root-free Cholesky
factorisation of the lower triangle and one back substitution solve it,
several systems a block at small rank (see the note there;
:func:`gj_plan` is its launch plan).  On
a CPU tensor it runs :func:`spd_solve_reference`, the lock-step
Gauss-Jordan elimination of the TPU kernel in plain PyTorch.  Both clamp
a pivot at ``_EPS``, so a zero system solves to zero.  There is no path
that skips the kernel on the card.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ._build import launch

__all__ = [
    "GjPlan",
    "MAX_RANK",
    "SMS",
    "cholesky_solve_batched",
    "gj_plan",
    "gj_rows_per_thread",
    "sm_count",
    "spd_solve_batched",
    "spd_solve_reference",
]

# the reference elimination's pivot clamp (predictionio_tpu/ops/solve.py)
_EPS = 1e-20

# the kernels' largest rank (csrc/gj_solve.cu kMaxRank; csrc/fused_als.cu
# holds the same limit)
MAX_RANK = 128

# csrc/gj_solve.cu: the padded ranks the kernel is compiled for, the
# most threads a block of several systems holds, and the shared memory
# such a block keeps within (the most a block takes without opting in)
GJ_RANKS = (16, 32, 64, 128)
_GJ_THREADS = 128
_GJ_SMEM = 48 * 1024

# an H100 SXM's streaming multiprocessors, where no device is named
SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA ``device`` (a
    ``torch.device`` or its index)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


class GjPlan(NamedTuple):
    """Launch plan of ``csrc/gj_solve.cu``: the padded rank the systems
    run at, threads a block, systems a block, the grid and one block's
    shared memory (each system's staged ``[RP, RP+1]`` triangle and two
    step vectors of ``RP + 4`` floats)."""

    rank_pad: int
    threads: int
    systems: int
    blocks: int
    smem_bytes: int


def gj_rows_per_thread(rank_pad: int) -> int:
    """Rows of a system one thread holds in registers
    (``csrc/gj_solve.cu`` ``rows_per_thread``): two up to rank 64, one
    at rank 128."""
    return 1 if rank_pad == 128 else 2


def _gj_smem_bytes(rank_pad: int, systems: int) -> int:
    return 4 * systems * (rank_pad * (rank_pad + 1) + 2 * (rank_pad + 4))


@functools.lru_cache(maxsize=1024)
def gj_plan(r: int, b: int, sms: int = SMS) -> GjPlan:
    """Plan of the SPD solve kernel for ``b`` systems of rank ``r``
    (1..128) on a card of ``sms`` SMs (cached: the wrapper asks on every
    call).  The rank is padded to the least of :data:`GJ_RANKS` that
    covers it, and a system takes ``RP / gj_rows_per_thread(RP)``
    threads.  A system of more than one warp (rank 128) has a block of
    its own.  Smaller ones share a block of up to 128 threads and 48 KB
    of shared memory, but no more than a power of two covering
    ``b / sms``, so that a small batch still gives every SM a block, and
    no fewer than one warp takes."""
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} is outside 1..{MAX_RANK}")
    rp = min(p for p in GJ_RANKS if p >= r)
    ts = rp // gj_rows_per_thread(rp)
    most = 1
    if ts <= 32:
        most = _GJ_THREADS // ts
        while most > 1 and _gj_smem_bytes(rp, most) > _GJ_SMEM:
            most //= 2
    least = max(1, 32 // ts)
    per_sm = -(-max(b, 1) // sms)
    systems = min(most, max(least, 1 << (per_sm - 1).bit_length()))
    return GjPlan(rank_pad=rp, threads=systems * ts, systems=systems,
                  blocks=-(-b // systems),
                  smem_bytes=_gj_smem_bytes(rp, systems))


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
    (R <= 128, contiguous float32 on one device) or raise.  The kernel
    reads only the lower triangle of each A."""
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
    plan = gj_plan(R, B, sm_count(A.device.index))
    x = torch.empty((B, R), dtype=torch.float32, device=A.device)
    launch("pio_gj_solve", "gj_solve", A.device,
           A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R, *plan)
    return x


# the reference's historical name (its first kernel factorised by Cholesky)
cholesky_solve_batched = spd_solve_batched
