"""Fused gather+Gram+regularise+solve for one ALS bucket, on Hopper.

Port of ``predictionio_tpu/ops/fused_als.py``.  For each bucket row it
solves ``(gram0 + sum_k cw_k v_k v_k^T + reg I) x = sum_k bw_k v_k`` with
``v_k = table[idx[:, k]]``, building the normal equations and solving
them in one pass so the ``[B, K, R]`` gathered rows never reach device
memory.

The TPU package has two kernels for this function, ``"taa"`` and
``"dma"``, which differ only in how table rows reach VMEM.
``csrc/fused_als.cu`` has the same two forms: ``"taa"`` loads each
chunk's rows from global memory (L2) into a shared-memory tile, ``"dma"``
double-buffers the tile and fills it with ``cp.async`` while the previous
chunk accumulates.  :func:`resolve_gather_impl` picks one for
``fused_gather="auto"`` from the gather probes' measured order
(:func:`predictionio_tpu_torch.ops.gather_probe.preferred_order`), as the
reference does.

:func:`fused_tile_plan` budgets the kernel's shared memory and registers
(the TPU planner budgeted VMEM and SMEM).  On a CPU tensor
:func:`fused_gather_gram_solve` runs the plain version,
:func:`fused_gather_gram_solve_reference`, whatever the form; on a CUDA
tensor it launches the form it names or raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..device import PRECISIONS
from ._build import LAUNCHES, check_launch, check_tensor, library
from .solve import MAX_RANK, spd_solve_reference

__all__ = [
    "GATHER_IMPLS",
    "FusedPlan",
    "copy_piece_bytes",
    "fused_gather_gram_solve",
    "fused_gather_gram_solve_reference",
    "fused_side_fits",
    "fused_tile_plan",
    "resolve_gather_impl",
]

# the reference's in-kernel gather forms, each a form of csrc/fused_als.cu
GATHER_IMPLS = ("taa", "dma")

# csrc/fused_als.cu: 256 threads as a 16 x 16 accumulator grid
THREADS = 256
GRID = 16
# an H100 SM has 228 KB of shared memory, of which the runtime reserves
# 1 KB per resident block; the planner keeps room for two blocks per SM
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
BLOCKS_PER_SM = 2
SMEM_BUDGET = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK
# registers: 64K per SM shared by BLOCKS_PER_SM blocks of THREADS threads
REGS_PER_THREAD = 65536 // (THREADS * BLOCKS_PER_SM)
# registers a thread spends besides its accumulator tile and operands
# (addresses, loop counters, the rhs sum), a planning allowance
REGS_OVERHEAD = 40
# K-chunk heights the planner tries, largest first
KC_CHOICES = (128, 64, 32, 16, 8)


class FusedPlan(NamedTuple):
    """Launch plan of the fused kernel.

    ``tile``: accumulator rows and columns per thread in each direction
    (the 16 x 16 thread grid covers 16 * tile >= R).  ``kc``: table rows
    gathered into shared memory per K chunk.  ``smem_bytes``: the block's
    dynamic shared memory.  ``regs``: the planner's estimate of registers
    per thread."""

    tile: int
    kc: int
    smem_bytes: int
    regs: int


def _pow2_ceil(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def fused_smem_bytes(
    r: int, kc: int, table_bytes: int = 4, gather_impl: str = "taa"
) -> int:
    """Shared memory of one block (csrc/fused_als.cu ``taa_smem_bytes``
    and ``dma_smem_bytes``).  Both forms hold the ``[R, R+1]``
    Gauss-Jordan system and its pivot row (R+1) and column (R) scratch in
    f32.  ``"taa"`` adds one ``[KC, R]`` f32 row tile and the chunk's cw,
    bw and idx (KC each, 4 bytes); ``"dma"`` double-buffers both: two
    ``[KC, R]`` tiles of raw table rows (``table_bytes`` each) and two
    sets of cw, bw and idx."""
    gj = 4 * (r * (r + 1) + (r + 1) + r)
    if gather_impl == "dma":
        return gj + 2 * kc * r * table_bytes + 2 * 3 * kc * 4
    return gj + 4 * (kc * r + 3 * kc)


def fused_tile_plan(
    m: int, r: int, k: int, table_bytes: int = 4, gather_impl: str = "taa"
) -> Optional[FusedPlan]:
    """Plan the kernel for a ``[M, R]`` table and ``[*, K]`` bucket.

    The tile is the smallest power of two with ``16 * tile >= R``.  The
    chunk height is the largest of :data:`KC_CHOICES` that is no taller
    than K rounded up to a power of two (at least 8) and keeps the block
    within :data:`SMEM_BUDGET`.  The table's height does not enter: rows
    are read from device memory (L2).  Its element width enters only the
    ``"dma"`` form, which stages raw rows; that form copies rows in
    4-byte pieces at least, so a bf16 table with an odd R has no
    ``"dma"`` plan.  Returns None when no plan fits (R > 128)."""
    if gather_impl not in GATHER_IMPLS:
        raise ValueError(
            f"gather_impl must be one of {GATHER_IMPLS}, got {gather_impl!r}"
        )
    if table_bytes not in (2, 4):
        raise ValueError(f"table_bytes must be 2 or 4, got {table_bytes}")
    if r < 1 or r > MAX_RANK:
        return None
    if gather_impl == "dma" and (r * table_bytes) % 4:
        return None
    tile = _pow2_ceil(-(-r // GRID))
    regs = tile * tile + 2 * tile + REGS_OVERHEAD
    if regs > REGS_PER_THREAD:
        return None
    kc_cap = max(8, _pow2_ceil(k))
    for kc in KC_CHOICES:
        if kc > kc_cap:
            continue
        smem = fused_smem_bytes(r, kc, table_bytes, gather_impl)
        if smem <= SMEM_BUDGET:
            return FusedPlan(tile=tile, kc=kc, smem_bytes=smem, regs=regs)
    return None


def fused_side_fits(
    m: int, r: int, k_max: int, table_bytes: int = 4,
    gather_impl: str = "taa",
) -> bool:
    """Does a fused plan exist for this side?"""
    return fused_tile_plan(
        m, r, max(k_max, 1), table_bytes, gather_impl
    ) is not None


def resolve_gather_impl(
    m: int, r: int, table_bytes: int = 4, precision=None,
    requested: str = "auto", device=None,
) -> Optional[str]:
    """Resolve ``ALSConfig(fused_gather=...)`` to a form that can run.

    An explicit form resolves to itself when it has a plan at rank ``r``
    and this table width, else to None (the caller then raises: no
    library path stands in).  ``"auto"`` walks
    :func:`~predictionio_tpu_torch.ops.gather_probe.preferred_order`
    (the static order on the CPU, the probes' measured order on the
    card) and takes the first form with a plan.  ``m`` and
    ``precision`` are the reference's arguments; no Hopper plan depends
    on them."""
    if requested in GATHER_IMPLS:
        if fused_tile_plan(m, r, 8, table_bytes, requested) is None:
            return None
        return requested
    if requested != "auto":
        raise ValueError(
            f"fused_gather must be 'auto' or one of {GATHER_IMPLS}, "
            f"got {requested!r}"
        )
    from .gather_probe import preferred_order

    for impl in preferred_order(r, table_bytes, device=device):
        if fused_tile_plan(m, r, 8, table_bytes, impl) is not None:
            return impl
    return None


def fused_gather_gram_solve_reference(
    table: torch.Tensor,
    idx: torch.Tensor,
    cw: torch.Tensor,
    bw: torch.Tensor,
    reg: torch.Tensor,
    gram0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: gather with ``table[idx]`` (widened to
    f32), einsum Gram and rhs, add ``gram0`` and ``reg*I``, then the
    plain Gauss-Jordan solve."""
    r = table.shape[1]
    rows = table[idx.long()].to(torch.float32)               # [B, K, R]
    A = torch.einsum("bk,bkr,bks->brs", cw.to(torch.float32), rows, rows)
    if gram0 is not None:
        A = A + gram0.to(torch.float32)
    eye = torch.eye(r, dtype=torch.float32, device=table.device)
    A = A + reg.to(torch.float32)[:, None, None] * eye
    b = torch.einsum("bk,bkr->br", bw.to(torch.float32), rows)
    return spd_solve_reference(A, b)


def fused_gather_gram_solve(
    table: torch.Tensor,    # [M, R] opposite factor table (f32 or bf16)
    idx: torch.Tensor,      # [B, K] int32 opposite ids, masked -> 0
    cw: torch.Tensor,       # [B, K] f32 Gram weights (0 where masked)
    bw: torch.Tensor,       # [B, K] f32 rhs weights (0 where masked)
    reg: torch.Tensor,      # [B]    f32 ridge diagonal
    gram0: Optional[torch.Tensor] = None,  # [R, R] f32 base Gram
    interpret: Optional[bool] = None,
    plan: Optional[FusedPlan] = None,
    precision=None,
    gather_impl: str = "taa",
) -> torch.Tensor:
    """One fused normal-equation build and solve for a bucket of rows.

    Returns ``x[B, R]`` solving ``(gram0 + sum_k cw_k v_k v_k^T + reg I)
    x = sum_k bw_k v_k`` with ``v_k = table[idx[:, k]]``.  Masking rides
    the weights: a masked entry has ``cw = bw = 0`` and ``idx`` pointing
    at a valid row, conventionally 0.

    The signature is the reference's.  ``interpret`` has no meaning here
    (the tensors' device picks the kernel or the plain version) and must
    be None or False.  ``precision`` is accepted as ``None`` or one of
    ``"highest"``, ``"high"``, ``"default"``: the kernel always multiplies
    and sums in f32, which is ``"highest"``.  ``plan`` overrides
    :func:`fused_tile_plan`.  ``gather_impl`` names the kernel form that
    launches; the plain version is the same for both."""
    if gather_impl not in GATHER_IMPLS:
        raise ValueError(
            f"gather_impl must be one of {GATHER_IMPLS}, got {gather_impl!r}"
        )
    if precision is not None and precision not in PRECISIONS:
        raise ValueError(
            f"precision must be None or one of {PRECISIONS}, "
            f"got {precision!r}"
        )
    if interpret:
        raise ValueError(
            "interpret mode does not exist in the port: CPU tensors run "
            "the plain version, CUDA tensors the kernel"
        )
    if table.device.type == "cpu":
        return fused_gather_gram_solve_reference(
            table, idx, cw, bw, reg, gram0
        )
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    dev = table.device
    m, r = table.shape
    b, k = idx.shape
    if plan is None:
        plan = fused_tile_plan(
            m, r, k, table.element_size(), gather_impl
        )
    if plan is None:
        raise ValueError(
            f"fused ALS kernel: no {gather_impl!r} plan for rank {r} with "
            f"{table.element_size()}-byte elements (rank at most {MAX_RANK}"
            ", and even for the 'dma' form of a bf16 table)"
        )
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    suffix = "f32" if table.dtype == torch.float32 else "bf16"
    if gram0 is None:
        gram0 = torch.zeros((r, r), dtype=torch.float32, device=dev)
    check_tensor("table", table, table.dtype, (m, r), dev)
    check_tensor("idx", idx, torch.int32, (b, k), dev)
    check_tensor("cw", cw, torch.float32, (b, k), dev)
    check_tensor("bw", bw, torch.float32, (b, k), dev)
    check_tensor("reg", reg, torch.float32, (b,), dev)
    check_tensor("gram0", gram0, torch.float32, (r, r), dev)
    x = torch.empty((b, r), dtype=torch.float32, device=dev)
    args = [
        table.data_ptr(), idx.data_ptr(), cw.data_ptr(), bw.data_ptr(),
        reg.data_ptr(), gram0.data_ptr(), x.data_ptr(),
        b, k, m, r, plan.kc, plan.tile, plan.smem_bytes,
    ]
    if gather_impl == "dma":
        fn = getattr(library(), f"pio_fused_als_dma_{suffix}")
        args.append(copy_piece_bytes(table))
        key = "fused_als_dma"
    else:
        fn = getattr(library(), f"pio_fused_als_{suffix}")
        key = "fused_als"
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, key)
    LAUNCHES[key] += 1
    return x


def copy_piece_bytes(table: torch.Tensor) -> int:
    """Bytes per ``cp.async`` piece for rows of ``table``: 16 where every
    row starts on a 16-byte boundary, else 4.  Raises when a row is not a
    whole number of 4-byte pieces (a bf16 table with an odd R) or the
    table is not 4-byte aligned: the kernels never read a row
    misaligned."""
    row_bytes = table.shape[-1] * table.element_size()
    if row_bytes % 16 == 0 and table.data_ptr() % 16 == 0:
        return 16
    if row_bytes % 4 or table.data_ptr() % 4:
        raise ValueError(
            f"rows of {row_bytes} bytes at address {table.data_ptr():#x} "
            "are not 4-byte pieces: the cp.async forms need an even rank "
            "for a bf16 table"
        )
    return 4
