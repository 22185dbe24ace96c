"""Fused gather+Gram+regularise+solve for one ALS bucket, on Hopper.

Port of ``predictionio_tpu/ops/fused_als.py``.  For each bucket row it
solves ``(gram0 + sum_k cw_k v_k v_k^T + reg I) x = sum_k bw_k v_k`` with
``v_k = table[idx[:, k]]``, building the normal equations and solving
them without writing the ``[B, K, R]`` gathered rows to device memory.

The TPU package has two kernels for this function, ``"taa"`` and
``"dma"``, which differ only in how table rows reach VMEM.
``csrc/fused_als.cu`` has the same two forms: ``"taa"`` loads each
chunk's rows from global memory (L2) into a shared-memory tile, ``"dma"``
double-buffers the tile and fills it with ``cp.async`` while the previous
chunk accumulates.  Both build the Gram on the tensor cores (TF32 with a
high/low split of every operand, f32 accumulation) and solve by a
blocked Cholesky factorisation by the whole block (warp 0 factors
8-column panels, all warps update).  :func:`resolve_gather_impl`
picks a form for ``fused_gather="auto"`` from the gather probes'
measured order (:func:`predictionio_tpu_torch.ops.gather_probe.
preferred_order`), as the reference does.

:func:`fused_tile_plan` budgets the kernel's shared memory and registers
(the TPU planner budgeted VMEM and SMEM) and, given the bucket's height,
splits long rows into segments so the bucket fills the card's SMs
(:func:`sm_count` of the tensors' device): pass 1 runs
``B * segments`` blocks, each writing its segment's partial Gram and rhs
to a workspace, and pass 2 (``fused_als_reduce``, its own launch count)
sums each row's partials and solves: where the rows are too few to fill
the card, groups of consecutive segments first, on :func:`reduce_plan`'s
grid, then the group sums, each in a fixed order.
:func:`fused_reduce_solve` is pass 2's wrapper;
:func:`fused_partials_reference` and :func:`fused_reduce_solve_reference`
are the plain versions of the two passes.
On a CPU tensor :func:`fused_gather_gram_solve` runs the plain version,
:func:`fused_gather_gram_solve_reference`, whatever the form; on a CUDA
tensor it launches the form it names or raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from ..device import PRECISIONS
from ._build import check_tensor, launch
from .solve import MAX_RANK, SMS, sm_count, spd_solve_reference

__all__ = [
    "GATHER_IMPLS",
    "FusedPlan",
    "ReducePlan",
    "copy_piece_bytes",
    "fused_gather_gram_solve",
    "fused_gather_gram_solve_reference",
    "fused_partials_reference",
    "fused_reduce_solve",
    "fused_reduce_solve_reference",
    "fused_side_fits",
    "fused_split_reference",
    "fused_tile_plan",
    "reduce_plan",
    "resolve_gather_impl",
    "sm_count",
    "split_segments",
]

# the reference's in-kernel gather forms, each a form of csrc/fused_als.cu
GATHER_IMPLS = ("taa", "dma")

# csrc/fused_als.cu: blocks of 8 warps sharing the Gram's m16n8 tiles
THREADS = 256
WARPS = THREADS // 32
# accumulator tiles per warp the kernels are compiled for
TPW_CHOICES = (1, 3, 6, 10)
# an H100 SM has 228 KB of shared memory, of which the runtime reserves
# 1 KB per resident block; the planner keeps room for two blocks per SM
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED_PER_BLOCK = 1024
BLOCKS_PER_SM = 2
SMEM_BUDGET = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED_PER_BLOCK
# registers: 64K per SM shared by BLOCKS_PER_SM blocks of THREADS threads
REGS_PER_THREAD = 65536 // (THREADS * BLOCKS_PER_SM)
# registers a thread spends besides its accumulator tiles (fragments,
# their high/low parts, addresses, loop counters), a planning allowance
REGS_OVERHEAD = 48
# K-chunk heights the planner tries, largest first
KC_CHOICES = (128, 64, 32, 16, 8)
# the split: enough blocks for WAVES waves over the card's SMs, but no
# segment shorter than MIN_SEGMENT slots; SMS (ops/solve.py, an H100
# SXM's count) when no device is named.  WAVES is the least of
# chip_smoke.py's sweep over the ML-20M trainer's buckets (both fused
# halves summed).
WAVES = 16
MIN_SEGMENT = 1024
# pass 2's two constants, defined in csrc/fused_als.cu (kSumThreads,
# kUnroll; tests/test_torch_fused_reduce.py holds these copies to them):
# threads of a first-stage block (fused_als_group_sum_kernel), each
# summing one load of VEC floats, and the slices a thread loads in one
# batch: the second stage alone sums a row of up to two batches (a first
# stage costs more there, kernel_variants.py reduce)
SUM_THREADS = 64
REDUCE_UNROLL = 8


class FusedPlan(NamedTuple):
    """Launch plan of the fused kernel.

    ``tile``: m16n8 accumulator tiles per warp (the block's 8 warps share
    the lower triangle's tiles and the rhs tiles).  ``kc``: table rows
    staged in shared memory per K chunk.  ``smem_bytes``: the block's
    dynamic shared memory.  ``regs``: the planner's estimate of registers
    per thread.  ``segments`` and ``seg_len``: each row's K slots run on
    ``segments`` blocks of ``seg_len`` slots (a whole number of chunks).
    ``workspace_bytes``: the f32 partials of a split bucket, ``B *
    segments * (R(R+1)/2 + R) * 4``, or 0 when ``segments == 1``."""

    tile: int
    kc: int
    smem_bytes: int
    regs: int
    segments: int = 1
    seg_len: int = 0
    workspace_bytes: int = 0


def _pow2_ceil(x: int) -> int:
    return 1 << (max(int(x), 1) - 1).bit_length()


def _pad16(r: int) -> int:
    return -(-r // 16) * 16


def stride_bytes(r: int, elem_bytes: int) -> int:
    """Row stride of a staged tile (csrc/fused_als.cu ``stride_words``):
    f32 rows take ``pad16(R) + 8`` words, bf16 rows ``pad16(R)/2 + 4``,
    so a fragment load's four rows fall on disjoint banks."""
    if elem_bytes == 4:
        return 4 * (_pad16(r) + 8)
    return 4 * (_pad16(r) // 2 + 4)


def tiles_per_warp(r: int) -> int:
    """The kernels' accumulator tiles per warp at rank ``r``: the
    smallest of :data:`TPW_CHOICES` covering the ``m16 (m16 + 2)`` tiles
    (``m16 = pad16(R) / 16``) over 8 warps."""
    m16 = _pad16(r) // 16
    need = -(-m16 * (m16 + 2) // WARPS)
    return min(c for c in TPW_CHOICES if c >= need)


def partial_floats(r: int) -> int:
    """Floats of one row's partial: the packed lower triangle and rhs."""
    return r * (r + 1) // 2 + r


def fused_smem_bytes(
    r: int, kc: int, table_bytes: int = 4, gather_impl: str = "taa"
) -> int:
    """Shared memory of one block (csrc/fused_als.cu ``taa_smem_bytes``
    and ``dma_smem_bytes``).  ``"taa"``: one ``[KC, stride]`` f32 row
    tile (the ``[R, R+1]`` f32 system reuses it after the last chunk)
    and the chunk's cw, bw and idx (KC each, 4 bytes).  ``"dma"``: two
    ``[KC, stride]`` tiles of raw table rows (``table_bytes`` each; the
    system reuses them) and two sets of cw, bw and idx."""
    system = 4 * r * (r + 1)
    if gather_impl == "dma":
        tiles = 2 * kc * stride_bytes(r, table_bytes)
        return max(tiles, system) + 2 * 3 * kc * 4
    return max(kc * stride_bytes(r, 4), system) + 3 * kc * 4


def split_segments(
    b: Optional[int], k: int, kc: int, sms: int = SMS,
    waves: Optional[int] = None,
) -> tuple[int, int]:
    """``(segments, seg_len)`` for a ``[b, k]`` bucket with chunks of
    ``kc``: a bucket of fewer than ``waves * sms`` rows splits each row
    into about ``waves * sms / b`` segments, no shorter than
    :data:`MIN_SEGMENT` slots, each a whole number of chunks.  ``b`` None
    (height unknown) gives one segment; ``waves`` None is
    :data:`WAVES` as it stands at the call."""
    if k <= 0:
        return 1, 0
    if waves is None:
        waves = WAVES
    s = 1
    if b is not None and 0 < b < waves * sms:
        s = max(1, min(-(-waves * sms // b), k // MIN_SEGMENT))
    seg = -(-(-(-k // s)) // kc) * kc
    return -(-k // seg), seg


class ReducePlan(NamedTuple):
    """Launch plan of pass 2 (csrc/fused_als.cu ``fused_als_reduce``).

    ``groups`` G of ``seg_per_group`` consecutive segments each (the last
    may hold fewer).  With ``scratch_bytes`` > 0 the first stage sums
    each group on a grid of ``tiles`` blocks along the ``B * P`` entries
    times G (``blocks``) into that ``[B, G, P]`` f32 scratch, and the
    second stage, a block per row, sums the G group sums and solves;
    else (G = 1, ``blocks`` 0) the second stage sums the S partials
    itself.  ``vec``: floats a load, 4 where P is a multiple of 4 (the
    kernel itself takes 1 for partials that are not 16-byte aligned,
    on more tiles)."""

    groups: int
    seg_per_group: int
    vec: int
    tiles: int
    blocks: int
    scratch_bytes: int


@functools.lru_cache(maxsize=1024)
def reduce_plan(
    b: int, s: int, r: int, sms: int = SMS, threads: int = SUM_THREADS,
) -> ReducePlan:
    """Plan pass 2 for ``[b, s, P]`` partials of rank ``r`` (``P = R(R+1)/2
    + R``, ``s >= 1``) on first-stage blocks of ``threads`` (the
    kernel's).  One stage where ``b`` rows fill the card (``b >= 2 *
    sms``) or ``s <= 2 * REDUCE_UNROLL`` (two batches of loads a thread).
    Else the first stage sums groups of ``seg_per_group = max(2, s //
    ceil(2 sms / tiles))`` segments: the fewest groups that give it at
    least ``2 * sms`` blocks (one where the tiles alone do), no group a
    single segment.  Cached: the wrapper asks for it every call."""
    p = partial_floats(r)
    vec = 4 if p % 4 == 0 else 1
    tiles = -(-b * p // (threads * vec))
    target = 2 * sms
    if b >= target or s <= 2 * REDUCE_UNROLL:
        return ReducePlan(1, s, vec, tiles, 0, 0)
    spg = max(2, s // -(-target // tiles))
    groups = -(-s // spg)
    return ReducePlan(groups, spg, vec, tiles, tiles * groups,
                      b * groups * p * 4)


def fused_tile_plan(
    m: int, r: int, k: int, table_bytes: int = 4, gather_impl: str = "taa",
    b: Optional[int] = None, sms: int = SMS, waves: Optional[int] = None,
) -> Optional[FusedPlan]:
    """Plan the kernel for a ``[M, R]`` table and a ``[b, K]`` bucket.

    The chunk height of the ``"taa"`` form is the largest of
    :data:`KC_CHOICES` that is no taller than K rounded up to a power of
    two (at least 8) and keeps the block within :data:`SMEM_BUDGET`.
    The ``"dma"`` form takes the largest chunk whose two buffers fit in
    the ``"taa"`` form's one f32 tile at the same K (half its height for
    an f32 table), at least 8, so both forms keep the same blocks per
    SM.  The table's height does not enter: rows are read from device
    memory (L2).  The ``"dma"`` form copies rows in 4-byte pieces at
    least, so a bf16 table with an odd R has no ``"dma"`` plan.  With the
    bucket's height ``b`` the plan splits long rows over ``waves`` waves
    of ``sms`` blocks (:func:`split_segments`; None: :data:`WAVES`).
    Returns None when no
    plan fits (R > 128)."""
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
    tile = tiles_per_warp(r)
    regs = 4 * tile + REGS_OVERHEAD
    if regs > REGS_PER_THREAD:
        return None
    kc_cap = max(8, _pow2_ceil(k))
    taa_kc = next(
        (c for c in KC_CHOICES if c <= kc_cap
         and fused_smem_bytes(r, c, 4, "taa") <= SMEM_BUDGET),
        None,
    )
    if taa_kc is None:
        return None
    kc = taa_kc
    if gather_impl == "dma":
        room = taa_kc * stride_bytes(r, 4)
        kc = next(
            (c for c in KC_CHOICES
             if c <= taa_kc and 2 * c * stride_bytes(r, table_bytes) <= room),
            KC_CHOICES[-1],
        )
    smem = fused_smem_bytes(r, kc, table_bytes, gather_impl)
    if smem > SMEM_BUDGET:
        return None
    segments, seg_len = split_segments(b, k, kc, sms, waves)
    ws = b * segments * partial_floats(r) * 4 if segments > 1 else 0
    return FusedPlan(tile=tile, kc=kc, smem_bytes=smem, regs=regs,
                     segments=segments, seg_len=seg_len, workspace_bytes=ws)


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
    :func:`~predictionio_tpu_torch.ops.gather_probe.preferred_order` on
    ``device`` (the static order for ``"cpu"``, the probes' measured
    order on the card, which None names: it raises without one) and
    takes the first form with a plan.  ``m`` and
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


def _rank_of_partials(p: int) -> int:
    """R with ``R(R+1)/2 + R == p`` (rounded; callers check)."""
    return int(round(((9 + 8 * p) ** 0.5 - 3) / 2))


def fused_partials_reference(
    table: torch.Tensor,
    idx: torch.Tensor,
    cw: torch.Tensor,
    bw: torch.Tensor,
    seg_len: int,
) -> torch.Tensor:
    """Plain PyTorch version of pass 1 of a split bucket: for each row and
    each segment of ``seg_len`` slots (zero-weighted past K), the partial
    Gram ``sum cw v v^T`` packed as its lower triangle, then the partial
    rhs ``sum bw v``, in f32: ``[B, S, R(R+1)/2 + R]``."""
    f32 = torch.float32
    b, k = idx.shape
    r = table.shape[1]
    s = -(-k // seg_len) if k > 0 else 1
    pad = s * seg_len - k
    idx_p = torch.nn.functional.pad(idx.long(), (0, pad))
    cw_p = torch.nn.functional.pad(cw.to(f32), (0, pad)).view(b, s, seg_len)
    bw_p = torch.nn.functional.pad(bw.to(f32), (0, pad)).view(b, s, seg_len)
    rows = table[idx_p].to(f32).view(b, s, seg_len, r)
    a_part = torch.einsum("bsk,bskr,bskt->bsrt", cw_p, rows, rows)
    b_part = torch.einsum("bsk,bskr->bsr", bw_p, rows)
    # packed lower triangle, entry i (i + 1) / 2 + j holding (i, j)
    ti, tj = torch.tril_indices(r, r, device=table.device)
    return torch.cat([a_part[:, :, ti, tj], b_part], dim=2).contiguous()


def fused_reduce_solve_reference(
    partials: torch.Tensor,
    reg: torch.Tensor,
    gram0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of pass 2: each row's partials summed in
    segment order, unpacked into the symmetric Gram and the rhs,
    ``gram0`` and ``reg*I`` added, then the plain Gauss-Jordan solve."""
    f32 = torch.float32
    b, s, p = partials.shape
    r = _rank_of_partials(p)
    tri = r * (r + 1) // 2
    total = partials[:, 0].to(f32)
    for i in range(1, s):
        total = total + partials[:, i].to(f32)
    ti, tj = torch.tril_indices(r, r, device=partials.device)
    A = torch.zeros((b, r, r), dtype=f32, device=partials.device)
    A[:, ti, tj] = total[:, :tri]
    A[:, tj, ti] = total[:, :tri]
    if gram0 is not None:
        A = A + gram0.to(f32)
    eye = torch.eye(r, dtype=f32, device=partials.device)
    A = A + reg.to(f32)[:, None, None] * eye
    return spd_solve_reference(A, total[:, tri:].contiguous())


def fused_split_reference(
    table: torch.Tensor,
    idx: torch.Tensor,
    cw: torch.Tensor,
    bw: torch.Tensor,
    reg: torch.Tensor,
    gram0: Optional[torch.Tensor] = None,
    seg_len: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of a split bucket's two passes
    (:func:`fused_partials_reference`, then
    :func:`fused_reduce_solve_reference`).  ``seg_len`` None is one
    segment of the whole K."""
    seg = idx.shape[1] if seg_len is None else int(seg_len)
    if seg <= 0:
        seg = 1
    return fused_reduce_solve_reference(
        fused_partials_reference(table, idx, cw, bw, seg), reg, gram0
    )


def fused_reduce_solve(
    partials: torch.Tensor,   # [B, S, R(R+1)/2 + R] f32 from pass 1
    reg: torch.Tensor,        # [B] f32
    gram0: Optional[torch.Tensor] = None,  # [R, R] f32, symmetric
) -> torch.Tensor:
    """Pass 2 of a split bucket: sum each row's ``S`` partials, add
    ``gram0`` (None: zeros) and ``reg*I``, solve.  A CPU tensor takes
    :func:`fused_reduce_solve_reference`; a CUDA tensor launches
    ``fused_als_reduce`` on :func:`reduce_plan`'s plan (one count under
    that key, however many stages run) or raises."""
    if partials.device.type == "cpu":
        return fused_reduce_solve_reference(partials, reg, gram0)
    if partials.device.type != "cuda":
        raise ValueError(f"unsupported device {partials.device}")
    dev = partials.device
    b, s, p = partials.shape
    r = _rank_of_partials(p)
    if r < 1 or r > MAX_RANK or partial_floats(r) != p or s < 1:
        raise ValueError(
            f"partials of shape {tuple(partials.shape)} are not [B, S, "
            "R(R+1)/2 + R] for a rank the kernel takes"
        )
    check_tensor("partials", partials, torch.float32, (b, s, p), dev)
    check_tensor("reg", reg, torch.float32, (b,), dev)
    if gram0 is not None:
        check_tensor("gram0", gram0, torch.float32, (r, r), dev)
    plan = reduce_plan(b, s, r, sm_count(dev))
    x = torch.empty((b, r), dtype=torch.float32, device=dev)
    scratch = None
    if plan.scratch_bytes:
        scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                              device=dev)
    launch("pio_fused_als_reduce", "fused_als_reduce", dev,
           partials.data_ptr(), reg.data_ptr(),
           0 if gram0 is None else gram0.data_ptr(), x.data_ptr(),
           0 if scratch is None else scratch.data_ptr(),
           b, r, s, plan.seg_per_group, partials.numel() * 4,
           plan.scratch_bytes)
    return x


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
    at f32 accuracy (TF32 parts with a high/low split, f32 sums), which is
    ``"highest"``.  ``plan`` overrides :func:`fused_tile_plan` (which
    splits long rows of a short bucket across blocks: then a second
    launch, ``fused_als_reduce``, sums the partials and solves).
    ``gather_impl`` names the kernel form that launches; the plain
    version is the same for both."""
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
            m, r, k, table.element_size(), gather_impl, b=b,
            sms=sm_count(dev),
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
    # a split bucket's pass 1 writes the partials, pass 2 solves
    ws = None
    if plan.workspace_bytes:
        ws = torch.empty(plan.workspace_bytes // 4, dtype=torch.float32,
                         device=dev)
    args = (
        table.data_ptr(), idx.data_ptr(), cw.data_ptr(), bw.data_ptr(),
        reg.data_ptr(), gram0.data_ptr(), x.data_ptr(),
        0 if ws is None else ws.data_ptr(),
        b, k, m, r, plan.kc, plan.tile, plan.smem_bytes, plan.segments,
        plan.seg_len, plan.workspace_bytes,
    )
    if gather_impl == "dma":
        launch(f"pio_fused_als_dma_{suffix}", "fused_als_dma", dev, *args,
               copy_piece_bytes(table))
    else:
        # the "taa" form has no cp.async piece size
        launch(f"pio_fused_als_{suffix}", "fused_als", dev, *args, 0)
    if ws is None:
        return x
    return fused_reduce_solve(
        ws.view(b, plan.segments, partial_floats(r)), reg, gram0
    )


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
