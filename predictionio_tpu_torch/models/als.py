"""Block ALS matrix factorization on one CUDA device.

Port of ``predictionio_tpu/models/als.py`` (replicated placement, full
solves).  The host groups each side's rows into power-of-two padded
buckets (ALX-style, arXiv 2112.02194; NumPy, copied from the reference),
and each half-iteration solves every bucket's normal equations on the
device.  Both staging paths group the COO by row with the native O(n)
counting sort (``native/bucketize.cpp`` through
:func:`predictionio_tpu_torch.native.sort_coo_by_row`), as the
reference does.

* ``solver="xla"`` — gather the opposite rows ``[B, K, R]``, einsum the
  Gram matrices, Cholesky-solve through ``torch.linalg`` (the library
  path that stands for the reference's XLA solver);
* ``solver="pallas"`` — the same gather and einsums, then the hand-written
  SPD solve kernel, a Cholesky factorisation in registers (``ops/solve.py``
  → ``ops/csrc/gj_solve.cu``; its plain version is the reference kernel's
  Gauss-Jordan);
* ``solver="fused"`` — the hand-written single-pass gather+Gram+solve
  kernel (``ops/fused_als.py`` → ``ops/csrc/fused_als.cu``), which never
  materialises ``[B, K, R]``.

A half-iteration writes the solved rows into the factor table in place
(the reference's jitted half donated it); :meth:`ALSTrainer.run` copies
its inputs once, so callers keep theirs.

Both regularization conventions are implemented: explicit least squares
with ALS-WR weighted λ (λ·n_row·I, Spark MLlib 1.3) and implicit
Hu-Koren-Volinsky confidence weighting c = 1 + α·r.

Observability is the reference's: every fenced half books
``pio_train_phase_seconds{phase="als.user_half"|"als.item_half"}``,
every sweep reports to the pio-tower session (``obs/tower.py``: run
manifest, convergence watchdog), and ``PIO_TPU_TRACE_ALS=1`` splits each
half into ``als.gather`` / ``als.gram`` / ``als.solve`` spans by timing
truncated halves (``_half_phase_probe``).  The ``train.nan`` fault point
poisons the factors after a sweep.

``solver_mode="subspace"`` sweeps the rank in blocks (iALS++,
:func:`_subspace_sweep`), :meth:`ALSTrainer.train` takes a step
checkpointer (``workflow/checkpoint.py``) and :func:`sweep_train_als`
trains one model a λ in one batched run.

``factor_placement="sharded"`` on a mesh of shards
(``parallel/mesh.py``; the shards may share a card) row-shards both
tables and the rating COO (ALX, arXiv 2112.02194): each half gathers
the opposite table and every shard solves its chunk of every bucket
with the configured solver (:func:`_sharded_half`).  ``coded_shards``
keeps a parity block beside the shards and serves a late or dead shard
from it (coded ALS, arXiv 2105.03631; ``parallel/coded.py``).
:meth:`ALSTrainer.distributed` stages a mesh that spans processes from
each process's own triples.
"""

from __future__ import annotations

import collections
import itertools
import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, fence, matmul_precision, resolve_device
from ..native import sort_coo_by_row
from ..parallel.mesh import fence as mesh_fence, pad_to_multiple
from ..obs import TRAIN_PHASE_SECONDS, get_tracer, tower, xray
from ..resilience import faults
from ..storage.columnar import Ratings

logger = logging.getLogger(__name__)

__all__ = [
    "ALSConfig",
    "ALSFactors",
    "ALSTrainer",
    "Bucket",
    "BucketLayout",
    "build_bucket_layout",
    "rmse",
    "sweep_train_als",
    "train_als",
]

# cap on B*K entries of a single bucket chunk: bounds the [B, K, R]
# gathered intermediate (~1 GiB at rank 64, f32) regardless of dataset size
MAX_ENTRIES_PER_BUCKET = 4 << 20

# kernel launches of the sharded halves by (shard, kernel): the kernels'
# own counts (ops/_build.LAUNCHES), split by the shard that made them
SHARD_LAUNCHES: collections.Counter = collections.Counter()

# the tower watchdog's token of each trainer (ALSTrainer.tower_source)
_TRAINER_TOKENS = itertools.count(1)


@dataclass(frozen=True)
class ALSConfig:
    """The reference's ALS configuration, with the same fields and
    validation (``predictionio_tpu.models.als.ALSConfig``)."""

    rank: int = 10
    num_iterations: int = 20
    lam: float = 0.01
    implicit: bool = False
    alpha: float = 1.0
    seed: int = 3
    # λ·n_row·I (MLlib <=1.3 / ALS-WR) vs plain λ·I
    weighted_lambda: bool = True
    # truncate pathological rows beyond this many ratings (0 = no cap)
    max_ratings_per_row: int = 0
    min_bucket_k: int = 8
    # storage dtype of the factor tables; Gram accumulation,
    # regularization and the solves always run in f32
    compute_dtype: str = "float32"
    # f32 matrix-product precision of the Gram einsums and YᵀY:
    # "highest" is true f32 (TF32 off), "high"/"default" allow TF32
    matmul_precision: str = "highest"
    # batched SPD solver: "xla" (torch.linalg Cholesky), "pallas" (the
    # SPD solve kernel for the solves alone) or "fused" (the
    # single-pass gather+Gram+solve kernel)
    solver: str = "xla"
    # the reference's in-kernel gather form of the fused kernel; every
    # value runs the one Hopper kernel (ops/fused_als.py)
    fused_gather: str = "auto"
    solver_mode: str = "full"
    subspace_size: int = 16
    # dtype the opposite factor table is gathered in: "float32" or
    # "bfloat16" (half the gathered bytes; solves and sums stay f32)
    gather_dtype: str = "float32"
    # the reference's memory-tile slab gather ("grouped") takes the same
    # rows as the row gather, so both values gather rows here
    gather_mode: str = "row"
    retrieval: str = "exact"
    candidate_factor: int = 10
    nprobe: int = 8
    factor_placement: str = "replicated"
    coded_shards: bool = False
    shard_hop_budget_s: float = 0.0
    # training-RMSE cadence in sweeps over a seeded subsample of at most
    # ALSTrainer.LOSS_SAMPLE_MAX triples; 0 disables, None = every sweep
    loss_every: Optional[int] = None

    def __post_init__(self) -> None:
        if self.gather_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"gather_dtype must be 'float32' or 'bfloat16', "
                f"got {self.gather_dtype!r}"
            )
        if self.gather_mode not in ("row", "grouped"):
            raise ValueError(
                f"gather_mode must be 'row' or 'grouped', "
                f"got {self.gather_mode!r}"
            )
        if self.gather_mode == "grouped" and self.solver == "fused":
            raise ValueError(
                "gather_mode='grouped' does not compose with "
                "solver='fused' (the fused kernel gathers in-kernel); "
                "pick one"
            )
        if self.solver not in ("xla", "pallas", "fused"):
            raise ValueError(
                f"solver must be 'xla', 'pallas' or 'fused', "
                f"got {self.solver!r}"
            )
        if self.fused_gather not in ("auto", "taa", "dma"):
            raise ValueError(
                f"fused_gather must be 'auto', 'taa' or 'dma', "
                f"got {self.fused_gather!r}"
            )
        if self.fused_gather != "auto" and self.solver != "fused":
            raise ValueError(
                f"fused_gather={self.fused_gather!r} only applies to "
                "solver='fused'"
            )
        if self.solver_mode not in ("full", "subspace"):
            raise ValueError(
                f"solver_mode must be 'full' or 'subspace', "
                f"got {self.solver_mode!r}"
            )
        if self.solver_mode == "subspace":
            if self.subspace_size < 1:
                raise ValueError(
                    f"subspace_size must be >= 1, got {self.subspace_size}"
                )
            if self.solver == "fused":
                raise ValueError(
                    "solver_mode='subspace' does not compose with "
                    "solver='fused' (the fused kernel solves the full "
                    "R×R system in-kernel); use solver='pallas' or "
                    "'xla'"
                )
        if self.factor_placement not in ("replicated", "sharded"):
            raise ValueError(
                f"factor_placement must be 'replicated' or 'sharded', "
                f"got {self.factor_placement!r}"
            )
        if self.loss_every is not None and self.loss_every < 0:
            raise ValueError(
                f"loss_every must be >= 0, got {self.loss_every}"
            )
        if self.retrieval not in ("exact", "int8", "ivf"):
            raise ValueError(
                f"retrieval must be 'exact', 'int8' or 'ivf', "
                f"got {self.retrieval!r}"
            )
        if self.candidate_factor < 1:
            raise ValueError(
                f"candidate_factor must be >= 1, "
                f"got {self.candidate_factor}"
            )
        if self.nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {self.nprobe}")
        if self.coded_shards:
            if self.factor_placement != "sharded":
                raise ValueError(
                    "coded_shards=True requires "
                    "factor_placement='sharded' (parity is a property "
                    "of the sharded table layout)"
                )
            if self.solver_mode == "subspace":
                raise ValueError(
                    "coded_shards=True does not compose with "
                    "solver_mode='subspace' (the warm-start gather of "
                    "the updating table is not parity-protected)"
                )
        if self.matmul_precision not in ("highest", "high", "default"):
            raise ValueError(
                f"matmul_precision must be 'highest', 'high' or "
                f"'default', got {self.matmul_precision!r}"
            )
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype must be 'float32' or 'bfloat16', "
                f"got {self.compute_dtype!r}"
            )


@dataclass
class ALSFactors:
    """The trained model: factor matrices as host arrays, plus what the
    training run measured (``report``: per-half fenced seconds, sweep
    losses, staging, solver)."""

    user_factors: np.ndarray  # [n_users, rank] float32
    item_factors: np.ndarray  # [n_items, rank] float32
    report: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# Host-side preprocessing: COO -> bucket layout (copied from the reference)
# --------------------------------------------------------------------------


@dataclass
class Bucket:
    k: int             # static pad width (power of two)
    rows: np.ndarray   # [B] row ids
    starts: np.ndarray  # [B] offset of each row's slice in the sorted COO
    counts: np.ndarray  # [B] true rating count (<= k)


@dataclass
class BucketLayout:
    n_rows: int
    col_sorted: np.ndarray  # [nnz] opposite-side ids, grouped by row
    val_sorted: np.ndarray  # [nnz] ratings, grouped by row
    buckets: list[Bucket] = field(default_factory=list)


def build_bucket_layout(
    row_ix: np.ndarray,
    col_ix: np.ndarray,
    val: np.ndarray,
    n_rows: int,
    min_k: int = 8,
    max_per_row: int = 0,
    max_entries: Optional[int] = None,
    batch_multiple: int = 1,
) -> BucketLayout:
    """Group rows by padded rating-count so the device solves static
    shapes.  Rows with zero ratings are excluded (their factors stay at
    init); oversized buckets are split so ``B*K <= max_entries``, and
    each bucket's batch is padded to ``batch_multiple`` (the mesh size of
    the sharded layout, whose offsets are shard-local int64 here, so
    only a single-device layout is held to the int32 range).  The rows
    are grouped by the native counting sort."""
    if batch_multiple == 1 and len(val) >= np.iinfo(np.int32).max:
        raise ValueError(
            f"{len(val):,} ratings exceed the int32 offset range of a "
            "replicated bucket layout; use factor_placement='sharded' "
            "(sharded COO)"
        )
    c_sorted, v_sorted, counts, starts = sort_coo_by_row(
        row_ix, col_ix, val, n_rows
    )
    layout = BucketLayout(
        n_rows=n_rows, col_sorted=c_sorted, val_sorted=v_sorted
    )
    layout.buckets = _assemble_buckets(
        counts, starts, min_k, max_per_row, max_entries,
        n_rows=n_rows, batch_multiple=batch_multiple,
        starts_dtype=np.int32 if batch_multiple == 1 else np.int64,
    )
    return layout


def _assemble_buckets(
    counts: np.ndarray,
    starts: np.ndarray,
    min_k: int = 8,
    max_per_row: int = 0,
    max_entries: Optional[int] = None,
    *,
    n_rows: int = 0,
    batch_multiple: int = 1,
    starts_dtype: type = np.int32,
) -> list[Bucket]:
    """Bucket plan from per-row (counts, starts) alone (shared by the
    host and the device staging paths).

    ``batch_multiple`` (the mesh size of the sharded layout) pads every
    bucket's batch to a multiple of it, as the reference does: padding
    rows carry distinct ids ``n_rows, n_rows + 1, ...`` (out of every
    shard's row range, so no shard writes them) and count 0."""
    if max_entries is None:
        max_entries = MAX_ENTRIES_PER_BUCKET
    if max_per_row and max_per_row > 0:
        eff_counts = np.minimum(counts, max_per_row)
    else:
        eff_counts = counts
    safe = np.maximum(eff_counts, 1)
    k_of_row = np.maximum(
        min_k, 1 << np.ceil(np.log2(safe)).astype(np.int64)
    )
    active = np.nonzero(counts)[0]
    k_active = k_of_row[active]

    buckets: list[Bucket] = []
    m = batch_multiple
    for k in np.unique(k_active):
        k = int(k)
        rows_k = active[k_active == k].astype(np.int32)
        b_cap = max(m, (max_entries // k) // m * m)
        for s in range(0, len(rows_k), b_cap):
            rows = rows_k[s : s + b_cap]
            if m == 1:
                buckets.append(Bucket(
                    k=k, rows=rows,
                    starts=starts[rows].astype(starts_dtype),
                    counts=eff_counts[rows].astype(np.int32),
                ))
                continue
            B = len(rows)
            Bp = pad_to_multiple(B, m)
            rows_p = n_rows + np.arange(Bp, dtype=np.int32)
            starts_p = np.zeros(Bp, dtype=starts_dtype)
            counts_p = np.zeros(Bp, dtype=np.int32)
            rows_p[:B] = rows
            starts_p[:B] = starts[rows]
            counts_p[:B] = eff_counts[rows]
            buckets.append(Bucket(k=k, rows=rows_p, starts=starts_p,
                                  counts=counts_p))
    return buckets


def _plan_shard_layout(
    buckets: list[Bucket], n_dev: int, build_perm: bool = True
) -> tuple[Optional[np.ndarray], list[np.ndarray], int]:
    """Shard-ordered COO plan (copied from the reference): co-partition
    the rating slices with the bucket rows each shard solves.

    Every bucket's batch splits into ``n_dev`` contiguous chunks, chunk
    ``d`` solved by shard ``d``; shard ``d`` holds exactly the rating
    slices of its chunks' rows, bucket by bucket.  Returns ``(perm,
    local_starts, L)``: ``perm`` ``[n_dev, L]`` gathers the row-sorted
    COO into shard-local order (padding positions gather 0 and are never
    read: every access is masked by counts), ``local_starts`` per
    bucket the rows' offsets into their own shard, and ``L`` the padded
    per-shard length.  ``build_perm=False`` skips ``perm`` (None)."""
    offsets = np.zeros(n_dev, dtype=np.int64)
    local_starts: list[np.ndarray] = []
    starts_per_dev: list[list[np.ndarray]] = [[] for _ in range(n_dev)]
    counts_per_dev: list[list[np.ndarray]] = [[] for _ in range(n_dev)]
    for b in buckets:
        Bp = len(b.rows)
        assert Bp % n_dev == 0, "bucket batch dim not padded to mesh size"
        chunk = Bp // n_dev
        ls = np.zeros(Bp, dtype=np.int64)
        for d in range(n_dev):
            sl = slice(d * chunk, (d + 1) * chunk)
            cnts = b.counts[sl].astype(np.int64)
            ls[sl] = offsets[d] + np.concatenate(
                ([0], np.cumsum(cnts)[:-1])
            )
            offsets[d] += int(cnts.sum())
            starts_per_dev[d].append(np.asarray(b.starts[sl], np.int64))
            counts_per_dev[d].append(cnts)
        local_starts.append(ls)
    L = int(offsets.max()) if n_dev else 0
    if L >= np.iinfo(np.int32).max:
        raise ValueError(
            f"per-shard nnz {L:,} exceeds the int32 offset range; use "
            "more devices or shard across hosts"
        )
    if not build_perm:
        return None, [ls.astype(np.int32) for ls in local_starts], max(L, 1)
    perm = np.zeros((n_dev, max(L, 1)), dtype=np.int64)
    for d in range(n_dev):
        if not starts_per_dev[d]:
            continue
        starts_d = np.concatenate(starts_per_dev[d])
        counts_d = np.concatenate(counts_per_dev[d])
        total = int(counts_d.sum())
        if total:
            base = np.repeat(
                starts_d - np.concatenate(([0], np.cumsum(counts_d)[:-1])),
                counts_d,
            )
            perm[d, :total] = np.arange(total, dtype=np.int64) + base
    return perm, [ls.astype(np.int32) for ls in local_starts], max(L, 1)


def _device_expand_sides(col_by_row, val_by_row, row_counts, val_scale):
    """Both sides' row-grouped ``(c_sorted, v_sorted)`` from a COO the
    host already sorted by row (``staging="device"``).

    Only ``(col_by_row, val_by_row, row_counts)`` cross to the device,
    in the narrowest lossless dtypes; the row side's grouping is the
    transfer order itself, its ids are rebuilt as
    ``repeat(arange(n_rows), row_counts)``, and the opposite side is one
    stable argsort over the col ids plus gathers.  The value decode to
    f32 happens after its gather so that move stays narrow."""
    nnz = col_by_row.shape[0]
    c_row = col_by_row.to(torch.int32)
    v_row = val_by_row.to(torch.float32) * val_scale
    rows = torch.repeat_interleave(
        torch.arange(row_counts.shape[0], dtype=torch.int32,
                     device=row_counts.device),
        row_counts, output_size=nnz,
    )
    order = torch.argsort(c_row, stable=True)
    c_opp = rows[order]
    v_opp = val_by_row[order].to(torch.float32) * val_scale
    return c_row, v_row, c_opp, v_opp


# --------------------------------------------------------------------------
# Device side: one half-iteration per direction
# --------------------------------------------------------------------------


def _spd_solve(A: torch.Tensor, b: torch.Tensor, solver: str) -> torch.Tensor:
    """Batched SPD solve ``A[i] x[i] = b[i]`` via the configured solver:
    ``"pallas"`` runs the SPD solve kernel (its plain version, the
    reference's Gauss-Jordan, on CPU tensors), anything else a Cholesky
    factorisation and two triangular solves, as the reference's XLA path
    does."""
    if solver == "pallas":
        from ..ops.solve import spd_solve_batched

        return spd_solve_batched(
            A.to(torch.float32).contiguous(), b.to(torch.float32).contiguous()
        )
    L = torch.linalg.cholesky(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)[..., 0]


def _bucket_inputs(
    c_sorted: torch.Tensor,   # [nnz] int32
    v_sorted: torch.Tensor,   # [nnz] f32
    starts: torch.Tensor,     # [B] int64
    counts: torch.Tensor,     # [B] int64
    k: int,
    lam_t: torch.Tensor,
    weighted_lambda: bool,
):
    """One bucket's ``[B, K]`` block expanded from the sorted COO: the
    opposite ids (masked -> 0), the values (masked -> 0), the mask and
    the ridge diagonal (``lam * max(n, 1)`` for ALS-WR, else ``lam``)."""
    dev = c_sorted.device
    nnz = c_sorted.shape[0]
    iota = torch.arange(k, dtype=torch.int64, device=dev)
    pos = torch.clamp(starts[:, None] + iota[None, :], max=nnz - 1)
    valid = iota[None, :] < counts[:, None]                 # [B, K]
    idx = torch.where(valid, c_sorted[pos], 0).to(torch.int32)
    val = torch.where(valid, v_sorted[pos], 0.0)            # f32, masked
    n_row = counts.to(torch.float32)
    if weighted_lambda:
        reg = lam_t * torch.clamp(n_row, min=1.0)          # ALS-WR
    else:
        reg = lam_t.expand(n_row.shape).contiguous()
    return idx, val, valid, reg


def _fused_weights(val, valid, alpha_t, implicit: bool):
    """The fused kernel's Gram and rhs weights for one bucket, as the
    reference builds them: implicit ``cw = alpha r`` (the confidence
    minus one) and ``bw = 1 + cw``; explicit ``cw = 1`` and ``bw = r``;
    both 0 where masked."""
    maskf = valid.to(torch.float32)
    if implicit:
        cwk = alpha_t * val * maskf
        bwk = (1.0 + cwk) * maskf
    else:
        cwk = maskf
        bwk = val * maskf
    return cwk.contiguous(), bwk.contiguous()


def _solve_buckets(
    upd: torch.Tensor,        # [N, R] table being solved, written in place
    opp: torch.Tensor,        # [M, R] opposite-side table
    c_sorted: torch.Tensor,   # [nnz] int32
    v_sorted: torch.Tensor,   # [nnz] f32
    buckets: tuple,           # per bucket (rows, starts, counts)
    ks: tuple,                # pad width per bucket
    lam,                      # float, or a 0-d tensor (the λ sweep)
    alpha: float,
    *,
    implicit: bool,
    weighted_lambda: bool,
    solver: str,
    gather_dtype: str = "float32",
    solver_mode: str = "full",
    subspace_size: int = 0,
    fused_gather: str = "taa",
    stop_after: Optional[str] = None,
    vmapped: bool = False,
    gram: Optional[torch.Tensor] = None,
    write=None,
) -> Optional[torch.Tensor]:
    """Solve every bucket of one side and write the rows into ``upd``.

    Per bucket: expand the ``[B, K]`` index/value block from the sorted
    COO, then either the fused kernel (``solver="fused"``, weights and
    ridge diagonal as the reference builds them; it splits the long rows
    of a short bucket across the card itself) or gather ``[B, K, R]`` +
    einsum Gram + ``_spd_solve``.  The Gram operands are the gathered
    rows widened to f32, so a bf16 gather table gives bf16 operands with
    f32 accumulation, as in the reference.  The solved rows go into
    ``upd`` by ``index_copy_``; under ``torch.func.vmap`` (``vmapped``,
    the λ sweep) by an ``index_put_``, which vmap batches.

    ``solver_mode="subspace"`` (iALS++, arXiv 2110.14044) replaces each
    row's full R×R solve by a sweep over rank blocks of width
    ``subspace_size`` (:func:`_subspace_sweep`), warm-started from the
    rows' current values in ``upd``; the B×B block systems go through
    ``_spd_solve`` like the full ones (the SPD solve kernel under
    ``"pallas"``).  ``subspace_size >= R`` takes the full-solve code
    unchanged, so it is bitwise ``solver_mode="full"``.

    ``stop_after`` ("gather" | "gram") truncates every bucket after that
    phase for the phase probes: nothing is written, and the sum of the
    truncated results comes back so the work cannot be skipped.  The
    fused kernel has no such prefix, so a truncated fused half takes
    the unfused path, as the reference does.

    The sharded half passes the implicit-mode ``gram`` (a sum of
    per-shard Grams) and a ``write(rows, x)`` callback that collects
    each bucket's solved block instead of writing ``upd``; there
    ``upd`` is the gathered updating table (the subspace warm start)
    or None, and bucket padding rows (ids past it) start from 0."""
    f32 = torch.float32
    dev = opp.device
    r = opp.shape[-1]
    sub = solver_mode == "subspace" and 0 < subspace_size < r
    lam_t = (lam.to(f32) if torch.is_tensor(lam)
             else torch.tensor(lam, dtype=f32, device=dev))
    alpha_t = torch.tensor(alpha, dtype=f32, device=dev)
    if implicit and gram is None:
        gram = (opp.T @ opp).to(f32)
    opp_g = (
        opp.to(torch.bfloat16)
        if gather_dtype == "bfloat16" and opp.dtype != torch.bfloat16
        else opp
    ).contiguous()
    # _resolve_solver checked that a fused plan exists at this rank, and
    # the plan does not depend on K: no bucket leaves the kernel
    fused_side = solver == "fused" and stop_after is None
    out = None
    for (rows, starts, counts), k in zip(buckets, ks):
        idx, val, valid, reg = _bucket_inputs(
            c_sorted, v_sorted, starts, counts, k, lam_t, weighted_lambda
        )
        if fused_side:
            from ..ops.fused_als import fused_gather_gram_solve

            cwk, bwk = _fused_weights(val, valid, alpha_t, implicit)
            x = fused_gather_gram_solve(
                opp_g, idx, cwk, bwk, reg, gram, gather_impl=fused_gather,
            )
        else:
            maskf = valid.to(f32)
            Vm = opp_g[idx].to(f32) * maskf[..., None]          # [B, K, R]
            if stop_after == "gather":
                out = Vm.sum() if out is None else out + Vm.sum()
                continue
            if sub:
                cw = alpha_t * val * maskf if implicit else None
                res = _subspace_sweep(
                    Vm, val, maskf, _rows_or_zero(upd, rows), reg, cw, gram,
                    solver, subspace_size, gram_probe=stop_after == "gram",
                )
                del Vm
                if stop_after == "gram":
                    out = res if out is None else out + res
                    continue
                if write is not None:
                    write(rows, res)
                else:
                    _write_rows(upd, rows, res, vmapped)
                continue
            if implicit:
                cw = alpha_t * val * maskf                       # (c - 1)
                A = gram + torch.einsum("bk,bkr,bks->brs", cw, Vm, Vm)
                b = torch.einsum("bk,bkr->br", (1.0 + cw) * maskf, Vm)
            else:
                A = torch.einsum("bkr,bks->brs", Vm, Vm)
                b = torch.einsum("bk,bkr->br", val * maskf, Vm)
            A = A + reg[:, None, None] * torch.eye(r, dtype=f32, device=dev)
            del Vm
            if stop_after == "gram":
                part = A.sum() + b.sum()
                out = part if out is None else out + part
                continue
            x = _spd_solve(A, b, solver)
        if write is not None:
            write(rows, x)
        else:
            _write_rows(upd, rows, x, vmapped)
    return out


def _rows_or_zero(table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``table[rows]`` in f32, with 0 for ids past the table (the
    sharded layout's bucket padding rows)."""
    inside = rows < table.shape[0]
    got = table[torch.where(inside, rows, 0)].to(torch.float32)
    return got * inside[:, None].to(torch.float32)


def _write_rows(upd: torch.Tensor, rows: torch.Tensor, x: torch.Tensor,
                vmapped: bool) -> None:
    if vmapped:
        upd[rows] = x.to(upd.dtype)
    else:
        upd.index_copy_(0, rows, x.to(upd.dtype))


def _subspace_sweep(
    Vm: torch.Tensor,          # [B, K, R] gathered, masked rows, f32
    val: torch.Tensor,         # [B, K] masked ratings, f32
    maskf: torch.Tensor,       # [B, K] validity mask, f32
    x0: torch.Tensor,          # [B, R] current factor rows, f32
    reg: torch.Tensor,         # [B] ridge (λ or λ·n_row)
    cw: Optional[torch.Tensor],    # [B, K] implicit (c - 1), or None
    gram: Optional[torch.Tensor],  # [R, R] YᵀY (implicit), f32
    solver: str,
    block: int,
    *,
    gram_probe: bool = False,
) -> torch.Tensor:
    """One iALS++ rank-block sweep over a bucket's rows (arXiv
    2110.14044 Alg. 2, batched over rows), as the reference's.

    Each block S takes an exact Newton step ``H_S δ = -g_S`` on the
    block's coordinates of the quadratic per-row objective, against
    caches kept with rank-B work:

    * explicit: the residual ``e = Vm·x - val``; ``g_S = Vsᵀe +
      reg·x_S``, ``H_S = VsᵀVs + reg·I``;
    * implicit: the prediction ``p = Vm·x`` and ``q = x·YᵀY``;
      ``g_S = q_S + Vsᵀ((c-1)p - c) + reg·x_S``,
      ``H_S = YᵀY[S,S] + Vsᵀdiag(c-1)Vs + reg·I``.

    A tail block narrower than ``block`` goes through the same solve.
    ``gram_probe=True`` forms every block's (H, g) without solving or
    updating the caches and returns their sum (the ``stop_after="gram"``
    probe)."""
    r = Vm.shape[-1]
    x = x0.clone()
    pred = torch.einsum("bkr,br->bk", Vm, x)
    e = q = None
    if cw is None:
        e = pred - val
    else:
        q = x @ gram
    acc = None
    for s in range(0, r, block):
        w = min(block, r - s)
        Vs = Vm[:, :, s:s + w]                             # [B, K, w]
        xs = x[:, s:s + w]
        if cw is None:
            H = torch.einsum("bks,bkt->bst", Vs, Vs)
            g = torch.einsum("bk,bks->bs", e, Vs)
        else:
            H = gram[s:s + w, s:s + w] + torch.einsum(
                "bk,bks,bkt->bst", cw, Vs, Vs)
            # (c-1)·p - c on rated items: cw is masked, so c·mask is
            # maskf + cw
            coef = cw * pred - maskf - cw
            g = q[:, s:s + w] + torch.einsum("bk,bks->bs", coef, Vs)
        H = H + reg[:, None, None] * torch.eye(w, dtype=H.dtype,
                                               device=H.device)
        g = g + reg[:, None] * xs
        if gram_probe:
            part = H.sum() + g.sum()
            acc = part if acc is None else acc + part
            continue
        d = -_spd_solve(H, g, solver)                       # [B, w]
        x[:, s:s + w] = xs + d
        dp = torch.einsum("bks,bs->bk", Vs, d)
        if cw is None:
            e = e + dp
        else:
            pred = pred + dp
            q = q + d @ gram[s:s + w, :]
    return acc if gram_probe else x


@xray.instrument("als.half_iteration")
def _half_iteration(
    upd: torch.Tensor,
    opp: torch.Tensor,
    side: dict,
    lam: float,
    alpha: float,
    *,
    implicit: bool,
    weighted_lambda: bool,
    precision: str,
    solver: str,
    gather_dtype: str = "float32",
    solver_mode: str = "full",
    subspace_size: int = 0,
    fused_gather: str = "taa",
    vmapped: bool = False,
) -> torch.Tensor:
    """One half-iteration: solve every bucket of ``side`` against
    ``opp`` and write the rows into ``upd`` in place (returned), with
    the f32 matrix-product precision scoped to ``precision``."""
    with matmul_precision(precision):
        _solve_buckets(
            upd, opp, side["c_sorted"], side["v_sorted"], side["buckets"],
            side["ks"], lam, alpha,
            implicit=implicit, weighted_lambda=weighted_lambda,
            solver=solver, gather_dtype=gather_dtype,
            solver_mode=solver_mode, subspace_size=subspace_size,
            fused_gather=fused_gather, vmapped=vmapped,
        )
    return upd


@xray.instrument("als.phase_probe")
def _half_phase_probe(
    upd: torch.Tensor,
    opp: torch.Tensor,
    side: dict,
    lam: float,
    alpha: float,
    *,
    implicit: bool,
    weighted_lambda: bool,
    precision: str,
    solver: str,
    gather_dtype: str = "float32",
    solver_mode: str = "full",
    subspace_size: int = 0,
    fused_gather: str = "taa",
    stop_after: str = "gather",
) -> torch.Tensor:
    """Truncated half-iteration for the phase spans: the gather-only or
    the gather+Gram prefix of every bucket, writing nothing (``upd`` is
    untouched; the real half runs right after the probes)."""
    with matmul_precision(precision):
        return _solve_buckets(
            upd, opp, side["c_sorted"], side["v_sorted"], side["buckets"],
            side["ks"], lam, alpha,
            implicit=implicit, weighted_lambda=weighted_lambda,
            solver=solver, gather_dtype=gather_dtype,
            solver_mode=solver_mode, subspace_size=subspace_size,
            fused_gather=fused_gather, stop_after=stop_after,
        )


@xray.instrument("als.sharded_half")
def _sharded_half(
    mesh,
    upd: list,                # this process's shards of the updating table
    opp: list,                # this process's shards of the opposite table
    side: dict,
    lam,
    alpha: float,
    *,
    implicit: bool,
    weighted_lambda: bool,
    precision: str,
    solver: str,
    gather_dtype: str = "float32",
    solver_mode: str = "full",
    subspace_size: int = 0,
    fused_gather: str = "taa",
    opp_parity: Optional[list] = None,
    ok: Optional[np.ndarray] = None,
) -> Optional[list]:
    """ALX-style half-iteration over row-sharded factor tables (the
    reference's ``build_sharded_half``), writing ``upd``'s shards in
    place.

    The opposite table is all-gathered (cast to bf16 before the gather
    in bf16 gather mode), the implicit-mode ``YᵀY`` is the sum of the
    per-shard Grams, and each shard solves its contiguous chunk of every
    bucket through :func:`_solve_buckets` against its own slice of the
    COO: under ``"pallas"`` the SPD solve kernel and under ``"fused"``
    the fused kernel run once per shard and bucket.  The solved
    ``[B, R]`` blocks are all-gathered and each shard writes only the
    rows it owns (bucket padding rows belong to no shard).
    ``solver_mode="subspace"`` gathers the updating table too (the warm
    start of rows other shards own).

    Coded (``ok``, the ``[d]`` 0/1 mask from ``ShardHealth.poll``, and
    ``opp_parity``, the opposite table's replicated f32 block sum): a
    masked opposite block is rebuilt as ``parity - sum(alive)``, the
    implicit Gram folds the rebuilt block in explicitly, a masked
    shard's own rows stay frozen, and the parity of the updated table
    comes back (None when not coded)."""
    from ..ops import _build
    from ..parallel.coded import coded_blocks
    from ..parallel.collectives import gather_shards, psum

    f32 = torch.float32
    coded = ok is not None
    with matmul_precision(precision):
        send = [p.to(torch.bfloat16) if gather_dtype == "bfloat16" else p
                for p in opp]
        if coded:
            blocks, recon = coded_blocks(opp, send, opp_parity, ok, mesh)
        else:
            blocks = gather_shards(send, mesh)
        opp_full = torch.cat(blocks)
        del blocks
        gram = None
        if implicit:
            if coded:
                okm = [float(ok[s]) for s in mesh.local]
                gram = psum([((p * m).T @ (p * m)).to(f32)
                             for p, m in zip(opp, okm)], mesh)[0]
                gram = gram + (recon.T @ recon).to(f32) * (
                    1.0 - float(np.min(ok)))
            else:
                gram = psum([(p.T @ p).to(f32) for p in opp], mesh)[0]
        sub = solver_mode == "subspace" and 0 < subspace_size < opp[0].shape[-1]
        upd_full = torch.cat(gather_shards(upd, mesh)) if sub else None
        got_rows, got_x = [], []
        for k, s in enumerate(mesh.local):
            dev = mesh.device_of(s)
            shard = side["shards"][k]
            rows_s, x_s = [], []

            def write(rows, x, rows_s=rows_s, x_s=x_s):
                rows_s.append(rows)
                x_s.append(x.to(f32))

            before = dict(_build.LAUNCHES)
            _solve_buckets(
                None if upd_full is None else upd_full.to(dev),
                opp_full.to(dev), shard["c_sorted"], shard["v_sorted"],
                shard["buckets"], side["ks"], lam, alpha,
                implicit=implicit, weighted_lambda=weighted_lambda,
                solver=solver, gather_dtype=gather_dtype,
                solver_mode=solver_mode, subspace_size=subspace_size,
                fused_gather=fused_gather,
                gram=None if gram is None else gram.to(dev), write=write,
            )
            for name, n in _build.LAUNCHES.items():
                if n > before.get(name, 0):
                    SHARD_LAUNCHES[(s, name)] += n - before.get(name, 0)
            got_rows.append(torch.cat(rows_s))
            got_x.append(torch.cat(x_s))
        del opp_full, upd_full
        rg = torch.cat(gather_shards(got_rows, mesh))
        xg = torch.cat(gather_shards(got_x, mesh))
        n_shard = upd[0].shape[0]
        for k, s in enumerate(mesh.local):
            if coded and ok[s] == 0:
                continue  # a degraded shard wrote nothing this half
            dev = mesh.device_of(s)
            local = rg.to(dev) - s * n_shard
            inside = (local >= 0) & (local < n_shard)
            upd[k].index_copy_(0, local[inside],
                               xg.to(dev)[inside].to(upd[k].dtype))
    if not coded:
        return None
    return psum([u.to(f32) for u in upd], mesh)


def _als_phase_trace_enabled() -> bool:
    """``PIO_TPU_TRACE_ALS=1`` arms per-phase span recording: opt-in,
    because the probes re-run truncated halves."""
    return os.environ.get("PIO_TPU_TRACE_ALS") == "1"


def _finite_all(U: torch.Tensor, V: torch.Tensor) -> bool:
    """The watchdog's NaN/Inf sentinel over both factor tables."""
    return bool(torch.isfinite(U).all()) and bool(torch.isfinite(V).all())


def _resolve_solver(
    cfg: ALSConfig, device: DeviceLike = "cuda"
) -> tuple[str, Optional[str]]:
    """Validate the solver choice and return ``(solver,
    fused_gather_resolved)``.  ``fused_gather="auto"`` resolves on
    ``device`` (the gather probes' measured order on the card, the static
    order on the host).  Unlike the reference, which compile-probes its
    kernels and degrades to XLA, the port runs what was asked: a form
    with no plan raises here, and a kernel that cannot build or launch
    raises at its first call."""
    if cfg.solver == "fused":
        from ..ops.fused_als import resolve_gather_impl

        tb = 2 if cfg.gather_dtype == "bfloat16" else 4
        impl = resolve_gather_impl(
            512, cfg.rank, tb, cfg.matmul_precision, cfg.fused_gather,
            device=device,
        )
        if impl is None:
            raise ValueError(
                f"solver='fused' has no kernel plan for "
                f"fused_gather={cfg.fused_gather!r} at rank {cfg.rank} "
                f"with a {cfg.gather_dtype} table"
            )
        return "fused", impl
    if cfg.solver == "pallas":
        from ..ops.solve import MAX_RANK

        if cfg.rank > MAX_RANK:
            raise ValueError(
                f"solver='pallas' supports rank <= {MAX_RANK}, "
                f"got {cfg.rank}"
            )
    return cfg.solver, None


class ALSTrainer:
    """Staged ALS state: build once, iterate cheaply.

    Separates the one-time host preprocessing + device staging from the
    iteration loop.  ``device`` defaults to the card; ``"cpu"`` runs the
    same path on the host with the kernels' plain versions."""

    # per-sweep loss sample cap: exact training RMSE when nnz fits it
    LOSS_SAMPLE_MAX = 1 << 16

    def __init__(
        self,
        ratings: Ratings | tuple[np.ndarray, np.ndarray, np.ndarray],
        n_users: Optional[int] = None,
        n_items: Optional[int] = None,
        cfg: ALSConfig = ALSConfig(),
        staging: str = "auto",
        device: DeviceLike = "cuda",
        mesh=None,
    ):
        # a mesh of one shard is the replicated path, as in the
        # reference (there is no ring to shard over)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        if mesh is not None:
            device = mesh.first_device
        self.device = resolve_device(device)
        if isinstance(ratings, Ratings):
            u, i, v = ratings.user_ix, ratings.item_ix, ratings.rating
            n_users = ratings.n_users
            n_items = ratings.n_items
        else:
            u, i, v = ratings
            if n_users is None or n_items is None:
                raise ValueError("n_users and n_items are required with "
                                 "a (user, item, rating) tuple")
        self.cfg = cfg
        self.n_users = n_users
        self.n_items = n_items
        self.solver, self.fused_gather = _resolve_solver(cfg, self.device)
        if staging not in ("auto", "host", "device"):
            raise ValueError(
                f"staging must be 'auto', 'host' or 'device', got {staging!r}"
            )
        n_dev = self.mesh.size if self.mesh is not None else 1
        self.sharded = (cfg.factor_placement == "sharded"
                        and self.mesh is not None)
        self.coded = bool(cfg.coded_shards) and self.sharded
        self._pad_users = pad_to_multiple(n_users, n_dev)
        self._pad_items = pad_to_multiple(n_items, n_dev)
        if self.sharded:
            if staging != "auto":
                logger.warning(
                    "staging=%r is ignored under factor_placement="
                    "'sharded': the sharded-COO layout has its own "
                    "staging path (trainer.staging == 'sharded')",
                    staging,
                )
            self.staging = "sharded"
            t0 = time.perf_counter()
            self._user_side = self._stage_side_sharded(build_bucket_layout(
                u, i, v, self._pad_users, cfg.min_bucket_k,
                cfg.max_ratings_per_row, batch_multiple=n_dev,
            ))
            self._item_side = self._stage_side_sharded(build_bucket_layout(
                i, u, v, self._pad_items, cfg.min_bucket_k,
                cfg.max_ratings_per_row, batch_multiple=n_dev,
            ))
            mesh_fence(self.mesh)
            self.staging_seconds = time.perf_counter() - t0
            self._build_sharded_state()
            self._init_loss(u, i, v)
            self.half_seconds = []
            self.sweep_losses = []
            return
        if staging == "auto":
            # device staging pays an argsort on the device; worth it once
            # the sorted-COO transfer dwarfs that
            staging = "device" if len(v) >= 2_000_000 else "host"
        self.staging = staging
        t0 = time.perf_counter()
        if staging == "device":
            self._user_side, self._item_side = self._stage_device(
                u, i, v, n_users, n_items
            )
        else:
            self._user_side = self._stage(build_bucket_layout(
                u, i, v, n_users, cfg.min_bucket_k, cfg.max_ratings_per_row,
            ))
            self._item_side = self._stage(build_bucket_layout(
                i, u, v, n_items, cfg.min_bucket_k, cfg.max_ratings_per_row,
            ))
        fence(self.device)
        self.staging_seconds = time.perf_counter() - t0
        self._init_loss(u, i, v)
        self.half_seconds: list[tuple[str, float]] = []
        self.sweep_losses: list[float] = []

    def _init_loss(self, u, i, v) -> None:
        """Keep the (sub)sampled COO triples for the per-sweep loss."""
        every = self.cfg.loss_every
        if every is None:
            every = 1
        self.loss_every = every
        if not every or len(v) == 0:
            self._loss_coo = None
            self.loss_sample_n = 0
        elif len(v) > self.LOSS_SAMPLE_MAX:
            pick = np.random.default_rng(self.cfg.seed).choice(
                len(v), size=self.LOSS_SAMPLE_MAX, replace=False,
            )
            pick.sort()
            self._loss_coo = (
                np.ascontiguousarray(np.asarray(u)[pick]),
                np.ascontiguousarray(np.asarray(i)[pick]),
                np.ascontiguousarray(np.asarray(v)[pick].astype(np.float32)),
            )
            self.loss_sample_n = int(self.LOSS_SAMPLE_MAX)
        else:
            self._loss_coo = (
                np.asarray(u), np.asarray(i),
                np.asarray(v).astype(np.float32),
            )
            self.loss_sample_n = int(len(v))
        self._loss_dev = None  # device copies, staged on first use

    def sweep_loss(self, U: torch.Tensor, V: torch.Tensor) -> Optional[float]:
        """Training RMSE over the retained (sub)sampled COO (the math of
        :func:`rmse`); the sample moves to the device once."""
        if self._loss_coo is None:
            return None
        if self._loss_dev is None:
            self._loss_dev = tuple(
                torch.as_tensor(a, device=self.device) for a in self._loss_coo
            )
        ud, idv, vd = self._loss_dev
        return math.sqrt(float(_sq_err_sum(U, V, ud, idv, vd))
                         / self.loss_sample_n)

    @classmethod
    def distributed(
        cls,
        local_ratings,
        n_users: Optional[int] = None,
        n_items: Optional[int] = None,
        cfg: ALSConfig = ALSConfig(factor_placement="sharded"),
        mesh=None,
        exchange_dir=None,
        tag: str = "als-coo",
        timeout: float = 120.0,
    ) -> "ALSTrainer":
        """Sharded-COO trainer over a mesh that spans processes, from
        each process's LOCAL rating triples (its entity-hash shard of a
        :func:`~..parallel.ingest.find_columnar_sharded` scan, encoded
        against the global id index).

        Every process sums the per-row counts with an all-reduce (the
        identical global bucket plan everywhere), then sends each triple
        to the process whose shard solves its row
        (:func:`~..parallel.ingest.exchange_ratings_by_owner`) and stages
        only its own shards: no process holds the full COO.  One process
        (or a mesh of one shard) takes the ordinary constructor."""
        from ..parallel.mesh import process_count

        if isinstance(local_ratings, Ratings):
            u, i, v = (local_ratings.user_ix, local_ratings.item_ix,
                       local_ratings.rating)
            n_users = local_ratings.n_users
            n_items = local_ratings.n_items
        else:
            u, i, v = local_ratings
            if n_users is None or n_items is None:
                raise ValueError("n_users and n_items are required with "
                                 "a (user, item, rating) tuple")
        if process_count() <= 1 or mesh is None or mesh.size <= 1:
            return cls((u, i, v), n_users, n_items, cfg, mesh=mesh)
        if cfg.factor_placement != "sharded":
            raise ValueError(
                "ALSTrainer.distributed requires "
                "factor_placement='sharded' (the sharded-COO layout)"
            )
        if exchange_dir is None:
            raise ValueError("exchange_dir is required for multi-process")
        from ..parallel.collectives import allreduce_host

        self = cls.__new__(cls)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(mesh.first_device)
        self.n_users = n_users
        self.n_items = n_items
        self.solver, self.fused_gather = _resolve_solver(cfg, self.device)
        self.sharded = True
        self.coded = bool(cfg.coded_shards)
        self.staging = "sharded-distributed"
        self._pad_users = pad_to_multiple(n_users, mesh.size)
        self._pad_items = pad_to_multiple(n_items, mesh.size)
        u, i = np.asarray(u, np.int64), np.asarray(i, np.int64)
        v = np.asarray(v, np.float32)

        def global_counts(rows, n_pad):
            local = np.bincount(rows, minlength=n_pad).astype(np.int64)
            return allreduce_host(local, mesh)

        t0 = time.perf_counter()
        self._user_side = self._stage_side_distributed(
            u, i, v, global_counts(u, self._pad_users), self._pad_users,
            exchange_dir, f"{tag}-user", timeout,
        )
        self._item_side = self._stage_side_distributed(
            i, u, v, global_counts(i, self._pad_items), self._pad_items,
            exchange_dir, f"{tag}-item", timeout,
        )
        mesh_fence(mesh)
        self.staging_seconds = time.perf_counter() - t0
        self._build_sharded_state()
        # only local triples here: a global training loss is not
        # computable from one process
        self.loss_every = 0
        self._loss_coo = None
        self._loss_dev = None
        self.loss_sample_n = 0
        self.half_seconds = []
        self.sweep_losses = []
        return self

    def _stage_side_distributed(self, rows, cols, vals, counts, n_rows_pad,
                                exchange_dir, tag, timeout) -> dict:
        """One side's sharded staging from process-local triples: the
        global plan from the summed counts, the owner exchange, then
        this process's shards only."""
        from ..parallel.ingest import exchange_ratings_by_owner

        cfg, mesh = self.cfg, self.mesh
        n_dev = mesh.size
        starts = np.concatenate(([0], np.cumsum(counts)[:-1]))
        buckets = _assemble_buckets(
            counts, starts, cfg.min_bucket_k, cfg.max_ratings_per_row,
            n_rows=n_rows_pad, batch_multiple=n_dev, starts_dtype=np.int64,
        )
        _, local_starts, L = _plan_shard_layout(
            buckets, n_dev, build_perm=False
        )
        # row -> owning shard / shard-local start / effective cap
        row_dev = np.zeros(n_rows_pad, np.int32)
        row_ls = np.zeros(n_rows_pad, np.int64)
        row_cap = np.zeros(n_rows_pad, np.int64)
        for b, ls in zip(buckets, local_starts):
            chunk = len(b.rows) // n_dev
            real = b.rows < n_rows_pad
            rr = b.rows[real]
            row_dev[rr] = (np.arange(len(b.rows))[real] // chunk).astype(
                np.int32)
            row_ls[rr] = ls[real]
            row_cap[rr] = b.counts[real]
        owner = np.asarray(mesh.owner, np.int64)
        rows2, cols2, vals2 = exchange_ratings_by_owner(
            rows, cols, vals, owner[row_dev], exchange_dir, tag,
            timeout=timeout,
        )
        # a deterministic within-row order (sources interleave): sort by
        # (row, col); occurrences past a row's cap are dropped
        order = np.lexsort((cols2, rows2))
        rows2, cols2, vals2 = rows2[order], cols2[order], vals2[order]
        rc = np.bincount(rows2, minlength=n_rows_pad).astype(np.int64)
        rstart = np.concatenate(([0], np.cumsum(rc)[:-1]))
        occ = np.arange(len(rows2), dtype=np.int64) - rstart[rows2]
        keep = occ < row_cap[rows2]
        rows2, cols2, vals2, occ = (rows2[keep], cols2[keep], vals2[keep],
                                    occ[keep])
        slot = row_ls[rows2] + occ
        dev_of = row_dev[rows2]
        shards = []
        for s in mesh.local:
            sel = dev_of == s
            c_loc = np.zeros(L, np.int32)
            v_loc = np.zeros(L, np.float32)
            c_loc[slot[sel]] = cols2[sel]
            v_loc[slot[sel]] = vals2[sel]
            shards.append(self._shard_arrays(s, c_loc, v_loc, buckets,
                                             local_starts))
        return {"ks": tuple(b.k for b in buckets), "shard_len": L,
                "shards": shards}

    def _stage_device(self, u, i, v, nu, ni):
        """Compact-transfer staging: host-sort the COO by user once, move
        only ``(item ids, values)`` in transfer order in the narrowest
        lossless dtypes (uint16 ids when they fit, uint8 half-star
        codes), and expand both sides on the device."""
        if len(v) >= np.iinfo(np.int32).max:
            # same int32-offset ceiling as build_bucket_layout: starts and
            # gather positions would wrap
            raise ValueError(
                f"{len(v):,} ratings exceed the int32 offset range of a "
                "single bucket layout; shard the COO across hosts first"
            )
        u = np.asarray(u)
        i = np.asarray(i)
        if len(v):
            if int(u.min()) < 0 or int(u.max()) >= nu:
                raise ValueError(
                    f"user ids must be in [0, {nu}); "
                    f"got [{int(u.min())}, {int(u.max())}]"
                )
            if int(i.min()) < 0 or int(i.max()) >= ni:
                raise ValueError(
                    f"item ids must be in [0, {ni}); "
                    f"got [{int(i.min())}, {int(i.max())}]"
                )
        # one O(n) native counting sort by user; its counts and starts
        # feed the user-side bucket plan directly
        i_by_u, v_by_u, counts_u, starts_u = sort_coo_by_row(u, i, v, nu)
        counts_i = np.bincount(i, minlength=ni).astype(np.int32)
        starts_i = np.concatenate(([0], np.cumsum(counts_i)[:-1])).astype(
            np.int32
        )
        cfg = self.cfg
        buckets_u = _assemble_buckets(
            np.asarray(counts_u, np.int32), np.asarray(starts_u, np.int32),
            cfg.min_bucket_k, cfg.max_ratings_per_row,
        )
        buckets_i = _assemble_buckets(
            counts_i, starts_i, cfg.min_bucket_k, cfg.max_ratings_per_row,
        )
        i_enc = (
            i_by_u.astype(np.uint16) if ni <= (1 << 16)
            else np.ascontiguousarray(i_by_u, dtype=np.int32)
        )
        twice = v_by_u * 2.0
        half_star = (
            v_by_u.size > 0
            and float(v_by_u.min(initial=0.0)) >= 0.0
            and float(v_by_u.max(initial=0.0)) <= 127.5
            and bool(np.all(twice == np.round(twice)))
        )
        v_enc = twice.astype(np.uint8) if half_star else v_by_u
        v_scale = 0.5 if half_star else 1.0
        counts_enc = np.asarray(counts_u, np.int64)
        self.staged_transfer_bytes = (
            i_enc.nbytes + v_enc.nbytes + counts_enc.nbytes
        )
        dev = self.device
        cs_u, vs_u, cs_i, vs_i = _device_expand_sides(
            torch.from_numpy(i_enc).to(dev),
            torch.from_numpy(v_enc).to(dev),
            torch.from_numpy(counts_enc).to(dev),
            v_scale,
        )
        return (
            self._stage_side(cs_u, vs_u, buckets_u),
            self._stage_side(cs_i, vs_i, buckets_i),
        )

    def _stage(self, layout: BucketLayout):
        return self._stage_side(
            torch.from_numpy(layout.col_sorted),
            torch.from_numpy(layout.val_sorted),
            layout.buckets,
        )

    def _stage_side(self, c_sorted, v_sorted, buckets):
        """One side's arrays on the device."""
        dev = self.device

        def put(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        return {
            "c_sorted": c_sorted.to(dev, torch.int32),
            "v_sorted": v_sorted.to(dev, torch.float32),
            "ks": tuple(b.k for b in buckets),
            "buckets": tuple(
                (put(b.rows), put(b.starts), put(b.counts)) for b in buckets
            ),
        }

    def _stage_side_sharded(self, layout: BucketLayout) -> dict:
        """One side's COO sharded (the reference's
        ``_stage_side_sharded``): shard ``d`` receives only the rating
        slices of the bucket rows it solves, in shard-local order, with
        shard-local starts (:func:`_plan_shard_layout`).  Only this
        process's shards are placed, each on its device; the staging is
        on the host (the reference ignores ``staging=`` here too)."""
        mesh = self.mesh
        perm, local_starts, L = _plan_shard_layout(layout.buckets, mesh.size)
        shards = []
        for s in mesh.local:
            shards.append(self._shard_arrays(
                s, layout.col_sorted[perm[s]], layout.val_sorted[perm[s]],
                layout.buckets, local_starts,
            ))
        return {"ks": tuple(b.k for b in layout.buckets), "shard_len": L,
                "shards": shards}

    def _shard_arrays(self, s: int, c, v, buckets, local_starts) -> dict:
        """Shard ``s``'s COO slice and its chunk of every bucket, on the
        shard's device."""
        mesh = self.mesh
        dev = mesh.device_of(s)

        def put(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(dev)

        chunks = []
        for b, ls in zip(buckets, local_starts):
            n = len(b.rows) // mesh.size
            sl = slice(s * n, (s + 1) * n)
            chunks.append((put(b.rows[sl]), put(ls[sl]), put(b.counts[sl])))
        return {
            "c_sorted": torch.from_numpy(
                np.ascontiguousarray(c, np.int32)).to(dev),
            "v_sorted": torch.from_numpy(
                np.ascontiguousarray(v, np.float32)).to(dev),
            "buckets": tuple(chunks),
        }

    def _build_sharded_state(self) -> None:
        """Parity and shard health of a coded trainer (one health per
        trainer: a kill is sticky across :meth:`run` calls, the way a
        dead host stays dead)."""
        if not self.coded:
            return
        from ..parallel.coded import ShardHealth, build_parity_fn

        self._parity_fn = build_parity_fn(self.mesh)
        self._parity_state: dict = {}
        self.shard_health = ShardHealth(
            self.mesh.size,
            hop_budget_s=self.cfg.shard_hop_budget_s or None,
            op="als.half",
        )

    @property
    def tower_source(self) -> int:
        """This trainer's token for the tower watchdog, whose loss window
        starts afresh when the token changes.  Unique for the process's
        life: ``id(self)`` is reused once a trainer is freed, and then
        the next trainer (an eval's next fold, say) would extend the
        last one's window, whose low final losses against the new
        model's early ones read as a divergence."""
        token = self.__dict__.get("_tower_token")
        if token is None:
            token = self._tower_token = next(_TRAINER_TOKENS)
        return token

    @property
    def coo_shard_entries(self) -> Optional[int]:
        """Per-shard padded rating-slot count of the sharded COO (about
        nnz / mesh size plus padding), or None when the COO is not
        sharded."""
        if not self.sharded:
            return None
        return int(self._user_side["shard_len"])

    def init_factors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """MLlib-style init: N(0, 1)/sqrt(rank) from a CPU generator
        seeded with ``cfg.seed`` (the same numbers on every device; not
        the reference's ``jax.random`` draw, which torch cannot
        reproduce — parity tests inject the reference's factors).
        Sharded placement pads the rows to a multiple of the mesh size
        with zero rows (never solved; zeros keep the implicit Gram
        exact), as the reference does."""
        cfg = self.cfg
        g = torch.Generator().manual_seed(cfg.seed)
        dtype = getattr(torch, cfg.compute_dtype)
        scale = 1.0 / math.sqrt(cfg.rank)
        U = torch.randn((self.n_users, cfg.rank), generator=g) * scale
        V = torch.randn((self.n_items, cfg.rank), generator=g) * scale
        if self.sharded:
            U = torch.nn.functional.pad(
                U, (0, 0, 0, self._pad_users - self.n_users))
            V = torch.nn.functional.pad(
                V, (0, 0, 0, self._pad_items - self.n_items))
        return U.to(self.device, dtype), V.to(self.device, dtype)

    def _half_options(self) -> dict:
        """The keyword options of every half this trainer runs."""
        cfg = self.cfg
        return dict(
            implicit=cfg.implicit,
            weighted_lambda=cfg.weighted_lambda,
            precision=cfg.matmul_precision,
            solver=self.solver,
            gather_dtype=cfg.gather_dtype,
            solver_mode=cfg.solver_mode,
            subspace_size=cfg.subspace_size,
            fused_gather=self.fused_gather or "taa",
        )

    def _half(self, upd, opp, side, lam: Optional[float] = None):
        cfg = self.cfg
        lam = cfg.lam if lam is None else lam
        if not self.sharded:
            return _half_iteration(upd, opp, side, lam, cfg.alpha,
                                   **self._half_options())
        if not self.coded:
            _sharded_half(self.mesh, upd, opp, side, lam, cfg.alpha,
                          **self._half_options())
            return upd
        upd_name = "user" if side is self._user_side else "item"
        opp_name = "item" if upd_name == "user" else "user"
        # consult the dist.* fault points and the hop budget before the
        # half: a late shard is served from parity, a killed one frozen
        ok = self.shard_health.poll()
        par = self._parity_state.get(opp_name)
        if par is None:
            par = self._parity_state[opp_name] = self._parity_fn(opp)
        self._parity_state[upd_name] = _sharded_half(
            self.mesh, upd, opp, side, lam, cfg.alpha,
            opp_parity=par, ok=ok, **self._half_options(),
        )
        return upd

    def _full(self, parts) -> torch.Tensor:
        """The whole (padded) table of a sharded run, on this process's
        first shard device."""
        from ..parallel.collectives import gather_shards

        return torch.cat(gather_shards(parts, self.mesh))

    def _fence(self) -> None:
        if self.mesh is not None:
            mesh_fence(self.mesh)
        else:
            fence(self.device)

    def _traced_half(self, upd, opp, side, side_name: str, it: int,
                     lam: Optional[float], collect: dict) -> float:
        """One half-iteration with the phase spans (``als.gather`` /
        ``als.gram`` / ``als.solve``), by fence-probe subtraction: time
        the gather-only truncation, the gather+Gram truncation and the
        full half, each fenced; the deltas are the phase times.  The
        first iteration runs each probe once unmeasured first, as the
        reference warms its compiles.  ``collect`` gathers the phase
        times under side-qualified keys (``user.gather`` ...) for the
        sweep record.  Returns the full half's seconds."""
        tracer = get_tracer()
        attrs = {"side": side_name, "iteration": it}
        cfg = self.cfg

        def probe(stop):
            return _half_phase_probe(
                upd, opp, side, cfg.lam if lam is None else lam, cfg.alpha,
                stop_after=stop, **self._half_options(),
            )

        def timed(fn, warm: bool) -> float:
            if warm:
                fn()
                self._fence()
            t0 = time.perf_counter()
            fn()
            self._fence()
            return time.perf_counter() - t0

        def emit(phase: str, dt: float) -> None:
            tracer.record(phase, dt, attrs=attrs)
            TRAIN_PHASE_SECONDS.labels(phase=phase).observe(dt)
            key = f"{side_name}.{phase.rsplit('.', 1)[-1]}"
            collect[key] = collect.get(key, 0.0) + dt

        if self.sharded:
            # no probe entry point under sharded placement: the fenced
            # full half is recorded as als.half, as in the reference
            t_full = timed(lambda: self._half(upd, opp, side, lam=lam),
                           False)
            emit("als.half", t_full)
            return t_full

        # the probes run BEFORE the real half: it writes ``upd``
        warm = it == 0
        t_gather = timed(lambda: probe("gather"), warm)
        t_gram_cum = timed(lambda: probe("gram"), warm)
        t_full = timed(lambda: self._half(upd, opp, side, lam=lam), False)
        emit("als.gather", t_gather)
        emit("als.gram", max(t_gram_cum - t_gather, 0.0))
        emit("als.solve", max(t_full - t_gram_cum, 0.0))
        return t_full

    def run(
        self,
        U,
        V,
        num_iterations: int,
        lam: Optional[float] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Iterate from ``(U, V)`` (tensors or arrays); the caller's
        arrays survive (one copy each up front, then the halves update
        the copies in place).  Each half is fenced and its wall time
        appended to :attr:`half_seconds`; the sweep loss (every
        ``loss_every`` sweeps) to :attr:`sweep_losses`; both describe
        the latest run.  Every sweep reports to ``tower.record_sweep``,
        which may raise :class:`~..obs.tower.ConvergenceError` (the
        watchdog's typed abort) with the run manifest finalized.

        ``lam`` overrides the config's regularization for this run.

        Under sharded placement ``U`` and ``V`` are the padded tables
        (:meth:`init_factors`' shape); each half runs on the shards, is
        recorded as an ``als.sharded_half`` span, and the whole padded
        tables come back, gathered on this process's first shard device.
        A coded run starts its parity afresh from these tables."""
        dtype = getattr(torch, self.cfg.compute_dtype)
        self.half_seconds = []
        self.sweep_losses = []
        if self.sharded:
            from ..parallel.mesh import shard_put

            U = shard_put(torch.as_tensor(U).to(dtype), self.mesh)
            V = shard_put(torch.as_tensor(V).to(dtype), self.mesh)
            if self.coded:
                self._parity_state = {}
            full = self._full
        else:
            U = torch.as_tensor(U).to(self.device, dtype).clone()
            V = torch.as_tensor(V).to(self.device, dtype).clone()

            def full(t):
                return t
        tracer = get_tracer()
        trace_phases = _als_phase_trace_enabled()
        session = tower.active_session()
        if session is not None:
            # the workflow layer opened the session without knowing the
            # algorithm's iteration budget; declare it for the ETA
            session.set_sweeps_planned(self.cfg.num_iterations)
        for it in range(num_iterations):
            t_sweep = time.perf_counter()
            phases: dict[str, float] = {}
            for name, upd, opp, side in (
                ("user", U, V, self._user_side),
                ("item", V, U, self._item_side),
            ):
                if trace_phases:
                    dt = self._traced_half(upd, opp, side, name, it, lam,
                                           phases)
                else:
                    t0 = time.perf_counter()
                    self._half(upd, opp, side, lam=lam)
                    self._fence()
                    dt = time.perf_counter() - t0
                    phases[f"{name}_half"] = dt
                    TRAIN_PHASE_SECONDS.labels(
                        phase=f"als.{name}_half").observe(dt)
                if self.sharded:
                    tracer.record("als.sharded_half", dt, attrs={
                        "side": name, "iteration": it,
                        "shards": self.mesh.size, "coded": self.coded})
                self.half_seconds.append((name, dt))
            if faults.fired("train.nan"):
                # poison the iterates the way an exploding sweep would;
                # the watchdog must catch it this sweep
                for t in (U if self.sharded else [U]):
                    t.mul_(float("nan"))
            loss = None
            if self.loss_every and (it + 1) % self.loss_every == 0:
                t0 = time.perf_counter()
                loss = self.sweep_loss(full(U), full(V))
                if loss is not None:
                    self.sweep_losses.append(loss)
                    phases["loss"] = time.perf_counter() - t0
            finite = True
            if session is not None and session.wants_finite_check():
                t0 = time.perf_counter()
                finite = _finite_all(full(U), full(V))
                phases["check"] = time.perf_counter() - t0
            tower.record_sweep(
                time.perf_counter() - t_sweep, phases,
                loss=loss, factors_finite=finite, source=self.tower_source,
            )
            logger.debug("ALS iteration %d/%d complete", it + 1,
                         num_iterations)
        return full(U), full(V)

    def fused_form(self) -> Optional[dict]:
        """What the fused kernel launches on the card (None for another
        solver): its entry point (the gather form and the table width)
        and, per side, how many buckets split their long rows across
        blocks (a pass 2 each), at this device's SM count."""
        if self.solver != "fused":
            return None
        from ..ops.fused_als import SMS, fused_tile_plan, sm_count

        cfg = self.cfg
        tb = 2 if cfg.gather_dtype == "bfloat16" else 4
        sms = sm_count(self.device) if self.device.type == "cuda" else SMS
        split = {}
        for name, side, m in (("user", self._user_side, self.n_items),
                              ("item", self._item_side, self.n_users)):
            # a shard's chunk of each bucket under sharded placement
            buckets = (side["shards"][0]["buckets"] if self.sharded
                       else side["buckets"])
            split[name] = sum(
                fused_tile_plan(m, cfg.rank, k, tb, self.fused_gather,
                                b=len(rows), sms=sms).segments > 1
                for (rows, _, _), k in zip(buckets, side["ks"])
            )
        form = "_dma" if self.fused_gather == "dma" else ""
        width = "bf16" if tb == 2 else "f32"
        return {"kernel": f"pio_fused_als{form}_{width}",
                "split_buckets": split}

    def train(
        self,
        checkpointer=None,
        checkpoint_every: int = 5,
        resume: bool = True,
        init=None,
    ) -> ALSFactors:
        """Full run from ``init = (U0, V0)`` (the reference's initial
        factors, say) or from :meth:`init_factors`.  With a
        :class:`~predictionio_tpu_torch.workflow.checkpoint.
        StepCheckpointer` the factors are saved every
        ``checkpoint_every`` iterations, and with ``resume`` a run
        starts from the latest saved step."""
        if checkpointer is not None and checkpoint_every <= 0:
            raise ValueError("checkpoint_every must be positive")
        U, V = self.init_factors() if init is None else init
        if checkpointer is None:
            U, V = self.run(U, V, self.cfg.num_iterations)
            return self._factors(U, V)
        start = 0
        if resume:
            if checkpointer.latest_step() is not None:
                # no explicit step: a torn newest step falls back to
                # the one before it
                state = checkpointer.restore(like={"U": U, "V": V})
                U, V = state["U"], state["V"]
                start = checkpointer.last_restored_step
                logger.info("resuming ALS from iteration %d", start)
        it = start
        half_seconds, losses = [], []
        while it < self.cfg.num_iterations:
            chunk = min(checkpoint_every, self.cfg.num_iterations - it)
            U, V = self.run(U, V, chunk)
            half_seconds += self.half_seconds
            losses += self.sweep_losses
            it += chunk
            checkpointer.save(it, {"U": U, "V": V})
        self.half_seconds, self.sweep_losses = half_seconds, losses
        return self._factors(U, V)

    def _factors(self, U, V) -> ALSFactors:
        """Host factor arrays (without a sharded run's padding rows) and
        the run's report."""
        return ALSFactors(
            user_factors=U[: self.n_users].float().cpu().numpy(),
            item_factors=V[: self.n_items].float().cpu().numpy(),
            report={
                "device": str(self.device),
                "placement": "sharded" if self.sharded else "replicated",
                "shards": self.mesh.size if self.sharded else 1,
                "coded": self.coded,
                "solver": self.solver,
                "fused_gather": self.fused_gather,
                "staging": self.staging,
                "staging_seconds": self.staging_seconds,
                "buckets": {"user": len(self._user_side["ks"]),
                            "item": len(self._item_side["ks"])},
                "fused_form": self.fused_form(),
                "half_seconds": list(self.half_seconds),
                "sweep_losses": list(self.sweep_losses),
            },
        )


def train_als(
    ratings: Ratings | tuple[np.ndarray, np.ndarray, np.ndarray],
    n_users: Optional[int] = None,
    n_items: Optional[int] = None,
    cfg: ALSConfig = ALSConfig(),
    device: DeviceLike = "cuda",
    init=None,
    mesh=None,
) -> ALSFactors:
    """Run ALS for ``cfg.num_iterations``; returns host factor arrays.
    With a ``mesh`` the trainer runs on its shards' devices."""
    return ALSTrainer(
        ratings, n_users, n_items, cfg, device=device, mesh=mesh
    ).train(init=init)


def sweep_train_als(
    ratings: Ratings | tuple[np.ndarray, np.ndarray, np.ndarray],
    n_users: Optional[int] = None,
    n_items: Optional[int] = None,
    cfg: ALSConfig = ALSConfig(),
    lams: Sequence[float] = (),
    device: DeviceLike = "cuda",
    init=None,
    mesh=None,
) -> list[ALSFactors]:
    """Train one model per λ candidate in one batched run.

    The reference's answer to the evaluation sweep: every candidate's
    half-iteration runs as one program with a leading λ dimension
    (``torch.func.vmap`` over the half, as the reference vmaps its
    jitted half), and staging is paid once for the whole sweep.  Memory
    scales with the number of candidates, so this fits
    evaluation-scale problems, not the full ML-20M train.  The batched
    form needs the ``"xla"`` solver (the kernels take no batch
    dimension).  Sharded placement on ``mesh`` sweeps one λ after
    another instead, on one staging, as the reference does.
    ``init = (U0, V0)`` starts every candidate there (the reference's
    initial factors, in the parity tests), else at
    :meth:`ALSTrainer.init_factors`."""
    if not lams:
        return []
    if cfg.factor_placement == "sharded" and mesh is not None:
        trainer = ALSTrainer(ratings, n_users, n_items, cfg, mesh=mesh)
        out = []
        for lam in lams:
            U0, V0 = trainer.init_factors() if init is None else init
            U, V = trainer.run(U0, V0, cfg.num_iterations, lam=float(lam))
            out.append(trainer._factors(U, V))
        return out
    if cfg.solver != "xla":
        raise ValueError(
            "sweep_train_als (vmapped form) requires solver='xla'"
        )
    trainer = ALSTrainer(ratings, n_users, n_items, cfg, device=device)
    opts = trainer._half_options()
    n = len(lams)
    lam_t = torch.tensor([float(x) for x in lams], dtype=torch.float32,
                         device=trainer.device)

    def make_half(side):
        def one(upd, opp, lam):
            # the half writes its rows in place: into its own copy
            return _half_iteration(upd.clone(), opp, side, lam, cfg.alpha,
                                   **opts, vmapped=True)

        return xray.instrument("als.sweep_half")(torch.func.vmap(one))

    half_u = make_half(trainer._user_side)
    half_i = make_half(trainer._item_side)
    U0, V0 = trainer.init_factors() if init is None else init
    dtype = getattr(torch, cfg.compute_dtype)
    U = torch.as_tensor(U0).to(trainer.device, dtype).expand(n, -1, -1)
    V = torch.as_tensor(V0).to(trainer.device, dtype).expand(n, -1, -1)
    for _ in range(cfg.num_iterations):
        U = half_u(U, V, lam_t)
        V = half_i(V, U, lam_t)
    Uh, Vh = U.float().cpu().numpy(), V.float().cpu().numpy()
    return [
        ALSFactors(user_factors=Uh[k], item_factors=Vh[k]) for k in range(n)
    ]


# --------------------------------------------------------------------------
# Quality metrics
# --------------------------------------------------------------------------


def _sq_err_sum(U, V, u, i, v) -> torch.Tensor:
    pred = (U[u.long()].float() * V[i.long()].float()).sum(-1)
    d = pred - v
    return (d * d).sum()


def rmse(
    factors: ALSFactors,
    user_ix: np.ndarray,
    item_ix: np.ndarray,
    rating: np.ndarray,
    chunk: int = 1 << 20,
    device: DeviceLike = "cuda",
) -> float:
    """RMSE over COO triples, chunked to bound device memory."""
    dev = resolve_device(device)
    U = torch.as_tensor(factors.user_factors, device=dev)
    V = torch.as_tensor(factors.item_factors, device=dev)
    total = 0.0
    n = len(rating)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        total += float(_sq_err_sum(
            U, V,
            torch.as_tensor(np.asarray(user_ix[s:e]), device=dev),
            torch.as_tensor(np.asarray(item_ix[s:e]), device=dev),
            torch.as_tensor(np.asarray(rating[s:e], np.float32), device=dev),
        ))
    return float(np.sqrt(total / max(n, 1)))
