"""Plain explicit ALS-WR in PyTorch: the yardstick the program's factors
are held to.

It follows the published method (Zhou et al. 2008, "Large-scale
parallel collaborative filtering for the Netflix Prize"; the weighted
λ of Spark MLlib 1.3): alternately, every user row with ratings solves

    (Σ_j v_j v_jᵀ + λ n_u I) x_u = Σ_j r_uj v_j

over the items j it rated (n_u of them), then every item row the same
against the new user table.  Rows with no rating keep their initial
values.  The ratings are grouped by row here from the COO alone, with
rows of similar length batched together; nothing of the program is
imported or read.

``dtype=torch.float64`` is the reference.  ``dtype=torch.float32`` with
``tf32=True`` is the control: the same arithmetic with its products on
the TF32 tensor cores, the step below the float32 (TF32 off) the
configurations state.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass

import torch

__all__ = ["als_reference", "group_rows"]

# bytes of one block's gathered rows and of its Gram matrices
BLOCK_BYTES = 1 << 30


@dataclass
class Grouped:
    """One side's ratings grouped by row (CSR), the rows with ratings in
    order of falling length, and the blocks they are solved in."""

    cols: torch.Tensor      # [nnz] opposite ids, grouped by row
    vals: torch.Tensor      # [nnz] ratings, grouped by row
    offsets: torch.Tensor   # [n_rows] start of each row's slice
    counts: torch.Tensor    # [n_rows] ratings of each row
    order: torch.Tensor     # [active] rows with ratings, longest first
    blocks: list            # (first, last + 1, longest) into ``order``


def group_rows(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
               n_rows: int, rank: int, itemsize: int) -> Grouped:
    """Group a COO by ``rows`` and plan the solve blocks: a block holds
    rows of falling length, each longer than half the longest (so the
    padding at most doubles the gather), whose padded ``[B, K, rank]``
    gather and ``[B, rank, rank]`` Grams each stay within
    :data:`BLOCK_BYTES`."""
    by_row = torch.argsort(rows, stable=True)
    counts = torch.bincount(rows.to(torch.int64), minlength=n_rows)
    offsets = torch.cumsum(counts, 0) - counts
    active = torch.nonzero(counts).flatten()
    order = active[torch.argsort(counts[active], descending=True,
                                 stable=True)]
    lengths = counts[order].tolist()
    lengths_neg = [-n for n in lengths]   # ascending, for bisect
    max_entries = BLOCK_BYTES // (rank * itemsize)
    max_rows = max(1, BLOCK_BYTES // (rank * rank * itemsize))
    blocks, start = [], 0
    while start < len(lengths):
        longest = lengths[start]
        take = max(1, min(max_rows, max_entries // longest))
        end = min(len(lengths), start + take)
        # a row no longer than half the longest starts the next block
        end = bisect.bisect_left(lengths_neg, -(longest // 2), start + 1,
                                 end)
        blocks.append((start, end, longest))
        start = end
    return Grouped(cols[by_row], vals[by_row], offsets, counts, order,
                   blocks)


def _solve_side(upd: torch.Tensor, opp: torch.Tensor, side: Grouped,
                lam: float) -> None:
    """Solve every row of ``side`` against ``opp``; write into ``upd``."""
    rank = opp.shape[1]
    eye = torch.eye(rank, dtype=opp.dtype, device=opp.device)
    for first, end, longest in side.blocks:
        rows = side.order[first:end]
        n = side.counts[rows]
        slot = torch.arange(longest, device=opp.device)
        valid = slot[None, :] < n[:, None]
        pos = torch.where(valid, side.offsets[rows, None] + slot[None, :], 0)
        mask = valid.to(opp.dtype)
        x_rows = opp[side.cols[pos]] * mask[..., None]        # [B, K, R]
        r = side.vals[pos].to(opp.dtype) * mask               # [B, K]
        gram = torch.bmm(x_rows.mT, x_rows)
        gram += (lam * n.to(opp.dtype))[:, None, None] * eye
        rhs = torch.bmm(x_rows.mT, r[..., None])
        chol = torch.linalg.cholesky(gram)
        upd[rows] = torch.cholesky_solve(rhs, chol)[..., 0]


def als_reference(users: torch.Tensor, items: torch.Tensor,
                  ratings: torch.Tensor, n_users: int, n_items: int,
                  init_users: torch.Tensor, init_items: torch.Tensor,
                  lam: float, iterations: int,
                  dtype: torch.dtype = torch.float64, tf32: bool = False,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """``iterations`` ALS-WR sweeps (user half, then item half) from
    ``(init_users, init_items)``; returns both tables in ``dtype``.

    ``tf32`` lets the float32 products run on the TF32 tensor cores (the
    control); the flag is restored on return."""
    rank = init_users.shape[1]
    itemsize = torch.empty((), dtype=dtype).element_size()
    by_user = group_rows(users, items, ratings, n_users, rank, itemsize)
    by_item = group_rows(items, users, ratings, n_items, rank, itemsize)
    U = init_users.to(dtype).clone()
    V = init_items.to(dtype).clone()
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for _ in range(iterations):
            _solve_side(U, V, by_user, lam)
            _solve_side(V, U, by_item, lam)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return U, V
