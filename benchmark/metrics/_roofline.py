"""Peaks of the card and the least work of an ALS iteration, shared by
the roofline and utilisation readers.

Peaks: one NVIDIA H100 SXM, NVIDIA's data sheet, dense rates at the
700 W power limit (the run prints the card's own limit beside them):
3.35 TB/s of HBM, 67 TFLOP/s in float32 on the CUDA cores, 495 TFLOP/s
in TF32 on the tensor cores.  A float32 product at float32 accuracy
("highest": TF32 off) takes three TF32 products (each operand split into
a high and a low TF32 part), so its peak is 495/3 TFLOP/s; a product
that allows TF32 runs at 495.

Work: counted from the ratings and the rank alone, never from the
program's buckets, launches or kernel plans, so it is the same whatever
kernel, split or library computes a half.  A half that solves the
``rows`` rows holding ``nnz`` ratings against an ``[m, rank]`` table
needs at least:

* operations: one triangle of each row's Gram (``nnz·R(R+1)``) and the
  right-hand sides (``2·nnz·R``) as products; one SPD solve per row,
  a Cholesky factorisation and two triangular solves
  (``R³/3 + 2R²``), on the CUDA cores;
* bytes: each rating's opposite id and value read once (8 bytes), the
  opposite table read once, each solved row written once.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12


def product_peak(matmul_precision: str) -> float:
    """FLOP/s of the Gram and right-hand-side products at the accuracy
    ``matmul_precision`` asks for."""
    return TF32_FLOP_PER_S / (3 if matmul_precision == "highest" else 1)


def half_work(nnz: int, rows: int, m: int, rank: int) -> dict:
    """Least product operations, solve operations and bytes of one
    half."""
    return {
        "product_flops": nnz * rank * (rank + 1) + 2 * nnz * rank,
        "solve_flops": rows * (rank ** 3 / 3 + 2 * rank ** 2),
        "bytes": nnz * 8 + m * rank * 4 + rows * rank * 4,
    }


def iteration_work(shape: dict) -> dict:
    """Both halves' least work; ``shape`` has ``nnz``, ``rank``,
    ``n_users``, ``n_items`` and the rows with ratings on each side
    (``active_users``, ``active_items``)."""
    user = half_work(shape["nnz"], shape["active_users"], shape["n_items"],
                     shape["rank"])
    item = half_work(shape["nnz"], shape["active_items"], shape["n_users"],
                     shape["rank"])
    return {k: user[k] + item[k] for k in user}


def ops_seconds(work: dict, matmul_precision: str) -> float:
    """Least seconds of the work's operations at the peaks."""
    return (work["product_flops"] / product_peak(matmul_precision)
            + work["solve_flops"] / F32_FLOP_PER_S)


def least_seconds(work: dict, matmul_precision: str) -> float:
    """Roofline: the larger of the operations' and the bytes' time."""
    return max(ops_seconds(work, matmul_precision),
               work["bytes"] / HBM_BYTES_PER_S)
