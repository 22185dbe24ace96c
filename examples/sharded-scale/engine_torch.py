"""Scaling an ALS train past one card's memory: the sharded-COO layout
(the port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``.  The
reference scales by adding Spark executors — MLlib block-partitions
both the factor matrices AND the rating blocks across the cluster
(SURVEY §2.7(2)).  The equivalent here is one config knob:

    ALSConfig(factor_placement="sharded")

* both factor tables are row-sharded over the port's mesh of shards
  (``parallel.make_mesh``), so model capacity scales with the shards'
  memory (ALX-style, arXiv 2112.02194),
* the rating COO is co-partitioned with the bucket rows each shard
  solves, so DATA capacity scales with the shards too,
* ``solver="fused"`` runs each shard's gather+Gram+solve as the port's
  fused CUDA kernel on the card (its plain PyTorch version on the
  host); the port runs what is asked and never degrades to another
  solver.

The mesh is ``--shards`` shards on one device (default 4 on the card):
the shards run one after another there, as the reference's virtual CPU
devices do, so the example shows the layout, not a speed-up.

Run: ``python engine_torch.py`` (on the card) or ``python
engine_torch.py --device cpu --shards 8`` (on the host).
"""

from __future__ import annotations

import argparse

import numpy as np

from predictionio_tpu_torch.device import resolve_device
from predictionio_tpu_torch.models.als import (
    ALSConfig,
    ALSFactors,
    ALSTrainer,
    rmse,
)
from predictionio_tpu_torch.parallel import make_mesh


def synth(n_users=600, n_items=240, nnz=40_000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, n_users, nnz).astype(np.int32)
    i = rng.integers(0, n_items, nnz).astype(np.int32)
    v = (rng.integers(1, 11, nnz) * 0.5).astype(np.float32)
    return u, i, v, n_users, n_items


def run(shards: int = 4, device: str = "cuda"
        ) -> tuple[ALSFactors, ALSFactors] | None:
    """Train replicated and sharded on a mesh of ``shards`` shards of
    ``device``, print what each stores and how they agree; returns
    ``(replicated, sharded)`` factors (None with fewer than 2 shards)."""
    u, i, v, n_users, n_items = synth()
    dev = resolve_device(device)
    mesh = make_mesh(devices=[dev] * shards)
    print(f"mesh: {mesh.size} shard(s) of {dev} over axis "
          f"{mesh.axis_names}")
    if mesh.size < 2:
        print(
            "only one shard — sharded placement degenerates to "
            "replicated, so there is nothing to demonstrate.  Re-run "
            "with a mesh of several shards, e.g.:\n  python "
            "engine_torch.py --shards 4"
        )
        return None

    replicated = ALSTrainer(
        (u, i, v), n_users, n_items,
        ALSConfig(rank=8, num_iterations=4), mesh=mesh,
    )
    sharded = ALSTrainer(
        (u, i, v), n_users, n_items,
        ALSConfig(rank=8, num_iterations=4, factor_placement="sharded",
                  solver="fused"),
        mesh=mesh,
    )
    L = sharded.coo_shard_entries
    print(
        f"rating COO: {len(v):,} ratings total; each device stores "
        f"{L:,} (~1/{mesh.size} + padding) in sharded placement vs "
        f"{len(v):,} replicated"
    )
    print(f"resolved solver: {sharded.solver!r}")

    f_rep = replicated.train()
    f_sh = sharded.train()
    err_rep = rmse(f_rep, u, i, v, device=dev)
    err_sh = rmse(f_sh, u, i, v, device=dev)
    print(f"train RMSE: replicated {err_rep:.4f} vs sharded {err_sh:.4f}")
    assert abs(err_rep - err_sh) < 1e-3, "placements must agree"
    drift = float(np.abs(f_sh.user_factors - f_rep.user_factors).max())
    print(f"max |factor drift| between placements: {drift:.2e}")
    print("sharded-scale OK")
    return f_rep, f_sh


def main(argv=None) -> tuple[ALSFactors, ALSFactors] | None:
    """Parse ``--shards`` and ``--device``, then :func:`run`."""
    ap = argparse.ArgumentParser(description="sharded ALS on a mesh of "
                                 "shards of one device")
    ap.add_argument("--shards", type=int, default=4,
                    help="shards of the mesh (default 4)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return run(args.shards, args.device)


if __name__ == "__main__":
    main()
