"""Batched regularization sweep: every λ candidate trains at once (the
port's engine).

The counterpart of ``engine.py`` on ``predictionio_tpu_torch``: the
port's ``models.als.sweep_train_als`` gives the candidates a shared
batch dimension (``torch.func.vmap`` over one half-iteration per ALS
direction), so the gathers, Gram products and solves of every λ run
batched on the device, and the COO staging is paid once for the whole
sweep — where the reference's evaluation sweep scores candidates with a
Scala parallel collection (`core/src/main/scala/io/prediction/
controller/MetricEvaluator.scala:183-192` `.par`): K candidates → K
independent Spark jobs sharing nothing.

Run: ``python engine_torch.py`` (on the card; ``--device cpu`` on the
host) — trains the λ grid in one shot, evaluates train/holdout RMSE per
candidate, prints the table and the winner.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from predictionio_tpu_torch.models.als import (
    ALSConfig,
    rmse,
    sweep_train_als,
)
from predictionio_tpu_torch.storage.bimap import StringIndex

HERE = Path(__file__).parent
LAMBDAS = [0.01, 0.05, 0.1, 0.5, 1.0]


def load_ratings(path: Path):
    rows = [ln.strip().split(",") for ln in path.read_text().splitlines()
            if ln.strip()]
    us = [r[0] for r in rows]
    its = [r[1] for r in rows]
    users = StringIndex.from_values(us)
    items = StringIndex.from_values(its)
    u = users.encode(us)
    i = items.encode(its)
    v = np.array([float(r[2]) for r in rows], dtype=np.float32)
    return u.astype(np.int32), i.astype(np.int32), v, len(users), len(items)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    device = ap.parse_args(argv).device
    u, i, v, n_users, n_items = load_ratings(HERE / "ratings.csv")
    rng = np.random.default_rng(7)
    holdout = rng.random(len(v)) < 0.2
    tr = ~holdout

    cfg = ALSConfig(rank=6, num_iterations=10)
    swept = sweep_train_als(
        (u[tr], i[tr], v[tr]), n_users, n_items, cfg, lams=LAMBDAS,
        device=device,
    )

    print(f"{'lambda':>8} {'train RMSE':>12} {'holdout RMSE':>13}")
    best = None
    for lam, factors in zip(LAMBDAS, swept):
        tr_rmse = rmse(factors, u[tr], i[tr], v[tr], device=device)
        ho_rmse = rmse(factors, u[holdout], i[holdout], v[holdout],
                       device=device)
        print(f"{lam:>8} {tr_rmse:>12.4f} {ho_rmse:>13.4f}")
        if best is None or ho_rmse < best[1]:
            best = (lam, ho_rmse)
    print(f"\nbest lambda = {best[0]} (holdout RMSE {best[1]:.4f})")


if __name__ == "__main__":
    main()
