"""The comparison that decides ``correct``: a trained pair of factor
tables against the reference's.

Two numbers for each train, each the worse of the user and the item
table:

* ``factor_err`` — ``‖P − R‖_F / ‖R‖_F``, the whole table's relative
  error;
* ``row_err`` — the worst row's ``‖p − r‖ / max(‖r‖, median row norm)``:
  one wrong row among hundreds of thousands moves ``factor_err`` by
  little, and this by much.

A train passes when both are finite and within their limits.  Imports
only torch.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NAMES", "judge", "readings"]

NAMES = ("factor_err", "row_err")


def _table(got: torch.Tensor, want: torch.Tensor) -> dict:
    diff = got.to(want.dtype) - want
    want_rows = torch.linalg.vector_norm(want, dim=1)
    floor = torch.clamp(want_rows, min=float(want_rows.median()))
    rows = torch.linalg.vector_norm(diff, dim=1) / floor
    return {
        "factor_err": float(torch.linalg.vector_norm(diff)
                            / torch.linalg.vector_norm(want)),
        "row_err": float(rows.max()),
    }


def readings(users, items, ref_users: torch.Tensor,
             ref_items: torch.Tensor) -> dict:
    """Both numbers for one train's tables (arrays or tensors) against
    the reference's, on the reference's device."""
    dev = ref_users.device
    per = [_table(torch.as_tensor(got).to(dev), want)
           for got, want in ((users, ref_users), (items, ref_items))]
    out = {}
    for name in NAMES:
        vals = [p[name] for p in per]
        # a NaN anywhere is the worst reading
        out[name] = (math.inf if any(math.isnan(v) for v in vals)
                     else max(vals))
    return out


def judge(per_train: list, limits: dict) -> dict:
    """Fold the trains' readings: ``attempted``, ``failed`` and, for each
    number, the worst reading beside its limit."""
    failed = sum(
        any(not r[n] <= limits[n] for n in NAMES) for r in per_train)
    worst = {n: max((r[n] for r in per_train), default=math.inf)
             for n in NAMES}
    return {
        "attempted": len(per_train),
        "failed": failed,
        "correct": bool(per_train) and failed == 0,
        "checks": {n: {"value": worst[n], "limit": limits[n]}
                   for n in NAMES},
    }
