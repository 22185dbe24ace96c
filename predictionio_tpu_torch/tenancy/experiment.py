"""Weighted A/B variant assignment: sticky, deterministic, hot-updatable.

Port of ``predictionio_tpu/tenancy/experiment.py``.  One
:class:`Experiment` per app groups that app's engine variants.
Assignment is ``hash(salt, app, user) -> [0, 1)`` mapped onto the
cumulative weight intervals of the variants in sorted-name order:

* **sticky across restarts**: the hash is salted SHA-256, so the same
  (salt, app, user) lands on the same variant on every replica and
  after every redeploy, with no assignment table to persist; both
  packages assign a user alike;
* **minimal moves under weight updates**: updating weights moves only
  the users whose hash falls in the shifted interval mass.  Weights are
  hot-updatable through ``POST /tenants/weights``; the replica router
  broadcasts the update so every replica assigns identically.
"""

from __future__ import annotations

import hashlib
import struct
import threading

__all__ = ["Experiment", "assign_bucket"]


def assign_bucket(salt: str, app: str, user: str) -> float:
    """Deterministic position in [0, 1) for a (salt, app, user) triple:
    the first 8 bytes of SHA-256 as a big-endian integer over 2^64."""
    digest = hashlib.sha256(
        f"{salt}\x00{app}\x00{user}".encode("utf-8", "surrogatepass")
    ).digest()
    (v,) = struct.unpack(">Q", digest[:8])
    return v / 2.0 ** 64


class Experiment:
    """Weighted variant assignment for one app's engine variants."""

    def __init__(self, app: str, weights: dict[str, float],
                 salt: str = "pio-hive"):
        if not weights:
            raise ValueError(f"experiment for {app!r} needs >= 1 variant")
        for name, w in weights.items():
            if not (w >= 0.0):
                raise ValueError(
                    f"variant {name!r} weight must be >= 0, got {w}"
                )
        if sum(weights.values()) <= 0:
            raise ValueError(
                f"experiment for {app!r} needs positive total weight"
            )
        self.app = app
        self.salt = salt
        self._lock = threading.Lock()
        self._weights = dict(weights)
        self.updates = 0

    def variants(self) -> list[str]:
        with self._lock:
            return sorted(self._weights)

    def weights(self) -> dict[str, float]:
        with self._lock:
            return dict(self._weights)

    def set_weights(self, weights: dict[str, float]) -> None:
        """Hot-update some or all variant weights.  Unknown variant
        names are refused (a typo must not silently route 0 traffic),
        and the total must stay positive."""
        with self._lock:
            unknown = set(weights) - set(self._weights)
            if unknown:
                raise KeyError(
                    f"unknown variant(s) {sorted(unknown)} for app "
                    f"{self.app!r}; known: {sorted(self._weights)}"
                )
            merged = {**self._weights, **{
                k: float(v) for k, v in weights.items()
            }}
            for name, w in merged.items():
                if not (w >= 0.0):
                    raise ValueError(
                        f"variant {name!r} weight must be >= 0, got {w}"
                    )
            if sum(merged.values()) <= 0:
                raise ValueError(
                    f"weights for {self.app!r} would sum to 0"
                )
            self._weights = merged
            self.updates += 1

    def assign(self, user: str) -> str:
        """The user's sticky variant under the current weights; the
        variants walk in sorted-name order, so the interval layout
        follows from the weight dict alone."""
        r = assign_bucket(self.salt, self.app, str(user))
        with self._lock:
            items = sorted(self._weights.items())
        total = sum(w for _, w in items)
        acc = 0.0
        for name, w in items:
            acc += w / total
            if r < acc:
                return name
        return items[-1][0]  # float round-off on the last boundary

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "app": self.app,
                "salt": self.salt,
                "weights": dict(self._weights),
                "updates": self.updates,
            }
