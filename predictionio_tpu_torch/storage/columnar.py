"""Rating triples over contiguous indices.

Copy of the ``Ratings`` container of ``predictionio_tpu/storage/columnar.py``
for the port.  The event frames that build it from an event scan come
with the event store, which is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .bimap import StringIndex

__all__ = ["Ratings"]


@dataclass
class Ratings:
    """COO rating triples over contiguous indices + the id dictionaries."""

    user_ix: np.ndarray  # int32 [n]
    item_ix: np.ndarray  # int32 [n]
    rating: np.ndarray   # float32 [n]
    users: StringIndex
    items: StringIndex

    def __len__(self) -> int:
        return len(self.rating)

    @property
    def n_users(self) -> int:
        return len(self.users)

    @property
    def n_items(self) -> int:
        return len(self.items)
