"""Bidirectional id maps: string entity ids <-> contiguous device-friendly
integer indices.

Copy of ``predictionio_tpu/storage/bimap.py`` (``BiMap``,
``StringIndex``, ``EntityIdIxMap`` and ``EntityMap``; the port imports
nothing of the JAX package).
Re-expression of reference `BiMap.scala:25-164` (``BiMap.stringInt`` /
``stringLong``) built for the device path: the forward map is a Python dict for
O(1) host lookups at serving time, the inverse is a NumPy object array so
batched top-k results coming back from the device can be decoded with a
single fancy-index instead of a Python loop.  Index assignment is by first
appearance when built incrementally, or sorted-unique when built from bulk
arrays (deterministic either way — SURVEY §7 hard-part 3).
"""

from __future__ import annotations

from typing import Generic, Iterable, Mapping, Sequence, TypeVar

import numpy as np

K = TypeVar("K")
V = TypeVar("V")

__all__ = ["BiMap", "EntityIdIxMap", "EntityMap", "StringIndex"]


class BiMap(Generic[K, V]):
    """Immutable bidirectional map (reference `BiMap.scala:25-110`)."""

    def __init__(self, forward: Mapping[K, V]):
        self._f = dict(forward)
        self._i = {v: k for k, v in self._f.items()}
        if len(self._i) != len(self._f):
            raise ValueError("BiMap values must be unique")

    def __getitem__(self, k: K) -> V:
        return self._f[k]

    def get(self, k: K, default=None):
        return self._f.get(k, default)

    def contains(self, k: K) -> bool:
        return k in self._f

    __contains__ = contains

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._i)

    def inv_get(self, v: V, default=None):
        return self._i.get(v, default)

    def keys(self):
        return self._f.keys()

    def values(self):
        return self._f.values()

    def items(self):
        return self._f.items()

    def __len__(self) -> int:
        return len(self._f)

    def to_dict(self) -> dict:
        return dict(self._f)

    # -- constructors matching BiMap.stringInt/stringLong ----------------
    @staticmethod
    def string_int(keys: Iterable[str]) -> "BiMap[str, int]":
        uniq = sorted(set(keys))
        return BiMap({k: i for i, k in enumerate(uniq)})


def _pandas():
    """pandas if importable (baked into this image), else None.

    Its hash-table factorize/get_indexer run the 20M-id dictionary
    builds at C speed (SURVEY §7 hard-part 3: measured 8.4 s vs 42 s for
    the pure-dict path at ML-20M scale); every caller keeps a
    pandas-free fallback.
    """
    try:
        import pandas as pd

        return pd
    except Exception:  # pragma: no cover - image always has pandas
        return None


# below this many lookups the dict path wins (no pandas Index build)
_BULK_ENCODE_MIN = 65_536


class StringIndex:
    """Contiguous index over string ids with a vectorized decode path.

    The device-facing counterpart of ``BiMap.stringInt``: ``encode`` maps id
    arrays to int32 (unknowns -> -1), ``decode`` maps device index arrays
    back to ids via one NumPy gather.
    """

    __slots__ = ("_to_ix", "_ids", "_pd_index")

    def __init__(self, ids: Sequence[str]):
        arr = np.asarray(list(ids), dtype=object)
        if len(set(arr.tolist())) != len(arr):
            raise ValueError("StringIndex ids must be unique")
        self._ids = arr
        self._to_ix = {s: i for i, s in enumerate(arr.tolist())}
        self._pd_index = None

    @staticmethod
    def from_values(values: Iterable[str]) -> "StringIndex":
        """Deterministic build: sorted unique (bulk-array path)."""
        return StringIndex(sorted(set(values)))

    @staticmethod
    def factorize(values) -> tuple["StringIndex", np.ndarray]:
        """Index + int32 codes for ``values`` in one pass.

        Equivalent to ``idx = from_values(values); idx.encode(values)``
        (sorted-unique determinism) but hash-based at C speed when
        pandas is available — the training-read hot path for string id
        dictionaries at 20M-rating scale.
        """
        pd = _pandas()
        if pd is not None:
            arr = np.asarray(values, dtype=object)
            codes, uniques = pd.factorize(arr, sort=True)
            if len(arr) and (codes < 0).any():
                # pd.factorize encodes None/NaN as -1; the pandas-free
                # fallback raises on them (sorted() over mixed types) —
                # keep the loud behavior so malformed events never get
                # silently dropped
                raise TypeError("id values must be non-null strings")
            return StringIndex(uniques.tolist()), codes.astype(np.int32)
        idx = StringIndex.from_values(values)
        return idx, idx.encode(values)

    def __len__(self) -> int:
        return len(self._ids)

    def __contains__(self, s: str) -> bool:
        return s in self._to_ix

    def get(self, s: str, default: int = -1) -> int:
        return self._to_ix.get(s, default)

    def __getitem__(self, s: str) -> int:
        return self._to_ix[s]

    def id_of(self, ix: int) -> str:
        return self._ids[ix]

    @property
    def ids(self) -> np.ndarray:
        return self._ids

    def encode(self, values: Iterable[str]) -> np.ndarray:
        """ids -> int32 indices; unknown ids become -1."""
        if isinstance(values, np.ndarray) and len(values) >= _BULK_ENCODE_MIN:
            pd = _pandas()
            if pd is not None:
                # hash-join lookup at C speed; -1 for unknowns matches
                # the dict path exactly
                # getattr: instances unpickled from pre-_pd_index
                # checkpoints restore only the slots they were saved with
                if getattr(self, "_pd_index", None) is None:
                    self._pd_index = pd.Index(self._ids)
                return self._pd_index.get_indexer(
                    np.asarray(values, dtype=object)
                ).astype(np.int32)
        g = self._to_ix.get
        return np.fromiter(
            (g(v, -1) for v in values), dtype=np.int32,
        )

    def decode(self, ixs: np.ndarray) -> np.ndarray:
        """int indices -> id object array (single gather)."""
        return self._ids[np.asarray(ixs)]

    def append(self, ids: Iterable[str]) -> np.ndarray:
        """Append-only growth (pio-live fold-in): add unseen ids in
        first-appearance order; returns int32 indices for EVERY given
        id (already-present ids resolve to their existing index, so a
        replayed delta maps idempotently).

        Existing indices never change meaning — ``_ids`` only grows —
        so a reader holding a decode view stays correct for every
        index it could have seen.  The new rows are published to
        ``_ids`` BEFORE their ``_to_ix`` entries appear: a concurrent
        ``get`` either misses (pre-append behavior) or hits an id whose
        row is already decodable.  Single-writer (the fold-in daemon /
        the serving delta-apply path, which holds the server state
        lock); concurrent readers need no lock.
        """
        ids = list(ids)
        out = np.empty(len(ids), dtype=np.int32)
        fresh: list[str] = []
        fresh_ix: dict[str, int] = {}
        base = len(self._ids)
        for j, s in enumerate(ids):
            ix = self._to_ix.get(s)
            if ix is None:
                # duplicate within THIS batch: first occurrence wins
                ix = fresh_ix.get(s)
                if ix is None:
                    ix = base + len(fresh)
                    fresh_ix[s] = ix
                    fresh.append(s)
            out[j] = ix
        if fresh:
            self._ids = np.concatenate(
                [self._ids, np.asarray(fresh, dtype=object)]
            )
            for k, s in enumerate(fresh):
                self._to_ix[s] = base + k
            # the pandas lookup index is rebuilt lazily on next bulk use
            self._pd_index = None
        return out


class EntityIdIxMap:
    """Entity id <-> contiguous index map (reference `EntityMap.scala:27-60`,
    ``EntityIdIxMap``).  Thin, order-preserving wrapper over
    :class:`StringIndex` keeping the reference's method names."""

    def __init__(self, id_to_ix: BiMap[str, int] | StringIndex):
        if isinstance(id_to_ix, BiMap):
            if sorted(id_to_ix.values()) != list(range(len(id_to_ix))):
                raise ValueError(
                    "EntityIdIxMap needs contiguous indices 0..n-1"
                )
            ordered = [None] * len(id_to_ix)
            for k, v in id_to_ix.items():
                ordered[v] = k
            self._index = StringIndex(ordered)
        else:
            self._index = id_to_ix

    @staticmethod
    def from_ids(ids: Iterable[str]) -> "EntityIdIxMap":
        return EntityIdIxMap(StringIndex.from_values(ids))

    def __call__(self, entity_id: str) -> int:
        return self._index[entity_id]

    def get(self, entity_id: str, default: int = -1) -> int:
        return self._index.get(entity_id, default)

    def contains(self, entity_id: str) -> bool:
        return entity_id in self._index

    __contains__ = contains

    def inverse(self, ix: int) -> str:
        return self._index.id_of(ix)

    def __len__(self) -> int:
        return len(self._index)

    @property
    def index(self) -> StringIndex:
        return self._index


class EntityMap(Generic[V]):
    """Index map + typed per-entity payload (reference
    `EntityMap.scala:62-98`): lookup by entity id or by contiguous index."""

    def __init__(self, data: Mapping[str, V]):
        self._data = dict(data)
        self.id_to_ix = EntityIdIxMap.from_ids(self._data.keys())

    def __getitem__(self, entity_id: str) -> V:
        return self._data[entity_id]

    def get(self, entity_id: str, default=None):
        return self._data.get(entity_id, default)

    def get_by_index(self, ix: int) -> V:
        return self._data[self.id_to_ix.inverse(ix)]

    def __contains__(self, entity_id: str) -> bool:
        return entity_id in self._data

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()
