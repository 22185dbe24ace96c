"""Gap-based sessionizer + decayed CSR transition store (port of
``predictionio_tpu/sessions/store.py``, the same arithmetic in the same
order, so weights agree bit for bit).

Decay math (trending's idiom): a transition observed at epoch ``te``
contributes ``2 ** ((te - t0) / half_life)`` where ``t0`` is the
store's reference epoch.  Ranking is invariant under the global
``2 ** ((t0 - now) / half_life)`` rescale, so incremental scans just
ADD weights; when the max stored weight's exponent passes
``_REBASE_EXP`` the reference is re-based (all weights scaled down,
``t0`` advanced) so an always-on deployment never overflows f64.

Storage layout: the compacted matrix is classic CSR over interned item
indices — ``indptr[src] : indptr[src+1]`` slices ``indices``/``data``
for one source row — plus a small pending-delta dict that absorbs
incremental adds and is merged back into the arrays once it grows past
``pending_limit`` (fold-in-style: serving reads see pending + CSR
overlaid, compaction never blocks a scan for long).
"""

from __future__ import annotations

import math
import threading
import time
from typing import Iterable, Optional

import numpy as np

__all__ = ["Sessionizer", "TransitionStore", "sessionize"]

# rebase the reference epoch when the max weight's exponent exceeds
# this (2**60 headroom in f64 keeps additive merges exact to ~1 ulp)
_REBASE_EXP = 60.0


class Sessionizer:
    """Streaming gap-based sessionization with per-user carry state.

    ``feed(user, item, ts)`` returns the completed transition
    ``(prev_item, item)`` when the event continues ``user``'s current
    session, else ``None``.  A session breaks only on a FORWARD gap
    (``ts - last_ts > gap_s``): modestly out-of-order timestamps —
    normal on a sharded store whose scan interleaves shard rowid order
    — land in the current session and the carry clock never runs
    backward, so replaying the same rows through a restored carry
    state reproduces the same transitions (idempotent-replay
    contract).  Self-loops (item repeated) refresh the clock but count
    no transition.
    """

    def __init__(self, gap_s: float = 1800.0):
        if gap_s <= 0:
            raise ValueError(f"session gap must be > 0, got {gap_s}")
        self.gap_s = float(gap_s)
        # user -> (last_item, last_ts); last_ts is monotone per user
        self._carry: dict[str, tuple[str, float]] = {}

    def feed(self, user: str, item: str,
             ts: float) -> Optional[tuple[str, str]]:
        last = self._carry.get(user)
        if last is None:
            self._carry[user] = (item, ts)
            return None
        last_item, last_ts = last
        if ts - last_ts > self.gap_s:
            # forward gap: new session, no transition
            self._carry[user] = (item, ts)
            return None
        self._carry[user] = (item, max(ts, last_ts))
        if item == last_item:
            return None
        return (last_item, item)

    def last_item(self, user: str) -> Optional[str]:
        last = self._carry.get(user)
        return last[0] if last is not None else None

    def __len__(self) -> int:
        return len(self._carry)

    # -- persistence (rides the model's JSON doc) --------------------------
    def to_doc(self) -> dict:
        return {
            "gapSec": self.gap_s,
            "carry": {u: [i, t] for u, (i, t) in self._carry.items()},
        }

    @classmethod
    def from_doc(cls, doc: dict) -> "Sessionizer":
        s = cls(gap_s=float(doc.get("gapSec", 1800.0)))
        s._carry = {
            str(u): (str(v[0]), float(v[1]))
            for u, v in (doc.get("carry") or {}).items()
        }
        return s


def sessionize(events: Iterable[tuple[str, str, float]],
               gap_s: float = 1800.0) -> list[list[str]]:
    """Batch sessionization for eval: (user, item, ts) triples ->
    per-user, time-sorted item sequences split on ``gap_s``.  Unlike
    the streaming path this SORTS first (the eval split reads a bounded
    holdout, so the full sort is affordable and makes the split exact);
    consecutive duplicates collapse like the streaming self-loop
    rule."""
    by_user: dict[str, list[tuple[float, str]]] = {}
    for user, item, ts in events:
        by_user.setdefault(user, []).append((ts, item))
    sessions: list[list[str]] = []
    for user in sorted(by_user):
        evs = sorted(by_user[user])
        cur: list[str] = []
        prev_ts = None
        for ts, item in evs:
            if prev_ts is not None and ts - prev_ts > gap_s:
                if len(cur) > 0:
                    sessions.append(cur)
                cur = []
            if not cur or cur[-1] != item:
                cur.append(item)
            prev_ts = ts
        if cur:
            sessions.append(cur)
    return sessions


class TransitionStore:
    """Decayed (src item -> dst item) transition weights: CSR arrays +
    a pending-delta overlay.  All mutation happens under ``_lock``;
    :meth:`top_successors` snapshots under the lock and ranks outside
    it."""

    def __init__(self, half_life_s: float = 604800.0,
                 t0: Optional[float] = None, pending_limit: int = 4096):
        if half_life_s <= 0:
            raise ValueError(
                f"halfLifeSec must be > 0, got {half_life_s}"
            )
        self._lock = threading.Lock()
        self.half_life_s = float(half_life_s)
        self.t0 = float(t0 if t0 is not None else time.time())
        self.pending_limit = int(pending_limit)
        self.item_ids: list[str] = []
        self._ix: dict[str, int] = {}
        # CSR over interned indices; indptr has n_rows+1 entries where
        # n_rows tracks the interned-item count at last compaction
        self._indptr = np.zeros(1, np.int64)
        self._indices = np.zeros(0, np.int64)
        self._data = np.zeros(0, np.float64)
        # (src_ix, dst_ix) -> reference-space weight, not yet in CSR
        self._pending: dict[tuple[int, int], float] = {}
        self._max_w = 0.0
        self.transitions_folded = 0
        self.compactions = 0

    # -- interning ---------------------------------------------------------
    def _intern_locked(self, item: str) -> int:
        ix = self._ix.get(item)
        if ix is None:
            ix = len(self.item_ids)
            self._ix[item] = ix
            self.item_ids.append(item)
        return ix

    # -- writes ------------------------------------------------------------
    def add(self, src: str, dst: str, te: float) -> None:
        self.add_many([(src, dst, te)])

    def add_many(self, transitions: Iterable[tuple[str, str, float]]) -> int:
        """Fold ``(src, dst, te)`` transitions in; returns the count.
        Each contributes ``2 ** ((te - t0) / half_life)`` in
        reference-time space."""
        n = 0
        with self._lock:
            for src, dst, te in transitions:
                si = self._intern_locked(src)
                di = self._intern_locked(dst)
                w = 2.0 ** ((float(te) - self.t0) / self.half_life_s)
                key = (si, di)
                nw = self._pending.get(key, 0.0) + w
                self._pending[key] = nw
                if nw > self._max_w:
                    self._max_w = nw
                n += 1
            self.transitions_folded += n
            self._maybe_rebase_locked()
            if len(self._pending) > self.pending_limit:
                self._compact_locked()
        return n

    def _maybe_rebase_locked(self) -> None:
        if self._max_w <= 0:
            return
        exp = math.log2(self._max_w + 1e-300)
        if exp <= _REBASE_EXP:
            return
        # advance the reference so the max weight rescales to 1.0.
        # The shift is derived from the weights themselves, not wall
        # clock, so a synthetic-time replay rebases identically.
        self.t0 += exp * self.half_life_s
        scale = 2.0 ** -exp
        self._data *= scale
        for key in self._pending:
            self._pending[key] *= scale
        self._max_w *= scale

    def _compact_locked(self) -> None:
        """Merge pending deltas into fresh CSR arrays (row-major,
        columns sorted within a row)."""
        rows: dict[int, dict[int, float]] = {}
        n_rows_old = len(self._indptr) - 1
        for si in range(n_rows_old):
            lo, hi = self._indptr[si], self._indptr[si + 1]
            if hi > lo:
                rows[si] = dict(zip(
                    (int(d) for d in self._indices[lo:hi]),
                    (float(w) for w in self._data[lo:hi]),
                ))
        for (si, di), w in self._pending.items():
            row = rows.setdefault(si, {})
            row[di] = row.get(di, 0.0) + w
        n_rows = len(self.item_ids)
        indptr = np.zeros(n_rows + 1, np.int64)
        indices: list[int] = []
        data: list[float] = []
        for si in range(n_rows):
            row = rows.get(si)
            if row:
                for di in sorted(row):
                    indices.append(di)
                    data.append(row[di])
            indptr[si + 1] = len(indices)
        self._indptr = indptr
        self._indices = np.asarray(indices, np.int64)
        self._data = np.asarray(data, np.float64)
        self._pending = {}
        self._max_w = float(self._data.max()) if len(self._data) else 0.0
        self.compactions += 1

    def compact(self) -> None:
        with self._lock:
            self._compact_locked()

    # -- reads -------------------------------------------------------------
    @property
    def n_items(self) -> int:
        with self._lock:
            return len(self.item_ids)

    @property
    def n_pairs(self) -> int:
        """Distinct (src, dst) pairs resident (CSR + pending overlay)."""
        with self._lock:
            csr_keys = set()
            for si in range(len(self._indptr) - 1):
                lo, hi = self._indptr[si], self._indptr[si + 1]
                for di in self._indices[lo:hi]:
                    csr_keys.add((si, int(di)))
            return len(csr_keys | set(self._pending))

    def weight(self, src: str, dst: str,
               now: Optional[float] = None) -> float:
        """One decayed transition weight AT ``now`` (query-time
        space)."""
        with self._lock:
            si = self._ix.get(src)
            di = self._ix.get(dst)
            if si is None or di is None:
                return 0.0
            w = self._pending.get((si, di), 0.0)
            if si < len(self._indptr) - 1:
                lo, hi = self._indptr[si], self._indptr[si + 1]
                pos = np.searchsorted(self._indices[lo:hi], di)
                if pos < hi - lo and self._indices[lo + pos] == di:
                    w += float(self._data[lo + pos])
            t0 = self.t0
        if now is None:
            now = time.time()
        return w * 2.0 ** ((t0 - now) / self.half_life_s)

    def top_successors(self, src: str, k: int, blacklist=(),
                       now: Optional[float] = None
                       ) -> list[tuple[str, float]]:
        """Top-k next items after ``src`` by decayed weight, scored at
        ``now`` (scores are comparable across queries)."""
        if k <= 0:
            return []
        with self._lock:
            si = self._ix.get(src)
            if si is None:
                return []
            merged: dict[int, float] = {}
            if si < len(self._indptr) - 1:
                lo, hi = self._indptr[si], self._indptr[si + 1]
                for di, w in zip(self._indices[lo:hi],
                                 self._data[lo:hi]):
                    merged[int(di)] = float(w)
            for (psi, pdi), w in self._pending.items():
                if psi == si:
                    merged[pdi] = merged.get(pdi, 0.0) + w
            ids = self.item_ids
            cand = [(ids[di], w) for di, w in merged.items() if w > 0]
            t0 = self.t0
        if blacklist:
            bl = set(blacklist)
            cand = [(i, w) for i, w in cand if i not in bl]
        if not cand:
            return []
        if now is None:
            now = time.time()
        scale = 2.0 ** ((t0 - now) / self.half_life_s)
        cand.sort(key=lambda iw: (-iw[1], iw[0]))
        return [(i, w * scale) for i, w in cand[:k]]

    # -- persistence -------------------------------------------------------
    def to_doc(self) -> dict:
        with self._lock:
            self._compact_locked()
            return {
                "halfLifeSec": self.half_life_s,
                "t0": self.t0,
                "pendingLimit": self.pending_limit,
                "itemIds": list(self.item_ids),
                "indptr": [int(x) for x in self._indptr],
                "indices": [int(x) for x in self._indices],
                "data": [float(x) for x in self._data],
                "transitionsFolded": self.transitions_folded,
            }

    @classmethod
    def from_doc(cls, doc: dict) -> "TransitionStore":
        s = cls(
            half_life_s=float(doc["halfLifeSec"]), t0=float(doc["t0"]),
            pending_limit=int(doc.get("pendingLimit", 4096)),
        )
        s.item_ids = [str(i) for i in doc["itemIds"]]
        s._ix = {i: n for n, i in enumerate(s.item_ids)}
        s._indptr = np.asarray(doc["indptr"], np.int64)
        s._indices = np.asarray(doc["indices"], np.int64)
        s._data = np.asarray(doc["data"], np.float64)
        s._max_w = float(s._data.max()) if len(s._data) else 0.0
        s.transitions_folded = int(doc.get("transitionsFolded", 0))
        return s
