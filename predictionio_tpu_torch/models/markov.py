"""Markov chain next-state model (port of
``predictionio_tpu/models/markov.py``, numpy on the host as there).

Re-expression of reference `e2/engine/MarkovChain.scala:25-90`: a
row-normalized top-N transition matrix built from (state, next-state) pair
counts.  Counting is one segment-sum over pair codes; top-N per row keeps
the model sparse like the reference's ``CoordinateMatrix`` build.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["MarkovChainModel", "train_markov_chain"]


@dataclass
class MarkovChainModel:
    """Per-state top-N transitions: indices [S, N], probabilities [S, N]
    (prob 0 marks padding)."""

    next_ix: np.ndarray
    prob: np.ndarray
    n_states: int

    def predict(self, state: int) -> list[tuple[int, float]]:
        """Next-state distribution (reference `MarkovChainModel.predict`)."""
        if not (0 <= state < self.n_states):
            return []
        row_p = self.prob[state]
        keep = row_p > 0
        return list(zip(self.next_ix[state][keep].tolist(),
                        row_p[keep].tolist()))


def train_markov_chain(
    from_ix: np.ndarray,
    to_ix: np.ndarray,
    n_states: int,
    top_n: int = 10,
) -> MarkovChainModel:
    pair = from_ix.astype(np.int64) * n_states + to_ix.astype(np.int64)
    uniq, counts = np.unique(pair, return_counts=True)
    rows = (uniq // n_states).astype(np.int64)
    cols = (uniq % n_states).astype(np.int64)

    next_ix = np.zeros((n_states, top_n), dtype=np.int32)
    prob = np.zeros((n_states, top_n), dtype=np.float32)
    order = np.lexsort((-counts, rows))
    rows_s, cols_s, counts_s = rows[order], cols[order], counts[order]
    row_starts = np.searchsorted(rows_s, np.arange(n_states + 1))
    for s in range(n_states):
        lo, hi = row_starts[s], row_starts[s + 1]
        if lo == hi:
            continue
        take = min(top_n, hi - lo)
        c = counts_s[lo : lo + take].astype(np.float32)
        total = counts_s[lo:hi].sum()
        next_ix[s, :take] = cols_s[lo : lo + take]
        prob[s, :take] = c / total
    return MarkovChainModel(next_ix=next_ix, prob=prob, n_states=n_states)
