"""Sessions: gap-based sessionization and a decayed Markov transition
store (port of ``predictionio_tpu/sessions``).

* :class:`Sessionizer` — streaming gap-based session windows over
  (user, item, timestamp) triples, with per-user carry state so a
  transition spanning two cursor scans still counts exactly once.
* :class:`TransitionStore` — a sparse CSR-backed (prev-item ->
  next-item) transition-weight matrix with trending's half-life decay
  (weights live in reference-time space; the reference epoch rebases
  before f64 exponents overflow) and top-K successor extraction.

Both are host-side numpy data structures, as in the reference: no torch,
no storage imports.  ``templates/nextitem.py`` owns the event-store
cursor contract and feeds scans through them.
"""

from .store import Sessionizer, TransitionStore, sessionize

__all__ = ["Sessionizer", "TransitionStore", "sessionize"]
