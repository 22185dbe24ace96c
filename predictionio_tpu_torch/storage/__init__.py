"""Host-side data model of the port: id dictionaries and ratings.

The event store (``event``/``levents``/``sqlite_events``/``metadata``/
``registry``) is not ported yet; until it is, training data reaches an
engine through a :class:`MemoryStore` carried by the ``WorkflowContext``.
"""

from dataclasses import dataclass, field

from .bimap import BiMap, StringIndex
from .columnar import Ratings

__all__ = [
    "BiMap",
    "MemoryStore",
    "Ratings",
    "StringIndex",
]


@dataclass
class MemoryStore:
    """In-memory training data for an engine: the rating COO and the
    item properties (``{item_id: {"categories": [...], ...}}``) that
    query filters read."""

    ratings: Ratings
    items: dict[str, dict] = field(default_factory=dict)
