"""pio-live: incremental ALS fold-in and delta model push.

Port of ``predictionio_tpu/live/``, closing the gap between fresh
events and fresh predictions without a full ``train`` and a
stop-the-world ``/reload``:

* :mod:`.watermark` — per-(app, channel) rowid high-water-mark cursor
  over the event store (a shard vector on the sharded store), persisted
  next to the model; yields only the events since the last fold-in.
* :mod:`.foldin` — the fixed-capacity row solver: touched user rows
  (and brand-new item rows) solved against the frozen opposite factor
  table through `models/als.py`'s ``_solve_buckets``, on the card
  (``solver="pallas"`` launches the SPD solve kernel); padded pow2
  shapes keep one ``live.foldin_solve`` signature per rung
  (``/debug/xray``).
* :mod:`.apply` — applies a persisted delta link to an in-memory model
  (attribute swaps, append-only id maps and a row-wise patch of the
  cached device tables: no reader lock, no re-upload).
* :mod:`.daemon` — :class:`FoldInRunner`: scan -> solve -> publish as
  a versioned delta chain (`workflow/model_io.py`), driven by
  ``python -m predictionio_tpu_torch foldin [--watch]``.

The serving side (`server/serving.py`) polls the chain
(``deploy --foldin-poll``) or is told to apply it (``POST
/foldin/apply``, the replica router's ``--push-foldin``) and applies new
links under its state lock.
"""

from .apply import apply_model_delta, model_supports_deltas
from .daemon import FoldInRunner
from .foldin import FoldInPlan, FoldInSolver, compute_foldin
from .watermark import (
    WATERMARK_FILE,
    ScanBatch,
    Watermark,
    WatermarkStore,
    scan_new_ratings,
)

__all__ = [
    "FoldInPlan",
    "FoldInRunner",
    "FoldInSolver",
    "ScanBatch",
    "WATERMARK_FILE",
    "Watermark",
    "WatermarkStore",
    "apply_model_delta",
    "compute_foldin",
    "model_supports_deltas",
    "scan_new_ratings",
]
