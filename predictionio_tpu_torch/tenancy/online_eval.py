"""Online (interleaved) evaluation: per-variant outcome aggregation.

Port of ``predictionio_tpu/tenancy/online_eval.py``.  Every served
query books an impression under its (app, variant); the variant tag
rides the feedback loop into the event store (the serving edge stamps
it on the ``pio_pr`` event; clients echo it on their conversion
events), and this aggregator scans the store past its cursor
(``find_rows_since``, the incremental scan fold-in reads) to count the
variant-attributed conversions.

The result, ``rate = conversions / impressions`` per (app, variant), is
exported three ways: ``pio_variant_requests_total`` /
``pio_variant_feedback_total`` / ``pio_variant_outcome_rate`` on
``/metrics``, the ``onlineEval`` block of ``GET /debug/tenants``, and
``candidate`` records of a run manifest
(``$PIO_TPU_HOME/telemetry/runs/hive-online-<id>/run.jsonl``).

Impressions are in-process counters; conversions come from the store
scan.  Refreshes are serialized (the serving loop's and a caller's
may overlap): two scans from one cursor would count its rows twice.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import uuid
from typing import Optional

from ..obs import (
    ONLINE_EVAL_CURSOR_LAG,
    VARIANT_FEEDBACK_TOTAL,
    VARIANT_RATE,
    VARIANT_REQUESTS_TOTAL,
)

__all__ = ["OnlineEval", "merge_cursor"]

logger = logging.getLogger(__name__)

# events that are impressions flowing back through the feedback loop,
# not client conversions: counting them would make every rate ~1.0
_FEEDBACK_EVENT = "predict"


def merge_cursor(old, new):
    """Component-wise monotone merge of two store cursors.  A sharded
    scan with ``tolerate_unavailable=True`` while a shard is down can
    hand back a component behind what an earlier scan covered; adopting
    it would re-scan (and double-count) conversions.  Int cursors take
    the max; JSON shard-vector strings merge per component over the
    union of shard keys.  Unparseable inputs fall back to ``new``."""
    if old is None:
        return new
    if isinstance(old, int) and isinstance(new, int):
        return max(old, new)
    try:
        ov = json.loads(old) if isinstance(old, str) else old
        nv = json.loads(new) if isinstance(new, str) else new
        if isinstance(ov, dict) and isinstance(nv, dict):
            merged = {
                k: max(int(ov.get(k, 0)), int(nv.get(k, 0)))
                for k in set(ov) | set(nv)
            }
            return json.dumps(
                {k: merged[k] for k in sorted(merged, key=int)}
            )
        if isinstance(ov, int) and isinstance(nv, int):
            return max(ov, nv)
    except (ValueError, TypeError):
        pass
    return new


class OnlineEval:
    def __init__(self, salt: str = "pio-hive",
                 manifest_id: Optional[str] = None,
                 scan_page: int = 5000):
        self._lock = threading.Lock()
        # one refresh at a time: each reads a cursor, scans past it and
        # advances it
        self._refresh_lock = threading.Lock()
        # (app, variant) -> {"impressions": n, "conversions": n}
        self._stats: dict[tuple[str, str], dict] = {}
        # app -> opaque store cursor (an int for the single-file store,
        # a JSON shard-vector string for the sharded store)
        self._cursors: dict[str, object] = {}
        self.salt = salt
        self.scan_page = scan_page
        self.manifest_id = manifest_id or f"hive-online-{uuid.uuid4().hex[:8]}"
        self._manifest = None
        self.refreshes = 0

    def _cell(self, app: str, variant: str) -> dict:
        key = (app, variant)
        cell = self._stats.get(key)
        if cell is None:
            cell = {"impressions": 0, "conversions": 0}
            self._stats[key] = cell
        return cell

    def impression(self, app: str, variant: str) -> None:
        with self._lock:
            self._cell(app, variant)["impressions"] += 1
        VARIANT_REQUESTS_TOTAL.labels(app=app, variant=variant).inc()

    # -- conversion scan ---------------------------------------------------
    def refresh(self, event_store, app_ids: dict[str, int]) -> dict:
        """Scan one page of each app's store past its cursor for
        variant-attributed conversion events, update the rates and
        append the table to the manifest.  Returns :meth:`snapshot`.
        Store errors are logged and skipped: online eval never fails
        serving."""
        with self._refresh_lock:
            if hasattr(event_store, "find_rows_since"):
                for app, app_id in sorted(app_ids.items()):
                    self._scan_app(event_store, app, app_id)
            snap = self.snapshot()
            self._export(snap)
        return snap

    def _scan_app(self, event_store, app: str, app_id: int) -> None:
        with self._lock:
            cursor = self._cursors.get(app, 0)
        # on a sharded store a down shard's cursor component freezes
        # while the healthy shards keep feeding conversions
        kw = ({"tolerate_unavailable": True}
              if hasattr(event_store, "shards") else {})
        try:
            rows, new_cursor = event_store.find_rows_since(
                app_id, 0, cursor=cursor, limit=self.scan_page, **kw,
            )
        except Exception:
            logger.exception("online-eval scan failed for app %s", app)
            return
        counted: dict[str, int] = {}
        for r in rows:
            # r = (rowid, event_id, event, entity_type, entity_id, tet,
            #      tei, properties, event_time, tags, pr_id,
            #      creation_time)
            if r[2] == _FEEDBACK_EVENT:
                continue
            try:
                variant = json.loads(r[7]).get("variant")
            except (json.JSONDecodeError, TypeError, AttributeError):
                continue
            if variant:
                counted[str(variant)] = counted.get(str(variant), 0) + 1
        with self._lock:
            self._cursors[app] = merge_cursor(self._cursors.get(app),
                                              new_cursor)
            merged = self._cursors[app]
            for variant, n in counted.items():
                self._cell(app, variant)["conversions"] += n
        for variant, n in counted.items():
            VARIANT_FEEDBACK_TOTAL.labels(app=app, variant=variant).inc(n)
        try:
            ONLINE_EVAL_CURSOR_LAG.labels(app=app).set(
                float(event_store.cursor_lag(app_id, 0, merged)))
        except Exception:
            logger.debug("cursor-lag probe failed for app %s", app,
                         exc_info=True)

    def _export(self, snap: dict) -> None:
        """The rate gauges, and one manifest record per (app,
        variant)."""
        with self._lock:
            self.refreshes += 1
            refresh_ix = self.refreshes
        for key, cell in snap.items():
            app, _, variant = key.partition("/")
            VARIANT_RATE.labels(app=app, variant=variant).set(cell["rate"])
        manifest = self._ensure_manifest()
        if manifest is None:
            return
        for key, cell in sorted(snap.items()):
            app, _, variant = key.partition("/")
            manifest.candidate(
                refresh_ix, app=app, variant=variant,
                impressions=cell["impressions"],
                conversions=cell["conversions"],
                rate=cell["rate"],
            )

    def _ensure_manifest(self):
        if self._manifest is None:
            try:
                from ..obs.runlog import RunManifest

                self._manifest = RunManifest(
                    self.manifest_id, kind="online_eval",
                    meta={"salt": self.salt, "startedAt": time.time()},
                )
            except Exception:
                logger.exception("online-eval manifest unavailable")
                return None
        return self._manifest

    def snapshot(self) -> dict:
        with self._lock:
            return {
                f"{app}/{variant}": {
                    "impressions": cell["impressions"],
                    "conversions": cell["conversions"],
                    "rate": (
                        round(cell["conversions"] / cell["impressions"], 6)
                        if cell["impressions"] else 0.0
                    ),
                }
                for (app, variant), cell in sorted(self._stats.items())
            }

    def close(self) -> None:
        with self._lock:
            refreshes = self.refreshes
        m = self._manifest
        if m is not None:
            m.finalize("completed", refreshes=refreshes)
