"""Columnar scan cache: npz snapshots of ``find_columnar`` and
``find_ratings`` results.

Copy of ``predictionio_tpu/storage/scan_cache.py`` for the port, with the
same file layout under ``$PIO_TPU_HOME/scan_cache``.  Repeat trains and
evaluation sweeps re-scan the same event table every run; this cache
snapshots the column arrays to one ``.npz`` per (database, table, query,
table state) and serves later identical scans from disk.

Correctness: the cache key includes a monotonic per-table write-version
counter (bumped inside every write's transaction,
``SQLiteEventStore._bump_version``; a rolled-back bulk scope rolls its
bump back too) plus the database file's identity: its inode and a random
token written once into the file (``SQLiteEventStore.
_snapshot_fingerprint``), so deleting and recreating the db cannot alias
the old file's counters.  Unlike the reference, whose identity is the
inode and the ctime, the key holds nothing that a write to ANOTHER table
of the same file changes: an app's snapshots survive writes to every
other app of the store.  Snapshots are stored only when the version is
unchanged across the scan and never from inside a bulk() scope, so a
published snapshot always describes committed data.  A stale entry is
never looked up again and is eventually pruned.

Enabled with ``PIO_TPU_SCAN_CACHE=1`` (opt-in: the write amplification
is only worth it for workflows that re-read), or per call with
``cache=True``.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_KEEP = 32   # newest snapshots kept per prune


def enabled(flag: Optional[bool]) -> bool:
    if flag is not None:
        return flag
    return os.environ.get("PIO_TPU_SCAN_CACHE") == "1"


def cache_dir() -> Path:
    home = os.environ.get("PIO_TPU_HOME") or os.path.expanduser(
        "~/.predictionio_tpu"
    )
    p = Path(home) / "scan_cache"
    p.mkdir(parents=True, exist_ok=True)
    return p


def key(db_path: str, table: str, fingerprint: tuple, query_repr) -> str:
    blob = json.dumps(
        [os.path.abspath(db_path), table, list(fingerprint), query_repr],
        sort_keys=True, default=str,
    )
    return hashlib.sha1(blob.encode()).hexdigest()


_FIELDS = (
    "event", "entity_type", "entity_id", "target_entity_type",
    "target_entity_id", "event_time_ms", "value",
)


def load(k: str):
    """Cached EventFrame, or None.  Never raises (cache is best-effort)."""
    path = cache_dir() / f"{k}.npz"
    if not path.exists():
        return None
    try:
        from .columnar import EventFrame

        with np.load(path, allow_pickle=False) as z:
            def col(name, as_obj):
                if name not in z.files:
                    return None
                a = z[name]
                return a.astype(object) if as_obj else a

            frame = EventFrame(
                event=col("event", True),
                entity_type=col("entity_type", True),
                entity_id=col("entity_id", True),
                target_entity_type=col("target_entity_type", True),
                target_entity_id=col("target_entity_id", True),
                event_time_ms=col("event_time_ms", False),
                properties=None,      # snapshots never cover property scans
                value=col("value", False),
            )
        os.utime(path, None)          # LRU touch for pruning
        return frame
    except Exception as e:            # corrupt or mid-write: ignore
        logger.debug("scan cache read failed (%s); rescanning", e)
        return None


def _publish(filename: str, arrays: dict) -> None:
    """Atomic snapshot publish shared by the frame and ratings caches:
    write to a temp file in the cache dir, os.replace into place,
    prune.  Best-effort by contract — callers wrap in try/except."""
    d = cache_dir()
    tmp = tempfile.NamedTemporaryFile(
        dir=d, suffix=".tmp", delete=False
    )
    try:
        np.savez(tmp, **arrays)
        tmp.close()
        os.replace(tmp.name, d / filename)
    finally:
        try:
            os.unlink(tmp.name)
        except OSError:
            pass
    _prune(d)


def store(k: str, frame) -> None:
    """Snapshot a property-free frame; best-effort, atomic publish."""
    if frame.properties is not None:
        return                        # parsed-dict column: not cacheable
    try:
        arrays = {}
        for name in _FIELDS:
            a = getattr(frame, name)
            if a is None:
                continue
            if a.dtype == object:
                # unicode dtype round-trips without pickle; columns with
                # SQL NULLs (None) are not representable -> skip caching
                # the whole frame rather than corrupt a value
                if any(x is None for x in a.tolist()):
                    return
                a = a.astype(str)
            arrays[name] = a
        _publish(f"{k}.npz", arrays)
    except Exception as e:
        logger.debug("scan cache write failed (%s)", e)


def _mtime(p: Path) -> float:
    # another thread's prune (the sharded store's shards publish at
    # once) may have removed the file since the glob
    try:
        return p.stat().st_mtime
    except FileNotFoundError:
        return float("-inf")


def _prune(d: Path) -> None:
    snaps = sorted(d.glob("*.npz"), key=_mtime)
    for p in snaps[:-_KEEP]:
        try:
            p.unlink()
        except OSError:
            pass


def load_ratings(k: str):
    """Cached Ratings snapshot (the fused find_ratings result), or
    None.  Same correctness story as frames: the key embeds the table's
    write-version + db identity, so a stale snapshot is never LOOKED UP,
    only orphaned."""
    path = cache_dir() / f"{k}.ratings.npz"
    if not path.exists():
        return None
    try:
        from .bimap import StringIndex
        from .columnar import Ratings

        with np.load(path, allow_pickle=False) as z:
            r = Ratings(
                user_ix=z["user_ix"],
                item_ix=z["item_ix"],
                rating=z["rating"],
                users=StringIndex(z["user_ids"].astype(object)),
                items=StringIndex(z["item_ids"].astype(object)),
            )
        os.utime(path, None)
        return r
    except Exception as e:  # noqa: BLE001 — cache is best-effort
        logger.debug("ratings cache read failed (%s); rescanning", e)
        return None


def store_ratings(k: str, ratings) -> None:
    """Snapshot a Ratings; best-effort, atomic publish."""
    try:
        _publish(f"{k}.ratings.npz", dict(
            user_ix=ratings.user_ix,
            item_ix=ratings.item_ix,
            rating=ratings.rating,
            user_ids=ratings.users.ids.astype(str),
            item_ids=ratings.items.ids.astype(str),
        ))
    except Exception as e:  # noqa: BLE001
        logger.debug("ratings cache write failed (%s)", e)
