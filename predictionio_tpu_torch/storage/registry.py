"""Env-var-driven storage registry.

Copy of ``predictionio_tpu/storage/registry.py`` for the port, with the
same variables and the same ``$PIO_TPU_HOME`` layout (``eventdata.db``,
``metadata.db``, ``models/<instance>/``), so an app filled by either
package trains and serves in the other.  Parity with the reference
`Storage` object (`data/.../storage/Storage.scala:40-296`):
``PIO_STORAGE_SOURCES_<NAME>_TYPE`` (+ ``_PATH``) define named sources,
and ``PIO_STORAGE_REPOSITORIES_{METADATA,EVENTDATA,MODELDATA}_{NAME,
SOURCE}`` map the three repositories onto them.  Builtin types are
``sqlite``, ``sqlite-sharded`` (an event store of ``SHARDS`` files,
default 4, under the directory ``PATH``), ``memory`` and ``localfs``
(for model files), and for metadata ``jsonfs`` (a JSON document a
record under the directory ``PATH``, ``file_metadata.py``); a dotted
import path names a third-party backend class, built with the source's
config dict.  Without env config everything is SQLite under
``$PIO_TPU_HOME`` (default ``~/.predictionio_tpu``).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Optional

from .event import Event, now_utc
from .levents import EventStore, MemoryEventStore
from .metadata import MetadataStore
from .sqlite_events import SQLiteEventStore

__all__ = ["Storage", "StorageError", "get_storage", "reset_storage"]


class StorageError(RuntimeError):
    pass


def _home(env: dict[str, str]) -> Path:
    return Path(
        env.get("PIO_TPU_HOME") or os.path.expanduser("~/.predictionio_tpu")
    )


class Storage:
    """One resolved storage configuration: event store + metadata + model dir."""

    def __init__(self, env: Optional[dict[str, str]] = None):
        self.env = dict(env if env is not None else os.environ)
        self._lock = threading.Lock()
        self._event_store: Optional[EventStore] = None
        self._metadata: Optional[MetadataStore] = None

    # -- source resolution ------------------------------------------------
    def _repo_source(self, repo: str) -> tuple[str, dict[str, str]]:
        """Resolve repository -> (type, source config).  Mirrors
        `Storage.scala:45-149` (sourcesToClientMeta / repositoriesToDataObjectMeta).
        """
        name = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_NAME", repo.lower())
        source = self.env.get(f"PIO_STORAGE_REPOSITORIES_{repo}_SOURCE", "")
        if source:
            stype = self.env.get(f"PIO_STORAGE_SOURCES_{source}_TYPE")
            if stype is None:
                raise StorageError(
                    f"repository {repo} points at source {source} but "
                    f"PIO_STORAGE_SOURCES_{source}_TYPE is not set"
                )
            conf = {
                k[len(f"PIO_STORAGE_SOURCES_{source}_"):].lower(): v
                for k, v in self.env.items()
                if k.startswith(f"PIO_STORAGE_SOURCES_{source}_")
            }
            # dotted TYPEs are python import paths: case-sensitive
            return (
                stype if "." in stype else stype.lower()
            ), conf
        # defaults under home: sqlite DBs, plain dir for model blobs
        home = _home(self.env)
        if repo == "MODELDATA":
            return "localfs", {"type": "localfs", "path": str(home / "models")}
        return "sqlite", {"type": "sqlite", "path": str(home / f"{name}.db")}

    # -- pluggable backends (Storage.scala:183-224) ------------------------
    @staticmethod
    def _load_custom(stype: str, conf: dict[str, str]):
        """Dotted-path TYPE -> import the class and instantiate it with
        the source's config dict (lower-cased suffix keys: ``type``,
        ``path``, anything else the operator set on the source).  The
        constructor contract for third-party backends is exactly
        ``Backend(conf)``: the analogue of the reference's reflective
        ``getConstructors ... newInstance(client, config)``."""
        import importlib

        mod_name, _, attr = stype.rpartition(".")
        try:
            cls = getattr(importlib.import_module(mod_name), attr)
        except (ImportError, AttributeError) as e:
            raise StorageError(
                f"cannot load storage backend {stype!r}: {e}"
            ) from e
        try:
            return cls(conf)
        except Exception as e:  # noqa: BLE001 — config errors surface here
            raise StorageError(
                f"storage backend {stype!r} failed to initialize "
                f"with config {sorted(conf)}: {e}"
            ) from e

    # -- accessors (Storage.scala:259-290) --------------------------------
    def get_event_store(self) -> EventStore:
        with self._lock:
            if self._event_store is None:
                stype, conf = self._repo_source("EVENTDATA")
                if stype == "memory":
                    self._event_store = MemoryEventStore()
                elif stype == "sqlite":
                    path = conf.get("path", ":memory:")
                    if path != ":memory:":
                        Path(path).parent.mkdir(parents=True, exist_ok=True)
                    self._event_store = SQLiteEventStore(path)
                elif stype == "sqlite-sharded":
                    # entity-hash sharded writes (region-parallel HBase
                    # analogue); PATH is a directory, SHARDS the count
                    from .sharded_events import ShardedSQLiteEventStore

                    try:
                        self._event_store = ShardedSQLiteEventStore(
                            conf.get("path")
                            or str(_home(self.env) / "eventdata-shards"),
                            n_shards=int(conf.get("shards", "4")),
                        )
                    except ValueError as e:
                        # bad SHARDS value, count < 1, or a marker
                        # mismatch — all config-class errors
                        raise StorageError(
                            f"sqlite-sharded source: {e}"
                        ) from e
                elif "." in stype:
                    self._event_store = self._load_custom(stype, conf)
                else:
                    raise StorageError(f"unknown event store type: {stype}")
            return self._event_store

    def get_metadata(self) -> MetadataStore:
        with self._lock:
            if self._metadata is None:
                stype, conf = self._repo_source("METADATA")
                if stype == "memory":
                    self._metadata = MetadataStore(":memory:")
                elif stype == "sqlite":
                    path = conf.get("path", ":memory:")
                    if path != ":memory:":
                        Path(path).parent.mkdir(parents=True, exist_ok=True)
                    self._metadata = MetadataStore(path)
                elif stype == "jsonfs":
                    # the JSON-document file tree (file_metadata.py)
                    from .file_metadata import FileMetadataStore

                    path = conf.get("path") or str(
                        _home(self.env) / "metadata-json"
                    )
                    self._metadata = FileMetadataStore(path)
                elif "." in stype:
                    self._metadata = self._load_custom(stype, conf)
                else:
                    raise StorageError(f"unknown metadata store type: {stype}")
            return self._metadata

    def model_data_dir(self) -> Path:
        stype, conf = self._repo_source("MODELDATA")
        if stype in ("sqlite", "localfs", "memory"):
            p = Path(conf.get("path", str(_home(self.env) / "models")))
            if p.suffix == ".db":
                p = p.with_suffix("")
            p.mkdir(parents=True, exist_ok=True)
            return p
        raise StorageError(f"unknown model data type: {stype}")

    def verify_all_data_objects(self) -> None:
        """Touch all repositories, incl. a test event write to app 0."""
        self.get_metadata().app_get_all()
        es = self.get_event_store()
        es.init_channel(0)
        eid = es.insert(
            Event(event="test", entity_type="test", entity_id="test",
                  event_time=now_utc()),
            app_id=0,
        )
        es.delete(eid, app_id=0)
        self.model_data_dir()

    def close(self) -> None:
        with self._lock:
            if self._event_store is not None:
                self._event_store.close()
                self._event_store = None
            if self._metadata is not None:
                self._metadata.close()
                self._metadata = None


_global: Optional[Storage] = None
_global_lock = threading.Lock()


def get_storage() -> Storage:
    global _global
    with _global_lock:
        if _global is None:
            _global = Storage()
        return _global


def reset_storage(storage: Optional[Storage] = None) -> None:
    """Swap the process-global storage (tests / embedding)."""
    global _global
    with _global_lock:
        if _global is not None:
            _global.close()
        _global = storage
