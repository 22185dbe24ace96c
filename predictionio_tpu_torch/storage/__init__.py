"""Storage layer of the port: event data model, event stores, metadata
store, id maps and the registry that resolves them.

Copies of ``predictionio_tpu/storage``'s host modules (the port imports
nothing of the JAX package): embedded SQLite and in-memory backends with
the reference's schemas and ``$PIO_TPU_HOME`` layout, a columnar
batch read path (struct-of-arrays -> the ``Ratings`` COO the trainer
stages onto the card; the native fused scan, with its snapshot cache),
the entity-hash sharded SQLite store (``sharded_events``), the
group-commit ingest WAL (``wal``) and the engine-facing facades
(``store``; the deprecated ``views``).
"""

from .aggregate import aggregate_properties, aggregate_properties_single
from .bimap import BiMap, EntityIdIxMap, EntityMap, StringIndex
from .columnar import EventFrame, Ratings, dedup_coo, events_to_frame
from .event import (
    DataMap,
    Event,
    EventValidationError,
    PropertyMap,
    format_time,
    now_utc,
    parse_time,
    validate_event,
)
from .levents import (
    NO_TARGET,
    EventStore,
    MemoryEventStore,
    ShardUnavailableError,
)
from .file_metadata import FileMetadataStore
from .metadata import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    MetadataStore,
    Model,
)
from .registry import Storage, StorageError, get_storage, reset_storage
from .sharded_events import ShardedSQLiteEventStore
from .sqlite_events import SQLiteEventStore
from .store import LEventStore, PEventStore, app_name_to_id

__all__ = [
    "aggregate_properties",
    "aggregate_properties_single",
    "BiMap",
    "EntityIdIxMap",
    "EntityMap",
    "StringIndex",
    "EventFrame",
    "Ratings",
    "dedup_coo",
    "events_to_frame",
    "DataMap",
    "Event",
    "EventValidationError",
    "PropertyMap",
    "format_time",
    "now_utc",
    "parse_time",
    "validate_event",
    "NO_TARGET",
    "EventStore",
    "MemoryEventStore",
    "ShardUnavailableError",
    "SQLiteEventStore",
    "ShardedSQLiteEventStore",
    "LEventStore",
    "PEventStore",
    "app_name_to_id",
    "AccessKey",
    "App",
    "Channel",
    "EngineInstance",
    "EngineManifest",
    "EvaluationInstance",
    "FileMetadataStore",
    "MetadataStore",
    "Model",
    "Storage",
    "StorageError",
    "get_storage",
    "reset_storage",
]
