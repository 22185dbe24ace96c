"""Metadata store: apps, access keys, channels, engine manifests,
engine instances, evaluation instances and model blobs.

Copy of ``predictionio_tpu/storage/metadata.py`` for the port, with the
same SQLite schema, so a ``metadata.db`` written by either package is
read by the other.  It replaces the reference's Elasticsearch metadata
backend and the record definitions in `storage/{Apps,AccessKeys,Channels,
EngineManifests,EngineInstances,EvaluationInstances,Models}.scala` with
one embedded SQLite database; the ``ESSequences`` id generator becomes
SQLite AUTOINCREMENT.  Model blobs (reference `Models.scala:30-48`) hold
the model manifest JSON that ``workflow/model_io.py`` writes; engine
manifests are what the CLI's ``build`` registers; evaluation instances
are what ``workflow/evaluate.py`` records for each sweep.
"""

from __future__ import annotations

import json
import secrets
import re
import sqlite3
import threading

from ._sqlite_util import SerializedConnection
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

__all__ = [
    "App",
    "AccessKey",
    "Channel",
    "EngineInstance",
    "EngineManifest",
    "EvaluationInstance",
    "Model",
    "MetadataStore",
    "CHANNEL_NAME_RE",
]

CHANNEL_NAME_RE = re.compile(r"^[a-zA-Z0-9-]{1,16}$")  # Channels.scala:27-65


def generate_access_key() -> str:
    """A fresh CLI-argument-safe access key (no leading ``-``/``_``)."""
    k = secrets.token_urlsafe(48).lstrip("-_")
    while len(k) < 24:  # extremely unlikely
        k = secrets.token_urlsafe(48).lstrip("-_")
    return k


@dataclass
class App:
    id: int
    name: str
    description: Optional[str] = None


@dataclass
class AccessKey:
    key: str
    appid: int
    events: list[str] = field(default_factory=list)  # empty = all events allowed


@dataclass
class Channel:
    id: int
    name: str
    appid: int

    @staticmethod
    def is_valid_name(s: str) -> bool:
        return bool(CHANNEL_NAME_RE.match(s))


@dataclass
class EngineInstance:
    """Full training-run record (reference `EngineInstances.scala:48-112`).

    Status lifecycle: INIT -> TRAINING -> COMPLETED (or FAILED)."""

    id: str
    status: str
    start_time: str
    end_time: str
    engine_id: str
    engine_version: str
    engine_variant: str
    engine_factory: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    mesh_conf: dict[str, Any] = field(default_factory=dict)
    data_source_params: str = ""
    preparator_params: str = ""
    algorithms_params: str = ""
    serving_params: str = ""


@dataclass
class EvaluationInstance:
    """One evaluation sweep (reference `EvaluationInstances.scala`).

    Status lifecycle: INIT -> EVALUATING -> EVALCOMPLETED (or
    EVALFAILED)."""

    id: str
    status: str
    start_time: str
    end_time: str
    evaluation_class: str
    engine_params_generator_class: str
    batch: str = ""
    env: dict[str, str] = field(default_factory=dict)
    evaluator_results: str = ""
    evaluator_results_html: str = ""
    evaluator_results_json: str = ""


@dataclass
class Model:
    id: str
    models: bytes


@dataclass
class EngineManifest:
    id: str
    version: str
    name: str
    description: Optional[str] = None
    files: list[str] = field(default_factory=list)
    engine_factory: str = ""


_SCHEMA = """
CREATE TABLE IF NOT EXISTS apps (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT UNIQUE NOT NULL,
  description TEXT
);
CREATE TABLE IF NOT EXISTS access_keys (
  key TEXT PRIMARY KEY,
  appid INTEGER NOT NULL,
  events TEXT NOT NULL DEFAULT '[]'
);
CREATE TABLE IF NOT EXISTS channels (
  id INTEGER PRIMARY KEY AUTOINCREMENT,
  name TEXT NOT NULL,
  appid INTEGER NOT NULL,
  UNIQUE (appid, name)
);
CREATE TABLE IF NOT EXISTS engine_manifests (
  id TEXT NOT NULL,
  version TEXT NOT NULL,
  name TEXT NOT NULL,
  description TEXT,
  files TEXT NOT NULL DEFAULT '[]',
  engine_factory TEXT NOT NULL DEFAULT '',
  PRIMARY KEY (id, version)
);
CREATE TABLE IF NOT EXISTS engine_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time TEXT NOT NULL,
  end_time TEXT NOT NULL,
  engine_id TEXT NOT NULL,
  engine_version TEXT NOT NULL,
  engine_variant TEXT NOT NULL,
  engine_factory TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  mesh_conf TEXT NOT NULL DEFAULT '{}',
  data_source_params TEXT NOT NULL DEFAULT '',
  preparator_params TEXT NOT NULL DEFAULT '',
  algorithms_params TEXT NOT NULL DEFAULT '',
  serving_params TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS evaluation_instances (
  id TEXT PRIMARY KEY,
  status TEXT NOT NULL,
  start_time TEXT NOT NULL,
  end_time TEXT NOT NULL,
  evaluation_class TEXT NOT NULL,
  engine_params_generator_class TEXT NOT NULL,
  batch TEXT NOT NULL DEFAULT '',
  env TEXT NOT NULL DEFAULT '{}',
  evaluator_results TEXT NOT NULL DEFAULT '',
  evaluator_results_html TEXT NOT NULL DEFAULT '',
  evaluator_results_json TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS models (
  id TEXT PRIMARY KEY,
  models BLOB NOT NULL
);
"""


class MetadataStore:
    """The metadata DAOs behind one handle
    (accessor parity with `Storage.scala:259-290`)."""

    def __init__(self, path: str | Path = ":memory:"):
        if not isinstance(path, (str, Path)):
            # str(dict) would silently become a garbage FILENAME
            raise TypeError(
                f"path must be str/Path, got {type(path).__name__} "
                "(pass conf['path'], not the conf dict)"
            )
        self._path = str(path)
        self._lock = threading.RLock()
        raw = sqlite3.connect(self._path, check_same_thread=False)
        # wait out cross-PROCESS contention (multi-host chief/peer reads,
        # CLI + server sharing one metadata db) instead of SQLITE_BUSY
        raw.execute("PRAGMA busy_timeout=10000")
        # one shared connection, every statement serialized + materialized
        # under the lock: bare sqlite3 connections break under interleaved
        # multi-thread use (event-server auth reads raced training writes)
        self._conn = SerializedConnection(raw, self._lock)
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # ---------------- apps (Apps.scala) ----------------
    def app_insert(self, name: str, description: Optional[str] = None) -> App:
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO apps (name, description) VALUES (?, ?)",
                (name, description),
            )
            self._conn.commit()
            return App(id=cur.lastrowid, name=name, description=description)

    def app_get(self, app_id: int) -> Optional[App]:
        r = self._conn.execute(
            "SELECT id, name, description FROM apps WHERE id=?", (app_id,)
        ).fetchone()
        return App(*r) if r else None

    def app_get_by_name(self, name: str) -> Optional[App]:
        r = self._conn.execute(
            "SELECT id, name, description FROM apps WHERE name=?", (name,)
        ).fetchone()
        return App(*r) if r else None

    def app_get_all(self) -> list[App]:
        return [
            App(*r)
            for r in self._conn.execute(
                "SELECT id, name, description FROM apps ORDER BY id"
            )
        ]

    def app_update(self, app: App) -> None:
        with self._lock:
            self._conn.execute(
                "UPDATE apps SET name=?, description=? WHERE id=?",
                (app.name, app.description, app.id),
            )
            self._conn.commit()

    def app_delete(self, app_id: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM apps WHERE id=?", (app_id,))
            self._conn.commit()

    # ---------------- access keys (AccessKeys.scala) ----------------
    def access_key_insert(self, key: AccessKey) -> str:
        k = key.key or generate_access_key()
        with self._lock:
            self._conn.execute(
                "INSERT INTO access_keys (key, appid, events) VALUES (?,?,?)",
                (k, key.appid, json.dumps(key.events)),
            )
            self._conn.commit()
        return k

    def access_key_get(self, key: str) -> Optional[AccessKey]:
        r = self._conn.execute(
            "SELECT key, appid, events FROM access_keys WHERE key=?", (key,)
        ).fetchone()
        return AccessKey(r[0], r[1], json.loads(r[2])) if r else None

    def access_key_get_by_app(self, appid: int) -> list[AccessKey]:
        return [
            AccessKey(r[0], r[1], json.loads(r[2]))
            for r in self._conn.execute(
                "SELECT key, appid, events FROM access_keys WHERE appid=?", (appid,)
            )
        ]

    def access_key_get_all(self) -> list[AccessKey]:
        return [
            AccessKey(r[0], r[1], json.loads(r[2]))
            for r in self._conn.execute("SELECT key, appid, events FROM access_keys")
        ]

    def access_key_delete(self, key: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM access_keys WHERE key=?", (key,))
            self._conn.commit()

    # ---------------- channels (Channels.scala) ----------------
    def channel_insert(self, name: str, appid: int) -> Channel:
        if not Channel.is_valid_name(name):
            raise ValueError(
                f"invalid channel name {name!r}: must match {CHANNEL_NAME_RE.pattern}"
            )
        with self._lock:
            cur = self._conn.execute(
                "INSERT INTO channels (name, appid) VALUES (?,?)", (name, appid)
            )
            self._conn.commit()
            return Channel(id=cur.lastrowid, name=name, appid=appid)

    def channel_get(self, channel_id: int) -> Optional[Channel]:
        r = self._conn.execute(
            "SELECT id, name, appid FROM channels WHERE id=?", (channel_id,)
        ).fetchone()
        return Channel(*r) if r else None

    def channel_get_by_app(self, appid: int) -> list[Channel]:
        return [
            Channel(*r)
            for r in self._conn.execute(
                "SELECT id, name, appid FROM channels WHERE appid=? ORDER BY id",
                (appid,),
            )
        ]

    def channel_delete(self, channel_id: int) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM channels WHERE id=?", (channel_id,))
            self._conn.commit()

    # ---------------- engine manifests (EngineManifests.scala) ------------
    def manifest_upsert(self, m: EngineManifest) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO engine_manifests VALUES (?,?,?,?,?,?)",
                (m.id, m.version, m.name, m.description, json.dumps(m.files),
                 m.engine_factory),
            )
            self._conn.commit()

    def manifest_get(self, id: str, version: str) -> Optional[EngineManifest]:
        r = self._conn.execute(
            "SELECT * FROM engine_manifests WHERE id=? AND version=?",
            (id, version),
        ).fetchone()
        if not r:
            return None
        return EngineManifest(r[0], r[1], r[2], r[3], json.loads(r[4]), r[5])

    def manifest_get_all(self) -> list[EngineManifest]:
        return [
            EngineManifest(r[0], r[1], r[2], r[3], json.loads(r[4]), r[5])
            for r in self._conn.execute("SELECT * FROM engine_manifests")
        ]

    def manifest_delete(self, id: str, version: str) -> None:
        with self._lock:
            self._conn.execute(
                "DELETE FROM engine_manifests WHERE id=? AND version=?",
                (id, version),
            )
            self._conn.commit()

    # ---------------- engine instances (EngineInstances.scala) ------------
    _EI_COLS = (
        "id status start_time end_time engine_id engine_version engine_variant "
        "engine_factory batch env mesh_conf data_source_params preparator_params "
        "algorithms_params serving_params"
    ).split()

    def engine_instance_insert(self, ei: EngineInstance) -> str:
        with self._lock:
            self._conn.execute(
                f"INSERT OR REPLACE INTO engine_instances "
                f"VALUES ({','.join('?' * len(self._EI_COLS))})",
                (ei.id, ei.status, ei.start_time, ei.end_time, ei.engine_id,
                 ei.engine_version, ei.engine_variant, ei.engine_factory, ei.batch,
                 json.dumps(ei.env), json.dumps(ei.mesh_conf),
                 ei.data_source_params, ei.preparator_params,
                 ei.algorithms_params, ei.serving_params),
            )
            self._conn.commit()
        return ei.id

    @staticmethod
    def _ei_from_row(r) -> EngineInstance:
        return EngineInstance(
            id=r[0], status=r[1], start_time=r[2], end_time=r[3], engine_id=r[4],
            engine_version=r[5], engine_variant=r[6], engine_factory=r[7],
            batch=r[8], env=json.loads(r[9]), mesh_conf=json.loads(r[10]),
            data_source_params=r[11], preparator_params=r[12],
            algorithms_params=r[13], serving_params=r[14],
        )

    def engine_instance_get(self, id: str) -> Optional[EngineInstance]:
        r = self._conn.execute(
            "SELECT * FROM engine_instances WHERE id=?", (id,)
        ).fetchone()
        return self._ei_from_row(r) if r else None

    def engine_instance_get_all(self) -> list[EngineInstance]:
        return [
            self._ei_from_row(r)
            for r in self._conn.execute(
                "SELECT * FROM engine_instances ORDER BY start_time DESC"
            )
        ]

    def engine_instance_get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        """`getLatestCompleted` (EngineInstances.scala) — deploy picks this."""
        r = self._conn.execute(
            "SELECT * FROM engine_instances WHERE engine_id=? AND engine_version=? "
            "AND engine_variant=? AND status='COMPLETED' "
            "ORDER BY start_time DESC LIMIT 1",
            (engine_id, engine_version, engine_variant),
        ).fetchone()
        return self._ei_from_row(r) if r else None

    def engine_instance_get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return [
            self._ei_from_row(r)
            for r in self._conn.execute(
                "SELECT * FROM engine_instances WHERE engine_id=? AND "
                "engine_version=? AND engine_variant=? AND status='COMPLETED' "
                "ORDER BY start_time DESC",
                (engine_id, engine_version, engine_variant),
            )
        ]

    def engine_instance_update(self, ei: EngineInstance) -> None:
        self.engine_instance_insert(ei)

    def engine_instance_delete(self, id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM engine_instances WHERE id=?", (id,))
            self._conn.commit()

    # ---------------- evaluation instances --------------------------------
    def evaluation_instance_insert(self, ev: EvaluationInstance) -> str:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO evaluation_instances VALUES "
                "(?,?,?,?,?,?,?,?,?,?,?)",
                (ev.id, ev.status, ev.start_time, ev.end_time, ev.evaluation_class,
                 ev.engine_params_generator_class, ev.batch, json.dumps(ev.env),
                 ev.evaluator_results, ev.evaluator_results_html,
                 ev.evaluator_results_json),
            )
            self._conn.commit()
        return ev.id

    @staticmethod
    def _ev_from_row(r) -> EvaluationInstance:
        return EvaluationInstance(
            id=r[0], status=r[1], start_time=r[2], end_time=r[3],
            evaluation_class=r[4], engine_params_generator_class=r[5], batch=r[6],
            env=json.loads(r[7]), evaluator_results=r[8],
            evaluator_results_html=r[9], evaluator_results_json=r[10],
        )

    def evaluation_instance_get(self, id: str) -> Optional[EvaluationInstance]:
        r = self._conn.execute(
            "SELECT * FROM evaluation_instances WHERE id=?", (id,)
        ).fetchone()
        return self._ev_from_row(r) if r else None

    def evaluation_instance_get_completed(self) -> list[EvaluationInstance]:
        return [
            self._ev_from_row(r)
            for r in self._conn.execute(
                "SELECT * FROM evaluation_instances WHERE status='EVALCOMPLETED' "
                "ORDER BY start_time DESC"
            )
        ]

    def evaluation_instance_update(self, ev: EvaluationInstance) -> None:
        self.evaluation_instance_insert(ev)

    # ---------------- model blobs (Models.scala) ---------------------------
    def model_insert(self, m: Model) -> None:
        with self._lock:
            self._conn.execute(
                "INSERT OR REPLACE INTO models VALUES (?,?)", (m.id, m.models)
            )
            self._conn.commit()

    def model_get(self, id: str) -> Optional[Model]:
        r = self._conn.execute("SELECT * FROM models WHERE id=?", (id,)).fetchone()
        return Model(r[0], r[1]) if r else None

    def model_delete(self, id: str) -> None:
        with self._lock:
            self._conn.execute("DELETE FROM models WHERE id=?", (id,))
            self._conn.commit()
