"""File-tree metadata backend: one JSON document per record.

Port of ``predictionio_tpu/storage/file_metadata.py`` (the ``jsonfs``
metadata store), the same document tree, so a store written by either
package is read by the other.  The reference ships an alternative
metadata backend next to the Elasticsearch one (mongodb, holding engine
instances, manifests and sequences as documents); this is its
equivalent second backend for a shared filesystem: a document tree
(`<root>/<kind>/<key>.json`) that rides the mount the model files
already share, with no server process.  Records are human-inspectable
and writes are crash-safe.

Semantics match :class:`~predictionio_tpu_torch.storage.metadata.
MetadataStore` method for method (the seven reference DAOs).

Concurrency: every mutation takes an exclusive ``fcntl`` lock on
``<root>/.lock`` (across processes) and lands via tmp-file + atomic
``os.replace``; readers never lock, so they see a complete old or a
complete new document.  Sequences are counter files bumped under the
same lock, monotonic across deletes like SQLite AUTOINCREMENT.

Selected by ``PIO_STORAGE_SOURCES_<N>_TYPE=jsonfs`` (+ ``_PATH``), or
as a dotted-path custom backend
(``predictionio_tpu_torch.storage.file_metadata.FileMetadataStore``:
the constructor also takes the registry's config dict).
"""

from __future__ import annotations

import fcntl
import json
import logging
import os
import urllib.parse
from dataclasses import asdict
from pathlib import Path
from typing import Any, Iterator, Optional

from .metadata import (
    AccessKey,
    App,
    Channel,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Model,
    generate_access_key,
)

__all__ = ["FileMetadataStore"]

logger = logging.getLogger(__name__)


def _log_corrupt(path) -> None:
    logger.warning(
        "jsonfs metadata: skipping undecodable document %s (torn write "
        "from a crash on a non-fsyncing mount?) — delete or restore it "
        "to silence this", path,
    )

_KINDS = (
    "apps",
    "access_keys",
    "channels",
    "engine_manifests",
    "engine_instances",
    "evaluation_instances",
    "models",
)


def _esc(key: str) -> str:
    """Any string -> one safe filename component (reversible quote)."""
    return urllib.parse.quote(str(key), safe="")


class FileMetadataStore:
    """All seven metadata DAOs over a JSON-document file tree."""

    def __init__(self, path: str | Path | dict):
        if isinstance(path, dict):  # registry custom-backend contract
            conf = path
            path = conf.get("path") or ""
            if not path:
                raise ValueError(
                    "jsonfs metadata source needs PATH "
                    "(PIO_STORAGE_SOURCES_<N>_PATH=<directory>)"
                )
        self.root = Path(path)
        for kind in _KINDS:
            (self.root / kind).mkdir(parents=True, exist_ok=True)
        (self.root / "_seq").mkdir(exist_ok=True)
        self._lock_path = self.root / ".lock"
        self._lock_path.touch(exist_ok=True)

    def close(self) -> None:  # same surface as MetadataStore
        pass

    # ---------------- plumbing -------------------------------------------
    class _Locked:
        def __init__(self, path: Path):
            self._path = path

        def __enter__(self):
            self._f = open(self._path, "a")
            fcntl.flock(self._f, fcntl.LOCK_EX)
            return self

        def __exit__(self, *exc):
            fcntl.flock(self._f, fcntl.LOCK_UN)
            self._f.close()
            return False

    def _mutate(self):
        return self._Locked(self._lock_path)

    def _doc_path(self, kind: str, key: str, suffix: str = ".json") -> Path:
        return self.root / kind / (_esc(key) + suffix)

    @staticmethod
    def _replace_durable(tmp: Path, dst: Path, data: bytes) -> None:
        """tmp-write + fsync + atomic rename + directory fsync: the
        document is on disk BEFORE it becomes visible, and the rename
        itself is durable — a crash leaves old-or-new, never a torn
        file, and a persisted record can never outrun its sequence
        bump's dirent (which would let ids be reused)."""
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, dst)
        dfd = os.open(dst.parent, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)

    def _write(self, kind: str, key: str, doc: dict[str, Any]) -> None:
        p = self._doc_path(kind, key)
        self._replace_durable(
            p.with_name(p.name + ".tmp"), p,
            json.dumps(doc, indent=1, sort_keys=True).encode(),
        )

    def _read(self, kind: str, key: str) -> Optional[dict[str, Any]]:
        p = self._doc_path(kind, key)
        try:
            return json.loads(p.read_text())
        except FileNotFoundError:
            return None
        except ValueError:
            # a torn document (crash mid-write on a non-fsyncing mount)
            # was never logically committed: treat as absent, loudly —
            # one bad file must not brick every lookup
            _log_corrupt(p)
            return None

    def _delete(self, kind: str, key: str, suffix: str = ".json") -> None:
        with self._mutate():
            self._doc_path(kind, key, suffix).unlink(missing_ok=True)

    def _scan(self, kind: str) -> Iterator[dict[str, Any]]:
        for p in sorted((self.root / kind).glob("*.json")):
            try:
                yield json.loads(p.read_text())
            except FileNotFoundError:  # deleted mid-scan
                continue
            except ValueError:
                _log_corrupt(p)
                continue

    def _next_id(self, seq: str) -> int:
        """Monotonic integer sequence (never reused after deletes),
        bumped under the store lock — MongoSequences.scala analogue."""
        p = self.root / "_seq" / seq
        try:
            n = int(p.read_text())
        except (FileNotFoundError, ValueError):
            n = 0
        n += 1
        self._replace_durable(p.with_name(p.name + ".tmp"), p,
                              str(n).encode())
        return n

    # ---------------- apps ------------------------------------------------
    def app_insert(self, name: str, description: Optional[str] = None) -> App:
        with self._mutate():
            if any(d["name"] == name for d in self._scan("apps")):
                raise ValueError(f"app name {name!r} already exists")
            app = App(id=self._next_id("apps"), name=name,
                      description=description)
            self._write("apps", str(app.id), asdict(app))
            return app

    def app_get(self, app_id: int) -> Optional[App]:
        d = self._read("apps", str(app_id))
        return App(**d) if d else None

    def app_get_by_name(self, name: str) -> Optional[App]:
        for d in self._scan("apps"):
            if d["name"] == name:
                return App(**d)
        return None

    def app_get_all(self) -> list[App]:
        return sorted(
            (App(**d) for d in self._scan("apps")), key=lambda a: a.id
        )

    def app_update(self, app: App) -> None:
        with self._mutate():
            if (
                self._read("apps", str(app.id)) is None
                and not self._doc_path("apps", str(app.id)).exists()
            ):
                # sqlite parity: UPDATE on a missing id is a no-op — a
                # stale App object must never resurrect a deleted app.
                # A present-but-torn document is different: overwriting
                # it is the API's repair path (_log_corrupt's advice).
                return
            if any(
                d["name"] == app.name and d["id"] != app.id
                for d in self._scan("apps")
            ):  # UNIQUE(name) parity with the sqlite backend
                raise ValueError(f"app name {app.name!r} already exists")
            self._write("apps", str(app.id), asdict(app))

    def app_delete(self, app_id: int) -> None:
        self._delete("apps", str(app_id))

    # ---------------- access keys ----------------------------------------
    def access_key_insert(self, key: AccessKey) -> str:
        k = key.key or generate_access_key()
        with self._mutate():
            if self._read("access_keys", k) is not None:
                # PRIMARY KEY parity: an existing key must never be
                # silently reassigned to another app
                raise ValueError(f"access key {k!r} already exists")
            self._write(
                "access_keys", k,
                {"key": k, "appid": key.appid, "events": key.events},
            )
        return k

    def access_key_get(self, key: str) -> Optional[AccessKey]:
        d = self._read("access_keys", key)
        return AccessKey(**d) if d else None

    def access_key_get_by_app(self, appid: int) -> list[AccessKey]:
        return [
            AccessKey(**d)
            for d in self._scan("access_keys")
            if d["appid"] == appid
        ]

    def access_key_get_all(self) -> list[AccessKey]:
        return [AccessKey(**d) for d in self._scan("access_keys")]

    def access_key_delete(self, key: str) -> None:
        self._delete("access_keys", key)

    # ---------------- channels -------------------------------------------
    def channel_insert(self, name: str, appid: int) -> Channel:
        if not Channel.is_valid_name(name):
            raise ValueError(
                f"invalid channel name {name!r}: must match "
                "^[a-zA-Z0-9-]{1,16}$"
            )
        with self._mutate():
            if any(
                d["name"] == name and d["appid"] == appid
                for d in self._scan("channels")
            ):
                raise ValueError(
                    f"channel {name!r} already exists for app {appid}"
                )
            ch = Channel(id=self._next_id("channels"), name=name,
                         appid=appid)
            self._write("channels", str(ch.id), asdict(ch))
            return ch

    def channel_get(self, channel_id: int) -> Optional[Channel]:
        d = self._read("channels", str(channel_id))
        return Channel(**d) if d else None

    def channel_get_by_app(self, appid: int) -> list[Channel]:
        return sorted(
            (
                Channel(**d)
                for d in self._scan("channels")
                if d["appid"] == appid
            ),
            key=lambda c: c.id,
        )

    def channel_delete(self, channel_id: int) -> None:
        self._delete("channels", str(channel_id))

    # ---------------- engine manifests -----------------------------------
    @staticmethod
    def _mkey(id: str, version: str) -> str:
        # quote() escapes "@", so the separator is unambiguous
        return f"{_esc(id)}@{_esc(version)}"

    def manifest_upsert(self, m: EngineManifest) -> None:
        with self._mutate():
            self._write(
                "engine_manifests", self._mkey(m.id, m.version), asdict(m)
            )

    def manifest_get(self, id: str, version: str) -> Optional[EngineManifest]:
        d = self._read("engine_manifests", self._mkey(id, version))
        return EngineManifest(**d) if d else None

    def manifest_get_all(self) -> list[EngineManifest]:
        return [EngineManifest(**d) for d in self._scan("engine_manifests")]

    def manifest_delete(self, id: str, version: str) -> None:
        self._delete("engine_manifests", self._mkey(id, version))

    # ---------------- engine instances -----------------------------------
    def engine_instance_insert(self, ei: EngineInstance) -> str:
        with self._mutate():
            self._write("engine_instances", ei.id, asdict(ei))
        return ei.id

    def engine_instance_get(self, id: str) -> Optional[EngineInstance]:
        d = self._read("engine_instances", id)
        return EngineInstance(**d) if d else None

    def engine_instance_get_all(self) -> list[EngineInstance]:
        return sorted(
            (EngineInstance(**d) for d in self._scan("engine_instances")),
            key=lambda e: e.start_time,
            reverse=True,
        )

    def _completed(self, engine_id, engine_version, engine_variant):
        return [
            e
            for e in self.engine_instance_get_all()  # already newest-first
            if e.status == "COMPLETED"
            and e.engine_id == engine_id
            and e.engine_version == engine_version
            and e.engine_variant == engine_variant
        ]

    def engine_instance_get_latest_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> Optional[EngineInstance]:
        done = self._completed(engine_id, engine_version, engine_variant)
        return done[0] if done else None

    def engine_instance_get_completed(
        self, engine_id: str, engine_version: str, engine_variant: str
    ) -> list[EngineInstance]:
        return self._completed(engine_id, engine_version, engine_variant)

    def engine_instance_update(self, ei: EngineInstance) -> None:
        self.engine_instance_insert(ei)

    def engine_instance_delete(self, id: str) -> None:
        self._delete("engine_instances", id)

    # ---------------- evaluation instances --------------------------------
    def evaluation_instance_insert(self, ev: EvaluationInstance) -> str:
        with self._mutate():
            self._write("evaluation_instances", ev.id, asdict(ev))
        return ev.id

    def evaluation_instance_get(self, id: str) -> Optional[EvaluationInstance]:
        d = self._read("evaluation_instances", id)
        return EvaluationInstance(**d) if d else None

    def evaluation_instance_get_completed(self) -> list[EvaluationInstance]:
        return sorted(
            (
                EvaluationInstance(**d)
                for d in self._scan("evaluation_instances")
                if d["status"] == "EVALCOMPLETED"
            ),
            key=lambda e: e.start_time,
            reverse=True,
        )

    def evaluation_instance_update(self, ev: EvaluationInstance) -> None:
        self.evaluation_instance_insert(ev)

    # ---------------- model blobs -----------------------------------------
    def model_insert(self, m: Model) -> None:
        with self._mutate():
            p = self._doc_path("models", m.id, ".bin")
            self._replace_durable(p.with_name(p.name + ".tmp"), p,
                                  m.models)

    def model_get(self, id: str) -> Optional[Model]:
        p = self._doc_path("models", id, ".bin")
        try:
            return Model(id=id, models=p.read_bytes())
        except FileNotFoundError:
            return None

    def model_delete(self, id: str) -> None:
        self._delete("models", id, ".bin")
