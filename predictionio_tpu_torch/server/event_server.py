"""REST Event Server (ingestion API, default port 7070).

Re-expression of reference `data/api/EventAPI.scala:90-469` on the stdlib
threading HTTP server.  Routes + semantics parity:

* ``POST /events.json?accessKey=K[&channel=C]``  -> 201 ``{"eventId": ...}``
* ``POST /batch/events.json``                    -> per-event status list
* ``GET  /events.json?accessKey=K&...filters``   -> event list (find filters:
  startTime, untilTime, entityType, entityId, event, targetEntityType,
  targetEntityId, limit, reversed)
* ``GET|DELETE /events/<id>.json?accessKey=K``
* ``GET  /stats.json?accessKey=K``               (when stats enabled)
* ``POST /webhooks/<name>.json`` / ``.form``, ``GET`` probes
* ``GET  /``                                      -> server info

Auth: accessKey (query param) -> (appId, channelId); keys may whitelist
event names (`AccessKeys.scala:27-54`).  401 on bad key, 400 on invalid
payloads, 404 on unknown ids/channels — matching the reference's
rejection handler (`api/Common.scala`).

Port of ``predictionio_tpu/server/event_server.py``: the same routes,
statuses and bodies, write retries answering 503 + Retry-After, the
group-commit ingest WAL (``wal_dir``), the TTL purge and compaction
timers, and the shard-owner mode of an ingest fleet (``owned_shards``:
writes to any other shard of the sharded store answer a structured 503
``ShardUnavailable``), with the reference's observability (``/metrics``
and ``/debug/*``, ``events.write`` spans carrying a propagated
``X-PIO-Trace`` id, the ingest timeline, ``--slo-ms`` burn rates) and
its fault-injection points ``storage.write`` and ``storage.read``
(``PIO_FAULT_PLAN``).  The server never touches the card.
"""

from __future__ import annotations

import json
import logging
import sqlite3
import threading
import time
import urllib.parse
from typing import Any, Optional

from ..obs import (
    EVENT_WRITE_LATENCY,
    INGEST_SHARD_UNAVAILABLE_TOTAL,
    fleet,
    get_tracer,
    scope,
    timeline,
    trace_scope,
)
from ..resilience import faults
from ..resilience.policy import RetryPolicy
from ..storage.event import (
    Event,
    EventValidationError,
    new_event_id,
    new_event_ids,
    parse_time,
)
from ..storage.levents import NO_TARGET, ShardUnavailableError
from ..storage.registry import Storage, get_storage
from ..storage.sqlite_events import event_to_row
from ..storage.wal import GroupCommitWAL
from .http_base import HTTPServerBase, JsonRequestHandler
from .stats import StatsCollector
from .webhooks import (
    FORM_CONNECTORS,
    JSON_CONNECTORS,
    ConnectorError,
    to_event,
)

logger = logging.getLogger(__name__)

__all__ = ["EventServer", "EventServerConfig"]


class EventServerConfig:
    def __init__(self, host: str = "127.0.0.1", port: int = 7070,
                 stats: bool = True, write_retries: int = 3,
                 write_backoff_s: float = 0.05,
                 retry_seed: Optional[int] = None,
                 max_connections: int = 512,
                 wal_dir: Optional[str] = None,
                 owned_shards: Optional[list[int]] = None,
                 ttl_s: Optional[float] = None,
                 compact_interval_s: Optional[float] = None,
                 maintenance_interval_s: float = 30.0,
                 slo_ms: Optional[float] = None):
        self.host = host
        self.port = port
        self.stats = stats
        # concurrent-connection cap (pio-surge): attempts past it get a
        # structured 503 + close instead of one pinned thread each
        self.max_connections = max_connections
        # transient-storage-failure policy: a busy WAL / locked sqlite
        # write is retried with backoff before the route answers
        # 503 + Retry-After (write_retries counts the first try)
        self.write_retries = write_retries
        self.write_backoff_s = write_backoff_s
        self.retry_seed = retry_seed
        # pio-levee ingest WAL: when set, writes group-commit through
        # `storage.wal.GroupCommitWAL` (ack = WAL fsync, sqlite commits
        # drain in the background; crash replay on next boot)
        self.wal_dir = wal_dir
        # shard-owner worker mode: restrict writes (and WAL files) to a
        # fixed shard subset; None = own everything (single process)
        self.owned_shards = owned_shards
        # bounded live window: purge events older than ttl_s, compact
        # the owned shard files every compact_interval_s (both off by
        # default; the maintenance thread only runs when one is set)
        self.ttl_s = ttl_s
        self.compact_interval_s = compact_interval_s
        self.maintenance_interval_s = maintenance_interval_s
        # ingest write-latency SLO (ms): arms pio_slo_burn_rate{window}
        # on the event-write histogram, the same multi-window burn
        # gauges the serving edge carries (pio-sentry)
        self.slo_ms = slo_ms


class AuthError(Exception):
    pass


# storage exceptions worth retrying: cross-connection sqlite contention
# (SQLITE_BUSY past the busy_timeout, WAL checkpoint races) is transient
# by construction; schema/constraint errors are not OperationalError
TRANSIENT_STORAGE_ERRORS = (sqlite3.OperationalError,)


class EventServer(HTTPServerBase):
    server_name = "events"
    def __init__(self, storage: Optional[Storage] = None,
                 config: Optional[EventServerConfig] = None):
        self.storage = storage or get_storage()
        self.config = config or EventServerConfig()
        self.stats = StatsCollector() if self.config.stats else None
        self.write_retry = RetryPolicy(
            max_attempts=self.config.write_retries,
            base_s=self.config.write_backoff_s,
            cap_s=max(1.0, self.config.write_backoff_s * 10),
            seed=self.config.retry_seed,
        )
        es = self.storage.get_event_store()
        if (self.config.owned_shards is not None
                and hasattr(es, "set_owned_shards")):
            es.set_owned_shards(self.config.owned_shards)
        self.wal: Optional[GroupCommitWAL] = None
        if self.config.wal_dir:
            self.wal = GroupCommitWAL(
                es, self.config.wal_dir,
                owned_shards=self.config.owned_shards,
            )
        # channels this process has written — the TTL/compaction
        # maintenance scope (a set mutated under the GIL only; readers
        # snapshot with list())
        self._seen_channels: set[tuple[int, int]] = set()
        self._maint_stop = threading.Event()
        self._maint_thread: Optional[threading.Thread] = None
        if self.config.ttl_s or self.config.compact_interval_s:
            self._maint_thread = threading.Thread(
                target=self._maintenance_loop,
                name="events-maintenance", daemon=True,
            )
            self._maint_thread.start()
        # pio-sentry on the write edge: --slo-ms arms the multi-window
        # burn-rate gauges over the event-write latency histogram
        self._burn = None
        if self.config.slo_ms:
            self._burn = fleet.install_burn_rate(
                EVENT_WRITE_LATENCY.child(), self.config.slo_ms / 1e3,
            )
        scope.ensure_started()

    def _note_retry(self, kind: str):
        def on_retry(attempt: int, exc: BaseException) -> None:
            logger.warning("%s retry %d after %s", kind, attempt, exc)
            if self.stats is not None:
                self.stats.note(f"{kind}.retry")
        return on_retry

    def barrier(self) -> None:
        """Read-your-writes: drain the ingest WAL's commit backlog so a
        201 is visible to this server's own GET routes.  No-op without
        a WAL; a stuck drain raises the transient-storage surface."""
        if self.wal is not None:
            self.wal.barrier()

    def stop(self) -> None:
        super().stop()
        self._maint_stop.set()
        if self._maint_thread is not None:
            self._maint_thread.join(timeout=5.0)
            self._maint_thread = None
        if self.wal is not None:
            self.wal.close()
            self.wal = None

    def _maintenance_loop(self) -> None:
        """Time-windowed retention: TTL purge each tick, compaction on
        its own (longer) cadence — both scoped to owned shards so a
        worker never takes a sibling's writer lock."""
        next_compact = time.monotonic() + (
            self.config.compact_interval_s or float("inf")
        )
        scope.register_thread_role("events_maintenance")
        while not self._maint_stop.wait(self.config.maintenance_interval_s):
            es = self.storage.get_event_store()
            try:
                if self.config.ttl_s and hasattr(es, "purge_older_than"):
                    cutoff = int((time.time() - self.config.ttl_s) * 1000)
                    for app_id, ch in list(self._seen_channels):
                        n = es.purge_older_than(cutoff, app_id, ch)
                        if n:
                            logger.info(
                                "TTL purge: %d events older than %ss "
                                "(app %d, channel %d)",
                                n, self.config.ttl_s, app_id, ch,
                            )
                            if self.stats is not None:
                                self.stats.note("ttl.purged", n)
                if (self.config.compact_interval_s
                        and time.monotonic() >= next_compact):
                    next_compact = (time.monotonic()
                                    + self.config.compact_interval_s)
                    # drain first: VACUUM wants the writer lock the WAL
                    # committer would otherwise be using
                    self.barrier()
                    es.compact()
                    logger.info("compacted event store")
            except Exception:
                # retention is advisory; a failed pass must not kill
                # the thread (the next tick retries)
                logger.exception("event-store maintenance pass failed")

    @property
    def host(self) -> str:
        return self.config.host

    @property
    def port(self) -> int:
        return self.config.port

    @property
    def max_connections(self) -> int:
        return self.config.max_connections

    @port.setter
    def port(self, v: int) -> None:
        self.config.port = v

    # -- auth (EventAPI.scala:90-116) -------------------------------------
    def authenticate(self, params: dict[str, list[str]]) -> tuple[int, int, list[str]]:
        """accessKey [+ channel] -> (app_id, channel_id, allowed_events)."""
        keys = params.get("accessKey")
        if not keys or not keys[0]:
            raise AuthError("missing accessKey")
        md = self.storage.get_metadata()
        ak = md.access_key_get(keys[0])
        if ak is None:
            raise AuthError("invalid accessKey")
        channel_id = 0
        channels = params.get("channel")
        if channels and channels[0]:
            chans = md.channel_get_by_app(ak.appid)
            match = [c for c in chans if c.name == channels[0]]
            if not match:
                raise AuthError(f"invalid channel {channels[0]!r}")
            channel_id = match[0].id
        return ak.appid, channel_id, ak.events

    # -- handlers ----------------------------------------------------------
    @staticmethod
    def check_allowed(event: Event, allowed: list[str]) -> None:
        """Access-key event whitelist (`AccessKeys.scala:27-54`); one
        definition for the single-event and batch routes."""
        if allowed and event.event not in allowed:
            raise AuthError(
                f"accessKey is not allowed to write event {event.event!r}"
            )

    def insert_event(self, event: Event, app_id: int, channel_id: int,
                     allowed: list[str]) -> str:
        self.check_allowed(event, allowed)
        es = self.storage.get_event_store()
        es.init_channel(app_id, channel_id)
        self._seen_channels.add((app_id, channel_id))

        if self.wal is not None:
            # group-commit path: ack = WAL fsync; the sqlite commit
            # drains in the background.  ShardUnavailableError is NOT
            # transient (sticky until restart/recovery) so the retry
            # policy passes it straight through to the 503 route.
            def put():
                faults.check("storage.write")
                eid = event.event_id or new_event_id()
                self.wal.submit(
                    app_id, channel_id, [event_to_row(event, eid)]
                )
                return eid
        else:
            def put():
                faults.check("storage.write")
                return es.insert(event, app_id, channel_id)

        # span + histogram cover the whole retried write: the client's
        # view of how long ingestion held their request
        t0 = time.perf_counter()
        try:
            return self.write_retry.call(
                put, retry_on=TRANSIENT_STORAGE_ERRORS,
                on_retry=self._note_retry("storage.write"),
            )
        finally:
            dt = time.perf_counter() - t0
            EVENT_WRITE_LATENCY.child().observe(dt)
            get_tracer().record("events.write", dt,
                                attrs={"event": event.event})

    @staticmethod
    def _find_kwargs(params: dict[str, list[str]]) -> dict[str, Any]:
        def one(name):
            v = params.get(name)
            return v[0] if v else None

        kw: dict[str, Any] = {}
        if one("startTime"):
            kw["start_time"] = parse_time(one("startTime"))
        if one("untilTime"):
            kw["until_time"] = parse_time(one("untilTime"))
        if one("entityType"):
            kw["entity_type"] = one("entityType")
        if one("entityId"):
            kw["entity_id"] = one("entityId")
        if params.get("event"):
            kw["event_names"] = params["event"]
        tet, tei = one("targetEntityType"), one("targetEntityId")
        if tet:
            kw["target_entity_type"] = NO_TARGET if tet == "none" else tet
        if tei:
            kw["target_entity_id"] = NO_TARGET if tei == "none" else tei
        if one("limit"):
            kw["limit"] = int(one("limit"))
        if one("reversed"):
            kw["reversed"] = one("reversed").lower() == "true"
        return kw

    # -- http ---------------------------------------------------------------
    def _make_handler(server: "EventServer"):
        class Handler(JsonRequestHandler):
            server_logger = logger

            def _params(self) -> dict[str, list[str]]:
                q = urllib.parse.urlparse(self.path).query
                return urllib.parse.parse_qs(q)

            def _route(self) -> str:
                return urllib.parse.urlparse(self.path).path

            def _auth(self):
                return server.authenticate(self._params())

            def _book(self, app_id: int, status: int, event=None):
                if server.stats is not None:
                    server.stats.bookkeeping(app_id, status, event)

            def _reply_503(self, e: BaseException):
                """Storage still unavailable after retries: tell the
                client when to come back instead of failing opaquely."""
                self.extra_headers = [("Retry-After", "1")]
                self._reply(503, {
                    "message": f"event store unavailable: {e}",
                    "error": "StorageUnavailable",
                })

            def _reply_503_shard(self, e: ShardUnavailableError):
                """One shard is down, the fleet is not: a structured
                503 naming the shard, with a Retry-After sized for a
                worker respawn rather than a lock blip."""
                INGEST_SHARD_UNAVAILABLE_TOTAL.labels(
                    shard=str(e.shard)
                ).inc()
                self.extra_headers = [("Retry-After", "2")]
                self._reply(503, {
                    "message": str(e),
                    "error": "ShardUnavailable",
                    "shard": e.shard,
                })

            # ---- POST ----
            def do_POST(self):
                path = self._route()
                # propagate (never mint) the trace id: ingestion is a
                # downstream hop — ids are born at the serving edge or
                # the client
                with trace_scope(self._trace_id()):
                    self._do_post(path)

            def _do_post(self, path):
                try:
                    if path == "/events.json":
                        self._post_event()
                    elif path == "/batch/events.json":
                        self._post_batch()
                    elif path.startswith("/webhooks/"):
                        self._post_webhook(path)
                    else:
                        self._reply(404, {"message": "not found"})
                except AuthError as e:
                    self._reply(401, {"message": str(e)})
                except (EventValidationError, ConnectorError,
                        json.JSONDecodeError, ValueError) as e:
                    self._reply(400, {"message": str(e)})
                except ShardUnavailableError as e:
                    self._reply_503_shard(e)
                except TRANSIENT_STORAGE_ERRORS as e:
                    self._reply_503(e)
                except Exception as e:
                    logger.exception("event server error")
                    self._reply(500, {"message": str(e)})

            def _post_event(self):
                # pulse ingest timeline (auth/parse/store_write/reply);
                # only the 201 path observes
                tl = timeline.Timeline("events")
                app_id, channel_id, allowed = self._auth()
                tl.mark("auth")
                try:
                    event = Event.from_json(json.loads(self._body().decode()))
                except (EventValidationError, json.JSONDecodeError,
                        ValueError) as e:
                    self._book(app_id, 400)
                    self._reply(400, {"message": str(e)})
                    return
                tl.mark("parse")
                try:
                    eid = server.insert_event(event, app_id, channel_id, allowed)
                except AuthError as e:
                    self._book(app_id, 401)
                    self._reply(401, {"message": str(e)})
                    return
                except ShardUnavailableError as e:
                    self._book(app_id, 503)
                    self._reply_503_shard(e)
                    return
                except TRANSIENT_STORAGE_ERRORS as e:
                    self._book(app_id, 503)
                    self._reply_503(e)
                    return
                tl.mark("store_write")
                self._book(app_id, 201, event)
                self._reply(201, {"eventId": eid})
                tl.mark("reply")
                tl.finish()

            def _post_batch(self):
                """Batch insert: per-event status
                (reference EventAPI batch route)."""
                app_id, channel_id, allowed = self._auth()
                # whole-body rejections are still this app's traffic:
                # book the 400 or /stats.json under-counts rejections
                try:
                    items = json.loads(self._body().decode())
                    if not isinstance(items, list):
                        raise ValueError("batch body must be a JSON array")
                    if len(items) > 50:
                        # the reference's limit (EventAPI.scala batch
                        # route); the REST path is for live trickle
                        # ingest — bulk loads belong on `pio-tpu import`
                        # (native scanner, one transaction, 55-95k
                        # events/s)
                        raise ValueError(
                            "batch limited to 50 events; use `pio-tpu "
                            "import` for bulk loads"
                        )
                except (json.JSONDecodeError, ValueError):
                    self._book(app_id, 400)
                    raise
                es = server.storage.get_event_store()
                es.init_channel(app_id, channel_id)
                # Parse/validate first, then insert every valid event in
                # ONE insert_batch (one executemany + one WAL commit):
                # per-event inserts put this route at 7.3k ev/s vs 33k
                # for the importer (SERVING_BENCH.md).  Statuses stay
                # positional; invalid events don't block valid siblings;
                # duplicate eventIds keep last-in-batch-wins order
                # (executemany preserves row order).  from_json already
                # validates, so validate=False skips the second pass —
                # same contract the bulk importer relies on.
                results: list[Optional[dict]] = [None] * len(items)
                valid: list[tuple[int, Event]] = []
                for k, item in enumerate(items):
                    try:
                        event = Event.from_json(item)
                        server.check_allowed(event, allowed)
                        valid.append((k, event))
                    except AuthError as e:
                        self._book(app_id, 401)
                        results[k] = {"status": 401, "message": str(e)}
                    except (EventValidationError, ValueError) as e:
                        self._book(app_id, 400)
                        results[k] = {"status": 400, "message": str(e)}
                if server.wal is not None:
                    server._seen_channels.add((app_id, channel_id))
                    fresh = iter(new_event_ids(len(valid)))
                    vids = [e.event_id or next(fresh) for _, e in valid]

                    def put_batch():
                        faults.check("storage.write")
                        server.wal.submit(
                            app_id, channel_id,
                            [event_to_row(e, eid)
                             for (_, e), eid in zip(valid, vids)],
                        )
                        return vids
                else:
                    def put_batch():
                        faults.check("storage.write")
                        return es.insert_batch(
                            [e for _, e in valid], app_id, channel_id,
                            validate=False,
                        )

                def timed_put_batch():
                    t0 = time.perf_counter()
                    try:
                        return server.write_retry.call(
                            put_batch, retry_on=TRANSIENT_STORAGE_ERRORS,
                            on_retry=server._note_retry("storage.write"),
                        )
                    finally:
                        dt = time.perf_counter() - t0
                        EVENT_WRITE_LATENCY.child().observe(dt)
                        get_tracer().record(
                            "events.write", dt, attrs={"n": len(valid)}
                        )

                try:
                    ids = timed_put_batch() if valid else []
                except ShardUnavailableError:
                    # one shard refused the whole-batch submit (which
                    # guards every row before logging any, so nothing
                    # was acknowledged).  Fall back to per-shard
                    # groups: healthy shards accept, only the dead
                    # shard's events answer 503 — the one-shard-down
                    # contract at batch granularity.
                    self._post_batch_degraded(app_id, channel_id,
                                              valid, results)
                    return
                except TRANSIENT_STORAGE_ERRORS as e:
                    # the batch contract is per-event statuses even when
                    # the store is down: valid events answer 503 (come
                    # back), invalid siblings keep their 400/401
                    for k, _ in valid:
                        self._book(app_id, 503)
                        results[k] = {
                            "status": 503,
                            "message": f"event store unavailable: {e}",
                        }
                    self.extra_headers = [("Retry-After", "1")]
                    self._reply(200, results)
                    return
                for (k, event), eid in zip(valid, ids):
                    self._book(app_id, 201, event)
                    results[k] = {"status": 201, "eventId": eid}
                self._reply(200, results)

            def _post_batch_degraded(self, app_id, channel_id, valid,
                                     results):
                """Shard-isolated batch retry: submit per shard group
                so a dead shard only fails ITS events.  Per-shard
                all-or-nothing is preserved (each submit guards every
                row first).  A shard-owner server without a WAL splits
                the same way over the sharded store itself."""
                wal = server.wal
                es = server.storage.get_event_store()
                route = wal.route if wal is not None else es.shard_of
                groups: dict[int, list[tuple[int, Event]]] = {}
                for k, e in valid:
                    six = route(e.entity_type, e.entity_id)
                    groups.setdefault(six, []).append((k, e))
                down: list[int] = []
                for six, group in sorted(groups.items()):
                    try:
                        if wal is None:
                            gids = es.insert_batch(
                                [e for _, e in group], app_id,
                                channel_id, validate=False,
                            )
                        else:
                            fresh = iter(new_event_ids(len(group)))
                            gids = [e.event_id or next(fresh)
                                    for _, e in group]
                            wal.submit(
                                app_id, channel_id,
                                [event_to_row(e, eid)
                                 for (_, e), eid in zip(group, gids)],
                            )
                    except ShardUnavailableError as e2:
                        down.append(six)
                        INGEST_SHARD_UNAVAILABLE_TOTAL.labels(
                            shard=str(six)
                        ).inc(len(group))
                        for k, _ in group:
                            self._book(app_id, 503)
                            results[k] = {
                                "status": 503,
                                "message": str(e2),
                                "error": "ShardUnavailable",
                                "shard": six,
                            }
                        continue
                    for (k, event), eid in zip(group, gids):
                        self._book(app_id, 201, event)
                        results[k] = {"status": 201, "eventId": eid}
                if down:
                    self.extra_headers = [("Retry-After", "2")]
                self._reply(200, results)

            def _post_webhook(self, path: str):
                app_id, channel_id, allowed = self._auth()
                name = path[len("/webhooks/"):]
                if name.endswith(".json"):
                    connector = JSON_CONNECTORS.get(name[: -len(".json")])
                    if connector is None:
                        self._reply(404, {"message": f"webhook {name} not found"})
                        return
                    data = json.loads(self._body().decode() or "{}")
                elif name.endswith(".form"):
                    connector = FORM_CONNECTORS.get(name[: -len(".form")])
                    if connector is None:
                        self._reply(404, {"message": f"webhook {name} not found"})
                        return
                    form = urllib.parse.parse_qs(
                        self._body().decode(), keep_blank_values=True
                    )
                    data = {k: v[0] for k, v in form.items()}
                else:
                    self._reply(404, {"message": "unknown webhook format"})
                    return
                event = to_event(connector, data)
                try:
                    eid = server.insert_event(
                        event, app_id, channel_id, allowed
                    )
                except TRANSIENT_STORAGE_ERRORS:
                    self._book(app_id, 503)
                    raise  # central handler answers 503 + Retry-After
                self._book(app_id, 201, event)
                self._reply(201, {"eventId": eid})

            # ---- GET ----
            def do_GET(self):
                if self._serve_metrics():
                    return
                path = self._route()
                try:
                    if path == "/":
                        self._reply(200, {
                            "status": "alive",
                            "description": "predictionio_tpu event server",
                        })
                    elif path == "/events.json":
                        self._get_events()
                    elif path.startswith("/events/") and path.endswith(".json"):
                        self._get_event(path[len("/events/"):-len(".json")])
                    elif path == "/stats.json":
                        self._get_stats()
                    elif path.startswith("/webhooks/"):
                        name = path[len("/webhooks/"):]
                        base = name.rsplit(".", 1)[0]
                        if base in JSON_CONNECTORS or base in FORM_CONNECTORS:
                            self._auth()
                            self._reply(200, {"message": f"webhook {base} connected"})
                        else:
                            self._reply(404, {"message": f"webhook {name} not found"})
                    else:
                        self._reply(404, {"message": "not found"})
                except AuthError as e:
                    self._reply(401, {"message": str(e)})
                except ValueError as e:
                    self._reply(400, {"message": str(e)})
                except ShardUnavailableError as e:
                    self._reply_503_shard(e)
                except TRANSIENT_STORAGE_ERRORS as e:
                    self._reply_503(e)
                except Exception as e:
                    logger.exception("event server error")
                    self._reply(500, {"message": str(e)})

            def _scan(self, app_id, fn):
                """Run a storage read through the injection point and
                the transient-error retry policy."""
                def read():
                    faults.check("storage.read")
                    # read-your-writes under the WAL: a 201 means
                    # "fsynced", not "committed" — drain before scanning
                    # so this server's own GETs see their POSTs
                    server.barrier()
                    return fn()

                try:
                    return server.write_retry.call(
                        read, retry_on=TRANSIENT_STORAGE_ERRORS,
                        on_retry=server._note_retry("storage.read"),
                    )
                except TRANSIENT_STORAGE_ERRORS:
                    self._book(app_id, 503)
                    raise

            def _get_events(self):
                app_id, channel_id, _ = self._auth()
                kw = server._find_kwargs(self._params())
                es = server.storage.get_event_store()
                es.init_channel(app_id, channel_id)
                events = self._scan(app_id, lambda: list(
                    es.find(app_id=app_id, channel_id=channel_id, **kw)
                ))
                self._book(app_id, 200)
                if not events:
                    self._reply(404, {"message": "Not Found"})
                else:
                    self._reply(200, [e.to_json() for e in events])

            def _get_event(self, event_id: str):
                app_id, channel_id, _ = self._auth()
                es = server.storage.get_event_store()
                es.init_channel(app_id, channel_id)
                e = self._scan(
                    app_id, lambda: es.get(event_id, app_id, channel_id)
                )
                if e is None:
                    self._reply(404, {"message": "Not Found"})
                else:
                    self._reply(200, e.to_json())

            def _get_stats(self):
                app_id, _, _ = self._auth()
                if server.stats is None:
                    self._reply(404, {"message": "stats disabled"})
                else:
                    self._reply(200, server.stats.to_json(app_id))

            # ---- DELETE ----
            def do_DELETE(self):
                path = self._route()
                try:
                    if path.startswith("/events/") and path.endswith(".json"):
                        app_id, channel_id, _ = self._auth()
                        eid = path[len("/events/"):-len(".json")]
                        es = server.storage.get_event_store()
                        es.init_channel(app_id, channel_id)
                        # a delete must see (and remove) the caller's
                        # own just-acknowledged writes
                        server.barrier()
                        if es.delete(eid, app_id, channel_id):
                            self._reply(200, {"message": "Found"})
                        else:
                            self._reply(404, {"message": "Not Found"})
                    else:
                        self._reply(404, {"message": "not found"})
                except AuthError as e:
                    self._reply(401, {"message": str(e)})
                except ShardUnavailableError as e:
                    self._reply_503_shard(e)
                except TRANSIENT_STORAGE_ERRORS as e:
                    self._reply_503(e)
                except Exception as e:
                    logger.exception("event server error")
                    self._reply(500, {"message": str(e)})

        return Handler
