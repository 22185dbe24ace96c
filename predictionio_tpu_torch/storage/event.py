"""Event data model.

Copy of ``predictionio_tpu/storage/event.py`` for the port (host code:
frozen dataclasses and a schemaless property bag, no device work).  The
reference event model is `data/.../storage/Event.scala:37-115`,
`DataMap.scala:38-202` and `PropertyMap.scala:33-96`.  Times are
timezone-aware UTC ``datetime`` objects; the wire format is ISO8601.
"""

from __future__ import annotations

import datetime as _dt
import uuid
from dataclasses import dataclass, field, replace
from typing import Any, Iterable, Mapping, Optional, Sequence

UTC = _dt.timezone.utc

__all__ = [
    "UTC",
    "DataMap",
    "PropertyMap",
    "Event",
    "EventValidationError",
    "validate_event",
    "SPECIAL_EVENTS",
    "now_utc",
    "parse_time",
    "format_time",
]


def now_utc() -> _dt.datetime:
    return _dt.datetime.now(tz=UTC)


def parse_time(s: str) -> _dt.datetime:
    """Parse ISO8601 (accepts trailing 'Z')."""
    if s.endswith("Z"):
        s = s[:-1] + "+00:00"
    t = _dt.datetime.fromisoformat(s)
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t.astimezone(UTC)


def format_time(t: _dt.datetime) -> str:
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return t.astimezone(UTC).isoformat(timespec="milliseconds").replace("+00:00", "Z")


def time_millis(t: _dt.datetime) -> int:
    if t.tzinfo is None:
        t = t.replace(tzinfo=UTC)
    return int(t.timestamp() * 1000)


def from_millis(ms: int) -> _dt.datetime:
    return _dt.datetime.fromtimestamp(ms / 1000.0, tz=UTC)


class EventValidationError(ValueError):
    """Raised when an event violates the validation rules
    (reference `Event.scala:70-99`)."""


class DataMapError(KeyError):
    """Raised when a required property is missing or has the wrong type."""


_MISSING = object()


class DataMap(Mapping[str, Any]):
    """Schemaless immutable property bag: name -> JSON value.

    Behavioral parity with reference `DataMap.scala:38-202`: typed ``get``
    (raises on missing / null), ``get_opt``, ``get_or_else``, merge (``++``
    -> :meth:`merged`) and key removal (``--`` -> :meth:`without`).
    """

    __slots__ = ("_fields",)

    def __init__(self, fields: Optional[Mapping[str, Any]] = None):
        object.__setattr__(self, "_fields", dict(fields or {}))

    # -- Mapping interface ------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._fields[key]

    def __iter__(self):
        return iter(self._fields)

    def __len__(self) -> int:
        return len(self._fields)

    def __contains__(self, key) -> bool:
        return key in self._fields

    # -- typed accessors --------------------------------------------------
    def require(self, name: str) -> None:
        if name not in self._fields:
            raise DataMapError(f"The field {name} is required.")

    def get(self, name: str, default: Any = _MISSING) -> Any:
        """Return the field value; raise :class:`DataMapError` when missing
        and no default given (parity with reference ``get[T]``)."""
        if name not in self._fields or self._fields[name] is None:
            if default is _MISSING:
                raise DataMapError(f"The field {name} is required.")
            return default
        return self._fields[name]

    def get_opt(self, name: str) -> Optional[Any]:
        return self._fields.get(name)

    def get_or_else(self, name: str, default: Any) -> Any:
        v = self._fields.get(name)
        return default if v is None else v

    def get_float(self, name: str) -> float:
        return float(self.get(name))

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def get_string(self, name: str) -> str:
        return str(self.get(name))

    def get_string_list(self, name: str) -> list[str]:
        v = self.get(name)
        if not isinstance(v, list):
            raise DataMapError(f"The field {name} is not a list.")
        return [str(x) for x in v]

    # -- functional updates ----------------------------------------------
    def merged(self, other: "DataMap | Mapping[str, Any]") -> "DataMap":
        """``this ++ that`` — that's values win (reference `DataMap.scala`)."""
        d = dict(self._fields)
        d.update(dict(other))
        return DataMap(d)

    def without(self, keys: Iterable[str]) -> "DataMap":
        """``this -- keys``."""
        drop = set(keys)
        return DataMap({k: v for k, v in self._fields.items() if k not in drop})

    @property
    def fields(self) -> dict[str, Any]:
        return dict(self._fields)

    def is_empty(self) -> bool:
        return not self._fields

    def keyset(self) -> set[str]:
        return set(self._fields)

    def to_json(self) -> dict[str, Any]:
        return dict(self._fields)

    def __eq__(self, other) -> bool:
        if isinstance(other, DataMap):
            return self._fields == other._fields
        if isinstance(other, Mapping):
            return self._fields == dict(other)
        return NotImplemented

    def __hash__(self):
        return hash(tuple(sorted((k, repr(v)) for k, v in self._fields.items())))

    def __repr__(self) -> str:
        return f"DataMap({self._fields!r})"


class PropertyMap(DataMap):
    """Aggregated entity property snapshot + first/last update times
    (reference `PropertyMap.scala:33-96`)."""

    __slots__ = ("first_updated", "last_updated")

    def __init__(
        self,
        fields: Optional[Mapping[str, Any]],
        first_updated: _dt.datetime,
        last_updated: _dt.datetime,
    ):
        super().__init__(fields)
        object.__setattr__(self, "first_updated", first_updated)
        object.__setattr__(self, "last_updated", last_updated)

    def __repr__(self) -> str:
        return (
            f"PropertyMap({self._fields!r}, first={self.first_updated}, "
            f"last={self.last_updated})"
        )

    def __eq__(self, other) -> bool:
        if isinstance(other, PropertyMap):
            return (
                self._fields == other._fields
                and self.first_updated == other.first_updated
                and self.last_updated == other.last_updated
            )
        return super().__eq__(other)

    def __hash__(self):
        return hash((super().__hash__(), self.first_updated, self.last_updated))


@dataclass(frozen=True)
class Event:
    """One behavioral event (reference `Event.scala:37-55`).

    ``target_entity_type``/``target_entity_id`` must be set together;
    ``pr_id`` links a feedback event back to a prediction.
    """

    event: str
    entity_type: str
    entity_id: str
    target_entity_type: Optional[str] = None
    target_entity_id: Optional[str] = None
    properties: DataMap = field(default_factory=DataMap)
    event_time: _dt.datetime = field(default_factory=now_utc)
    tags: Sequence[str] = ()
    pr_id: Optional[str] = None
    event_id: Optional[str] = None
    creation_time: _dt.datetime = field(default_factory=now_utc)

    def __post_init__(self) -> None:
        # ergonomics: accept a plain dict for properties (the reference's
        # typed DataMap has no such ambiguity; in Python a raw dict is the
        # natural thing to pass and must not crash later in validation)
        if not isinstance(self.properties, DataMap):
            object.__setattr__(self, "properties", DataMap(self.properties))

    def with_id(self, event_id: str) -> "Event":
        return replace(self, event_id=event_id)

    def to_json(self) -> dict[str, Any]:
        """API wire format (reference `EventJson4sSupport.scala:25-178`)."""
        d: dict[str, Any] = {
            "eventId": self.event_id,
            "event": self.event,
            "entityType": self.entity_type,
            "entityId": self.entity_id,
            "properties": self.properties.to_json(),
            "eventTime": format_time(self.event_time),
        }
        if self.target_entity_type is not None:
            d["targetEntityType"] = self.target_entity_type
        if self.target_entity_id is not None:
            d["targetEntityId"] = self.target_entity_id
        if self.pr_id is not None:
            d["prId"] = self.pr_id
        d["creationTime"] = format_time(self.creation_time)
        return d

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "Event":
        """Parse the API wire format; raises on missing required fields."""
        if not isinstance(d, Mapping):
            raise EventValidationError(
                f"event must be a JSON object, got {type(d).__name__}"
            )
        try:
            name = d["event"]
            etype = d["entityType"]
            eid = d["entityId"]
        except KeyError as e:
            raise EventValidationError(f"field {e.args[0]} is required") from e
        ev = Event(
            event=str(name),
            entity_type=str(etype),
            entity_id=str(eid),
            target_entity_type=d.get("targetEntityType"),
            target_entity_id=d.get("targetEntityId"),
            properties=DataMap(d.get("properties") or {}),
            event_time=(
                parse_time(d["eventTime"]) if d.get("eventTime") else now_utc()
            ),
            tags=tuple(d.get("tags") or ()),
            pr_id=d.get("prId"),
            event_id=d.get("eventId"),
            creation_time=(
                parse_time(d["creationTime"]) if d.get("creationTime") else now_utc()
            ),
        )
        validate_event(ev)
        return ev


# --- validation (reference `Event.scala:57-115`) -------------------------

SPECIAL_EVENTS = frozenset({"$set", "$unset", "$delete"})
BUILTIN_ENTITY_TYPES = frozenset({"pio_pr"})
BUILTIN_PROPERTIES: frozenset[str] = frozenset()


def _is_reserved_prefix(name: str) -> bool:
    return name.startswith("$") or name.startswith("pio_")


def validate_event(e: Event) -> None:
    def need(cond: bool, msg: str) -> None:
        if not cond:
            raise EventValidationError(msg)

    need(bool(e.event), "event must not be empty.")
    need(bool(e.entity_type), "entityType must not be empty string.")
    need(bool(e.entity_id), "entityId must not be empty string.")
    need(e.target_entity_type != "", "targetEntityType must not be empty string")
    need(e.target_entity_id != "", "targetEntityId must not be empty string.")
    need(
        (e.target_entity_type is None) == (e.target_entity_id is None),
        "targetEntityType and targetEntityId must be specified together.",
    )
    need(
        not (e.event == "$unset" and e.properties.is_empty()),
        "properties cannot be empty for $unset event",
    )
    need(
        not _is_reserved_prefix(e.event) or e.event in SPECIAL_EVENTS,
        f"{e.event} is not a supported reserved event name.",
    )
    need(
        e.event not in SPECIAL_EVENTS or e.target_entity_type is None,
        f"Reserved event {e.event} cannot have targetEntity",
    )
    need(
        not _is_reserved_prefix(e.entity_type)
        or e.entity_type in BUILTIN_ENTITY_TYPES,
        f"The entityType {e.entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    need(
        e.target_entity_type is None
        or not _is_reserved_prefix(e.target_entity_type)
        or e.target_entity_type in BUILTIN_ENTITY_TYPES,
        f"The targetEntityType {e.target_entity_type} is not allowed. "
        "'pio_' is a reserved name prefix.",
    )
    for k in e.properties.keyset():
        need(
            not _is_reserved_prefix(k) or k in BUILTIN_PROPERTIES,
            f"The property {k} is not allowed. 'pio_' is a reserved name prefix.",
        )


def new_event_id() -> str:
    return uuid.uuid4().hex


def new_event_ids(n: int) -> list[str]:
    """``n`` unique event ids for bulk inserts: one random 64-bit prefix +
    counter — same 32-hex shape as :func:`new_event_id`, ~10x cheaper than
    ``n`` uuid4 calls (measured in the ML-20M import profile)."""
    prefix = uuid.uuid4().hex[:16]
    return [f"{prefix}{k:016x}" for k in range(n)]
