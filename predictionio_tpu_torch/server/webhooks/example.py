"""Example connectors: templates for writing custom webhook adapters.

Semantics mirror the reference's test-fixture connectors
(`data/src/test/.../webhooks/examplejson`, `exampleform`): a minimal
field mapping from a third-party payload into the event wire format.
Registered as ``examplejson`` / ``exampleform`` so
``POST /webhooks/examplejson.json`` works out of the box as a starting
point.
"""

from __future__ import annotations

from typing import Any, Mapping

from . import ConnectorError, FormConnector, JsonConnector

__all__ = ["ExampleJsonConnector", "ExampleFormConnector"]


class ExampleJsonConnector(JsonConnector):
    """Expects ``{"type": ..., "userId": ..., "timestamp": ...,
    ["itemId": ...], ...extra}`` and maps extras into properties."""

    _RESERVED = {"type", "userId", "itemId", "timestamp"}

    def to_event_json(self, data: Mapping[str, Any]) -> dict:
        for required in ("type", "userId", "timestamp"):
            if required not in data:
                raise ConnectorError(
                    f"examplejson payload missing {required!r}"
                )
        out: dict[str, Any] = {
            "event": str(data["type"]),
            "entityType": "user",
            "entityId": str(data["userId"]),
            "eventTime": str(data["timestamp"]),
        }
        if data.get("itemId") is not None:
            out["targetEntityType"] = "item"
            out["targetEntityId"] = str(data["itemId"])
        props = {k: v for k, v in data.items() if k not in self._RESERVED}
        if props:
            out["properties"] = props
        return out


class ExampleFormConnector(FormConnector):
    """Form-encoded variant: ``type``, ``userId``, ``timestamp`` fields,
    everything else becomes string properties."""

    _RESERVED = {"type", "userId", "itemId", "timestamp"}

    def to_event_json(self, data: Mapping[str, str]) -> dict:
        json_like: dict[str, Any] = dict(data)
        return ExampleJsonConnector().to_event_json(json_like)
