"""Segment.io webhook connector
(reference `data/webhooks/segmentio/SegmentIOConnector.scala:25-71`):
supports the ``identify`` call type."""

from __future__ import annotations

from typing import Any, Mapping


class SegmentIOConnector:
    def to_event_json(self, data: Mapping[str, Any]) -> dict:
        from . import ConnectorError

        typ = data.get("type")
        if typ is None:
            raise ConnectorError("missing 'type' field in segment.io data")
        if typ != "identify":
            raise ConnectorError(
                f"Cannot convert unknown type {typ} to event JSON."
            )
        user_id = data.get("userId") or data.get("user_id")
        if not user_id:
            raise ConnectorError("missing 'userId' in segment.io identify")
        out = {
            "event": typ,
            "entityType": "user",
            "entityId": str(user_id),
            "properties": {
                "context": data.get("context", {}),
                "traits": data.get("traits", {}),
            },
        }
        if data.get("timestamp"):
            out["eventTime"] = data["timestamp"]
        return out
