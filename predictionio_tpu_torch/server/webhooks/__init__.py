"""Webhooks framework: third-party payloads -> validated events.

Copy of ``predictionio_tpu/server/webhooks`` for the port, itself a
re-expression of reference `data/webhooks/` (`JsonConnector.scala`,
`FormConnector.scala`, `ConnectorUtil.scala`, registry in
`api/WebhooksConnectors.scala`): connectors are pure functions from
provider payloads to event-JSON; :func:`to_event` pushes them through the
standard wire-format validation.
"""

from __future__ import annotations

from typing import Any, Mapping

from ...storage.event import Event

__all__ = [
    "ConnectorError",
    "JsonConnector",
    "FormConnector",
    "to_event",
    "JSON_CONNECTORS",
    "FORM_CONNECTORS",
]


class ConnectorError(ValueError):
    """(reference `ConnectorException`)"""


class JsonConnector:
    """JSON-body webhook -> event JSON (reference `JsonConnector.scala`)."""

    def to_event_json(self, data: Mapping[str, Any]) -> dict:
        raise NotImplementedError


class FormConnector:
    """Form-encoded webhook -> event JSON (reference `FormConnector.scala`)."""

    def to_event_json(self, data: Mapping[str, str]) -> dict:
        raise NotImplementedError


def to_event(connector, data) -> Event:
    """connector payload -> validated Event
    (reference `ConnectorUtil.toEvent`)."""
    event_json = connector.to_event_json(data)
    try:
        return Event.from_json(event_json)
    except Exception as e:
        raise ConnectorError(
            f"connector produced invalid event JSON: {e}"
        ) from e


from .segmentio import SegmentIOConnector  # noqa: E402
from .mailchimp import MailChimpConnector  # noqa: E402
from .example import (  # noqa: E402
    ExampleFormConnector,
    ExampleJsonConnector,
)

JSON_CONNECTORS: dict[str, JsonConnector] = {
    "segmentio": SegmentIOConnector(),
    "examplejson": ExampleJsonConnector(),
}
FORM_CONNECTORS: dict[str, FormConnector] = {
    "mailchimp": MailChimpConnector(),
    "exampleform": ExampleFormConnector(),
}
