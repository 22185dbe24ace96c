"""MailChimp webhook connector
(reference `data/webhooks/mailchimp/MailChimpConnector.scala`): supports the
``subscribe`` form callback; MailChimp timestamps (``yyyy-MM-dd HH:mm:ss``
UTC) are converted to ISO8601."""

from __future__ import annotations

import datetime as _dt
from typing import Mapping

from ...storage.event import UTC, format_time


class MailChimpConnector:
    @staticmethod
    def _parse_time(s: str) -> _dt.datetime:
        return _dt.datetime.strptime(s, "%Y-%m-%d %H:%M:%S").replace(tzinfo=UTC)

    def to_event_json(self, data: Mapping[str, str]) -> dict:
        from . import ConnectorError

        typ = data.get("type")
        if typ is None:
            raise ConnectorError("The field 'type' is required for MailChimp data.")
        if typ != "subscribe":
            raise ConnectorError(
                f"Cannot convert unknown MailChimp data type {typ} to event JSON"
            )
        try:
            event_time = format_time(self._parse_time(data["fired_at"]))
            return {
                "event": "subscribe",
                "entityType": "user",
                "entityId": data["data[id]"],
                "targetEntityType": "list",
                "targetEntityId": data["data[list_id]"],
                "eventTime": event_time,
                "properties": {
                    "email": data["data[email]"],
                    "email_type": data["data[email_type]"],
                    "merges": {
                        "EMAIL": data["data[merges][EMAIL]"],
                        "FNAME": data["data[merges][FNAME]"],
                        "LNAME": data["data[merges][LNAME]"],
                        "INTERESTS": data.get("data[merges][INTERESTS]", ""),
                    },
                    "ip_opt": data["data[ip_opt]"],
                    "ip_signup": data["data[ip_signup]"],
                },
            }
        except KeyError as e:
            raise ConnectorError(
                f"missing MailChimp field {e.args[0]}"
            ) from e
