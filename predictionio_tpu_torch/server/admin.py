"""Admin REST API (port 7071).

Port of ``predictionio_tpu/server/admin.py``, the re-expression of the
reference's `tools/admin/AdminAPI.scala:40-154` +
`admin/CommandClient.scala`: app administration over HTTP, on any
metadata store of the registry (``jsonfs`` included).

* ``GET    /``                   -> server info
* ``GET    /cmd/app``            -> list apps
* ``POST   /cmd/app``            -> create app (+default access key)
* ``DELETE /cmd/app/<name>``     -> delete app
* ``DELETE /cmd/app/<name>/data``-> wipe app event data
"""

from __future__ import annotations

import json
import logging
import urllib.parse
from typing import Optional

from ..storage.metadata import AccessKey
from ..storage.registry import Storage
from .http_base import HTTPServerBase, JsonRequestHandler

logger = logging.getLogger(__name__)

__all__ = ["AdminServer"]


class AdminServer(HTTPServerBase):
    server_name = "admin"

    def __init__(self, storage: Storage, host: str = "127.0.0.1",
                 port: int = 7071):
        self.storage = storage
        self.host = host
        self.port = port

    # -- command impls (CommandClient.scala) -------------------------------
    def app_list(self) -> list[dict]:
        md = self.storage.get_metadata()
        return [
            {
                "name": a.name,
                "id": a.id,
                "description": a.description,
                "accessKeys": [k.key for k in md.access_key_get_by_app(a.id)],
            }
            for a in md.app_get_all()
        ]

    def app_new(self, name: str, description: Optional[str]) -> dict:
        md = self.storage.get_metadata()
        if md.app_get_by_name(name):
            raise ValueError(f"App {name} already exists.")
        app = md.app_insert(name, description)
        self.storage.get_event_store().init_channel(app.id)
        key = md.access_key_insert(AccessKey(key="", appid=app.id))
        return {"name": app.name, "id": app.id, "accessKey": key}

    def app_delete(self, name: str) -> None:
        md = self.storage.get_metadata()
        app = md.app_get_by_name(name)
        if app is None:
            raise LookupError(f"App {name} not found.")
        es = self.storage.get_event_store()
        for c in md.channel_get_by_app(app.id):
            es.remove_channel(app.id, c.id)
            md.channel_delete(c.id)
        es.remove_channel(app.id)
        for k in md.access_key_get_by_app(app.id):
            md.access_key_delete(k.key)
        md.app_delete(app.id)

    def app_data_delete(self, name: str) -> None:
        md = self.storage.get_metadata()
        app = md.app_get_by_name(name)
        if app is None:
            raise LookupError(f"App {name} not found.")
        es = self.storage.get_event_store()
        es.remove_channel(app.id)
        es.init_channel(app.id)

    # -- http ---------------------------------------------------------------
    def _make_handler(server: "AdminServer"):
        class Handler(JsonRequestHandler):
            server_logger = logger

            def do_GET(self):
                if self._serve_metrics():
                    return
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    self._reply(200, {
                        "status": "alive",
                        "description": "predictionio_tpu_torch admin server",
                    })
                elif path == "/cmd/app":
                    self._reply(200, server.app_list())
                else:
                    self._reply(404, {"message": "not found"})

            def do_POST(self):
                path = urllib.parse.urlparse(self.path).path
                if path != "/cmd/app":
                    self._reply(404, {"message": "not found"})
                    return
                try:
                    body = json.loads(self._body().decode() or "{}")
                    name = body.get("name")
                    if not name:
                        raise ValueError("field 'name' is required")
                    self._reply(
                        201, server.app_new(name, body.get("description"))
                    )
                except ValueError as e:
                    self._reply(400, {"message": str(e)})
                except Exception as e:
                    logger.exception("admin error")
                    self._reply(500, {"message": str(e)})

            def do_DELETE(self):
                path = urllib.parse.urlparse(self.path).path
                parts = [
                    urllib.parse.unquote(x) for x in path.split("/") if x
                ]
                try:
                    if len(parts) == 3 and parts[:2] == ["cmd", "app"]:
                        server.app_delete(parts[2])
                        self._reply(200, {"message": f"App {parts[2]} deleted."})
                    elif (
                        len(parts) == 4
                        and parts[:2] == ["cmd", "app"]
                        and parts[3] == "data"
                    ):
                        server.app_data_delete(parts[2])
                        self._reply(
                            200, {"message": f"App {parts[2]} data deleted."}
                        )
                    else:
                        self._reply(404, {"message": "not found"})
                except LookupError as e:
                    self._reply(404, {"message": str(e)})
                except Exception as e:
                    logger.exception("admin error")
                    self._reply(500, {"message": str(e)})

        return Handler
