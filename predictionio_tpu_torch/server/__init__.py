"""HTTP servers of the port: the REST event server with its stats and
webhooks, the engine server on its two edges (the event loop and
threads), its micro-batchers and the shared HTTP plumbing (ports of
``predictionio_tpu/server``'s ``event_server``, ``stats``, ``webhooks``,
``serving``, ``eventloop``, ``microbatch`` and ``http_base``; the ingest
and replica routers and the admin and dashboard servers are not ported
yet)."""

from .event_server import EventServer, EventServerConfig
from .eventloop import EventLoopHTTPServer
from .microbatch import (
    AdmissionRejected,
    MicroBatcher,
    SharedBatcher,
    SharedBatcherView,
    dispatchable_sizes,
)
from .serving import EngineServer, ServerConfig
from .stats import StatsCollector

__all__ = [
    "AdmissionRejected",
    "EngineServer",
    "EventLoopHTTPServer",
    "EventServer",
    "EventServerConfig",
    "MicroBatcher",
    "ServerConfig",
    "SharedBatcher",
    "SharedBatcherView",
    "StatsCollector",
    "dispatchable_sizes",
]
