"""HTTP servers of the port: the REST event server with its stats and
webhooks, the engine server on the threads edge, its micro-batcher and
the shared HTTP plumbing (ports of ``predictionio_tpu/server``'s
``event_server``, ``stats``, ``webhooks``, ``serving``, ``microbatch``
and ``http_base``; the event-loop edge, the ingest and replica routers
and the admin and dashboard servers are not ported yet)."""

from .event_server import EventServer, EventServerConfig
from .microbatch import AdmissionRejected, MicroBatcher, dispatchable_sizes
from .serving import EngineServer, ServerConfig
from .stats import StatsCollector

__all__ = [
    "AdmissionRejected",
    "EngineServer",
    "EventServer",
    "EventServerConfig",
    "MicroBatcher",
    "ServerConfig",
    "StatsCollector",
    "dispatchable_sizes",
]
