"""HTTP servers of the port: the REST event server with its stats and
webhooks, the engine server on its two edges (the event loop and
threads), its micro-batchers, the serving replica router and the
multi-process ingest router with their fleet helpers, and the shared
HTTP plumbing, the admin API and the evaluation dashboard (ports of
``predictionio_tpu/server``'s ``event_server``, ``stats``, ``webhooks``,
``serving``, ``eventloop``, ``microbatch``, ``ingest_router``,
``router``, ``http_base``, ``admin`` and ``dashboard``)."""

from .admin import AdminServer
from .dashboard import DashboardServer
from .event_server import EventServer, EventServerConfig
from .eventloop import EventLoopHTTPServer
from .ingest_router import (
    IngestRouterConfig,
    IngestRouterServer,
    IngestWorker,
    boot_ingest_fleet,
    shards_for_worker,
    spawn_ingest_worker,
)
from .microbatch import (
    AdmissionRejected,
    MicroBatcher,
    SharedBatcher,
    SharedBatcherView,
    dispatchable_sizes,
)
from .router import (
    Replica,
    ReplicaSupervisor,
    RouterConfig,
    RouterServer,
    spawn_port_process,
    spawn_replica,
    wait_for_port_file,
)
from .serving import EngineServer, ServerConfig
from .stats import StatsCollector

__all__ = [
    "AdminServer",
    "AdmissionRejected",
    "DashboardServer",
    "EngineServer",
    "EventLoopHTTPServer",
    "EventServer",
    "EventServerConfig",
    "IngestRouterConfig",
    "IngestRouterServer",
    "IngestWorker",
    "MicroBatcher",
    "Replica",
    "ReplicaSupervisor",
    "RouterConfig",
    "RouterServer",
    "ServerConfig",
    "SharedBatcher",
    "SharedBatcherView",
    "StatsCollector",
    "boot_ingest_fleet",
    "dispatchable_sizes",
    "shards_for_worker",
    "spawn_ingest_worker",
    "spawn_port_process",
    "spawn_replica",
    "wait_for_port_file",
]
