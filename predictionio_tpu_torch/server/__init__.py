"""HTTP servers of the port: the engine server on the threads edge, its
micro-batcher and the shared HTTP plumbing (ports of
``predictionio_tpu/server``'s ``serving``, ``microbatch`` and
``http_base``; the event server, the event-loop edge and the admin and
dashboard servers are not ported yet)."""

from .microbatch import AdmissionRejected, MicroBatcher, dispatchable_sizes
from .serving import EngineServer, ServerConfig

__all__ = [
    "AdmissionRejected",
    "EngineServer",
    "MicroBatcher",
    "ServerConfig",
    "dispatchable_sizes",
]
