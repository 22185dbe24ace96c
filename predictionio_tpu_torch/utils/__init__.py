"""Observability and debugging utilities of the port.

Port of ``predictionio_tpu/utils``: stdlib logging with the reference's
two-tier chatty/root split (``logging``), a recursive debug dumper for
tensors, arrays and nested workflow data (``debug``), and
``torch.profiler`` hooks for workflows (``profiling``).
"""

from .debug import debug_string
from .logging import modify_logging, setup_logging
from .profiling import profile_trace, profiled

__all__ = [
    "debug_string",
    "modify_logging",
    "setup_logging",
    "profile_trace",
    "profiled",
]
