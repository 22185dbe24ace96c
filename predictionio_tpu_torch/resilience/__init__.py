"""Resilience primitives of the port: retries with jittered backoff,
propagated deadlines and circuit breakers (``policy``).  The
reference's fault-injection registry (``resilience/faults.py``) and
delivery queues are not ported yet (ROADMAP Queue 1)."""

from .policy import (
    CircuitBreaker,
    Deadline,
    DeadlineExceeded,
    RetryPolicy,
    check_deadline,
    current_deadline,
    deadline_scope,
)

__all__ = [
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "RetryPolicy",
    "check_deadline",
    "current_deadline",
    "deadline_scope",
]
