"""Resilience primitives of the port: retries with jittered backoff,
propagated deadlines and circuit breakers (``policy``), and the
reference's deterministic fault-injection registry (``faults``: named
points in the real code paths, armed programmatically or through
``PIO_FAULT_PLAN``).  The reference's delivery queues are not ported
yet (ROADMAP Queue 1 item 4)."""

from .faults import (
    FaultPlan,
    InjectedFault,
    arm,
    armed,
    check,
    disarm,
    fired_shard,
)
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
    "FaultPlan",
    "InjectedFault",
    "RetryPolicy",
    "arm",
    "armed",
    "check",
    "check_deadline",
    "current_deadline",
    "deadline_scope",
    "disarm",
    "fired_shard",
]
