"""Resilience primitives of the port: retries with jittered backoff,
propagated deadlines and circuit breakers (``policy``), the reference's
deterministic fault-injection registry (``faults``: named points in the
real code paths, armed programmatically or through ``PIO_FAULT_PLAN``),
and the bounded background delivery queue of the serving edge's
feedback events and remote error logs (``delivery``)."""

from .faults import (
    FaultPlan,
    InjectedFault,
    arm,
    armed,
    check,
    disarm,
    fired_shard,
)
from .delivery import DeliveryQueue
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
    "DeliveryQueue",
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
