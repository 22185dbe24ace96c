"""Tenancy error types, importable without the registry machinery.

Port of ``predictionio_tpu/tenancy/errors.py``.  Kept in their own
module so ``server/serving.py`` can import the classes for its error
mapping without pulling the whole tenancy package into its import graph
(the registry's loader lives in serving).

Both shed types subclass :class:`~..resilience.policy.DeadlineExceeded`,
so code that only knows the resilience taxonomy treats a shed tenant
like any other structured overload answer; the serving edges map each
to its own error name and status code (429 for quota, 503 for
unavailability).
"""

from __future__ import annotations

from ..resilience.policy import DeadlineExceeded

__all__ = ["QuotaExceeded", "TenantUnavailable", "UnknownTenant"]


class QuotaExceeded(DeadlineExceeded):
    """The tenant's token-bucket rate limit is exhausted (HTTP 429)."""


class TenantUnavailable(DeadlineExceeded):
    """The tenant cannot serve right now: its breaker is open (repeated
    errors or timeouts) or its lazy load failed.  The rest of the
    process keeps serving every other tenant."""


class UnknownTenant(KeyError):
    """The query named an (app, variant) or access key no tenant spec
    covers: a client error (HTTP 400), never a server fault."""
