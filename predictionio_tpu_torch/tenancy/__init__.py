"""pio-hive: multi-tenant model serving with live A/B experiments.

Port of ``predictionio_tpu/tenancy/``.  One serving process (or each
replica of a ``deploy --replicas N`` fleet) hosts many (app,
engine_variant) models behind a memory-budgeted
:class:`TenantRegistry` (lazy load, LRU eviction and pinning, per-tenant
circuit breakers, token-bucket quotas and metric labels), with weighted
sticky variant assignment, per-variant feedback attribution through the
event store, an online-eval aggregator feeding ``/metrics`` and a run
manifest, and the SPRT :class:`AutoPilot` that ramps traffic to the
winning variant.
"""

from .autopilot import (
    AutoPilot,
    AutopilotConfig,
    autopilot_payload,
    sprt_test,
    step_weights,
)
from .errors import QuotaExceeded, TenantUnavailable, UnknownTenant
from .experiment import Experiment, assign_bucket
from .online_eval import OnlineEval
from .quota import TokenBucket
from .registry import (
    TenantLease,
    TenantRegistry,
    TenantRuntime,
    TenantSpec,
    load_tenant_manifest,
    model_resident_bytes,
)

__all__ = [
    "AutoPilot",
    "AutopilotConfig",
    "Experiment",
    "OnlineEval",
    "QuotaExceeded",
    "TenantLease",
    "TenantRegistry",
    "TenantRuntime",
    "TenantSpec",
    "TenantUnavailable",
    "TokenBucket",
    "UnknownTenant",
    "assign_bucket",
    "autopilot_payload",
    "load_tenant_manifest",
    "model_resident_bytes",
    "sprt_test",
    "step_weights",
]
