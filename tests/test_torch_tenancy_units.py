"""The port's tenancy units against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through both packages'
``tenancy`` modules: ``assign_bucket`` and ``Experiment.assign`` (10,000
users x 3 salts x 3 weight sets: the same position in [0, 1) to the bit
and the same variant for every user), ``Experiment``'s errors and
snapshots, ``TokenBucket`` under an injected clock, ``merge_cursor``,
``load_tenant_manifest`` (equal specs and options) and
``model_resident_bytes`` (the reference's recommendation model against
the port's built from it by ``convert.model_from_jax``, before and after
each warm-up made its device tables).  Equality is exact.
"""

import json

import numpy as np
import pytest

from predictionio_tpu import tenancy as jax_tenancy
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.templates.recommendation import (
    ALSAlgorithm as JaxALSAlgorithm,
    ALSAlgorithmParams as JaxALSAlgorithmParams,
    ALSModel as JaxALSModel,
)
from predictionio_tpu.tenancy.online_eval import (
    merge_cursor as jax_merge_cursor,
)
from predictionio_tpu_torch import tenancy
from predictionio_tpu_torch.convert import model_from_jax
from predictionio_tpu_torch.templates.recommendation import (
    ALSAlgorithm,
    ALSAlgorithmParams,
)
from predictionio_tpu_torch.tenancy.online_eval import merge_cursor

SALTS = ("pio-hive", "exp-2026w31", "sél")
WEIGHT_SETS = (
    {"control": 0.5, "treatment": 0.5},
    {"a": 0.7, "b": 0.2, "c": 0.1},
    {"x": 3.0, "y": 0.0, "z": 1.0},
)


def _outcome(fn):
    """``("ok", value)`` or ``(exception type name, message)``."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        return type(e).__name__, str(e)


def test_assignment_is_the_references_for_every_user():
    rng = np.random.default_rng(0)
    users = [f"user-{k}" for k in rng.integers(0, 10**9, 10_000)]
    for salt in SALTS:
        for app in ("shop", "news"):
            got = [tenancy.assign_bucket(salt, app, u) for u in users]
            assert got == [jax_tenancy.assign_bucket(salt, app, u)
                           for u in users]
            assert all(0.0 <= g < 1.0 for g in got)
        for weights in WEIGHT_SETS:
            port = tenancy.Experiment("shop", weights, salt=salt)
            ref = jax_tenancy.Experiment("shop", weights, salt=salt)
            assigned = [port.assign(u) for u in users]
            assert assigned == [ref.assign(u) for u in users]
            # every variant with weight is reached, none without
            assert set(assigned) == {v for v, w in weights.items() if w}


def test_experiment_errors_and_snapshots_equal():
    updates = [
        {"a": 0.4},
        {"nope": 1.0},
        {"a": -1.0},
        {"a": 0.0, "b": 0.0, "c": 0.0},
        {"b": "0.3"},
        {"c": 0.9, "a": 0.05},
    ]
    port = tenancy.Experiment("shop", WEIGHT_SETS[1], salt="t")
    ref = jax_tenancy.Experiment("shop", WEIGHT_SETS[1], salt="t")
    for u in updates:
        assert _outcome(lambda: port.set_weights(u)) == _outcome(
            lambda: ref.set_weights(u))
        assert port.snapshot() == ref.snapshot()
        assert port.variants() == ref.variants()
    for bad in ({}, {"a": -0.5}, {"a": 0.0}, {"a": float("nan")}):
        assert _outcome(lambda: tenancy.Experiment("shop", bad)) == (
            _outcome(lambda: jax_tenancy.Experiment("shop", bad)))


def test_token_bucket_equal_under_an_injected_clock():
    rng = np.random.default_rng(1)
    steps = rng.exponential(0.03, 400)
    costs = rng.choice([1.0, 1.0, 1.0, 2.5], 400)
    rejected = 0
    for rate, burst in ((10.0, 2.0), (0.5, None), (100.0, 25.0)):
        clock = [0.0]
        port = tenancy.TokenBucket(rate, burst, clock=lambda: clock[0])
        ref = jax_tenancy.TokenBucket(rate, burst, clock=lambda: clock[0])
        for dt, n in zip(steps, costs):
            clock[0] += float(dt)
            assert port.try_acquire(n) == ref.try_acquire(n)
        assert port.snapshot() == ref.snapshot()
        assert port.acquired > 0
        rejected += port.rejected
    assert rejected > 0
    for args in ((0.0,), (5.0, 0.5), (-1.0, 2.0)):
        assert _outcome(lambda: tenancy.TokenBucket(*args)) == _outcome(
            lambda: jax_tenancy.TokenBucket(*args))


def test_merge_cursor_equal():
    rng = np.random.default_rng(2)

    def vec():
        keys = rng.choice(6, rng.integers(1, 5), replace=False)
        return json.dumps({str(k): int(rng.integers(0, 100))
                           for k in keys})

    cases = [(None, 7), (5, 3), (3, 5), ("not json", 42), (vec(), 9)]
    cases += [(vec(), vec()) for _ in range(50)]
    for old, new in cases:
        assert merge_cursor(old, new) == jax_merge_cursor(old, new)


def _spec_fields(spec) -> dict:
    return {k: getattr(spec, k) for k in (
        "app", "variant", "engine_json", "engine_name", "instance_id",
        "access_key", "weight", "pinned", "quota_qps", "quota_burst",
        "key", "key_str")}


def test_load_tenant_manifest_equal(tmp_path):
    doc = {
        "memoryBudgetBytes": 2e9,
        "experimentSalt": "exp-7",
        "defaultQuotaQps": 100,
        "evalIntervalSec": 2,
        "autopilot": {"minLift": 0.3, "maxStep": 0.2},
        "tenants": [
            {"app": "shop", "variant": "control",
             "engineJson": "a/engine.json", "weight": 0.7,
             "pinned": True, "engineInstanceId": "abc"},
            {"app": "shop", "variant": "treatment",
             "engineJson": "a/engine.json", "weight": 0.3,
             "quotaQps": 5, "quotaBurst": 9, "accessKey": "K"},
            {"app": "news", "engine": "recommendation"},
        ],
    }
    path = tmp_path / "tenants.json"
    path.write_text(json.dumps(doc))
    specs, opts = tenancy.load_tenant_manifest(path)
    jspecs, jopts = jax_tenancy.load_tenant_manifest(path)
    assert opts == jopts
    assert [_spec_fields(s) for s in specs] == [_spec_fields(s)
                                                for s in jspecs]
    # the default quota fills every spec without one, alike
    port = tenancy.TenantRegistry(specs, **opts)
    ref = jax_tenancy.TenantRegistry(jspecs, **jopts)
    try:
        assert [_spec_fields(s) for s in port.specs()] == [
            _spec_fields(s) for s in ref.specs()]
        assert port.autopilot.config.__dict__ == ref.autopilot.config.__dict__
    finally:
        port.close()
        ref.close()
    for bad in ({"tenants": []}, {"tenants": [{"app": "", "engine": "x"}]},
                {"tenants": [{"app": "a"}]},
                {"tenants": [{"app": "a", "engine": "x", "weight": -1}]}):
        path.write_text(json.dumps(bad))
        got = _outcome(lambda: tenancy.load_tenant_manifest(path))
        want = _outcome(lambda: jax_tenancy.load_tenant_manifest(path))
        assert got[0] == want[0] != "ok" and got[1] == want[1]


def _warm(cls, params_cls, model) -> None:
    algo = cls()
    algo.params = params_cls()
    algo.warmup(model, max_batch=8)


def test_model_resident_bytes_equal():
    rng = np.random.default_rng(3)
    ref = JaxALSModel(
        user_factors=rng.normal(size=(37, 8)).astype(np.float32),
        item_factors=rng.normal(size=(53, 8)).astype(np.float32),
        users=JaxStringIndex([f"u{k}" for k in range(37)]),
        items=JaxStringIndex([f"i{k}" for k in range(53)]),
        item_props={f"i{k}": {"categories": ["c"]} for k in range(5)},
    )
    port = model_from_jax(ref, "cpu")
    cold = tenancy.model_resident_bytes([port])
    assert cold == jax_tenancy.model_resident_bytes([ref]) == 4 * 8 * 90
    _warm(JaxALSAlgorithm, JaxALSAlgorithmParams, ref)
    _warm(ALSAlgorithm, ALSAlgorithmParams, port)
    # the warm-up's device item table and its [R, M] copy count too
    warm = tenancy.model_resident_bytes([port])
    assert warm == jax_tenancy.model_resident_bytes([ref])
    assert warm == cold + 2 * 4 * 8 * 53
    # one model twice is one residency; aliases count once
    assert tenancy.model_resident_bytes([port, port]) == warm
    port.alias = port.user_factors
    assert tenancy.model_resident_bytes([port]) == warm


@pytest.mark.parametrize("specs", [
    [],
    [("a", "v"), ("a", "v")],
])
def test_registry_refuses_what_the_reference_refuses(specs):
    def make(mod):
        return mod.TenantRegistry([mod.TenantSpec(a, v, engine_json="x")
                                   for a, v in specs])

    got, want = _outcome(lambda: make(tenancy)), _outcome(
        lambda: make(jax_tenancy))
    assert got[0] == want[0] == "ValueError" and got[1] == want[1]
