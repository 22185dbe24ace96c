"""The port's ring top-k against the JAX package's, at the same shard count.

Mirrors ``tests/test_distributed_topk.py``: the reference runs on
``make_mesh(4)`` (four of the suite's eight virtual CPU devices), the
port on four CPU shards (``make_mesh(devices=["cpu"] * 4)``), both from
the same numpy inputs made from a seed.  Values are held to the
reference's within 1e-5 (relative and absolute, the reference test's
tolerance); indices exactly, the inputs having no ties.
"""

import jax
import numpy as np
import pytest
import torch

from predictionio_tpu.ops.distributed_topk import (
    ShardedTopK as JaxShardedTopK,
    ring_topk_scores as jax_ring,
)
from predictionio_tpu.parallel import make_mesh as jax_make_mesh
from predictionio_tpu.parallel.coded import (
    ShardHealth as JaxShardHealth,
    build_parity_fn as jax_parity_fn,
)
from predictionio_tpu.parallel.mesh import data_sharding, replicated
from predictionio_tpu.resilience import faults as jax_faults
from predictionio_tpu_torch.ops.distributed_topk import (
    ShardedTopK,
    _ring_callable,
    ring_topk_scores,
)
from predictionio_tpu_torch.parallel import make_mesh
from predictionio_tpu_torch.parallel.coded import ShardHealth, build_parity_fn
from predictionio_tpu_torch.parallel.mesh import shard_put
from predictionio_tpu_torch.resilience import faults

D = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _disarm():
    faults.disarm()
    jax_faults.disarm()
    yield
    faults.disarm()
    jax_faults.disarm()


@pytest.fixture(scope="module")
def meshes():
    return jax_make_mesh(D), make_mesh(devices=["cpu"] * D)


def _jax_place(mesh, q, v):
    return (jax.device_put(q, replicated(mesh)),
            jax.device_put(v, data_sharding(mesh, 2)))


def _same(got, want):
    gv, gi = (np.asarray(x) for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gv, wv, **TOL)
    np.testing.assert_array_equal(gi, wi)
    assert gi.dtype == np.int32


def _problem(seed, B, M, R):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, R)).astype(np.float32),
            rng.normal(size=(M, R)).astype(np.float32))


def test_matches_the_reference_and_the_dense_topk(meshes):
    jm, tm = meshes
    q, v = _problem(0, 6, 64, 8)
    got = ring_topk_scores(torch.from_numpy(q), shard_put(v, tm), 5, tm)
    _same(got, jax_ring(*_jax_place(jm, q, v), k=5, mesh=jm))
    dense = q @ v.T
    ref_ix = np.argsort(-dense, axis=1)[:, :5]
    np.testing.assert_allclose(got[0].numpy(),
                               np.take_along_axis(dense, ref_ix, 1), **TOL)
    # the whole table in place of its shards gives the same answer
    _same(ring_topk_scores(q, v, 5, tm), got)


def test_k_larger_than_a_shard(meshes):
    """k spanning several shards exercises the running merge."""
    jm, tm = meshes
    q, v = _problem(1, 3, 32, 4)
    got = ring_topk_scores(torch.from_numpy(q), shard_put(v, tm), 12, tm)
    _same(got, jax_ring(*_jax_place(jm, q, v), k=12, mesh=jm))


def test_validation(meshes):
    jm, tm = meshes
    q = np.zeros((2, 4), np.float32)
    for ring, mesh in ((jax_ring, jm), (ring_topk_scores, tm)):
        with pytest.raises(ValueError, match="divisible"):
            ring(q, np.zeros((30, 4), np.float32), 4, mesh)
        with pytest.raises(ValueError, match="k="):
            ring(q, np.zeros((32, 4), np.float32), 64, mesh)
    with pytest.raises(ValueError, match="do not compose"):
        _ring_callable(tm, "data", 4, True, candidate_k=8)


def test_row_bias_excludes_rows(meshes):
    """-inf-biased rows can never win: the padding contract."""
    jm, tm = meshes
    q, v = _problem(3, 4, 32, 6)
    bias = np.zeros(32, np.float32)
    bias[24:] = -np.inf   # the last shard's rows masked out
    got = ring_topk_scores(torch.from_numpy(q), shard_put(v, tm), 6, tm,
                           row_bias=shard_put(bias, tm))
    want = jax_ring(*_jax_place(jm, q, v), k=6, mesh=jm,
                    row_bias=jax.device_put(bias, data_sharding(jm, 1)))
    _same(got, want)
    assert int(got[1].max()) < 24


@pytest.mark.parametrize("dead", [0, 1, 3])
def test_coded_answer_with_a_shard_out(meshes, dead):
    """With one shard's ``ok`` at 0 its block is rebuilt from the
    others and parity inside the ring: the reference's answer, which
    is the clean top-k while parity is current."""
    jm, tm = meshes
    q, v = _problem(4, 3, 8 * D, 5)
    qd, vd = _jax_place(jm, q, v)
    jh = JaxShardHealth(D, op="topk.ring")
    jh.killed.add(dead)
    want = jax_ring(qd, vd, k=6, mesh=jm, parity=jax_parity_fn(jm)(vd),
                    health=jh)
    shards = shard_put(v, tm)
    th = ShardHealth(D, op="topk.ring")
    th.killed.add(dead)
    got = ring_topk_scores(torch.from_numpy(q), shards, 6, tm,
                           parity=build_parity_fn(tm)(shards), health=th)
    _same(got, want)
    assert th.degraded_polls == jh.degraded_polls == 1
    clean = ring_topk_scores(torch.from_numpy(q), shards, 6, tm)
    _same(got, clean)


def test_stale_parity_serves_the_last_published_rows(meshes):
    jm, tm = meshes
    q, v_old = _problem(5, 2, 4 * D, 4)
    v_new = v_old.copy()
    v_new[4:8] += 0.25   # shard 1 moved after parity was built
    jh = JaxShardHealth(D, op="topk.ring")
    jh.killed.add(1)
    qd, vd_new = _jax_place(jm, q, v_new)
    want = jax_ring(qd, vd_new, k=5, mesh=jm,
                    parity=jax_parity_fn(jm)(_jax_place(jm, q, v_old)[1]),
                    health=jh)
    th = ShardHealth(D, op="topk.ring")
    th.killed.add(1)
    got = ring_topk_scores(torch.from_numpy(q), shard_put(v_new, tm), 5, tm,
                           parity=build_parity_fn(tm)(shard_put(v_old, tm)),
                           health=th)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("factor", [4, 1000])
def test_int8_ring_matches_the_reference(meshes, factor):
    """The int8 candidate stage per hop: the reference's ids and values
    at ``candidateFactor`` 4 and at a covering factor (a shortlist of
    the whole shard, the exact answer)."""
    jm, tm = meshes
    rng = np.random.default_rng(6)
    q = rng.normal(size=(5, 8)).astype(np.float32)
    v = (rng.normal(size=(50, 8))
         * rng.uniform(0.2, 3.0, size=(50, 1))).astype(np.float32)
    idx = ShardedTopK(v, tm, retrieval="int8", candidate_factor=factor)
    ref = JaxShardedTopK(v, jm, retrieval="int8", candidate_factor=factor)
    assert idx._candidate_k(3) == ref._candidate_k(3)
    got, want = idx(q, 3), ref(q, 3)
    _same(got, want)
    if factor == 1000:
        dense = q @ v.T
        np.testing.assert_array_equal(got[1].numpy(),
                                      np.argsort(-dense, axis=1)[:, :3])
    assert idx.summary() == ref.summary()


def test_sharded_topk_pads_and_summarises(meshes):
    """An item count that is no multiple of the mesh is padded with
    -inf rows that never win; ``k`` above the count is clipped; the
    summary is the reference's; ``warm`` runs every variant."""
    jm, tm = meshes
    q, v = _problem(7, 3, 21, 4)
    idx, ref = ShardedTopK(v, tm), JaxShardedTopK(v, jm)
    assert len(idx.table) == D and idx.table[0].shape == (6, 4)
    for k in (5, 40):
        got = idx(q, k)
        _same(got, ref(q, k))
        assert int(got[1].max()) < 21 and got[1].shape[1] == min(k, 21)
    idx.warm(4, batch=2)
    s = idx.summary()
    assert s == ref.summary() and (s["items"], s["shards"], s["retrieval"],
                                   s["killed"], s["degradedPolls"]) == (
        21, D, "exact", [], 0)
    with pytest.raises(ValueError, match="retrieval"):
        ShardedTopK(v, tm, retrieval="hnsw")
    one = ShardedTopK(v, make_mesh(devices=["cpu"]))
    assert one.health is None and one.summary() == {
        "items": 21, "shards": 1, "retrieval": "exact"}
    _same(one(q, 5), ref(q, 5))
