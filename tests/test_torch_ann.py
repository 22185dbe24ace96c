"""The port's quantized candidate stages, rerank and retriever against
the JAX package's, on the CPU.

The host code (``quantize_rows``, the k-means cluster build and slab
layout, ``nearest_cluster``, ``recall_at_k``) must be the reference's
bit for bit.  The candidate stages must return the reference's ids
apart from exact score ties: both rank with ``lax.top_k``'s order
(lower index first among equal scores), but an f32 score may round the
other way in the other package's product, so an id the two disagree on
must score within 1e-5 (relative) of the shortlist's last kept score in
float64.  Rerank and cosine scores agree within 1e-5; a retriever
patched with the same delta holds the reference's quantized artifacts
bit for bit and answers alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import ann as jax_ann
from predictionio_tpu.ops.topk import (
    cosine_topk as jax_cosine_topk,
    rerank_topk as jax_rerank_topk,
)
from predictionio_tpu.retrieval import (
    RetrievalConfig as JaxRetrievalConfig,
    TwoStageRetriever as JaxRetriever,
)
from predictionio_tpu_torch.ops import ann
from predictionio_tpu_torch.ops.topk import cosine_topk, rerank_topk
from predictionio_tpu_torch.retrieval import (
    RetrievalConfig,
    TwoStageRetriever,
)


def _table(m=600, r=16, seed=0):
    rng = np.random.default_rng(seed)
    # uneven row norms, one all-zero row, and a clustered part
    t = rng.normal(size=(m, r)) * rng.uniform(0.1, 3.0, (m, 1))
    t[m // 2:] += rng.normal(size=(4, r))[rng.integers(0, 4, m - m // 2)]
    t[7] = 0.0
    return t.astype(np.float32)


def _same_apart_from_ties(got, want, scores64):
    """Per query: equal ids, or ids the two disagree on scoring within
    1e-5 (relative) of the last kept score."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for q in range(got.shape[0]):
        if np.array_equal(got[q], want[q]):
            continue
        s = scores64[q]
        edge = min(s[i] for i in want[q] if i >= 0)
        odd = set(got[q].tolist()) ^ set(want[q].tolist())
        for i in odd:
            assert i >= 0 and abs(s[i] - edge) <= 1e-5 * max(
                abs(edge), 1.0), (q, i, s[i], edge)


def test_quantization_and_recall_are_the_references():
    t = _table()
    q, s = ann.quantize_rows(t)
    jq, js = jax_ann.quantize_rows(t)
    assert q.dtype == np.int8 and np.array_equal(q, jq)
    assert np.array_equal(s, js) and s[7] == 1.0
    with pytest.raises(ValueError):
        ann.quantize_rows(t[0])
    rng = np.random.default_rng(1)
    e = np.stack([rng.permutation(50)[:10] for _ in range(20)])
    a = np.stack([rng.permutation(50)[:10] for _ in range(20)])
    assert ann.recall_at_k(e, a) == jax_ann.recall_at_k(e, a)
    assert ann.recall_at_k(e, e) == 1.0


@pytest.mark.parametrize("n_clusters", [16, 40])
def test_cluster_build_is_the_references_bit_for_bit(n_clusters):
    t = _table(seed=2)
    c, a = ann.build_clusters(t, n_clusters, seed=5, sample=400)
    jc, ja = jax_ann.build_clusters(t, n_clusters, seed=5, sample=400)
    assert np.array_equal(c, jc) and np.array_equal(a, ja)
    assert len(c) >= n_clusters  # oversized clusters split
    q, s = ann.quantize_rows(t)
    got = ann.build_cluster_layout(q, s, a, len(c))
    want = jax_ann.build_cluster_layout(q, s, ja, len(jc))
    assert got.keys() == want.keys()
    for k in got:
        assert np.array_equal(got[k], want[k]), k
    new = np.random.default_rng(3).normal(size=(5, 16)).astype(np.float32)
    assert np.array_equal(ann.nearest_cluster(new, c),
                          jax_ann.nearest_cluster(new, jc))


def test_int8_and_ivf_candidates_match_the_references():
    t = _table(seed=4)
    qv = np.random.default_rng(5).normal(size=(9, 16)).astype(np.float32)
    q, s = ann.quantize_rows(t)
    deq64 = q.astype(np.float64) * s[:, None].astype(np.float64)
    scores64 = qv.astype(np.float64) @ deq64.T
    kc = 40
    got = ann.int8_candidate_topk(torch.from_numpy(qv),
                                  torch.from_numpy(np.ascontiguousarray(q.T)),
                                  torch.from_numpy(s), kc)
    want = jax_ann.int8_candidate_topk(
        jnp.asarray(qv), jnp.asarray(np.ascontiguousarray(q.T)),
        jnp.asarray(s), kc)
    assert got.dtype == torch.int32 and got.shape == (9, kc)
    _same_apart_from_ties(got.numpy(), want, scores64)

    c, a = ann.build_clusters(t, 16, seed=0)
    lay = ann.build_cluster_layout(q, s, a, len(c))
    ct = np.ascontiguousarray(c.T)
    for nprobe, kc in ((3, 40), (len(c), 64), (1, 500)):
        got = ann.ivf_candidate_topk(
            torch.from_numpy(qv), torch.from_numpy(ct),
            torch.from_numpy(lay["q_slabs"]),
            torch.from_numpy(lay["slab_scale"]),
            torch.from_numpy(lay["slab_ids"]), nprobe, kc)
        want = np.asarray(jax_ann.ivf_candidate_topk(
            jnp.asarray(qv), jnp.asarray(ct), jnp.asarray(lay["q_slabs"]),
            jnp.asarray(lay["slab_scale"]), jnp.asarray(lay["slab_ids"]),
            nprobe, kc))
        # a shortfall below kc comes back as -1 in both
        assert np.array_equal(got.numpy() < 0, want < 0)
        _same_apart_from_ties(got.numpy(), want, scores64)


def test_rerank_and_cosine_match_the_references():
    rng = np.random.default_rng(6)
    t = _table(seed=6)
    qv = rng.normal(size=(5, 16)).astype(np.float32)
    cand = rng.integers(-1, len(t), (5, 30)).astype(np.int32)
    gv, gi = rerank_topk(torch.from_numpy(qv), torch.from_numpy(t),
                         torch.from_numpy(cand), 8)
    wv, wi = jax_rerank_topk(jnp.asarray(qv), jnp.asarray(t),
                             jnp.asarray(cand), 8)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    cv, ci = cosine_topk(torch.from_numpy(qv[0]), torch.from_numpy(t), 10)
    jv, ji = jax_cosine_topk(jnp.asarray(qv[0]), jnp.asarray(t), 10)
    np.testing.assert_allclose(cv.numpy(), np.asarray(jv), rtol=1e-5,
                               atol=1e-5)
    assert np.array_equal(ci.numpy(), np.asarray(ji))


def _state_equal(port: TwoStageRetriever, ref: JaxRetriever) -> None:
    assert port.n_items == ref.n_items and port.patches == ref.patches
    for k, want in ref._state.items():
        got = port._state[k]
        got = got.cpu().numpy() if torch.is_tensor(got) else got
        assert np.array_equal(got, np.asarray(want)), k


@pytest.mark.parametrize("mode", ["int8", "ivf"])
def test_a_patched_retriever_is_the_references(mode):
    rng = np.random.default_rng(8)
    t = _table(m=300, seed=8)
    kw = dict(mode=mode, candidate_factor=4, nprobe=3, clusters=8)
    port = TwoStageRetriever.build(t, RetrievalConfig(**kw), device="cpu")
    ref = JaxRetriever.build(t, JaxRetrievalConfig(**kw))
    _state_equal(port, ref)
    assert port.summary() == ref.summary()
    rows = rng.normal(size=(3, 16)).astype(np.float32)
    # enough appended rows to grow the IVF slabs' capacity
    app = np.tile(rows[:1], (80, 1)) + rng.normal(
        size=(80, 16)).astype(np.float32) * 0.01
    for ixs, r, a in (([4, 9, 200], rows, None), ([], rows[:0], app),
                      ([1], rows[:1], app[:2])):
        assert port.patch(ixs, r, a) == ref.patch(ixs, r, a)
        _state_equal(port, ref)
    assert port.summary() == ref.summary()
    assert port.patch([], rows[:0]) == {"patched": 0, "appended": 0}
    table = np.concatenate([t, app, app[:2]])
    table[[4, 9, 200]] = rows
    table[1] = rows[0]
    qv = rng.normal(size=(6, 16)).astype(np.float32)
    gv, gi = port.search(torch.from_numpy(qv), 5, torch.from_numpy(table))
    wv, wi = ref.search(jnp.asarray(qv), 5, jnp.asarray(table))
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=1e-5,
                               atol=1e-5)
