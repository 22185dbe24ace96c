"""Serving top-k: ``predictionio_tpu_torch.ops.topk`` against the JAX
package's ``ops/topk.py`` (``jax.lax.top_k``) on the same inputs.

The tables hold small integers, so every product is exact in f32 and
scores tie often, inside the top k and across its last place; -inf masks
tie too.  Ids must be identical (ties go to the lower index) and scores
equal to 1e-6 of their scale (exact integer sums in both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import topk as jtopk
from predictionio_tpu_torch.ops import topk


def _tables(seed, B, M, R):
    rng = np.random.default_rng(seed)
    table = rng.integers(-2, 3, size=(M, R)).astype(np.float32)
    queries = rng.integers(-1, 2, size=(B, R)).astype(np.float32)
    mask = np.where(rng.random((B, M)) < 0.3, -np.inf, 0.0).astype(np.float32)
    return table, queries, mask


def _same(got, want):
    gv, gi = (t.numpy() for t in got)
    wv, wi = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    assert np.abs(gv[fin] - wv[fin]).max(initial=0.0) <= 1e-6 * max(
        np.abs(wv[fin]).max(initial=0.0), 1.0)


@pytest.mark.parametrize("seed,B,M,R,k", [
    (0, 4, 37, 3, 1), (1, 5, 64, 4, 7), (2, 3, 100, 2, 16), (3, 2, 9, 3, 9),
])
def test_batched_top_k_matches_lax_top_k(seed, B, M, R, k):
    table, queries, mask = _tables(seed, B, M, R)
    tt, tq, tm = (torch.from_numpy(a) for a in (table, queries, mask))
    jt, jq, jm = (jnp.asarray(a) for a in (table, queries, mask))
    _same(topk.batch_topk_scores(tq, tt, k),
          jtopk.batch_topk_scores(jq, jt, k))
    _same(topk.batch_topk_scores(tq, tt, k, mask=tm),
          jtopk.batch_topk_scores(jq, jt, k, mask=jm))
    _same(topk.batch_topk_scores_t(tq, tt.T.contiguous(), k, mask=tm),
          jtopk.batch_topk_scores_t(jq, jt.T, k, mask=jm))


@pytest.mark.parametrize("seed,k", [(4, 1), (5, 5), (6, 30)])
def test_solo_top_k_matches_lax_top_k(seed, k):
    table, queries, mask = _tables(seed, 1, 30, 3)
    tt, tq, tm = torch.from_numpy(table), torch.from_numpy(queries[0]), \
        torch.from_numpy(mask[0])
    jt, jq, jm = jnp.asarray(table), jnp.asarray(queries[0]), \
        jnp.asarray(mask[0])
    _same(topk.topk_scores(tq, tt, k), jtopk.topk_scores(jq, jt, k))
    _same(topk.topk_scores(tq, tt, k, bias=tm),
          jtopk.topk_scores(jq, jt, k, bias=jm))


def test_signed_zeros_negatives_and_inf_order_like_floats():
    s = torch.tensor([0.0, -0.0, -1.0, -np.inf, 2.0, -0.0, -1.5, 1e-30])
    vals, ixs = topk._top_k(s, 8)
    assert ixs.tolist() == [4, 7, 0, 1, 5, 2, 6, 3]
    assert vals.tolist() == s[ixs].tolist()


def test_all_tied_row_keeps_the_first_k():
    vals, ixs = topk._top_k(torch.zeros(2, 10), 4)
    assert ixs.tolist() == [[0, 1, 2, 3]] * 2
    assert vals.tolist() == [[0.0] * 4] * 2
