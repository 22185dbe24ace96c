"""The port's fold-in solver (``live/foldin.py``) against the JAX
package's, on the CPU.

The same seeded factor tables and ratings go through both packages'
``FoldInSolver`` and ``compute_foldin``: the padded (B, K) rungs are
equal, and the solved rows agree within 1e-4 relative for the Cholesky
route (``"xla"``) and the SPD solve kernel's route (``"pallas"``: the
reference runs its Pallas kernel in interpret mode, as its own tests do
on the CPU; the port runs the kernel's plain version on CPU tensors).
``compute_foldin``'s three passes agree on new users, new items and
patched users, including histories that name items the model does not
have yet; the signature count stays put across same-shaped calls.
"""

import numpy as np
import pytest

from predictionio_tpu.live.foldin import (
    FoldInSolver as JaxFoldInSolver,
    compute_foldin as jax_compute_foldin,
)
from predictionio_tpu.live.watermark import ScanBatch as JaxScanBatch
from predictionio_tpu.models.als import ALSConfig as JaxALSConfig
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu_torch.live import (
    FoldInSolver,
    ScanBatch,
    compute_foldin,
)
from predictionio_tpu_torch.live.foldin import TABLE_PAD_ROWS
from predictionio_tpu_torch.models.als import ALSConfig
from predictionio_tpu_torch.storage.bimap import StringIndex

RANK = 8
RTOL = 1e-4


def _solvers(solver: str, max_k: int = 4096, **cfg):
    return (
        FoldInSolver(ALSConfig(rank=RANK, solver=solver, **cfg),
                     max_k=max_k, device="cpu"),
        JaxFoldInSolver(JaxALSConfig(rank=RANK, solver=solver, **cfg),
                        max_k=max_k),
    )


def _rows(rng, n_rows: int, n_opp: int, most: int) -> list:
    """``n_rows`` (opposite ids, values) pairs of 1..most ratings."""
    out = []
    for _ in range(n_rows):
        k = int(rng.integers(1, most + 1))
        ixs = rng.choice(n_opp, size=min(k, n_opp), replace=False)
        out.append((ixs.astype(np.int32),
                    (rng.integers(1, 11, len(ixs)) * 0.5).astype(np.float32)))
    return out


def _close(got: np.ndarray, want: np.ndarray) -> None:
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("n_rows,max_count,min_k", [
    (1, 3, 8), (9, 9, 8), (3, 5000, 8), (130, 1, 16), (8, 64, 4),
])
def test_padded_shape_equals_the_references(n_rows, max_count, min_k):
    port, jax = _solvers("xla", min_bucket_k=min_k)
    assert port.padded_shape(n_rows, max_count) == jax.padded_shape(
        n_rows, max_count)


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_solve_equals_the_references(solver):
    """Explicit ALS-WR rows of 1..40 ratings against a 300-row table
    (padded to a multiple of ``TABLE_PAD_ROWS``), and implicit rows with
    plain lambda."""
    rng = np.random.default_rng(0)
    opp = rng.normal(scale=0.5, size=(300, RANK)).astype(np.float32)
    rows = _rows(rng, 19, len(opp), 40)
    port, jax = _solvers(solver, lam=0.07)
    got = port.solve(opp, rows)
    assert got.shape == (19, RANK) and got.dtype == np.float32
    _close(got, jax.solve(opp, rows))
    port, jax = _solvers(solver, lam=0.1, implicit=True, alpha=2.0,
                         weighted_lambda=False)
    _close(port.solve(opp, rows[:5]), jax.solve(opp, rows[:5]))
    assert TABLE_PAD_ROWS == 1024


def test_long_rows_keep_their_most_recent_ratings():
    rng = np.random.default_rng(1)
    opp = rng.normal(size=(64, RANK)).astype(np.float32)
    rows = [(np.arange(20, dtype=np.int32),
             rng.uniform(1, 5, 20).astype(np.float32))]
    port, jax = _solvers("xla", lam=0.05, max_k=8)
    assert port.padded_shape(1, 20) == (8, 8)
    _close(port.solve(opp, rows), jax.solve(opp, rows))
    _close(port.solve(opp, rows), port.solve(
        opp, [(rows[0][0][-8:], rows[0][1][-8:])]))


def test_fused_routes_to_the_cholesky_solve():
    port, jax = _solvers("fused")
    assert port.solver == jax.solver == "xla"
    assert _solvers("pallas")[0].solver == "pallas"


def _model(rng, n_users: int, n_items: int):
    uf = rng.normal(scale=0.5, size=(n_users, RANK)).astype(np.float32)
    itf = rng.normal(scale=0.5, size=(n_items, RANK)).astype(np.float32)
    uids = [f"u{j}" for j in range(n_users)]
    iids = [f"i{j}" for j in range(n_items)]
    return uf, itf, uids, iids


def _window(rng, uids, iids):
    """A scan window and the touched users' full histories: two new
    users, three existing ones, two new items; one existing user's
    history also names an item that no window rating brings in (it
    must drop out of every pass), one new item is rated by a user the
    model does not know yet."""
    scan_u, scan_i, scan_v = [], [], []
    for u, items in (("nu0", ["i1", "ni0", "i4"]), ("u2", ["ni0", "i7"]),
                     ("u5", ["i3"]), ("nu1", ["ni1", "i0", "i2"]),
                     ("u9", ["ni1", "ni0"])):
        for i in items:
            scan_u.append(u)
            scan_i.append(i)
            scan_v.append(float(rng.integers(1, 11)) * 0.5)
    history = {}
    for u in dict.fromkeys(scan_u):
        old = ([] if u.startswith("nu") else
               list(rng.choice(iids, size=6, replace=False)))
        if u == "u5":
            old.append("ghost")  # no row anywhere
        new = [i for uu, i in zip(scan_u, scan_i) if uu == u]
        ids = list(dict.fromkeys(old + new))
        history[u] = (ids, (rng.integers(1, 11, len(ids)) * 0.5)
                      .astype(np.float32))
    return scan_u, scan_i, np.asarray(scan_v, np.float32), history


@pytest.mark.parametrize("solver", ["xla", "pallas"])
def test_compute_foldin_equals_the_references(solver):
    rng = np.random.default_rng(2)
    uf, itf, uids, iids = _model(rng, 40, 30)
    su, si, sv, history = _window(rng, uids, iids)
    port_solver, jax_solver = _solvers(solver, lam=0.05)
    users, items = StringIndex(uids), StringIndex(iids)
    plan = compute_foldin(
        port_solver, uf, itf, users, items,
        ScanBatch(user_ids=su, item_ids=si, values=sv, n_events=len(su),
                  cursor=0, new_cursor=len(su)), history)
    want = jax_compute_foldin(
        jax_solver, uf, itf, JaxStringIndex(uids), JaxStringIndex(iids),
        JaxScanBatch(user_ids=su, item_ids=si, values=sv,
                     n_events=len(su), cursor=0, new_cursor=len(su)),
        history)
    assert plan.counts() == want.counts() == {
        "patchedUsers": 3, "appendedUsers": 2, "patchedItems": 0,
        "appendedItems": 2}
    assert plan.new_user_ids == want.new_user_ids == ["nu0", "nu1"]
    assert plan.new_item_ids == want.new_item_ids == ["ni0", "ni1"]
    assert (plan.base_n_users, plan.base_n_items) == (40, 30)
    assert plan.user_rows_ix.tolist() == want.user_rows_ix.tolist()
    for f in ("user_rows", "new_user_rows", "new_item_rows"):
        _close(getattr(plan, f), getattr(want, f))
    # the indexes are not mutated (applying the plan owns that)
    assert (len(users), len(items)) == (40, 30)


def test_signature_count_is_stable_across_same_shaped_calls():
    rng = np.random.default_rng(3)
    opp = rng.normal(size=(40, RANK)).astype(np.float32)
    port, _ = _solvers("xla", lam=0.05)
    port.solve(opp, _rows(rng, 5, 40, 7))
    first = port.cache_size()
    for _ in range(3):
        port.solve(opp, _rows(rng, int(rng.integers(1, 8)), 40, 7))
    assert port.cache_size() == first >= 1
    port.solve(opp, _rows(rng, 20, 40, 30))  # another rung, once
    port.solve(opp, _rows(rng, 20, 40, 30))
    assert port.cache_size() == first + 1


def test_the_solver_takes_the_card_unless_asked_for_the_cpu():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FoldInSolver(ALSConfig(rank=RANK))
