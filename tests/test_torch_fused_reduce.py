"""Pass 2 of a split fused bucket (``fused_als_reduce``), on the CPU.

A bucket of fewer rows than fill the card splits its long rows into S
segments; pass 2 sums each row's S partials, adds ``gram0`` and ``reg
I``, and solves.  On the card it runs in two stages where the rows are
too few to fill it: groups of consecutive segments summed on a grid of
at least 2 x SMs blocks, then the group sums by a block per row.  Here
:func:`reduce_plan` is checked against what the kernel needs (whole
groups, every entry once, the grid, the scratch), a plain mirror of the
kernel's grouped order is held against the plain pass 2's segment
order, and the port's split path against the JAX package's fused solve
at the planner's split.

Tolerances.  Grouped against segment order: each row's sums within
1e-6 relative in the 2-norm, f32 reassociation over at most 1024 terms
(a single entry whose terms cancel can move further); the solutions of
the well-conditioned systems here, 1e-5 of their scale.  Against the JAX
package: 1e-5 of the solution's scale, as ``tests/test_torch_fused_split.py``
states (the same f32 arithmetic in another order).
"""

import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from predictionio_tpu.ops.fused_als import (
    fused_gather_gram_solve as jax_fused,
)
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import fused_als as fmod
from predictionio_tpu_torch.ops.fused_als import (
    fused_partials_reference,
    fused_reduce_solve,
    fused_reduce_solve_reference,
    fused_split_reference,
    fused_tile_plan,
    partial_floats,
    reduce_plan,
)
from predictionio_tpu_torch.ops.solve import spd_solve_reference

# the ML-20M trainer's split buckets (chip_smoke.py's generator, every
# (user, item) pair distinct; its phase breakdown): (B, K, the opposite
# table's rows), the user half's from 2048 slots and the item half's,
# and the heavy row of chip_smoke.py's phase fused
ML20M_SPLIT = (
    [(b, 2048 << j, 26_744) for j, b in enumerate((1046, 372, 124, 38, 10))]
    + [(b, 2048 << j, 138_493) for j, b in enumerate(
        (1532, 728, 347, 162, 77, 34, 16, 2))]
    + [(1, 1 << 21, 138_493)]
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _check_plan(b, s, r, sms, plan, threads=fmod.SUM_THREADS):
    """What csrc/fused_als.cu pio_fused_als_reduce takes of a plan."""
    p = partial_floats(r)
    g, spg = plan.groups, plan.seg_per_group
    # whole groups of consecutive segments, each segment in one group,
    # as many as the kernel counts (ceil(S / seg_per_group))
    groups = [range(k * spg, min(s, (k + 1) * spg)) for k in range(g)]
    assert [x for grp in groups for x in grp] == list(range(s))
    assert all(len(grp) > 0 for grp in groups)
    assert g == -(-s // spg)
    assert plan.vec == (4 if p % 4 == 0 else 1)
    # the first stage's tiles cover every entry of the [B * P] rows once
    width = threads * plan.vec
    assert (plan.tiles - 1) * width < b * p <= plan.tiles * width
    target = 2 * sms
    if b >= target or s <= 2 * fmod.REDUCE_UNROLL:
        # B alone fills the card, or the row's segments are two batches
        # of loads at most: the second stage sums the partials itself
        assert g == 1 and plan.blocks == 0 and plan.scratch_bytes == 0
    else:
        # groups of at least two segments, on at least 2 x SMs blocks
        # where the tiles and such groups allow it
        assert spg >= 2
        assert plan.blocks == plan.tiles * g >= min(
            target, plan.tiles * (s // 2))
        assert plan.scratch_bytes == b * g * p * 4


@pytest.mark.parametrize("r", [10, 64, 128])
def test_reduce_plan_on_the_ml20m_split_buckets(r):
    """Every split ML-20M bucket (the planner's S at 132 SMs): whole
    groups, every entry once, at least 2 x SMs first-stage blocks where
    the rows are few and long, and one stage where they fill the card."""
    for b, k, m in ML20M_SPLIT:
        s = fused_tile_plan(m, 64, k, 4, "taa", b=b).segments
        assert s > 1
        plan = reduce_plan(b, s, r)
        _check_plan(b, s, r, fmod.SMS, plan)
        if b >= 2 * fmod.SMS:
            assert plan.groups == 1
    heavy = reduce_plan(1, 1024, 64)
    assert heavy.groups > 1 and heavy.blocks >= 2 * fmod.SMS
    assert reduce_plan(1046, 2, r).scratch_bytes == 0


@settings(max_examples=300, deadline=None)
@given(
    b=st.integers(1, 600),
    s=st.integers(1, 4096),
    r=st.integers(1, 128),
    sms=st.sampled_from([1, 8, 114, 132]),
    threads=st.sampled_from([32, 64, 128]),
)
def test_reduce_plan_covers_every_segment_and_entry(b, s, r, sms, threads):
    """Any shape, rank, SM count and first-stage block width."""
    _check_plan(b, s, r, sms, reduce_plan(b, s, r, sms, threads), threads)


def test_plan_constants_are_the_kernels():
    """The plan's copies of pass 2's constants are the ones
    csrc/fused_als.cu defines and launches with."""
    src = (_build.CSRC / "fused_als.cu").read_text()
    assert f"constexpr int kSumThreads = {fmod.SUM_THREADS};" in src
    assert f"constexpr int kUnroll = {fmod.REDUCE_UNROLL};" in src
    assert len(re.findall(r"constexpr int (kSumThreads|kUnroll) =", src)) \
        == 2


def _partials(rng, b, s, r, rows=2):
    """[b, s, P] f32 partials as pass 1 writes them: each segment's packed
    lower triangle of ``rows`` random rows' Gram, then their rhs."""
    v = rng.normal(size=(b, s, rows, r)).astype(np.float32) / 4
    w = (rng.integers(1, 11, size=(b, s, rows)) * 0.5).astype(np.float32)
    gram = np.einsum("bskr,bskt->bsrt", v, v)
    ti, tj = np.tril_indices(r)
    rhs = np.einsum("bsk,bskr->bsr", w, v)
    return np.concatenate([gram[:, :, ti, tj], rhs], axis=2).astype(
        np.float32)


def _grouped_sum(partials, plan):
    """The kernel's order in f32: each group's segments in order, then the
    group sums in order (one level where the plan has one group)."""
    b, s, p = partials.shape
    spg = plan.seg_per_group
    groups = []
    for g in range(plan.groups):
        acc = np.zeros((b, p), np.float32)
        for k in range(g * spg, min(s, (g + 1) * spg)):
            acc = acc + partials[:, k]
        groups.append(acc)
    total = np.zeros((b, p), np.float32)
    for acc in groups:
        total = total + acc
    return total


def _solve_total(total, reg, r):
    tri = r * (r + 1) // 2
    ti, tj = torch.tril_indices(r, r)
    t = torch.from_numpy(total)
    A = torch.zeros((t.shape[0], r, r))
    A[:, ti, tj] = t[:, :tri]
    A[:, tj, ti] = t[:, :tri]
    A = A + torch.from_numpy(reg)[:, None, None] * torch.eye(r)
    return spd_solve_reference(A, t[:, tri:].contiguous()).numpy()


def _segment_sum(partials):
    total = partials[:, 0].copy()
    for k in range(1, partials.shape[1]):
        total = total + partials[:, k]
    return total


@pytest.mark.parametrize("r", [10, 64, 128])
def test_grouped_order_matches_the_segment_order(r):
    """The kernel's grouped order against the plain pass 2's segment
    order, on the heavy row's 1024 segments and at two more ML-20M
    splits: each row's sums within 1e-6 relative (2-norm), the solutions
    within 1e-5 of their scale."""
    rng = np.random.default_rng(r)
    for b, s in ((1, 1024), (4, 256), (14, 74)):
        partials = _partials(rng, b, s, r)
        plan = reduce_plan(b, s, r)
        assert plan.groups > 1 or (b, s) != (1, 1024)
        got = _grouped_sum(partials, plan)
        want = _segment_sum(partials)
        diff = got.astype(np.float64) - want
        assert (np.linalg.norm(diff, axis=1)
                <= 1e-6 * np.linalg.norm(want.astype(np.float64), axis=1)
                ).all()
        reg = np.full(b, 1.0, np.float32)
        x = _solve_total(got, reg, r)
        y = fused_reduce_solve_reference(torch.from_numpy(partials),
                                         torch.from_numpy(reg)).numpy()
        assert np.abs(x - y).max() <= 1e-5 * max(np.abs(y).max(), 1.0)


@pytest.mark.parametrize("implicit", [False, True])
def test_split_path_matches_jax_at_the_planners_split(implicit):
    """One row of 32768 slots, rank 8: the planner splits it (at WAVES
    over 132 SMs, into segments of MIN_SEGMENT); the port's split path,
    and the kernel's grouped order on its partials, against the JAX
    package's fused solve on the same inputs."""
    import jax.numpy as jnp

    rng = np.random.default_rng(17 + implicit)
    M, R, B, K = 97, 8, 1, 32768
    table = rng.normal(size=(M, R)).astype(np.float32)
    counts = rng.integers(K // 2, K + 1, size=B)
    valid = np.arange(K)[None, :] < counts[:, None]
    idx = np.where(valid, rng.integers(0, M, size=(B, K)), 0).astype(
        np.int32)
    mask = valid.astype(np.float32)
    if implicit:
        r = rng.integers(0, 3, size=(B, K)).astype(np.float32)
        cw = (1.5 * r * mask).astype(np.float32)
        bw = ((1.0 + cw) * mask).astype(np.float32)
        gram0 = (table.T @ table).astype(np.float32)
    else:
        r = (rng.integers(1, 11, size=(B, K)) * 0.5).astype(np.float32)
        cw, bw, gram0 = mask, (r * mask).astype(np.float32), None
    reg = (0.05 * counts + 0.5).astype(np.float32)
    plan = fused_tile_plan(M, R, K, 4, "taa", b=B)
    assert plan.segments > 1
    t_args = [torch.from_numpy(a) for a in (table, idx, cw, bw, reg)]
    g0 = None if gram0 is None else torch.from_numpy(gram0)
    x = fused_split_reference(*t_args, g0, seg_len=plan.seg_len).numpy()
    want = np.asarray(jax_fused(jnp.asarray(table), idx, cw, bw, reg, gram0))
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(x - want).max() <= 1e-5 * scale
    # the same partials in the kernel's grouped order
    parts = fused_partials_reference(*t_args[:4], plan.seg_len).numpy()
    rp = reduce_plan(B, plan.segments, R)
    assert rp.groups > 1
    total = _grouped_sum(parts, rp)
    if gram0 is not None:
        ti, tj = np.tril_indices(R)
        total[:, :R * (R + 1) // 2] += gram0[ti, tj]
    y = _solve_total(total, reg, R)
    assert np.abs(y - want).max() <= 1e-5 * scale


def test_cpu_wrapper_runs_the_plain_pass_2():
    """On CPU tensors pass 2's wrapper is its plain version, bit for bit,
    one segment or many; another device type raises."""
    rng = np.random.default_rng(2)
    reg = torch.full((3,), 0.5)
    gram0 = torch.eye(12) * 0.25
    for s in (1, 2, 9):
        parts = torch.from_numpy(_partials(rng, 3, s, 12))
        assert torch.equal(fused_reduce_solve(parts, reg, gram0),
                           fused_reduce_solve_reference(parts, reg, gram0))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_reduce_solve(parts.to("meta"), reg.to("meta"))
