"""The yardstick on the host at small sizes: the work and peaks of the
rooflines, the generator, the plain reference, the comparison and the
trace reading."""

import numpy as np
import pytest
import torch

from benchmark import compare, reference, tracing
from benchmark.generator import synth_ratings
from benchmark.metrics import _roofline


def test_half_work_by_hand():
    # 10 ratings over 3 rows at rank 4 against a 5-row table:
    # Gram triangles 10 * 4 * 5 = 200, rhs 2 * 10 * 4 = 80; one solve a
    # row 64/3 + 32; bytes 10 * 8 + 5 * 4 * 4 + 3 * 4 * 4
    w = _roofline.half_work(nnz=10, rows=3, m=5, rank=4)
    assert w["product_flops"] == 280
    assert w["solve_flops"] == pytest.approx(3 * (64 / 3 + 32))
    assert w["bytes"] == 80 + 80 + 48


def test_iteration_work_sums_both_halves():
    shape = {"nnz": 10, "rank": 4, "n_users": 6, "n_items": 5,
             "active_users": 3, "active_items": 4}
    w = _roofline.iteration_work(shape)
    user = _roofline.half_work(10, 3, 5, 4)
    item = _roofline.half_work(10, 4, 6, 4)
    assert w == {k: user[k] + item[k] for k in user}


def test_least_seconds_takes_the_larger_bound():
    ops_bound = {"product_flops": 165e12, "solve_flops": 67e12,
                 "bytes": 1.0}
    # one second of products at 495/3 TFLOP/s, one of solves at 67
    assert _roofline.ops_seconds(ops_bound, "highest") == pytest.approx(2)
    assert _roofline.least_seconds(ops_bound, "highest") == pytest.approx(2)
    # TF32 allowed: the products run at the full 495 TFLOP/s
    assert _roofline.ops_seconds(ops_bound, "high") == pytest.approx(
        1 + 165 / 495)
    bytes_bound = {"product_flops": 0, "solve_flops": 0, "bytes": 6.7e12}
    assert _roofline.least_seconds(bytes_bound, "highest") == pytest.approx(
        2)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 40 + 3])
def test_generator_distinct_pairs_and_seeded(seed):
    u, i, v = synth_ratings(300, 40, 6000, seed, "cpu")
    assert u.dtype == torch.int32 and i.dtype == torch.int32
    assert v.dtype == torch.float32
    assert int(u.min()) >= 0 and int(u.max()) < 300
    assert int(i.min()) >= 0 and int(i.max()) < 40
    keys = u.long() * 40 + i
    assert torch.unique(keys).numel() == 6000
    assert set((v * 2).long().unique().tolist()) <= set(range(1, 11))
    again = synth_ratings(300, 40, 6000, seed, "cpu")
    for a, b in zip((u, i, v), again):
        assert torch.equal(a, b)
    other = synth_ratings(300, 40, 6000, seed + 1, "cpu")
    assert not torch.equal(u, other[0])


def test_generator_fills_the_heaviest_rows():
    # 40 items, Zipf 1.0: the first item's share of 6000 draws is far
    # above the 300 users that can rate it, so its row fills
    u, i, _ = synth_ratings(300, 40, 6000, 5, "cpu")
    per_item = torch.bincount(i, minlength=40)
    assert int(per_item[0]) == 300
    per_user = torch.bincount(u, minlength=300)
    assert int(per_user[0]) > int(per_user[-1])


def test_generator_refuses_too_many_pairs():
    with pytest.raises(ValueError):
        synth_ratings(3, 3, 10, 0, "cpu")


def _numpy_half(upd, opp, rows, cols, vals, lam):
    """One ALS-WR half in float64 NumPy, row by row."""
    out = upd.copy()
    r = opp.shape[1]
    for row in np.unique(rows):
        sel = rows == row
        x = opp[cols[sel]]
        a = x.T @ x + lam * sel.sum() * np.eye(r)
        out[row] = np.linalg.solve(a, x.T @ vals[sel])
    return out


def test_reference_against_numpy_halves():
    u, i, v = synth_ratings(50, 30, 400, 9, "cpu")
    gen = torch.Generator().manual_seed(1)
    U0 = torch.randn(50, 6, generator=gen)
    V0 = torch.randn(30, 6, generator=gen)
    U, V = reference.als_reference(u, i, v, 50, 30, U0, V0, 0.05, 2)
    un, vn, rn = u.numpy(), i.numpy(), v.numpy().astype(np.float64)
    Un, Vn = U0.double().numpy(), V0.double().numpy()
    for _ in range(2):
        Un = _numpy_half(Un, Vn, un, vn, rn, 0.05)
        Vn = _numpy_half(Vn, Un, vn, un, rn, 0.05)
    np.testing.assert_allclose(U.numpy(), Un, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(V.numpy(), Vn, rtol=1e-9, atol=1e-12)


def test_reference_blocks_cover_every_row_once(monkeypatch):
    monkeypatch.setattr(reference, "BLOCK_BYTES", 4096)
    u, i, v = synth_ratings(200, 20, 1500, 3, "cpu")
    g = reference.group_rows(u, i, v, 200, 4, 8)
    seen = []
    for first, end, longest in g.blocks:
        lengths = g.counts[g.order[first:end]]
        assert int(lengths[0]) == longest
        # each block's rows are longer than half its longest
        assert bool((lengths * 2 > longest).all())
        seen += g.order[first:end].tolist()
    assert sorted(seen) == torch.nonzero(g.counts).flatten().tolist()


def test_readings_zero_when_equal_and_one_row_shows():
    gen = torch.Generator().manual_seed(2)
    ru = torch.randn(1000, 8, generator=gen, dtype=torch.float64)
    rv = torch.randn(50, 8, generator=gen, dtype=torch.float64)
    same = compare.readings(ru.float().numpy(), rv.float().numpy(), ru, rv)
    assert same["factor_err"] < 1e-7 and same["row_err"] < 1e-6
    bad = ru.clone()
    bad[7] += 1.0
    got = compare.readings(bad, rv, ru, rv)
    assert got["row_err"] > 0.3
    assert got["factor_err"] < got["row_err"] / 10


def test_judge_counts_failures_and_nan():
    limits = {"factor_err": 1e-3, "row_err": 1e-2}
    rows = [{"factor_err": 1e-4, "row_err": 1e-3},
            {"factor_err": float("nan"), "row_err": 1e-3},
            {"factor_err": 1e-4, "row_err": 0.5}]
    v = compare.judge(rows, limits)
    assert (v["attempted"], v["failed"], v["correct"]) == (3, 2, False)
    assert v["checks"]["row_err"] == {"value": 0.5, "limit": 1e-2}
    assert compare.judge(rows[:1], limits)["correct"] is True
    assert compare.judge([], limits)["correct"] is False


class _Event:
    def __init__(self, name, start, end, kind, cuda=False):
        self._n, self._s, self._e, self._k, self._c = (
            name, start, end, kind, cuda)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def activity_type(self):
        return self._k

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._c
                else torch.autograd.DeviceType.CPU)


def test_trace_summary_by_hand():
    ev = [
        _Event("bench.stretch", 0, 1000, "user_annotation"),
        _Event("bench.train", 0, 1000, "user_annotation"),
        _Event("bench.half", 100, 500, "user_annotation"),
        _Event("aten::item", 700, 900, "cpu_op"),
        _Event("k1", 150, 300, "kernel", cuda=True),
        _Event("k2", 250, 400, "kernel", cuda=True),   # overlaps k1
        _Event("k1", 600, 650, "kernel", cuda=True),
        _Event("bench.half", 0, 0, "gpu_user_annotation", cuda=True),
    ]
    s = tracing.summarize(ev)
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(300e-9)         # 150..400, 600..650
    assert s.half_device_s == pytest.approx(250e-9)  # inside 100..500
    assert s.device_ops == [["k1", 200e-9], ["k2", 150e-9]]
    gaps = dict(s.idle_gaps)
    # gaps 0..150, 400..600 and 650..1000, named at their middles
    assert gaps["bench.train: python"] == pytest.approx(150e-9)
    assert gaps["bench.half: python"] == pytest.approx(200e-9)
    assert gaps["bench.train: aten::item"] == pytest.approx(350e-9)
    assert sum(gaps.values()) == pytest.approx(700e-9)


def test_short_device_names():
    assert tracing.short_name(
        "void (anonymous namespace)::fused_als_kernel<float, 3>(float "
        "const*, int const*, float*, int, int)") == (
        "(anonymous namespace)::fused_als_kernel<float, 3>")
    assert tracing.short_name("Memcpy DtoH (Device -> Pageable)") == (
        "Memcpy DtoH")
    assert tracing.short_name("sm80_xmma_gemm_f32f32_nt_n") == (
        "sm80_xmma_gemm_f32f32_nt_n")
    assert len(tracing.short_name("k<" + "x" * 500 + ">()")) == 120
