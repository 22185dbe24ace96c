"""The gather probe CUDA kernels against their plain PyTorch versions, on
the card.

These kernels have no CPU mode, so every test here needs an NVIDIA GPU
and ``nvcc`` (Hopper, ``sm_90a``) and skips without one.  Run them on the
card with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

A gather is a copy, so every comparison is exact (``torch.equal``).
Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops import gather_probe as gp

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _table(rng, n, r, dtype, dev):
    return torch.from_numpy(
        rng.normal(size=(n, r)).astype(np.float32)).to(dev).to(dtype)


DTYPES = (torch.float32, torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
def test_taa0_matches_plain(dev, dtype):
    for n, r in ((1, 1), (256, 16), (2048, 64), (777, 10)):
        rng = np.random.default_rng(n + r)
        table = _table(rng, n, r, dtype, dev)
        rows = rng.integers(0, n, size=(n,)).astype(np.int32)
        idx = torch.from_numpy(
            np.broadcast_to(rows[:, None], (n, r)).copy()).to(dev)
        before = _build.LAUNCHES["taa0_gather"]
        out = gp.taa0_gather(table, idx)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["taa0_gather"] == before + 1
        assert torch.equal(out, gp.taa0_gather(table.cpu(), idx.cpu()).to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
def test_taa1_matches_plain(dev, dtype):
    """Rows of whole 16-byte vectors, rows with a tail (and rows whose
    start is off a vector boundary: M not a multiple of 4 or 8), and a
    table and ids sliced one element off their start (the ids off the
    output's boundaries: one element at a time), bitwise."""
    for r, m in ((16, 256), (64, 3001), (1, 1), (3, 5), (5, 7), (64, 9),
                 (8, 4100), (4, 4104), (2, 40_001)):
        rng = np.random.default_rng(r * m)
        for sliced in (False, True):
            n = r * m + sliced
            table = _table(rng, n, 1, dtype, dev).view(-1)[sliced:].view(r, m)
            idx = torch.from_numpy(rng.integers(0, m, size=n).astype(
                np.int32)).to(dev)[sliced:].view(r, m)
            assert (idx.data_ptr() % 16 != 0) == sliced
            before = _build.LAUNCHES["taa1_gather"]
            out = gp.taa1_gather(table, idx)
            torch.cuda.synchronize()
            assert _build.LAUNCHES["taa1_gather"] == before + 1
            assert torch.equal(
                out, gp.taa1_gather(table.cpu(), idx.cpu()).to(dev))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dma_row_gather_matches_plain(dev, dtype):
    sms = gp.sm_count(dev)
    # rows a group walks where 2^20 rows of 64 f32 make long runs
    runs = gp.dma_row_plan(64, 4, 32771, True, sms).rows_per_group
    assert runs > 1 and 32771 % runs
    for m, nout, r in ((512, 256, 16), (2048, 2048, 64), (1000, 5, 64),
                       (300, 1234, 10), (100, 999, 128), (50, 70, 6),
                       (64, 3, 16),            # below one block's rows
                       (4099, 32771, 64),      # not a whole number of runs
                       (1 << 20, 1 << 20, 64)):
        rng = np.random.default_rng(m + nout + r)
        table = _table(rng, m, r, dtype, dev)
        idx = torch.from_numpy(
            rng.integers(0, m, size=(nout,)).astype(np.int32)).to(dev)
        before = _build.LAUNCHES["dma_row_gather"]
        out = gp.dma_row_gather(table, idx, nout=nout)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["dma_row_gather"] == before + 1
        assert torch.equal(out, table[idx.long()])


def test_row_copy_entry_refuses_a_plan_that_differs(dev):
    """The C entry point recomputes the grid and the shared memory from
    the plan's rows per group and refuses a launch whose numbers differ;
    a refused launch raises and is not counted."""
    table = torch.ones((100, 64), device=dev)
    idx = torch.zeros((2048,), dtype=torch.int32, device=dev)
    out = torch.empty((2048, 64), device=dev)
    plan = gp.dma_row_plan(64, 4, 2048, True, gp.sm_count(dev))
    good = (plan.vec, plan.rows_per_group, plan.blocks, plan.smem_bytes)
    for bad in ((plan.vec, plan.rows_per_group, plan.blocks + 1,
                 plan.smem_bytes),
                (plan.vec, plan.rows_per_group + 1, plan.blocks,
                 plan.smem_bytes),
                (plan.vec, plan.rows_per_group, plan.blocks,
                 plan.smem_bytes + 4),
                (plan.vec, 33, -(-2048 // (8 * 33)), 8 * (16 * 256 + 132))):
        before = _build.LAUNCHES["dma_row_gather"]
        with pytest.raises(RuntimeError, match="launch failed"):
            _build.launch("pio_dma_row_gather", "dma_row_gather", dev,
                          table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                          100, 2048, 64, 4, *bad)
        assert _build.LAUNCHES["dma_row_gather"] == before
    _build.launch("pio_dma_row_gather", "dma_row_gather", dev,
                  table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                  100, 2048, 64, 4, *good)
    torch.cuda.synchronize()
    assert (out == 1).all()


def test_launches_follow_the_current_stream(dev):
    """A kernel runs on PyTorch's current stream: on a side stream that
    first waits behind a long spin, the output is only there once that
    stream is done."""
    rng = np.random.default_rng(9)
    table = _table(rng, 2048, 64, torch.float32, dev)
    rows = torch.from_numpy(
        rng.integers(0, 2048, size=(2048,)).astype(np.int32)).to(dev)
    idx = rows[:, None].expand(2048, 64).contiguous()
    side = torch.cuda.Stream(device=dev)
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1 << 24)
        a = gp.taa0_gather(table, idx)
        b = gp.dma_row_gather(table, rows, nout=2048)
    assert not side.query()            # still spinning: queued behind it
    side.synchronize()
    want = table[rows.long()]
    assert torch.equal(a, want) and torch.equal(b, want)


def test_dma_row_gather_unaligned_table_takes_4_byte_pieces(dev):
    """A table view that starts 4 bytes past an allocation is copied in
    4-byte pieces and still gives the exact rows."""
    rng = np.random.default_rng(1)
    base = _table(rng, 400 * 64 + 1, 1, torch.float32, dev).view(-1)
    table = base[1:].view(400, 64)
    assert table.data_ptr() % 16 != 0 and table.is_contiguous()
    idx = torch.from_numpy(
        rng.integers(0, 400, size=(333,)).astype(np.int32)).to(dev)
    out = gp.dma_row_gather(table, idx, nout=333)
    torch.cuda.synchronize()
    assert torch.equal(out, table[idx.long()])


def test_out_of_range_ids_give_nan(dev):
    table = torch.ones((8, 16), device=dev)
    idx = torch.tensor([0, 8, -1, 3], dtype=torch.int32, device=dev)
    out = gp.dma_row_gather(table, idx, nout=4)
    assert torch.isnan(out[1:3]).all() and (out[[0, 3]] == 1).all()
    idx2 = idx[:, None].expand(4, 16).contiguous()
    out2 = gp.taa0_gather(torch.ones((4, 16), device=dev), idx2)
    assert torch.isnan(out2[1:3]).all() and (out2[[0, 3]] == 1).all()
    # taa1: columns, one a thread (M = 8, 9) and on the vector path
    # (M = 4096)
    for dtype in DTYPES:
        for m in (8, 9, 4096):
            ids = torch.tensor(([0, m, -1, 3] * m)[:m], dtype=torch.int32,
                               device=dev)
            out3 = gp.taa1_gather(torch.ones((3, m), dtype=dtype, device=dev),
                                  ids[None].expand(3, m).contiguous())
            bad = (ids < 0) | (ids >= m)
            assert torch.isnan(out3[:, bad]).all()
            assert (out3[:, ~bad] == 1).all()


def test_bf16_odd_rank_is_refused(dev):
    table = torch.zeros((10, 7), dtype=torch.bfloat16, device=dev)
    idx = torch.zeros((3,), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="no plan"):
        gp.dma_row_gather(table, idx, nout=3)
    rec = gp.probe_dma(64, 32, 7, torch.bfloat16, device=dev)
    assert rec["ok"] is False and "no row-copy plan" in rec["error"]


def test_preferred_order_and_smoke_on_the_card(dev):
    order = gp.preferred_order(64, 4, device=dev)
    assert sorted(order) == ["dma", "taa"]
    assert gp.preferred_order(64, 4, device=dev) is order   # cached
    assert gp.preferred_order(7, 2, device=dev)[-1] == "dma"  # no plan: last
    recs = gp.smoke(16, device=dev)
    assert all(r.get("ok", True) for r in recs), recs
    assert all(r["device"] == "cuda" for r in recs)
