"""The port's gather probes against the JAX package's, on the CPU.

On a CPU tensor each probe wrapper runs its plain PyTorch version; the
JAX package's Pallas probes run in interpret mode, as they do off the
TPU.  A gather is a copy, so the comparison is bitwise, for f32 and bf16
tables made from the same seeded numpy values.  The arbitration
(``preferred_order``, ``resolve_gather_impl``) returns the static order
on a CPU run, and the planners refuse what the ``cp.async`` forms cannot
copy (a bf16 row of odd R).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from predictionio_tpu.ops import gather_probe as jgp
from predictionio_tpu_torch.models.als import ALSConfig, _resolve_solver
from predictionio_tpu_torch.ops import fused_als, gather_probe as gp
from predictionio_tpu_torch.ops.fused_als import (
    copy_piece_bytes,
    fused_tile_plan,
    resolve_gather_impl,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tables(rng, shape, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``:
    rounded once, by JAX, then carried over exactly through f32."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(rng.normal(size=shape).astype(np.float32)).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _bitwise(t: torch.Tensor, j) -> None:
    got = t.float().numpy()
    want = np.asarray(j.astype(jnp.float32))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_taa0_matches_jax(dtype):
    rng = np.random.default_rng(1)
    for n, r in ((1, 1), (64, 16), (257, 10), (128, 64)):
        jt, tt = _tables(rng, (n, r), dtype)
        rows = rng.integers(0, n, size=(n,)).astype(np.int32)
        idx = np.broadcast_to(rows[:, None], (n, r)).copy()
        _bitwise(gp.taa0_gather(tt, torch.from_numpy(idx)),
                 jgp.taa0_gather(jt, jnp.asarray(idx)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_taa1_matches_jax(dtype):
    rng = np.random.default_rng(2)
    for r, m in ((1, 1), (16, 64), (10, 257), (64, 128)):
        jt, tt = _tables(rng, (r, m), dtype)
        idx = rng.integers(0, m, size=(r, m)).astype(np.int32)
        _bitwise(gp.taa1_gather(tt, torch.from_numpy(idx)),
                 jgp.taa1_gather(jt, jnp.asarray(idx)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dma_row_gather_matches_jax(dtype):
    rng = np.random.default_rng(3)
    for m, nout, r in ((64, 20, 16), (100, 250, 64), (33, 16, 10),
                       (5, 1, 8)):
        jt, tt = _tables(rng, (m, r), dtype)
        idx = rng.integers(0, m, size=(nout,)).astype(np.int32)
        _bitwise(gp.dma_row_gather(tt, torch.from_numpy(idx), nout=nout),
                 jgp.dma_row_gather(jt, jnp.asarray(idx), nout=nout))
    with pytest.raises(ValueError, match="expected"):
        gp.dma_row_gather(tt, torch.from_numpy(idx), nout=nout + 1)


def test_preferred_order_is_static_on_the_cpu():
    assert gp.preferred_order(64, 4, device="cpu") == ("taa", "dma")
    assert gp.preferred_order(7, 2, device="cpu") == ("taa", "dma")
    # the host asked for by name gives the reference's order off the TPU
    assert gp.preferred_order(device="cpu") == jgp.preferred_order() == (
        "taa", "dma")
    assert gp._ORDER_CACHE == {} and gp.PROBE_NS == {}
    if not torch.cuda.is_available():
        # no default to the host: None names the card, and there is none
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gp.preferred_order()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            gp.probe_taa0(8, 4, torch.float32)


def test_threads_share_one_measured_order(monkeypatch):
    """Trainers built at once in several threads (a parallel evaluation
    sweep) get the order of one measurement: the first caller probes
    while the others wait, where each used to time the probes against
    the others' kernels and cache its own order.  The card is faked:
    each probe call takes a while and ranks the forms the other way
    round from the call before."""
    import threading
    import time
    from concurrent.futures import ThreadPoolExecutor

    calls = {"taa": 0, "dma": 0}
    lock = threading.Lock()

    def fake_probe(form):
        def probe(*args, **kw):
            with lock:
                calls[form] += 1
                n = calls[form]
            time.sleep(0.05)
            fast = (form == "taa") == (n % 2 == 1)
            return {"ok": True, "ns_per_row": 1.0 if fast else 2.0,
                    "metric": form, "dtype": "float32"}
        return probe

    monkeypatch.setattr(gp, "_probe_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "card")
    monkeypatch.setattr(gp, "probe_taa0", fake_probe("taa"))
    monkeypatch.setattr(gp, "probe_dma", fake_probe("dma"))
    monkeypatch.setattr(gp, "_ORDER_CACHE", {})
    monkeypatch.setattr(gp, "PROBE_NS", {})
    start = threading.Barrier(4)

    def resolve(_):
        start.wait()
        return gp.preferred_order(64, 4)

    with ThreadPoolExecutor(max_workers=4) as pool:
        orders = list(pool.map(resolve, range(4)))
    assert orders == [("taa", "dma")] * 4
    assert calls == {"taa": 1, "dma": 1}
    assert gp.PROBE_NS == {("card", 64, 4): {"taa": 1.0, "dma": 2.0}}


def test_resolve_gather_impl_walks_the_order_to_a_plan(monkeypatch):
    assert resolve_gather_impl(512, 64, device="cpu") == "taa"
    assert resolve_gather_impl(512, 64, 2, requested="dma") == "dma"
    assert resolve_gather_impl(512, 7, 4, requested="dma") == "dma"
    # an explicit form resolves to itself or to None, never to the other
    assert resolve_gather_impl(512, 7, 2, requested="dma") is None
    assert resolve_gather_impl(512, 7, 2, requested="taa") == "taa"
    assert resolve_gather_impl(512, 200, requested="taa") is None
    assert resolve_gather_impl(512, 200, device="cpu") is None
    with pytest.raises(ValueError, match="fused_gather"):
        resolve_gather_impl(512, 8, requested="nope")
    # a measured order that puts "dma" first: "auto" takes it where it
    # has a plan, and walks on to "taa" where it has none
    monkeypatch.setattr(gp, "preferred_order",
                        lambda r, tb, device=None: ("dma", "taa"))
    assert resolve_gather_impl(512, 64, 2) == "dma"
    assert resolve_gather_impl(512, 7, 2) == "taa"


def test_dma_planners_refuse_a_bf16_row_of_odd_rank():
    for r in (1, 7, 63, 127):
        assert fused_tile_plan(1000, r, 64, 2, "dma") is None
        assert fused_tile_plan(1000, r, 64, 4, "dma") is not None
        assert fused_tile_plan(1000, r, 64, 2, "taa") is not None
        assert gp.dma_row_plan(r, 2, 2048) is None
    # 2,048 rows of 64 f32: 8 groups of 16 lanes a block, one row a group
    assert gp.dma_row_plan(64, 4, 2048) == gp.RowPlan(
        vec=16, rows_per_group=1, blocks=256, smem_bytes=8 * (256 + 4))
    assert gp.dma_row_plan(64, 4, 2048, aligned16=False).vec == 4
    assert gp.dma_row_plan(10, 4, 2048).vec == 4     # 40-byte rows
    assert gp.dma_row_plan(10, 2, 2048).vec == 4     # 20-byte rows
    assert copy_piece_bytes(torch.zeros((3, 64))) == 16
    with pytest.raises(ValueError, match="even rank"):
        copy_piece_bytes(torch.zeros((3, 7), dtype=torch.bfloat16))
    # the trainer refuses the form it was asked for: no library stand-in
    cfg = ALSConfig(rank=7, solver="fused", fused_gather="dma",
                    gather_dtype="bfloat16")
    with pytest.raises(ValueError, match="no kernel plan"):
        _resolve_solver(cfg, "cpu")
    assert _resolve_solver(ALSConfig(rank=7, solver="fused",
                                     gather_dtype="bfloat16"), "cpu") == (
        "fused", "taa")


CSRC = Path(gp.__file__).with_name("csrc") / "gather_probe.cu"


# (r, elem bytes, nout, 16-byte aligned table, SMs)
PLAN_CASES = (
    (64, 4, 2048, True, 132),      # preferred_order's probe shape
    (64, 2, 2048, True, 132),
    (64, 4, 1 << 20, True, 132),   # bytes dominate: long runs
    (64, 4, 32771, True, 132),     # not a whole number of runs
    (16, 4, 3, True, 132),         # fewer rows than one block takes
    (10, 2, 1234, True, 132),      # 4-byte pieces
    (128, 4, 5000, False, 114),    # unaligned table, a 114-SM card
    (1, 4, 70000, True, 132),      # one piece a row: 128 groups
)


def test_dma_row_plan_accounting():
    """The row-copy plan against the kernel's own accounting, as
    csrc/gather_probe.cu writes it (its constants read from the source):
    groups of a row's pieces in blocks of 128 threads, a ring of
    min(rows_per_group, 16) slots and the block's ids in shared memory,
    a grid that takes every row once and covers every SM once there are
    rows enough, and never more than 16 rows in flight per group."""
    src = CSRC.read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(consts["kWindow"]) == gp._DMA_WINDOW == 16
    assert int(consts["kRowThreads"]) == gp._ROW_THREADS
    assert consts["kMaxRowsPerGroup"] == "2 * kWindow"
    for r, eb, nout, aligned, sms in PLAN_CASES:
        plan = gp.dma_row_plan(r, eb, nout, aligned, sms)
        row_bytes = r * eb
        vec = 16 if row_bytes % 16 == 0 and aligned else 4
        lanes = min(row_bytes // vec, 128)
        groups = 128 // lanes
        rpg = plan.rows_per_group
        window = min(rpg, 16)
        assert plan.vec == vec and 1 <= rpg <= 2 * 16 and window <= 16
        assert plan.smem_bytes == groups * (window * row_bytes + 4 * rpg)
        per_block = groups * rpg
        assert plan.blocks == -(-nout // per_block)
        assert (plan.blocks - 1) * per_block < nout <= plan.blocks * per_block
        if nout >= groups * sms:
            assert plan.blocks >= sms
        if nout >= 32 * groups * sms:
            assert rpg == 32
    # the probe shape fills the card: 256 blocks of one row a group
    probe = gp.dma_row_plan(64, 4, 2048, True, 132)
    assert probe.blocks >= 132 and probe.rows_per_group == 1


def test_probe_records_and_smoke_on_the_cpu():
    recs = gp.smoke(16, device="cpu")
    want = [r["metric"] for r in jgp.smoke(16)]
    assert [r["metric"] for r in recs] == want
    assert all(r.get("ok", True) for r in recs), recs
    assert all(r["device"] == "cpu" and r["seconds"] > 0 for r in recs)
    rec = gp.probe_dma(64, 32, 7, torch.bfloat16, device="cpu")
    assert rec["ok"] is False and "no row-copy plan" in rec["error"]
    assert fused_als.GATHER_IMPLS == ("taa", "dma")
