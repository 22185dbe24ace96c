"""The port's gather probes against the JAX package's, on the CPU.

On a CPU tensor each probe wrapper runs its plain PyTorch version; the
JAX package's Pallas probes run in interpret mode, as they do off the
TPU.  A gather is a copy, so the comparison is bitwise, for f32 and bf16
tables made from the same seeded numpy values.  The arbitration
(``preferred_order``, ``resolve_gather_impl``) returns the static order
on a CPU run, and the planners refuse what the ``cp.async`` forms cannot
copy (a bf16 row of odd R).
"""

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
    # no card here: the default device is the host, as the reference's
    # order off the TPU
    assert gp.preferred_order() == jgp.preferred_order() == ("taa", "dma")
    assert gp._ORDER_CACHE == {}


def test_resolve_gather_impl_walks_the_order_to_a_plan(monkeypatch):
    assert resolve_gather_impl(512, 64) == "taa"
    assert resolve_gather_impl(512, 64, 2, requested="dma") == "dma"
    assert resolve_gather_impl(512, 7, 4, requested="dma") == "dma"
    # an explicit form resolves to itself or to None, never to the other
    assert resolve_gather_impl(512, 7, 2, requested="dma") is None
    assert resolve_gather_impl(512, 7, 2, requested="taa") == "taa"
    assert resolve_gather_impl(512, 200, requested="taa") is None
    assert resolve_gather_impl(512, 200) is None
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
        assert gp.dma_row_plan(r, 2) is None
    assert gp.dma_row_plan(64, 4) == gp.RowPlan(vec=16, smem_bytes=8 * 16 * 256)
    assert gp.dma_row_plan(64, 4, aligned16=False).vec == 4
    assert gp.dma_row_plan(10, 4).vec == 4     # 40-byte rows
    assert gp.dma_row_plan(10, 2).vec == 4     # 20-byte rows
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


def test_probe_records_and_smoke_on_the_cpu():
    recs = gp.smoke(16, device="cpu")
    want = [r["metric"] for r in jgp.smoke(16)]
    assert [r["metric"] for r in recs] == want
    assert all(r.get("ok", True) for r in recs), recs
    assert all(r["device"] == "cpu" and r["seconds"] > 0 for r in recs)
    rec = gp.probe_dma(64, 32, 7, torch.bfloat16, device="cpu")
    assert rec["ok"] is False and "no row-copy plan" in rec["error"]
    assert fused_als.GATHER_IMPLS == ("taa", "dma")
