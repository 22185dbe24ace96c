"""The port's fused gather+Gram+solve against the JAX package's kernel.

On the CPU ``fused_gather_gram_solve`` runs its plain PyTorch version
(gather, einsum Gram, plain Gauss-Jordan); the JAX package's Pallas
kernel runs in interpret mode, as ``tests/test_fused_als.py`` runs it,
on the cases of that file: a dense check, tile-boundary ids with masked
entries and batch/K tails, both gather forms, a forced streamed plan, a
bf16 table with f32 accumulation, and an implicit-mode ``gram0``.  The
Hopper planner gets a byte-accounting property test of its own.

Tolerances: 1e-5 of the solution's scale against the JAX kernel and a
float64 dense solve (same f32 math, another summation order, well
conditioned systems); 1% for a bf16 table (bf16 operand rounding: the
JAX kernel keeps operands in bf16, the port widens them to f32).
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from predictionio_tpu.ops.fused_als import (
    fused_gather_gram_solve as jax_fused,
)
from predictionio_tpu_torch.ops import fused_als as fmod
from predictionio_tpu_torch.ops.fused_als import (
    GATHER_IMPLS,
    fused_gather_gram_solve,
    fused_gather_gram_solve_reference,
    fused_side_fits,
    fused_tile_plan,
    resolve_gather_impl,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread keeps the parallel suite's
    workers from oversubscribing the host's cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _dense_solve(table, idx, cw, bw, reg, gram0=None):
    """Float64 per-row dense reference for the kernel's math."""
    B, K = idx.shape
    R = table.shape[1]
    t64 = np.asarray(table, np.float64)
    out = np.zeros((B, R))
    for b in range(B):
        A = (np.zeros((R, R)) if gram0 is None
             else np.asarray(gram0, np.float64).copy())
        rhs = np.zeros(R)
        for k in range(K):
            row = t64[idx[b, k]]
            A += float(cw[b, k]) * np.outer(row, row)
            rhs += float(bw[b, k]) * row
        A += float(reg[b]) * np.eye(R)
        out[b] = np.linalg.solve(A, rhs)
    return out


def _parity_case(seed=0, M=300, R=8, B=11, K=24):
    """tests/test_fused_als.py's case: ids on (8,128) tile seams, masked
    entries pointing at row 0 with zero weights, B and K not multiples
    of any tile."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(M, R)).astype(np.float32)
    idx = rng.integers(0, M, size=(B, K)).astype(np.int32)
    boundary = np.array([0, 7, 8, 9, 127, 128, 129, 255, 256, M - 1],
                        np.int32)
    idx[:, : len(boundary)] = boundary[None, :]
    mask = (rng.random((B, K)) < 0.8).astype(np.float32)
    mask[:, -2:] = 0.0
    idx = np.where(mask > 0, idx, 0).astype(np.int32)
    val = (rng.random((B, K)) * 2 + 0.5).astype(np.float32)
    reg = (rng.random(B).astype(np.float32) + 2.0)
    return table, idx, mask, (val * mask).astype(np.float32), reg


def _port(table, idx, cw, bw, reg, gram0=None, **kw):
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    return fused_gather_gram_solve(
        t(table), t(idx), t(cw), t(bw), t(reg), t(gram0), **kw
    ).numpy()


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def test_matches_dense_reference_with_gram0():
    """tests/test_fused_als.py::test_kernel_matches_dense_reference."""
    rng = np.random.default_rng(1)
    M, R, B, K = 200, 12, 9, 21
    table = rng.normal(size=(M, R)).astype(np.float32)
    idx = rng.integers(0, M, size=(B, K)).astype(np.int32)
    mask = (rng.random((B, K)) < 0.7).astype(np.float32)
    val = (rng.random((B, K)) * 4 + 1).astype(np.float32)
    reg = rng.random(B).astype(np.float32) + 0.5
    gram0 = np.eye(R, dtype=np.float32) * 0.25
    x = _port(table, idx, mask, val * mask, reg, gram0)
    _close(x, np.asarray(jax_fused(table, idx, mask, val * mask, reg,
                                   gram0)), 1e-5)
    _close(x, _dense_solve(table, idx, mask, val * mask, reg, gram0), 1e-5)


@pytest.mark.parametrize("impl", GATHER_IMPLS)
def test_matches_jax_both_gather_forms(impl):
    table, idx, cw, bw, reg = _parity_case()
    x = _port(table, idx, cw, bw, reg, gather_impl=impl)
    _close(x, np.asarray(jax_fused(table, idx, cw, bw, reg,
                                   gather_impl=impl)), 1e-5)
    _close(x, _dense_solve(table, idx, cw, bw, reg), 1e-5)


def test_matches_jax_forced_streamed_plan():
    """The JAX kernel's multi-chunk streamed grid (id-range masking) gives
    the same answer the port's one-pass version does."""
    table, idx, cw, bw, reg = _parity_case(seed=3)
    want = np.asarray(jax_fused(table, idx, cw, bw, reg, plan=(8, 128, 64),
                                gather_impl="taa"))
    _close(_port(table, idx, cw, bw, reg), want, 1e-5)


def test_bf16_table_fp32_accum_within_1pct():
    import jax.numpy as jnp

    table, idx, cw, bw, reg = _parity_case(seed=11)
    want = _dense_solve(table, idx, cw, bw, reg)
    t16 = torch.from_numpy(table).to(torch.bfloat16)
    x = fused_gather_gram_solve(
        t16, *(torch.from_numpy(a) for a in (idx, cw, bw, reg))
    ).numpy()
    scale = np.abs(want).max()
    assert np.abs(x - want).max() / scale < 0.01
    jx = np.asarray(jax_fused(jnp.asarray(table).astype(jnp.bfloat16),
                              idx, cw, bw, reg))
    assert np.abs(x - jx).max() / scale < 0.01


def test_implicit_gram0_and_zero_confidence_entries():
    """Implicit weights: cw = alpha*r is 0 where r = 0 while bw = 1, and
    gram0 = YᵀY; tail rows of the batch have every entry masked."""
    rng = np.random.default_rng(5)
    table, idx, mask, _, reg = _parity_case(seed=5, R=6, B=13, K=17)
    mask[-2:] = 0.0
    idx[-2:] = 0
    val = rng.integers(0, 3, size=mask.shape).astype(np.float32)
    cw = (1.5 * val * mask).astype(np.float32)
    bw = ((1.0 + cw) * mask).astype(np.float32)
    gram0 = (table.T @ table).astype(np.float32)
    x = _port(table, idx, cw, bw, reg, gram0)
    _close(x, np.asarray(jax_fused(table, idx, cw, bw, reg, gram0)), 1e-5)
    _close(x, _dense_solve(table, idx, cw, bw, reg, gram0), 1e-5)
    np.testing.assert_array_equal(x[-2:], 0.0)   # b = 0 -> x = 0


def test_cpu_takes_the_plain_version():
    table, idx, cw, bw, reg = _parity_case(seed=7)
    args = [torch.from_numpy(a) for a in (table, idx, cw, bw, reg)]
    assert torch.equal(fused_gather_gram_solve(*args),
                       fused_gather_gram_solve_reference(*args))


def test_argument_validation():
    table, idx, cw, bw, reg = _parity_case(seed=9)
    with pytest.raises(ValueError, match="gather_impl"):
        _port(table, idx, cw, bw, reg, gather_impl="take")
    with pytest.raises(ValueError, match="interpret"):
        _port(table, idx, cw, bw, reg, interpret=True)
    with pytest.raises(ValueError, match="precision"):
        _port(table, idx, cw, bw, reg, precision="tf32")


def test_resolve_gather_impl():
    assert resolve_gather_impl(512, 8, device="cpu") == "taa"
    assert resolve_gather_impl(512, 8, requested="dma") == "dma"
    assert resolve_gather_impl(512, 200, device="cpu") is None
    with pytest.raises(ValueError, match="fused_gather"):
        resolve_gather_impl(512, 8, requested="nope")


def test_plan_at_the_full_width_shapes():
    """Rank 64 plans for the ML-20M item and user tables, any bucket K
    up to the heaviest item's 2^21, f32 or bf16; rank > 128 has none.
    Rank 64 has 24 m16n8 tiles (the Gram's lower triangle and diagonal
    tiles, and the rhs), 3 for each of the 8 warps."""
    for m in (26_744, 138_493):
        for k in (8, 128, 4096, 1 << 21):
            for tb in (2, 4):
                plan = fused_tile_plan(m, 64, k, tb)
                assert plan is not None and plan.tile == 3
    assert fused_tile_plan(1000, 64, 1 << 21).kc == fmod.KC_CHOICES[0]
    assert fused_tile_plan(1000, 64, 5).kc == 8
    assert not fused_side_fits(1000, 129, 64)
    with pytest.raises(ValueError, match="gather_impl"):
        fused_tile_plan(100, 8, 8, gather_impl="nope")


@settings(max_examples=300, deadline=None)
@given(
    r=st.integers(1, 160),
    k=st.integers(1, 1 << 22),
    table_bytes=st.sampled_from([2, 4]),
    impl=st.sampled_from(GATHER_IMPLS),
)
def test_plan_byte_accounting(r, k, table_bytes, impl):
    """Every plan's shared memory is exactly the kernel's buffers: for
    "taa" one [KC, stride] f32 row tile, for "dma" two [KC, stride] tiles
    of raw table rows (f32 rows pad16(R) + 8 words apart, bf16 rows
    pad16(R)/2 + 4), the [R, R+1] f32 system reusing the tiles, and KC
    each of cw, bw, idx (two sets for "dma"), 4 bytes apiece; two blocks
    fit an SM.  The "dma" form's two tiles take no more than the "taa"
    form's one at the same K (but for the smallest chunk).  Tiles per
    warp cover the m16 (m16 + 2) output tiles over 8 warps, and their
    registers fit the per-thread share of two blocks.  The "dma" form
    has no plan for a row that is not whole 4-byte pieces (bf16, odd R).
    Without the bucket's height there is one segment."""
    plan = fused_tile_plan(10_000, r, k, table_bytes, impl)
    if r > 128 or (impl == "dma" and r * table_bytes % 4):
        assert plan is None
        return
    assert plan is not None
    tile, kc, smem, regs, segments, seg_len, ws = plan
    p16 = -(-r // 16) * 16
    stride = {4: 4 * (p16 + 8), 2: 4 * (p16 // 2 + 4)}
    system = 4 * r * (r + 1)
    taa = fused_tile_plan(10_000, r, k, table_bytes, "taa")
    if impl == "dma":
        assert smem == max(2 * kc * stride[table_bytes], system) + 24 * kc
        assert (2 * kc * stride[table_bytes] <= taa.kc * stride[4]
                or kc == fmod.KC_CHOICES[-1])
    else:
        assert smem == max(kc * stride[4], system) + 12 * kc
    assert fmod.BLOCKS_PER_SM * (smem + fmod.SMEM_RESERVED_PER_BLOCK) \
        <= fmod.SMEM_PER_SM
    m16 = p16 // 16
    assert tile in fmod.TPW_CHOICES and tile * 8 >= m16 * (m16 + 2)
    assert all(c * 8 < m16 * (m16 + 2) for c in fmod.TPW_CHOICES if c < tile)
    assert regs == 4 * tile + fmod.REGS_OVERHEAD
    assert regs * fmod.THREADS * fmod.BLOCKS_PER_SM <= 65536
    assert kc in fmod.KC_CHOICES and kc <= max(8, 1 << (k - 1).bit_length())
    assert (segments, ws) == (1, 0) and seg_len % kc == 0 and seg_len >= k
    # the "taa" form takes the largest chunk that fits: the next size up
    # would break a bound
    bigger = [c for c in fmod.KC_CHOICES if c > taa.kc]
    if bigger:
        c = min(bigger)
        assert c > max(8, 1 << (k - 1).bit_length()) or (
            fmod.fused_smem_bytes(r, c, 4, "taa") > fmod.SMEM_BUDGET)
