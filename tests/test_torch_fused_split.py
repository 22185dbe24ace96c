"""The fused ALS kernel's split of long rows, on the CPU.

A bucket of fewer rows than fill the card runs each row on several
blocks: pass 1 writes each segment's partial Gram and rhs, pass 2 sums a
row's partials in segment order and solves.  Here the planner's split is
checked on the ML-20M bucket shapes and against the kernel's workspace
accounting, and the plain two-pass version (``fused_split_reference``)
is held against the single-pass plain version and against the JAX
package's fused kernel, run in interpret mode as ``tests/test_fused_als.py``
runs it, with a split forced (R = 8, K = 64, segments of 8).

Tolerance: 1e-5 of the solution's scale.  Both sides do the same f32
arithmetic on the same operands, summed in another order (segment
partials, then their sum), on well-conditioned systems.  The weights and
ratings are chosen exact in bf16 (0/1 masks, half stars, implicit
confidences alpha*r with small integer r), so the JAX kernel's bf16
operands carry no rounding a f32 operand does not, and a bf16 table is
held to the same tolerance.
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
    fused_gather_gram_solve,
    fused_gather_gram_solve_reference,
    fused_split_reference,
    fused_tile_plan,
    split_segments,
)

# ML-20M's heavy buckets (bench.py's generator, seed 0): rows per bucket
# for K = 8192, 16384, ... in each half
ML20M_HEAVY = {
    "user": (138_493, 26_744, (180, 77, 32, 14, 5, 3, 1)),
    "item": (26_744, 138_493, (229, 111, 58, 27, 14, 7, 4, 2, 1)),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1.0), err


def _case(seed, M=97, R=8, B=5, K=64, implicit=False):
    """Ids, masked tails (each row's count in [K/4, K]), half-star
    ratings; implicit weights cw = 1.5 r, bw = 1 + cw."""
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(M, R)).astype(np.float32)
    counts = rng.integers(K // 4, K + 1, size=B)
    valid = np.arange(K)[None, :] < counts[:, None]
    idx = np.where(valid, rng.integers(0, M, size=(B, K)), 0).astype(np.int32)
    mask = valid.astype(np.float32)
    if implicit:
        r = rng.integers(0, 3, size=(B, K)).astype(np.float32)
        cw = (1.5 * r * mask).astype(np.float32)
        bw = ((1.0 + cw) * mask).astype(np.float32)
        gram0 = (table.T @ table).astype(np.float32)
    else:
        r = (rng.integers(1, 11, size=(B, K)) * 0.5).astype(np.float32)
        cw, bw, gram0 = mask, (r * mask).astype(np.float32), None
    reg = (0.05 * np.maximum(counts, 1) + 0.5).astype(np.float32)
    return table, idx, cw, bw, reg, gram0


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def test_split_segments_on_the_ml20m_buckets():
    """Every heavy ML-20M bucket fills about WAVES waves over 132 SMs (to
    within the rounding of segments up to whole chunks) or runs out of
    1024-slot segments; K <= 1024 and buckets with the rows already stay
    whole; segments are whole chunks and tile K."""
    for half, (n_rows, m, rows) in ML20M_HEAVY.items():
        for j, b in enumerate(rows):
            k = 8192 << j
            for tb in (2, 4):
                for impl in fmod.GATHER_IMPLS:
                    p = fused_tile_plan(m, 64, k, tb, impl, b=b)
                    s, seg = p.segments, p.seg_len
                    assert seg % p.kc == 0 and (s - 1) * seg < k <= s * seg
                    assert b * s >= 0.9 * fmod.WAVES * fmod.SMS or \
                        s >= k // fmod.MIN_SEGMENT - 1, (half, b, k, s)
                    assert s > 1 and seg >= fmod.MIN_SEGMENT
    heavy = fused_tile_plan(138_493, 64, 1 << 21, 4, "taa", b=1)
    assert (heavy.segments, heavy.seg_len) == (2048, 1024)
    assert fused_tile_plan(26_744, 64, 8192, 4, "taa", b=229).segments == 8
    full = fmod.WAVES * fmod.SMS
    for b, k in ((5000, 8192), (full, 1 << 16), (1, 1024), (3, 512), (9, 8)):
        assert fused_tile_plan(1000, 64, k, 4, "taa", b=b).segments == 1
    assert split_segments(None, 1 << 21, 128) == (1, 1 << 21)
    # the card's SM count and the split target are arguments
    assert split_segments(1, 1 << 21, 128, sms=114, waves=1)[0] == 114
    assert split_segments(300, 1 << 16, 128, sms=132, waves=3)[0] == 2
    assert split_segments(300, 1 << 16, 128, sms=132, waves=2)[0] == 1
    assert split_segments(1, 1 << 21, 128, waves=2) == (261, 8064)
    assert fused_tile_plan(138_493, 64, 1 << 21, 4, "taa", b=1, sms=100,
                           waves=1).segments == 100


@settings(max_examples=200, deadline=None)
@given(
    b=st.integers(0, 600),
    k=st.integers(0, 1 << 22),
    r=st.integers(1, 128),
    table_bytes=st.sampled_from([2, 4]),
    impl=st.sampled_from(fmod.GATHER_IMPLS),
)
def test_split_workspace_bytes_match_the_kernel(b, k, r, table_bytes, impl):
    """The workspace is csrc/fused_als.cu's own sum: B * segments *
    (R(R+1)/2 + R) f32 partials when a row is split, else none; the
    segments tile K in whole chunks, the last one not empty."""
    p = fused_tile_plan(1000, r, k, table_bytes, impl, b=b)
    if p is None:
        assert impl == "dma" and r * table_bytes % 4
        return
    s, seg = p.segments, p.seg_len
    if s > 1:
        assert p.workspace_bytes == b * s * (r * (r + 1) // 2 + r) * 4
        assert 0 < b < fmod.WAVES * fmod.SMS and seg >= fmod.MIN_SEGMENT
        assert (s - 1) * seg < k <= s * seg
    else:
        assert p.workspace_bytes == 0 and seg >= k
    assert seg % p.kc == 0


def test_split_matches_the_single_pass_plain_version():
    """The two-pass plain version, at several segment lengths, gives the
    single pass's answer, and the same bits on every call."""
    for implicit in (False, True):
        table, idx, cw, bw, reg, gram0 = _case(3, M=300, R=12, B=7, K=200,
                                               implicit=implicit)
        args = _torch(table, idx, cw, bw, reg, gram0)
        want = fused_gather_gram_solve_reference(*args).numpy()
        for seg in (8, 24, 64, 199, 200, 256):
            x = fused_split_reference(*args, seg_len=seg)
            _close(x.numpy(), want)
            assert torch.equal(x, fused_split_reference(*args, seg_len=seg))
        _close(fused_split_reference(*args).numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("implicit", [False, True])
def test_split_matches_jax(dtype, implicit):
    """R = 8, K = 64 in segments of 8 against the JAX package's fused
    kernel on the same inputs (f32 or bf16 table, explicit or implicit
    weights, gram0 = YᵀY in implicit mode)."""
    import jax.numpy as jnp

    table, idx, cw, bw, reg, gram0 = _case(11, implicit=implicit)
    t = torch.from_numpy(table).to(getattr(torch, dtype))
    jt = jnp.asarray(table).astype(getattr(jnp, dtype))
    x = fused_split_reference(t, *_torch(idx, cw, bw, reg, gram0),
                              seg_len=8).numpy()
    want = np.asarray(jax_fused(jt, idx, cw, bw, reg, gram0))
    _close(x, want)


def test_the_dma_form_keeps_the_taa_forms_occupancy():
    """The "dma" form's two buffers take no more shared memory than the
    "taa" form's one f32 tile: half the chunk for an f32 table, the same
    chunk for a bf16 table at rank 64; so the blocks are the same size."""
    for r in (8, 16, 33, 64, 100, 128):
        for tb in (2, 4) if r % 2 == 0 else (4,):
            for k in (64, 128, 1 << 21):
                taa = fused_tile_plan(1000, r, k, tb, "taa")
                dma = fused_tile_plan(1000, r, k, tb, "dma")
                assert dma.smem_bytes <= taa.smem_bytes + 12 * taa.kc
                assert 2 * dma.kc * fmod.stride_bytes(r, tb) <= \
                    taa.kc * fmod.stride_bytes(r, 4)
    big = dict(k=1 << 21, m=1000, r=64)
    assert fused_tile_plan(big["m"], 64, big["k"], 4, "dma").kc == 64
    assert fused_tile_plan(big["m"], 64, big["k"], 2, "dma").kc == 128
    assert fused_tile_plan(1000, 64, 128, 4, "dma").smem_bytes == \
        fused_tile_plan(1000, 64, 128, 4, "taa").smem_bytes


def test_cpu_wrapper_runs_the_single_pass_plain_version():
    """On CPU tensors the wrapper takes the plain version whatever the
    plan would split; the split's plain version agrees with it."""
    table, idx, cw, bw, reg, gram0 = _case(5, M=500, R=16, B=2, K=4096,
                                           implicit=True)
    args = _torch(table, idx, cw, bw, reg, gram0)
    plan = fused_tile_plan(500, 16, 4096, 4, "taa", b=2)
    assert plan.segments == 4
    x = fused_gather_gram_solve(*args, gather_impl="dma")
    assert torch.equal(x, fused_gather_gram_solve_reference(*args))
    _close(fused_split_reference(*args, seg_len=plan.seg_len).numpy(),
           x.numpy())
