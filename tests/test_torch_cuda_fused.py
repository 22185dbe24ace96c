"""The fused ALS CUDA kernel against its plain PyTorch version, on the card.

These kernels have no CPU mode, so every test here needs an NVIDIA GPU
and ``nvcc`` (Hopper, ``sm_90a``) and skips without one.  Run them on the
card with::

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_*.py

(``--noconftest``: the suite's conftest imports JAX, which the port's
GPU machine need not have.)  Inputs are made with numpy from fixed seeds.

Tolerance: the kernel multiplies on the tensor cores with every operand
split into TF32 high and low parts (about 22 significant bits, f32
sums) and solves by Cholesky, the plain version multiplies in f32 and
solves by Gauss-Jordan: results agree to a few f32 ulps of the Gram
entries, amplified by the systems' conditioning: 1e-4 of the solution's
scale for the well-conditioned systems here, 1e-3 where K runs to 1e5.
A bucket of fewer rows than fill the card splits its long rows across
blocks (pass 1) and sums the partials in a fixed order (pass 2,
``fused_als_reduce``): two calls give the same bits.
"""

import numpy as np
import pytest
import torch

from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.fused_als import (
    fused_gather_gram_solve,
    fused_gather_gram_solve_reference,
    fused_split_reference,
    fused_tile_plan,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _close(got, want, tol):
    got = got.double().cpu()
    want = want.double().cpu()
    err = (got - want).abs().max().item()
    scale = max(want.abs().max().item(), 1.0)
    assert err <= tol * scale, (err, scale)


def _fused_case(rng, M, R, B, K, density=0.8):
    table = rng.normal(size=(M, R)).astype(np.float32)
    idx = rng.integers(0, M, size=(B, K)).astype(np.int32)
    mask = (rng.random((B, K)) < density).astype(np.float32)
    mask[:, -1] = 0.0
    idx = np.where(mask > 0, idx, 0).astype(np.int32)
    val = (rng.random((B, K)) * 4.5 + 0.5).astype(np.float32)
    reg = (0.01 * np.maximum(mask.sum(1), 1.0)).astype(np.float32) + 0.1
    return table, idx, mask, (val * mask).astype(np.float32), reg


@pytest.mark.parametrize("R,B,K", [
    (5, 13, 8), (8, 11, 24), (12, 9, 21), (33, 5, 40), (64, 300, 128),
    (64, 3, 1000), (100, 4, 200), (128, 6, 300),
])
def test_fused_kernel_matches_plain(dev, R, B, K):
    """Both forms, f32 and bf16 tables (the "dma" form only where a bf16
    row is whole 4-byte pieces), ragged K and masked tails, a gram0; each
    launch is counted under its own form's key."""
    rng = np.random.default_rng(R + 7 * K)
    table, idx, cw, bw, reg = _fused_case(rng, 500, R, B, K)
    args = [torch.from_numpy(a).to(dev) for a in (idx, cw, bw, reg)]
    gram0 = torch.from_numpy(
        (np.eye(R) * 0.25).astype(np.float32)).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dev).to(dtype)
        want = fused_gather_gram_solve_reference(t, *args, gram0)
        for impl, key in (("taa", "fused_als"), ("dma", "fused_als_dma")):
            if impl == "dma" and dtype == torch.bfloat16 and R % 2:
                continue
            before = dict(_build.LAUNCHES)
            x = fused_gather_gram_solve(t, *args, gram0, gather_impl=impl)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[key] == before[key] + 1
            assert sum(_build.LAUNCHES.values()) == sum(before.values()) + 1
            _close(x, want, 1e-4)


def test_fused_kernel_long_row(dev):
    """Two rows of 2^17 entries (the heavy-item shape, shortened): the
    planner splits them into segments, so each call is pass 1 and pass 2;
    both forms, f32 and bf16 tables, two calls give the same bits."""
    rng = np.random.default_rng(3)
    K = 1 << 17
    table, idx, cw, bw, reg = _fused_case(rng, 30000, 64, 2, K)
    args = [torch.from_numpy(a).to(dev) for a in (idx, cw, bw, reg)]
    for dtype in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dev).to(dtype)
        want = fused_gather_gram_solve_reference(t, *args)
        for impl, key in (("taa", "fused_als"), ("dma", "fused_als_dma")):
            plan = fused_tile_plan(30000, 64, K, t.element_size(), impl, b=2)
            assert plan.segments > 1 and plan.workspace_bytes > 0
            before = dict(_build.LAUNCHES)
            x = fused_gather_gram_solve(t, *args, gather_impl=impl)
            y = fused_gather_gram_solve(t, *args, gather_impl=impl)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[key] == before[key] + 2
            assert (_build.LAUNCHES["fused_als_reduce"]
                    == before["fused_als_reduce"] + 2)
            assert torch.equal(x, y)
            _close(x, want, 1e-3)


def test_fused_kernel_implicit_weights(dev):
    """Implicit-mode weights: cw = alpha*r can be 0 where bw = 1, with
    gram0 = YᵀY; a short bucket of 4096-slot rows is split, and both
    passes agree with the plain two-pass version too."""
    rng = np.random.default_rng(5)
    for B, K in ((20, 64), (3, 4096)):
        table, idx, mask, _, reg = _fused_case(rng, 400, 16, B, K)
        val = rng.integers(0, 3, size=mask.shape).astype(np.float32)
        cw = (1.5 * val * mask).astype(np.float32)
        bw = ((1.0 + cw) * mask).astype(np.float32)
        t = torch.from_numpy(table).to(dev)
        gram0 = t.T @ t
        args = [torch.from_numpy(a).to(dev) for a in (idx, cw, bw, reg)]
        want = fused_gather_gram_solve_reference(t, *args, gram0)
        for impl in ("taa", "dma"):
            plan = fused_tile_plan(400, 16, K, 4, impl, b=B)
            x = fused_gather_gram_solve(t, *args, gram0, gather_impl=impl)
            torch.cuda.synchronize()
            _close(x, want, 1e-4)
            _close(x, fused_split_reference(t, *args, gram0,
                                            seg_len=plan.seg_len), 1e-4)


def test_fused_kernel_refuses_a_plan_it_disagrees_with(dev):
    """A plan whose bytes differ from the kernel's own is refused: its
    shared memory, its split workspace, or segments that do not tile K;
    and pass 2's: scratch bytes off by 4, groups of no segment, or one
    stage whose group does not hold every segment.  Partials one float
    off their 16-byte start take 4-byte loads and still solve."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_reduce_solve, fused_reduce_solve_reference, reduce_plan,
    )

    rng = np.random.default_rng(9)
    table, idx, cw, bw, reg = _fused_case(rng, 100, 8, 4, 16)
    args = [torch.from_numpy(a).to(dev) for a in (table, idx, cw, bw, reg)]
    plan = fused_tile_plan(100, 8, 16)
    bad = plan._replace(smem_bytes=plan.smem_bytes + 4)
    with pytest.raises(RuntimeError, match="fused_als kernel launch failed"):
        fused_gather_gram_solve(*args, plan=bad)
    table, idx, cw, bw, reg = _fused_case(rng, 100, 8, 4, 4096)
    args = [torch.from_numpy(a).to(dev) for a in (table, idx, cw, bw, reg)]
    plan = fused_tile_plan(100, 8, 4096, b=4)
    assert plan.segments > 1
    for bad in (plan._replace(workspace_bytes=plan.workspace_bytes + 4),
                plan._replace(segments=plan.segments - 1)):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            fused_gather_gram_solve(*args, plan=bad)
    fused_gather_gram_solve(*args, plan=plan)

    rng = np.random.default_rng(21)
    B, S, R = 1, 128, 64
    parts = torch.from_numpy(_partials(rng, B, S, R)).to(dev)
    reg = torch.ones(B, device=dev)
    x = torch.empty((B, R), device=dev)
    plan = reduce_plan(B, S, R, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    assert plan.groups > 1
    scratch = torch.empty(plan.scratch_bytes // 4 + 4, device=dev)

    def call(spg, scratch_bytes, sc=scratch):
        _build.launch(
            "pio_fused_als_reduce", "fused_als_reduce", dev,
            parts.data_ptr(), reg.data_ptr(), 0, x.data_ptr(),
            0 if sc is None else sc.data_ptr(), B, R, S, spg,
            parts.numel() * 4, scratch_bytes)

    call(plan.seg_per_group, plan.scratch_bytes)
    call(S, 0, sc=None)
    for bad in ((plan.seg_per_group, plan.scratch_bytes + 4),
                (0, plan.scratch_bytes),
                (plan.seg_per_group, 0, None),
                (S, plan.scratch_bytes, None)):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            call(*bad)
    base = torch.zeros(parts.numel() + 1, device=dev)
    off = base[1:].view(parts.shape)
    off.copy_(parts)
    _close(fused_reduce_solve(off, reg),
           fused_reduce_solve_reference(parts, reg), 1e-4)


# ---- the "dma" form: rows staged by cp.async into a double-buffered tile
def test_fused_dma_form_long_row_and_poisoned_id(dev):
    """A long row (2^17 entries, many chunks through the double buffer,
    split across blocks), and an id outside the table that poisons only
    its own row, through both passes."""
    rng = np.random.default_rng(4)
    K = 1 << 17
    table, idx, cw, bw, reg = _fused_case(rng, 30000, 64, 2, K)
    args = [torch.from_numpy(a).to(dev) for a in (table, idx, cw, bw, reg)]
    x = fused_gather_gram_solve(*args, gather_impl="dma")
    torch.cuda.synchronize()
    _close(x, fused_gather_gram_solve_reference(*args), 1e-3)
    bad = args[1].clone()
    bad[0, 5] = 30000
    args[2][0, 5] = 1.0
    y = fused_gather_gram_solve(args[0], bad, *args[2:], gather_impl="dma")
    assert torch.isnan(y[0]).all() and torch.isfinite(y[1]).all()


def test_fused_dma_planner_bytes_match_the_launcher(dev):
    """The planner's byte sum is the launcher's for both forms and both
    table widths: its own plan launches, one 4 bytes off is refused, and
    a bf16 table of odd rank has no dma plan."""
    rng = np.random.default_rng(9)
    for R, dtype in ((8, torch.float32), (64, torch.bfloat16),
                     (10, torch.bfloat16), (128, torch.float32)):
        table, idx, cw, bw, reg = _fused_case(rng, 100, R, 4, 40)
        t = torch.from_numpy(table).to(dev).to(dtype)
        args = [torch.from_numpy(a).to(dev) for a in (idx, cw, bw, reg)]
        for impl in ("taa", "dma"):
            plan = fused_tile_plan(100, R, 40, t.element_size(), impl)
            fused_gather_gram_solve(t, *args, plan=plan, gather_impl=impl)
            bad = plan._replace(smem_bytes=plan.smem_bytes + 4)
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                fused_gather_gram_solve(t, *args, plan=bad, gather_impl=impl)
    t7 = torch.zeros((100, 7), dtype=torch.bfloat16, device=dev)
    assert fused_tile_plan(100, 7, 40, 2, "dma") is None
    with pytest.raises(ValueError, match="no 'dma' plan"):
        fused_gather_gram_solve(t7, *args, gather_impl="dma")


# ---- pass 2 alone: fused_als_reduce at the ML-20M trainer's split shapes
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


# (B, S) of the ML-20M trainer's split buckets at WAVES over 132 SMs
# (both halves, both forms; chip_smoke.py's generator) and of phase
# fused's heavy row
ML20M_REDUCE = ((1046, 2), (372, 4), (124, 8), (38, 16), (10, 32),
                (1532, 2), (728, 3), (347, 7), (162, 13), (162, 14),
                (77, 26), (77, 27), (34, 57), (34, 61), (16, 128), (2, 256),
                (1, 2048))


def test_reduce_kernel_matches_plain_at_the_split_shapes(dev):
    """Pass 2 against its plain version at every ML-20M split shape (rank
    64) and at R = 10 (4-byte loads) and 128, B = 1, 2 and 914 (one or
    two stages, as the plan gives), with a gram0 and without (zeros);
    two calls give the same bits, and each call counts one
    fused_als_reduce launch."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_reduce_solve, fused_reduce_solve_reference,
    )

    shapes = [(64, b, s) for b, s in ML20M_REDUCE]
    shapes += [(r, b, s) for r in (10, 128)
               for b, s in ((1, 1024), (2, 512), (914, 2))]
    for R, B, S in shapes:
        rng = np.random.default_rng(B * 1000 + R)
        parts = torch.from_numpy(_partials(rng, B, S, R)).to(dev)
        reg = torch.from_numpy(
            rng.uniform(0.5, 1.5, size=B).astype(np.float32)).to(dev)
        gram0 = torch.eye(R, device=dev) * 0.25
        before = dict(_build.LAUNCHES)
        x = fused_reduce_solve(parts, reg, gram0)
        y = fused_reduce_solve(parts, reg, gram0)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["fused_als_reduce"] == \
            before["fused_als_reduce"] + 2, (R, B, S)
        assert sum(_build.LAUNCHES.values()) == \
            sum(before.values()) + 2, (R, B, S)
        assert torch.equal(x, y), (R, B, S)
        _close(x, fused_reduce_solve_reference(parts, reg, gram0), 1e-4)
        _close(fused_reduce_solve(parts, reg),
               fused_reduce_solve_reference(parts, reg), 1e-4)
