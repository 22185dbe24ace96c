#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``predictionio_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version on the card at the shapes
the main path gives it (timing kernel, plain version and a PyTorch
library yardstick that the port never calls), then drives the main path
through the entry points a user calls: ratings shaped like MovieLens-20M
(138,493 users x 26,744 items x 20,000,263 ratings, made with numpy from
a seed) → ``recommendation_engine()`` training at rank 64 with
``solver="fused"`` (2 iterations) and ``solver="pallas"`` (1 iteration)
→ serving solo and batched top-K queries.  Every launch counter is set
to 0 just before that run and read just after it; a kernel the main path
did not launch fails the run.

Prints the card's name and power limit (``nvidia-smi``), one line per
phase, a ``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without that last line; so does a run without a CUDA
device or without the package beside the script.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

N_USERS = 138_493
N_ITEMS = 26_744
N_RATINGS = 20_000_263
RANK = 64


def synth_ml20m(seed: int = 0):
    """MovieLens-20M-shaped ratings: Zipf 0.8 user activity, Zipf 1.0
    item popularity, half-star values 0.5..5 (the repository's
    ``bench.py`` generator at scale 1)."""
    rng = np.random.default_rng(seed)
    w_u = 1.0 / np.arange(1, N_USERS + 1) ** 0.8
    w_u /= w_u.sum()
    u = rng.choice(N_USERS, size=N_RATINGS, p=w_u).astype(np.int32)
    w_i = 1.0 / np.arange(1, N_ITEMS + 1) ** 1.0
    w_i /= w_i.sum()
    i = rng.choice(N_ITEMS, size=N_RATINGS, p=w_i).astype(np.int32)
    v = (rng.integers(1, 11, size=N_RATINGS) * 0.5).astype(np.float32)
    return u, i, v


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events around the whole run, after ``warmup`` calls)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spd_solve_flops(r: int) -> float:
    """Least operations of one SPD solve of rank r, whatever the method:
    a Cholesky factorisation (r^3/3) and two triangular solves (2 r^2).
    The kernels' Gauss-Jordan does about three times the first term; the
    bound counts the function's work, not the kernel's."""
    return r ** 3 / 3 + 2 * r ** 2


def spd_bytes(b: int, r: int) -> int:
    """Least bytes of b SPD solves of rank r in f32: one triangle of each
    A (the function needs no more of a symmetric matrix), b read, x
    written."""
    return b * (r * (r + 1) // 2 + 2 * r) * 4


def max_err(got, want, tol: float, what: str) -> float:
    err = (got.double() - want.double()).abs().max().item()
    scale = max(want.double().abs().max().item(), 1.0)
    if not math.isfinite(err) or err > tol * scale:
        raise AssertionError(
            f"{what}: max |kernel - plain| = {err:.3e} exceeds "
            f"{tol:g} x {scale:.3e}"
        )
    return err


# ---------------------------------------------------------------- phases --

def phase_gj(torch, dev) -> dict:
    """GJ kernel vs its plain version at R in {10, 64, 128} (ragged
    batches included); times at the main path's rank-64 bucket shape.
    Tolerance 1e-4 of the solution's scale: same f32 elimination, other
    rounding (FMA) of the updates."""
    from predictionio_tpu_torch.ops.solve import (
        spd_solve_batched, spd_solve_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1)

    def spd(B, R):
        G = torch.randn((B, R, R), generator=g, device=dev)
        A = torch.bmm(G, G.mT) / R + 0.5 * torch.eye(R, device=dev)
        return A.contiguous(), torch.randn((B, R), generator=g, device=dev)

    errs = []
    for R, B in ((10, 4099), (64, 1031), (128, 4099)):
        A, b = spd(B, R)
        errs.append(max_err(spd_solve_batched(A, b), spd_solve_reference(A, b),
                            1e-4, f"gj R={R} B={B}"))
        log(f"phase gj R={R} B={B}: max_abs_err {errs[-1]:.3e} (tol 1e-4 x scale)")
    # the main path's shape: a full rank-64 bucket of the user half
    R, B = RANK, 65_536
    A, b = spd(B, R)
    errs.append(max_err(spd_solve_batched(A, b), spd_solve_reference(A, b),
                        1e-4, f"gj R={R} B={B}"))
    ms = cuda_ms(lambda: spd_solve_batched(A, b), iters=10)
    plain_ms = cuda_ms(lambda: spd_solve_reference(A, b), iters=2)

    def library():
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(b[..., None], L)

    library_ms = cuda_ms(library, iters=5)
    bound_ms, bound_by = bound(spd_bytes(B, R), B * spd_solve_flops(R))
    log(f"phase gj R={R} B={B}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"library {library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"max_abs_err {errs[-1]:.3e}")
    return dict(
        name="gj_solve", route="cuda",
        source="predictionio_tpu_torch/ops/csrc/gj_solve.cu",
        replaces="predictionio_tpu/ops/solve.py:162",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"A[{B},{R},{R}] f32",
    )


def phase_fused(torch, dev) -> dict:
    """Fused kernel vs its plain version at rank 64: a rank-64 user-half
    bucket [32768, 128] against the item table with a f32 and a bf16
    table (masked tails: counts in [65, 128]), and the heaviest item's
    row [1, 2^21] with 1,860,000 ratings against the user table.
    Tolerance: 1e-4 of the solution's scale, 1e-3 for the long row (the
    same f32 sums in another order; the long row sums 1.86M terms)."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_gather_gram_solve, fused_gather_gram_solve_reference,
    )

    g = torch.Generator(device=dev).manual_seed(2)

    def bucket(B, K, M, lo, hi):
        counts = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
        valid = torch.arange(K, device=dev)[None, :] < counts[:, None]
        idx = torch.randint(0, M, (B, K), generator=g, device=dev)
        idx = torch.where(valid, idx, 0).to(torch.int32)
        val = torch.randint(1, 11, (B, K), generator=g, device=dev) * 0.5
        cw = valid.float()
        bw = (val * cw).float()
        reg = 0.01 * counts.clamp(min=1).float()
        return idx, cw, bw, reg, int(counts.sum().item())

    table = torch.randn((N_ITEMS, RANK), generator=g, device=dev) / 8
    B, K = 32_768, 128
    idx, cw, bw, reg, nnz = bucket(B, K, N_ITEMS, 65, 128)
    err = max_err(fused_gather_gram_solve(table, idx, cw, bw, reg),
                  fused_gather_gram_solve_reference(table, idx, cw, bw, reg),
                  1e-4, f"fused f32 [{B},{K}]")
    t16 = table.to(torch.bfloat16)
    err16 = max_err(fused_gather_gram_solve(t16, idx, cw, bw, reg),
                    fused_gather_gram_solve_reference(t16, idx, cw, bw, reg),
                    1e-4, f"fused bf16 [{B},{K}]")
    log(f"phase fused bf16 table [{B},{K}] R={RANK}: max_abs_err {err16:.3e}")
    ms = cuda_ms(lambda: fused_gather_gram_solve(table, idx, cw, bw, reg),
                 iters=10)
    ms16 = cuda_ms(lambda: fused_gather_gram_solve(t16, idx, cw, bw, reg),
                   iters=10)
    plain_ms = cuda_ms(
        lambda: fused_gather_gram_solve_reference(table, idx, cw, bw, reg),
        iters=2)
    eye = torch.eye(RANK, device=dev)

    def library():
        rows = torch.index_select(table, 0, idx.view(-1)).view(B, K, RANK)
        A = torch.bmm((rows * cw[..., None]).mT, rows) + reg[:, None, None] * eye
        rhs = torch.bmm(bw[:, None, :], rows).mT
        L, _ = torch.linalg.cholesky_ex(A)
        return torch.cholesky_solve(rhs, L)

    library_ms = cuda_ms(library, iters=5)
    # the function's least work on this run's data: idx/cw/bw of the nnz
    # real entries, reg, gram0, the table once and x out; one triangle of
    # each Gram (nnz * R(R+1) flop), the right-hand sides (2 nnz R) and
    # one SPD solve per row
    nbytes = (nnz * 12 + B * 4 + RANK * RANK * 4 + N_ITEMS * RANK * 4
              + B * RANK * 4)
    flops = (nnz * RANK * (RANK + 1) + 2 * nnz * RANK
             + B * spd_solve_flops(RANK))
    bound_ms, bound_by = bound(nbytes, flops)
    log(f"phase fused f32 [{B},{K}] R={RANK}: kernel {ms:.3f} ms "
        f"(bf16 table {ms16:.3f} ms), plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"max_abs_err {err:.3e}")
    del idx, cw, bw, reg, t16

    # the heaviest item of the item half: one block runs the whole row
    users = torch.randn((N_USERS, RANK), generator=g, device=dev) / 8
    Kl = 1 << 21
    idx, cw, bw, reg, _ = bucket(1, Kl, N_USERS, 1_860_000, 1_860_000)
    err_long = max_err(
        fused_gather_gram_solve(users, idx, cw, bw, reg),
        fused_gather_gram_solve_reference(users, idx, cw, bw, reg),
        1e-3, f"fused long row [1,{Kl}]")
    ms_long = cuda_ms(lambda: fused_gather_gram_solve(users, idx, cw, bw, reg),
                      iters=2)
    log(f"phase fused long row [1,{Kl}] (1,860,000 ratings) R={RANK}: kernel "
        f"{ms_long:.3f} ms, max_abs_err {err_long:.3e} (tol 1e-3 x scale)")
    return dict(
        name="fused_als", route="cuda",
        source="predictionio_tpu_torch/ops/csrc/fused_als.cu",
        replaces="predictionio_tpu/ops/fused_als.py:368",
        also_replaces="predictionio_tpu/ops/fused_als.py:500",
        max_abs_err=max(err, err16, err_long), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"table[{N_ITEMS},{RANK}] f32, idx[{B},{K}]",
        bf16_ms=ms16, long_row_ms=ms_long,
    )


def phase_small_reference(torch) -> None:
    """What comes out is right: on a small input, both kernel solvers on
    the card agree with the library (Cholesky) solver on the host, from
    the same start, within 1e-3 of the factors' scale."""
    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer

    rng = np.random.default_rng(7)
    nu, ni = 300, 120
    mask = rng.random((nu, ni)) < 0.2
    u, i = np.nonzero(mask)
    v = (rng.integers(1, 11, size=len(u)) * 0.5).astype(np.float32)
    data = (u.astype(np.int32), i.astype(np.int32), v)
    kw = dict(rank=16, num_iterations=3, lam=0.05)
    ref_tr = ALSTrainer(data, nu, ni, ALSConfig(**kw), device="cpu")
    init = ref_tr.init_factors()
    ref = ref_tr.train(init=init)
    for solver in ("fused", "pallas"):
        got = ALSTrainer(data, nu, ni, ALSConfig(solver=solver, **kw),
                         device="cuda").train(init=init)
        for a, b in ((got.user_factors, ref.user_factors),
                     (got.item_factors, ref.item_factors)):
            err = float(np.abs(a - b).max())
            if not err <= 1e-3 * float(np.abs(b).max()):
                raise AssertionError(f"small {solver} train differs by {err}")
        log(f"phase small reference: solver={solver} on the card matches the "
            f"host Cholesky path (300x120, rank 16, 3 iterations)")


def phase_train(torch, data, solver: str, iterations: int):
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.models.als import ALSFactors, rmse
    from predictionio_tpu_torch.storage import MemoryStore
    from predictionio_tpu_torch.templates.recommendation import (
        recommendation_engine,
    )

    ratings, items, (u, i, v) = data
    engine = recommendation_engine()
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
        "rank": RANK, "numIterations": iterations, "lambda": 0.01,
        "seed": 3, "solver": solver}}]})
    ctx = WorkflowContext(device="cuda", storage=MemoryStore(ratings, items))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    algos, models = engine.train_components(ctx, ep)
    wall = time.perf_counter() - t0
    rep = algos[0].train_report
    model = models[0]
    train_rmse = rmse(ALSFactors(model.user_factors, model.item_factors),
                      u, i, v)
    halves = ", ".join(f"{s} {t * 1e3:.1f} ms" for s, t in rep["half_seconds"])
    log(f"phase train solver={solver}: {iterations} iteration(s), wall "
        f"{wall:.1f} s, buckets {rep['buckets']}, staging ({rep['staging']}) "
        f"{rep['staging_seconds']:.2f} s, halves [{halves}], sweep losses "
        f"{[round(x, 5) for x in rep['sweep_losses']]}, training RMSE "
        f"{train_rmse:.5f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    zero_rmse = float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
    if not (math.isfinite(train_rmse) and train_rmse < zero_rmse):
        raise AssertionError(
            f"training RMSE {train_rmse} does not beat the zero model "
            f"({zero_rmse})")
    if model.user_factors.shape != (N_USERS, RANK) or \
            model.item_factors.shape != (N_ITEMS, RANK):
        raise AssertionError("factor tables have the wrong shape")
    return algos[0], model, rep


def _same_ranking(a, b, tol: float) -> None:
    """Two top-k lists agree: same length, scores within ``tol`` of the
    scale, and equal ids wherever the scores are not tied within tol."""
    if len(a) != len(b):
        raise AssertionError(f"solo and batched lengths differ: {len(a)} {len(b)}")
    scale = max([abs(s.score) for s in a] + [1.0])
    for x, y in zip(a, b):
        if abs(x.score - y.score) > tol * scale:
            raise AssertionError(f"solo/batched scores differ: {x} {y}")
    sa = {s.item: s.score for s in a}
    for y in b:
        if y.item not in sa and not any(
                abs(y.score - s.score) <= tol * scale for s in a):
            raise AssertionError(f"batched item {y.item} missing from solo")


def phase_serve(torch, algo, model) -> dict:
    from predictionio_tpu_torch.templates.recommendation import Query

    t0 = time.perf_counter()
    algo.warmup(model, max_batch=64)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    solo = [Query(user=f"u{k}", num=10) for k in range(6)]
    solo.append(Query(user="u7", num=10, categories=("even",)))
    solo.append(Query(user="nobody", num=10))
    answers, lat = [], []
    for q in solo:
        t0 = time.perf_counter()
        answers.append(algo.predict(model, q))
        lat.append((time.perf_counter() - t0) * 1e3)
    if answers[-1].item_scores:
        raise AssertionError("an unknown user got recommendations")
    for q, a in zip(solo[:-1], answers[:-1]):
        if len(a.item_scores) != 10:
            raise AssertionError(f"{q} got {len(a.item_scores)} items")
    evens = {f"i{j}" for j in range(0, N_ITEMS, 2)}
    if not all(s.item in evens for s in answers[6].item_scores):
        raise AssertionError("the category filter let an odd item through")
    batch = solo + [Query(user=f"u{k}", num=10) for k in range(100, 156)]
    t0 = time.perf_counter()
    got = algo.batch_predict(model, batch)
    batch_ms = (time.perf_counter() - t0) * 1e3
    for a, b in zip(answers, got[:len(solo)]):
        _same_ranking(a.item_scores, b.item_scores, 1e-4)
    log(f"phase serve: warmup {warm_s:.2f} s; solo predict ms "
        f"{[round(x, 3) for x in lat]}; batch_predict of {len(batch)} "
        f"{batch_ms:.3f} ms; solo and batched answers agree")
    return {"solo_ms": lat, "batch_ms": batch_ms}


def phase_topk(torch, dev) -> None:
    """The serving top-k (``torch.topk`` over a key with the exact tie
    order) against a full stable sort, which gives the same order, on
    integer-valued scores with many ties: at the catalogue of the main
    path [64, 26,744] and at [64, 2^20], where a sort's M log M shows.
    The ids and scores must be equal; all three are timed."""
    from predictionio_tpu_torch.ops.topk import _top_k

    g = torch.Generator(device=dev).manual_seed(4)
    for m in (N_ITEMS, 1 << 20):
        s = torch.round(torch.randn((64, m), generator=g, device=dev) * 4)
        want_v, want_i = torch.sort(s, dim=-1, descending=True, stable=True)
        for k in (1, 16, 64):
            vals, ixs = _top_k(s, k)
            if not (torch.equal(ixs, want_i[:, :k])
                    and torch.equal(vals, want_v[:, :k])):
                raise AssertionError(
                    f"top-k order differs from a stable sort, M={m} k={k}")
        del want_v, want_i
        topk_ms = cuda_ms(lambda: _top_k(s, 16), iters=50)
        sort_ms = cuda_ms(
            lambda: torch.sort(s, dim=-1, descending=True, stable=True),
            iters=20)
        bare_ms = cuda_ms(lambda: torch.topk(s, 16, dim=-1), iters=50)
        log(f"phase topk [64,{m}] k=16: top-k with tie order {topk_ms:.4f} "
            f"ms, stable sort {sort_ms:.4f} ms, torch.topk without tie "
            f"order {bare_ms:.4f} ms; same ids on tied scores")
        del s
    torch.cuda.empty_cache()


def phase_breakdown(torch, ratings) -> None:
    """Where one full-width iteration's device time goes, per solver:
    one iteration without the profiler (its fenced halves), then one
    under ``torch.profiler``: device time by kernel (top 6) and the
    device's busy share of that iteration's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer

    for solver in ("fused", "pallas"):
        tr = ALSTrainer(ratings, cfg=ALSConfig(
            rank=RANK, lam=0.01, solver=solver, loss_every=0))
        U, V = tr.init_factors()
        tr.run(U, V, 1)
        plain = ", ".join(f"{s} {t * 1e3:.1f} ms" for s, t in tr.half_seconds)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(U, V, 1)
            wall = time.perf_counter() - t0
        rows = sorted(
            ((e.self_device_time_total, e.key, e.count)
             for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0),
            reverse=True,
        )
        total = sum(t for t, _, _ in rows)
        halves = ", ".join(f"{s} {t * 1e3:.1f} ms" for s, t in tr.half_seconds)
        top = "; ".join(f"{k[:70]} x{c} {t / 1e3:.1f} ms ({t / total:.1%})"
                        for t, k, c in rows[:6]) if total else "none"
        log(f"phase breakdown solver={solver}: unprofiled [{plain}]; "
            f"profiled wall {wall * 1e3:.1f} ms [{halves}], device time {total / 1e3:.1f} ms (busy "
            f"{total / 1e6 / wall:.1%} of wall); top kernels: {top}")
        del tr, U, V
        torch.cuda.empty_cache()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from predictionio_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is not importable ({e}); "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.library()
    build_log = (_build.BUILD_DIR / "build.log").read_text()
    regs = [ln.split(":", 1)[1].strip() for ln in build_log.splitlines()
            if "registers" in ln]
    log(f"phase build: {time.perf_counter() - t0:.1f} s; ptxas: {regs}")

    kernels = [phase_gj(torch, dev)]
    torch.cuda.empty_cache()
    kernels.append(phase_fused(torch, dev))
    torch.cuda.empty_cache()
    phase_small_reference(torch)
    phase_topk(torch, dev)

    t0 = time.perf_counter()
    u, i, v = synth_ml20m(seed=0)
    from predictionio_tpu_torch.storage import Ratings, StringIndex

    ratings = Ratings(
        user_ix=u, item_ix=i, rating=v,
        users=StringIndex([f"u{k}" for k in range(N_USERS)]),
        items=StringIndex([f"i{k}" for k in range(N_ITEMS)]),
    )
    items = {f"i{j}": {"categories": ["even" if j % 2 == 0 else "odd"]}
             for j in range(N_ITEMS)}
    log(f"phase data: {len(v):,} ratings, {N_USERS:,} users, "
        f"{N_ITEMS:,} items in {time.perf_counter() - t0:.1f} s")
    data = (ratings, items, (u, i, v))

    # the main path: counts from 0 just before, read just after
    _build.reset_launches()
    algo, model, _ = phase_train(torch, data, "fused", 2)
    del model
    torch.cuda.empty_cache()
    algo, model, _ = phase_train(torch, data, "pallas", 1)
    phase_serve(torch, algo, model)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    log(f"phase main path launches: {launches}")
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"the main path never launched {k['name']}")

    phase_breakdown(torch, ratings)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
