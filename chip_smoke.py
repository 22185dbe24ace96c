#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``predictionio_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version on the card at the shapes
the main paths give it (timing kernel, plain version and a PyTorch
library yardstick that the port never calls): the GJ solve, both forms
of the fused ALS kernel ("taa" and "dma") and the three gather probes.
Then it drives three main paths through the entry points a user calls,
each with every launch counter set to 0 just before it and read just
after it; a kernel its path did not launch fails the run:

* ML-20M: ratings shaped like MovieLens-20M (138,493 users x 26,744
  items x 20,000,263 ratings, made with numpy from a seed) → the
  recommendation engine training at rank 64 with ``solver="fused"``
  (2 iterations) and ``solver="pallas"`` (1 iteration) → serving solo
  and batched top-K queries;
* pio: MovieLens-1M-shaped events (6,040 x 3,706 x 1,000,209) into the
  SQLite event store of a fresh ``$PIO_TPU_HOME`` → ``run_train``
  (``fused_gather="auto"``, which ranks the fused kernel's forms with
  the gather probe kernels) → ``EngineServer`` answering solo and
  concurrent ``POST /queries.json`` like an in-process ``predict``;
* probe smoke: ``gather_probe.smoke``, the probe module's own entry
  point.

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

# MovieLens-1M's published counts: the event-store path's data scale
ML1M_USERS = 6_040
ML1M_ITEMS = 3_706
ML1M_RATINGS = 1_000_209

# the gather probes: preferred_order's shape and a shape bytes dominate
PROBE_N = 2048
BIG_N = 1 << 20


def synth_ratings(n_users: int, n_items: int, n_ratings: int, seed: int = 0):
    """MovieLens-shaped ratings: Zipf 0.8 user activity, Zipf 1.0 item
    popularity, half-star values 0.5..5 (the repository's ``bench.py``
    generator)."""
    rng = np.random.default_rng(seed)
    w_u = 1.0 / np.arange(1, n_users + 1) ** 0.8
    w_u /= w_u.sum()
    u = rng.choice(n_users, size=n_ratings, p=w_u).astype(np.int32)
    w_i = 1.0 / np.arange(1, n_items + 1) ** 1.0
    w_i /= w_i.sum()
    i = rng.choice(n_items, size=n_ratings, p=w_i).astype(np.int32)
    v = (rng.integers(1, 11, size=n_ratings) * 0.5).astype(np.float32)
    return u, i, v


def synth_ml20m(seed: int = 0):
    """The ``bench.py`` generator at MovieLens-20M's counts."""
    return synth_ratings(N_USERS, N_ITEMS, N_RATINGS, seed)


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


def fused_cases(torch, dev):
    """The fused phases' inputs, made on the card from generator seed 2:
    the item table [26,744, 64] and a rank-64 user-half bucket [32768,
    128] against it (masked tails: counts in [65, 128]); the user table
    [138,493, 64] and the heaviest item's row [1, 2^21] with 1,860,000
    ratings against it.  Each bucket is (idx, cw, bw, reg, nnz)."""
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
    short = bucket(32_768, 128, N_ITEMS, 65, 128)
    users = torch.randn((N_USERS, RANK), generator=g, device=dev) / 8
    long = bucket(1, 1 << 21, N_USERS, 1_860_000, 1_860_000)
    return table, short, users, long


def fused_bound(B: int, nnz: int) -> tuple[float, str]:
    """The fused function's least work on a [B, *] bucket of nnz real
    entries against the item table: idx/cw/bw of the real entries, reg,
    gram0, the table once and x out; one triangle of each Gram (nnz *
    R(R+1) flop), the right-hand sides (2 nnz R) and one SPD solve per
    row."""
    nbytes = (nnz * 12 + B * 4 + RANK * RANK * 4 + N_ITEMS * RANK * 4
              + B * RANK * 4)
    flops = (nnz * RANK * (RANK + 1) + 2 * nnz * RANK
             + B * spd_solve_flops(RANK))
    return bound(nbytes, flops)


def fused_library(torch, table, idx, cw, bw, reg):
    """One PyTorch computation of the fused function (gather, batched
    Gram, Cholesky): the yardstick, never called by the port."""
    B, K = idx.shape
    eye = torch.eye(RANK, device=table.device)
    rows = torch.index_select(table, 0, idx.view(-1)).view(B, K, RANK)
    A = torch.bmm((rows * cw[..., None]).mT, rows) + reg[:, None, None] * eye
    rhs = torch.bmm(bw[:, None, :], rows).mT
    L, _ = torch.linalg.cholesky_ex(A)
    return torch.cholesky_solve(rhs, L)


def phase_fused(torch, dev) -> dict:
    """Fused kernel ("taa" form) vs its plain version at rank 64 on
    :func:`fused_cases`' bucket with a f32 and a bf16 table, and on the
    heaviest item's row.  Tolerance: 1e-4 of the solution's scale, 1e-3
    for the long row (the same f32 sums in another order; the long row
    sums 1.86M terms)."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_gather_gram_solve, fused_gather_gram_solve_reference,
    )

    table, (idx, cw, bw, reg, nnz), users, long = fused_cases(torch, dev)
    B, K = idx.shape
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
    library_ms = cuda_ms(lambda: fused_library(torch, table, idx, cw, bw, reg),
                         iters=5)
    bound_ms, bound_by = fused_bound(B, nnz)
    log(f"phase fused f32 [{B},{K}] R={RANK}: kernel {ms:.3f} ms "
        f"(bf16 table {ms16:.3f} ms), plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"max_abs_err {err:.3e}")
    del idx, cw, bw, reg, t16

    # the heaviest item of the item half: one block runs the whole row
    idx, cw, bw, reg, _ = long
    Kl = idx.shape[1]
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
        max_abs_err=max(err, err16, err_long), ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"table[{N_ITEMS},{RANK}] f32, idx[{B},{K}]",
        bf16_ms=ms16, long_row_ms=ms_long,
    )


def phase_fused_dma(torch, dev) -> dict:
    """The fused kernel's "dma" form (rows staged by cp.async into a
    double-buffered tile) vs the plain version on the same inputs and
    tolerances as phase fused; both forms timed side by side, in turns
    (taa, dma, dma, taa)."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_gather_gram_solve, fused_gather_gram_solve_reference,
    )

    table, (idx, cw, bw, reg, nnz), users, long = fused_cases(torch, dev)
    B, K = idx.shape
    t16 = table.to(torch.bfloat16)
    errs = []
    for t, what in ((table, "f32"), (t16, "bf16")):
        errs.append(max_err(
            fused_gather_gram_solve(t, idx, cw, bw, reg, gather_impl="dma"),
            fused_gather_gram_solve_reference(t, idx, cw, bw, reg),
            1e-4, f"fused dma {what} [{B},{K}]"))

    def turns(t, iters):
        times = {"taa": [], "dma": []}
        for impl in ("taa", "dma", "dma", "taa"):
            times[impl].append(cuda_ms(
                lambda: fused_gather_gram_solve(*t, gather_impl=impl), iters))
        return {k: sum(v) / len(v) for k, v in times.items()}

    ms = turns((table, idx, cw, bw, reg), 5)
    ms16 = turns((t16, idx, cw, bw, reg), 5)
    plain_ms = cuda_ms(
        lambda: fused_gather_gram_solve_reference(table, idx, cw, bw, reg),
        iters=2)
    library_ms = cuda_ms(lambda: fused_library(torch, table, idx, cw, bw, reg),
                         iters=5)
    bound_ms, bound_by = fused_bound(B, nnz)
    log(f"phase fused dma [{B},{K}] R={RANK}: f32 table dma {ms['dma']:.3f} "
        f"ms vs taa {ms['taa']:.3f} ms; bf16 table dma {ms16['dma']:.3f} ms "
        f"vs taa {ms16['taa']:.3f} ms; plain {plain_ms:.3f} ms, library "
        f"{library_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}), "
        f"max_abs_err f32 {errs[0]:.3e} bf16 {errs[1]:.3e}")
    del idx, cw, bw, reg, t16

    idx, cw, bw, reg, _ = long
    Kl = idx.shape[1]
    err_long = max_err(
        fused_gather_gram_solve(users, idx, cw, bw, reg, gather_impl="dma"),
        fused_gather_gram_solve_reference(users, idx, cw, bw, reg),
        1e-3, f"fused dma long row [1,{Kl}]")
    long_ms = {impl: cuda_ms(lambda: fused_gather_gram_solve(
        users, idx, cw, bw, reg, gather_impl=impl), iters=1)
        for impl in ("dma", "taa")}
    log(f"phase fused dma long row [1,{Kl}] (1,860,000 ratings): dma "
        f"{long_ms['dma']:.3f} ms vs taa {long_ms['taa']:.3f} ms, "
        f"max_abs_err {err_long:.3e} (tol 1e-3 x scale)")
    return dict(
        name="fused_als_dma", route="cuda",
        source="predictionio_tpu_torch/ops/csrc/fused_als.cu",
        replaces="predictionio_tpu/ops/fused_als.py:500",
        max_abs_err=max(errs + [err_long]), ms=ms["dma"], plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
        shape=f"table[{N_ITEMS},{RANK}] f32, idx[{B},{K}]",
        taa_ms_same_run=ms["taa"], bf16_ms=ms16["dma"],
        bf16_taa_ms_same_run=ms16["taa"], long_row_ms=long_ms["dma"],
        long_row_taa_ms_same_run=long_ms["taa"],
    )


def phase_gather(torch, dev) -> list[dict]:
    """The three gather probe kernels vs their plain versions, exactly
    (a gather is a copy): f32 and bf16 tables, R in {16, 64}.  Each is
    timed at the shape its path gives it (preferred_order's 2,048 rows
    for taa0 and the row copy, smoke(64)'s [64, 256] for taa1) and at a
    shape where bytes dominate (2^20 rows or columns of 64 f32), beside
    its plain version, the library call (``torch.gather`` or
    ``torch.index_select``) and its bound: the bytes of the indices, of
    the distinct table rows (or columns) they name, and of the output,
    over 3.35 TB/s."""
    from predictionio_tpu_torch.ops import gather_probe as gp

    rng = np.random.default_rng(5)

    def table_of(n, r, dtype):
        return torch.from_numpy(
            rng.normal(size=(n, r)).astype(np.float32)).to(dev).to(dtype)

    def exact(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel and plain version differ")

    for dtype in (torch.float32, torch.bfloat16):
        for r in (16, 64):
            n = 4099
            t = table_of(n, r, dtype)
            rows = torch.from_numpy(
                rng.integers(0, n, size=n).astype(np.int32)).to(dev)
            i0 = rows[:, None].expand(n, r).contiguous()
            exact(gp.taa0_gather(t, i0), gp.taa0_gather_reference(t, i0),
                  f"taa0 {dtype} R={r}")
            t1 = table_of(r, n, dtype)
            i1 = rows[None, :].expand(r, n).contiguous()
            exact(gp.taa1_gather(t1, i1), gp.taa1_gather_reference(t1, i1),
                  f"taa1 {dtype} R={r}")
            exact(gp.dma_row_gather(t, rows[:3001], nout=3001),
                  gp.dma_row_gather_reference(t, rows[:3001]),
                  f"dma_row_gather {dtype} R={r}")
    log("phase gather: taa0, taa1 and the row copy equal their plain "
        "versions exactly (f32 and bf16, R in {16, 64})")

    def shapes(kind, n):
        """(kernel, plain, library, least bytes) at n rows of 64 f32."""
        r = RANK
        if kind == "taa1":
            t = table_of(r, n, torch.float32)
            cols = torch.from_numpy(
                rng.integers(0, n, size=n).astype(np.int32)).to(dev)
            i = cols[None, :].expand(r, n).contiguous()
            i64 = i.long()
            named = torch.unique(cols).numel()
            nbytes = named * r * 4 + i.numel() * 4 + t.numel() * 4
            return (lambda: gp.taa1_gather(t, i),
                    lambda: gp.taa1_gather_reference(t, i),
                    lambda: torch.gather(t, 1, i64), nbytes)
        t = table_of(n, r, torch.float32)
        rows = torch.from_numpy(
            rng.integers(0, n, size=n).astype(np.int32)).to(dev)
        named = torch.unique(rows).numel()
        if kind == "taa0":
            i = rows[:, None].expand(n, r).contiguous()
            i64 = i.long()
            nbytes = named * r * 4 + i.numel() * 4 + t.numel() * 4
            return (lambda: gp.taa0_gather(t, i),
                    lambda: gp.taa0_gather_reference(t, i),
                    lambda: torch.gather(t, 0, i64), nbytes)
        nbytes = named * r * 4 + n * 4 + n * r * 4
        return (lambda: gp.dma_row_gather(t, rows, nout=n),
                lambda: gp.dma_row_gather_reference(t, rows),
                lambda: torch.index_select(t, 0, rows), nbytes)

    out = []
    for name, kind, line, n_main in (
            ("taa0_gather", "taa0", 98, PROBE_N),
            ("taa1_gather", "taa1", 144, 256),
            ("dma_row_gather", "dma", 224, PROBE_N)):
        rec = dict(name=name, route="cuda",
                   source="predictionio_tpu_torch/ops/csrc/gather_probe.cu",
                   replaces=f"predictionio_tpu/ops/gather_probe.py:{line}",
                   max_abs_err=0.0)
        for tag, n, iters in (("", n_main, 200), ("big_", BIG_N, 20)):
            fn, plain, lib, nbytes = shapes(kind, n)
            exact(fn(), plain(), f"{name} n={n}")
            rec[tag + "ms"] = cuda_ms(fn, iters)
            rec[tag + "plain_ms"] = cuda_ms(plain, iters)
            rec[tag + "library_ms"] = cuda_ms(lib, iters)
            rec[tag + "bound_ms"], rec[tag + "bound_by"] = bound(nbytes, 0)
            rec[tag + "shape"] = (f"[{RANK},{n}]" if kind == "taa1"
                                  else f"[{n},{RANK}]") + " f32"
            del fn, plain, lib
        log(f"phase gather {name}: {rec['shape']} kernel {rec['ms']:.4f} ms, "
            f"plain {rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} "
            f"ms, bound {rec['bound_ms']:.4f} ms; {rec['big_shape']} kernel "
            f"{rec['big_ms']:.4f} ms, plain {rec['big_plain_ms']:.4f} ms, "
            f"library {rec['big_library_ms']:.4f} ms, bound "
            f"{rec['big_bound_ms']:.4f} ms (bytes)")
        out.append(rec)
    # the order fused_gather="auto" takes, with the probes it rests on;
    # cleared after, so that each main path ranks the forms itself
    for tb, dtype in ((4, torch.float32), (2, torch.bfloat16)):
        order = gp.preferred_order(RANK, tb)
        taa = gp.probe_taa0(PROBE_N, RANK, dtype)["ns_per_row"]
        dma = gp.probe_dma(PROBE_N, PROBE_N, RANK, dtype)["ns_per_row"]
        log(f"phase gather preferred_order({RANK}, {tb}) = {order}: taa0 "
            f"{taa:.2f} ns/row, row copy {dma:.2f} ns/row at n={PROBE_N}")
    gp._ORDER_CACHE.clear()
    torch.cuda.empty_cache()
    return out


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


def engine_over(ratings, items):
    """The recommendation engine's own components with a data source
    that hands over ratings already in memory.  ML-20M through the event
    store waits for the port of the native SQLite scan: its Python read
    alone takes minutes at 20M events."""
    from predictionio_tpu_torch.controller import Engine, IdentityPreparator
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm, RecommendationDataSource, RecommendationServing,
        TrainingData,
    )

    class InMemorySource(RecommendationDataSource):
        def read_training(self, ctx):
            return TrainingData(ratings=ratings, items=items)

    return Engine(InMemorySource, IdentityPreparator,
                  {"als": ALSAlgorithm, "": ALSAlgorithm},
                  RecommendationServing)


def phase_train(torch, data, solver: str, iterations: int):
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.models.als import ALSFactors, rmse

    ratings, items, (u, i, v) = data
    engine = engine_over(ratings, items)
    ep = engine.params_from_variant({"algorithms": [{"name": "als", "params": {
        "rank": RANK, "numIterations": iterations, "lambda": 0.01,
        "seed": 3, "solver": solver}}]})
    ctx = WorkflowContext(device="cuda")
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


def _http(port: int, path: str, body=None):
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _same_reply(got: dict, want: dict, what: str) -> int:
    """An HTTP reply against the in-process answer: the same items in
    the same order, scores within 1e-5 of their scale.  Two items may
    trade places only where their scores tie within that tolerance (the
    batched product rounds differently from the solo one); returns the
    number of such trades."""
    g, w = got["itemScores"], want["itemScores"]
    scale = max([abs(s["score"]) for s in w] + [1.0])
    if len(g) != len(w):
        raise AssertionError(f"{what}: {len(g)} items, expected {len(w)}")
    trades = 0
    for a, b in zip(g, w):
        if abs(a["score"] - b["score"]) > 1e-5 * scale:
            raise AssertionError(f"{what}: {a} where predict gives {b}")
        trades += a["item"] != b["item"]
    return trades


def phase_pio(torch) -> dict:
    """The event-store path, as a user runs it: a fresh ``$PIO_TPU_HOME``,
    an app, MovieLens-1M-shaped rate events (6,040 users x 3,706 items x
    1,000,209 ratings, seed 0) and a ``$set`` of categories for every
    item through the SQLite store's bulk path → ``run_train`` (rank 64,
    ``solver="fused"``, 2 iterations, ``fusedGather`` at its ``"auto"``
    default, so the trainer ranks the gather forms with the probe
    kernels) → ``EngineServer`` on 127.0.0.1 answering 32 solo and 64
    concurrent ``POST /queries.json``, each held against an in-process
    ``predict`` on the deployed model → ``POST /stop``.  A second
    ``run_train`` names the form ``"auto"`` did not pick, so both forms
    of the fused kernel run through the user's entry point.  The launch
    counts are set to 0 just before the first ``run_train`` and read
    after the last query."""
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from predictionio_tpu_torch.controller import (
        Engine, IdentityPreparator, WorkflowContext,
    )
    from predictionio_tpu_torch.ops import _build, gather_probe
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.storage import Event, Storage, reset_storage
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm, Query, RecommendationDataSource, RecommendationServing,
    )
    from predictionio_tpu_torch.workflow import (
        prepare_deploy_components, run_train,
    )

    read_s = []

    class TimedSource(RecommendationDataSource):
        """The template's data source, with its read timed."""

        def read_training(self, ctx):
            t0 = time.perf_counter()
            td = super().read_training(ctx)
            read_s.append(time.perf_counter() - t0)
            return td

    engine = Engine(TimedSource, IdentityPreparator,
                    {"als": ALSAlgorithm, "": ALSAlgorithm},
                    RecommendationServing)
    home = tempfile.mkdtemp(prefix="pio_home_")
    old_home = os.environ.get("PIO_TPU_HOME")
    os.environ["PIO_TPU_HOME"] = home
    reset_storage(Storage())
    try:
        from predictionio_tpu_torch.storage import get_storage

        storage = get_storage()
        md = storage.get_metadata()
        app = md.app_insert("ml1m")
        es = storage.get_event_store()
        es.init_channel(app.id)
        u, i, v = synth_ratings(ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, seed=0)
        t0 = time.perf_counter()
        step = 100_000
        with es.bulk():
            for s in range(0, len(v), step):
                es.insert_batch([
                    Event(event="rate", entity_type="user",
                          entity_id=f"u{a}", target_entity_type="item",
                          target_entity_id=f"i{b}",
                          properties={"rating": float(r)})
                    for a, b, r in zip(u[s:s + step].tolist(),
                                       i[s:s + step].tolist(),
                                       v[s:s + step].tolist())
                ], app.id, validate=False)
            es.insert_batch([
                Event(event="$set", entity_type="item", entity_id=f"i{j}",
                      properties={"categories": [
                          "even" if j % 2 == 0 else "odd"]})
                for j in range(ML1M_ITEMS)
            ], app.id, validate=False)
        ingest_s = time.perf_counter() - t0
        log(f"phase pio ingest: {len(v):,} rate + {ML1M_ITEMS:,} $set events "
            f"in {ingest_s:.1f} s")

        def variant(**algo):
            return engine.params_from_variant({
                "datasource": {"params": {"appName": "ml1m"}},
                "algorithms": [{"name": "als", "params": dict(
                    rank=RANK, numIterations=2, solver="fused", **algo)}]})

        # a `pio train` is a process of its own: no probe order cached
        gather_probe._ORDER_CACHE.clear()
        _build.reset_launches()
        ep = variant()
        t0 = time.perf_counter()
        iid = run_train(engine, ep)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        after_auto = dict(_build.LAUNCHES)
        forms = [f for f, k in (("taa", "fused_als"), ("dma", "fused_als_dma"))
                 if after_auto[k] > 0]
        if len(forms) != 1:
            raise AssertionError(f"fused forms launched by one run: {forms}")
        resolved = forms[0]
        other = "dma" if resolved == "taa" else "taa"
        for k in ("taa0_gather", "dma_row_gather"):
            if after_auto[k] <= 0:
                raise AssertionError(f"fused_gather='auto' never ran {k}")
        status = md.engine_instance_get(iid).status
        model_file = storage.model_data_dir() / iid / "model_0_als.pkl"
        if status != "COMPLETED" or not model_file.is_file():
            raise AssertionError(f"instance {iid}: {status}, {model_file}")
        t0 = time.perf_counter()
        iid_other = run_train(engine, variant(fusedGather=other))
        torch.cuda.synchronize()
        other_s = time.perf_counter() - t0
        if md.engine_instance_get(iid_other).status != "COMPLETED":
            raise AssertionError(f"the fusedGather={other!r} run failed")
        log(f"phase pio train: read_training {read_s[0]:.2f} s, run_train "
            f"wall {train_s:.2f} s, fused_gather 'auto' resolved to "
            f"{resolved!r} (probe order {gather_probe._ORDER_CACHE}); "
            f"fusedGather={other!r} run {other_s:.2f} s (read "
            f"{read_s[1]:.2f} s); instance {iid} COMPLETED, model file "
            f"written")

        # deploy the "auto" instance, in process and behind the server
        algos, models, _ = prepare_deploy_components(
            engine, ep, iid, ctx=WorkflowContext(mode="Serving"))
        algo, model = algos[0], models[0]
        t0 = time.perf_counter()
        srv = EngineServer(engine, ep, iid, ctx=WorkflowContext(
            mode="Serving"), config=ServerConfig(host="127.0.0.1", port=0))
        thread = srv.start_background()
        deploy_s = time.perf_counter() - t0
        rng = np.random.default_rng(11)
        items = [f"i{j}" for j in range(ML1M_ITEMS)]

        def query(k):
            q = {"user": f"u{int(rng.integers(0, ML1M_USERS))}", "num": 10}
            if k % 4 == 1:
                q["categories"] = ["even"]
            elif k % 4 == 2:
                q["whiteList"] = list(rng.choice(items, 50, replace=False))
            elif k % 4 == 3:
                q["blackList"] = list(rng.choice(items, 20, replace=False))
            return q

        solo_q = [query(k) for k in range(32)]
        conc_q = [query(k) for k in range(64)]
        solo, solo_ms = [], []
        for q in solo_q:
            t1 = time.perf_counter()
            solo.append(_http(srv.port, "/queries.json", q))
            solo_ms.append((time.perf_counter() - t1) * 1e3)

        def timed(q):
            t1 = time.perf_counter()
            r = _http(srv.port, "/queries.json", q)
            return r, (time.perf_counter() - t1) * 1e3

        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=64) as pool:
            conc = list(pool.map(timed, conc_q))
        conc_wall = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        trades = 0
        for q, got in zip(solo_q + conc_q, solo + [r for r, _ in conc]):
            want = algo.predict(model, Query.from_json(q)).to_json()
            trades += _same_reply(got, want, f"query {q}")
        if not any(r["itemScores"] for r in solo):
            raise AssertionError("no query got recommendations")
        status = _http(srv.port, "/")
        if status["requestCount"] != len(solo_q) + len(conc_q):
            raise AssertionError(f"server counted {status['requestCount']}")
        _http(srv.port, "/stop", {})
        thread.join(timeout=30)
        if thread.is_alive():
            raise AssertionError("the server did not stop")
        conc_ms = sorted(ms for _, ms in conc)
        log(f"phase pio serve: deploy {deploy_s:.2f} s; solo ms p50 "
            f"{np.percentile(solo_ms, 50):.3f} max {max(solo_ms):.3f}; 64 "
            f"concurrent in {conc_wall:.1f} ms (per query p50 "
            f"{np.percentile(conc_ms, 50):.3f} ms, max {conc_ms[-1]:.3f} ms, "
            f"microbatch {status.get('microbatch')}); all 96 replies match "
            f"in-process predict ({trades} tied items traded places); "
            f"stopped")
        return dict(launches=launches, resolved=resolved, ingest_s=ingest_s,
                    read_s=read_s[0], train_s=train_s, solo_ms=solo_ms,
                    conc_wall_ms=conc_wall, conc_ms=conc_ms)
    finally:
        reset_storage(None)
        if old_home is None:
            os.environ.pop("PIO_TPU_HOME", None)
        else:
            os.environ["PIO_TPU_HOME"] = old_home
        import shutil

        shutil.rmtree(home, ignore_errors=True)


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
    kernels.append(phase_fused_dma(torch, dev))
    torch.cuda.empty_cache()
    kernels.extend(phase_gather(torch, dev))
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

    # The main paths, each with the counts set to 0 just before it and
    # read just after.  ML-20M: train both kernel solvers and serve.
    _build.reset_launches()
    algo, model, _ = phase_train(torch, data, "fused", 2)
    del model
    torch.cuda.empty_cache()
    algo, model, _ = phase_train(torch, data, "pallas", 1)
    phase_serve(torch, algo, model)
    torch.cuda.synchronize()
    paths = {"ml20m": dict(_build.LAUNCHES)}
    del algo, model
    torch.cuda.empty_cache()
    # events -> run_train -> EngineServer (resets the counts itself)
    paths["pio"] = phase_pio(torch)["launches"]
    # the probe module's own entry point (the reference's
    # tools/probe_gather.py --smoke), the one path taa1 lies on
    from predictionio_tpu_torch.ops import gather_probe

    _build.reset_launches()
    recs = gather_probe.smoke(RANK)
    torch.cuda.synchronize()
    paths["probe_smoke"] = dict(_build.LAUNCHES)
    if not all(r.get("ok", True) for r in recs):
        raise AssertionError(f"gather_probe.smoke failed: {recs}")
    log(f"phase main path launches: {paths}")
    expected = {
        "ml20m": ("gj_solve", "taa0_gather", "dma_row_gather"),
        "pio": ("fused_als", "fused_als_dma", "taa0_gather",
                "dma_row_gather"),
        "probe_smoke": ("taa0_gather", "taa1_gather", "dma_row_gather"),
    }
    for path, names in expected.items():
        for name in names:
            if paths[path][name] <= 0:
                raise AssertionError(f"path {path} never launched {name}")
    if paths["ml20m"]["fused_als"] + paths["ml20m"]["fused_als_dma"] <= 0:
        raise AssertionError("path ml20m never launched the fused kernel")
    for k in kernels:
        k["launches"] = sum(p[k["name"]] for p in paths.values())
        k["launches_by_path"] = {n: p[k["name"]] for n, p in paths.items()}

    phase_breakdown(torch, ratings)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
