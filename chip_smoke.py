#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``predictionio_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version on the card at the shapes
the main paths give it (timing kernel, plain version and a PyTorch
library yardstick that the port never calls the same way: medians over
the same turns, taken in turns, after a warm-up): the SPD solve (on
ALS-built, zero and padded-rank boundary systems too, and against a
float64 solve), both forms of the fused ALS kernel ("taa" and "dma")
with the second pass of a split bucket, and the three gather probes,
whose launch path it takes apart step by step at the probe shape.
It builds the native host runtime (``build/native/``, ``g++``) beside
the kernels.  Then it drives ten main paths and phases ring, scout,
sessions, admin and examples through the entry points a user calls, each path with every launch counter set
to 0 just before it and read just after it; a kernel its path did not
launch fails the run:

* ML-20M: ratings shaped like MovieLens-20M (138,493 users x 26,744
  items x 20,000,263 ratings, every (user, item) pair distinct, made
  with numpy from a seed) imported as JSON lines into a 4-shard
  ``sqlite-sharded`` event store (a worker process a shard file), the
  items' ``$set`` events posted through the ingest fleet
  (``eventserver --workers 4``: a router and four shard-owner worker
  processes, put through the chaos checks of ``tools/ingest_smoke.py``
  on an app of their own), and read back by
  the native scan of every shard at once (``find_ratings``, held
  against the synthetic triples in the shards' order) → the
  recommendation engine training at rank 64 with ``solver="fused"`` (2
  iterations) and ``solver="pallas"`` (1 iteration) → serving solo and
  batched top-K queries;
* subspace: the rest of the trainer at ML-20M width: ``solver="pallas"``
  with ``solver_mode="subspace"`` (the SPD solve kernel on the iALS++
  sweep's 16 x 16 block systems, rows of the largest bucket held
  against a float64 block sweep), ``gather_mode="grouped"`` (accepted,
  and the row gather's factors bit for bit), a checkpointed ``train`` resumed by a new
  trainer (equal to the uninterrupted run bit for bit) and
  ``sweep_train_als`` at ML-1M counts (each lambda against a sequential
  train);
* cli: the quickstart on that store through the port's console
  (``template get``, ``build``, ``train --scan-cache`` in process, a
  ``deploy`` process on the event-loop edge answering queries like an
  in-process ``predict``, ``undeploy``);
* ring (no kernel on its path): the ring top-k on the ML-20M
  ``"pallas"`` model over four shards on the card, solo and batched
  against the single card's top-k, its coded path under a delay past
  the request deadline and a killed shard, its int8 candidate stage
  against the single card's int8 retrieval, and the template's
  ``"distributedTopk": true`` deployed in this process answering HTTP
  queries like an in-process ``predict``;
* router: ``deploy --replicas 2 --feedback`` on the instance that
  ``train`` made (a router process and two replica processes, each its
  own CUDA context), its feedback going to an event server on an app of
  its own and its remote log to a sink in this script: replies like an
  in-process ``predict``, one ``pio_pr`` event per answered query, the
  trace id on the feedback write, one log POST for an invalid query,
  ``/debug/fleet``, the HTML status page, and a replica SIGKILLed under
  load with no query failing and its respawn booked; while they are
  up, ``python -m predictionio_tpu_torch.tools.profcat --fleet`` merges
  the router's and both replicas' CPU profiles;
* eval: ``pio eval`` on that store through the console, in process: one
  candidate over 2 folds (:class:`ML20MSweep`; the two-candidate
  sweep runs at ML-1M counts in phase pio), its folds
  held against a numpy split and its winner's RMSE against a float64
  recomputation;
* scout (no kernel on its path): two-stage retrieval on that store
  after eval: the int8 and ivf retrievers of the ML-20M ``"pallas"``
  model (build seconds, recall@10 against the exact scan over 1,024
  users, a 64-query ``batch_predict``), the reference ANN smoke's
  invariants, and a console ``train`` with ``"retrieval": "ivf"``
  deployed and loaded from 64 clients, every reply held against the
  in-process two-stage ``predict``;
* engines: on that store after scout, the model-backed engines through
  the console: similarproduct (implicit ALS, ``"fused"``, its implicit
  counts held against a numpy recount of a shard), itemsimilarity
  (``"pallas"``, served by the ivf retriever, recall@10 against the
  exact scan), ecommerce (``"fused"``, served with the seen-items and
  unavailable-items reads of the store) and classification (an app of
  100,000 users imported as JSON lines; naive Bayes, logistic and a
  random forest, each held against its CPU counterpart); four
  ``deploy`` processes answering like an in-process ``predict``, each
  ALS train's float64 health check;
* sessions (no kernel on its path): on that store after engines, the
  engines that train no factor model on an app of their own, a day of
  500,000 view events in sessions (ML-20M's users and items) imported
  as JSON lines: trending and nextitem trained through the console and
  deployed as two processes (trending's under a ``storage.read`` fault
  plan), each held against a numpy recomputation from the generator's
  arrays (and ``e2.MarkovChain`` against a numpy count), every reply
  against an in-process ``predict`` at query time, and each engine's
  freshness timed from views posted through an ``eventserver`` process
  to the first reply that shows them;
* foldin: on that store after sessions, a ``"pallas"`` console ``train``
  (whose read must still hit phase read's snapshot),
  ``deploy --replicas 2 --push-foldin 1``, ``foldin --from-now`` (which
  must find nothing to fold), then a ``FoldInRunner`` on the card over
  three windows written through ``import`` (500 cold-start users,
  500 existing users with new ratings and 20 new items; twice 100
  cold-start users): the SPD solve kernel solves the rows, the first
  cycle is held against a float64 solve of the same window, every
  replica's reply for folded users against an in-process ``predict`` on
  the model and the chain, and the freshness from an import to the
  first fresh reply through the router is timed;
* hive: on that store after foldin, a second app (``beta``, at
  MovieLens-100K's counts) imported and trained twice through the
  console (``"fused"``, rank 64: the path's kernels), then four tenants
  (phase cli's instance as the anchor, phase foldin's with its delta
  chain, beta's two) in one ``EngineServer`` with a ``TenantRegistry``:
  sticky routing by the hash rule, the fold-in tenant answering as
  phase foldin did, the shared batcher mixing tenants, fair sharing
  under a flood, breaker and quota isolation, LRU eviction under a
  memory budget with ``torch.cuda.memory_allocated`` falling by the
  evicted tenant's device tables and its reload with the chain applied,
  per-variant attribution and online eval, and the SPRT autopilot
  concluding beta's experiment through ``POST /tenants/weights``; then
  ``deploy --multi --memory-budget --autopilot on`` as a process;
* admin (no kernel on its path): ``adminserver`` over a ``jsonfs``
  metadata store (an app and its keys created, listed and deleted) and
  ``dashboard`` over that store, every page answering, beside a
  ``deploy --multi`` process of phase hive's tenants whose
  ``/debug/profile`` capture names a CUDA kernel and which exits 0 at
  its ``undeploy``;
* pio: MovieLens-1M-shaped events (6,040 x 3,706 x 1,000,209) into the
  SQLite event store of a fresh ``$PIO_TPU_HOME`` through the REST event
  server (one with the group-commit WAL) and ``import_events`` →
  ``run_train`` (``fused_gather="auto"``, which ranks the fused kernel's
  forms with the gather probe kernels) → ``EngineServer`` answering solo
  and concurrent ``POST /queries.json`` like an in-process ``predict``,
  then (phase formats, on the first 100,000 of those ratings) the
  ``.npz`` and Parquet exports and imports through the console and
  ``import_ratings_csv`` of a MovieLens file, each new app's ratings
  held against the synthetic triples, then the
  eval sweep on that store sequentially and with ``--parallelism 2``,
  which must agree, and (phase dist (c)) ``train --coordinator`` as two
  console processes sharing the card (gloo, sharded placement,
  ``coo: "local"``): one instance, a sharded ``.npz`` model, factors
  equal to a one-process train's, its deploy answering like
  ``predict``;
* dist: on the ML-20M ratings, an iteration on a mesh of four shards
  on the card (``"fused"`` and ``"pallas"``, each held against a
  single-card iteration from the same start; every shard must launch
  the kernel) and the coded trainer (clean, a straggler served from
  parity within 1% of the clean RMSE, two holes refused);
* examples: the 18 example engines of ``examples/*/engine_torch.py``
  trained and queried on the card as ``tests/test_examples.py`` queries
  the reference's, each held against its own run on the host and to
  that test's assertions; sharded-scale on four shards of the card
  (``"fused"``: every shard must launch the kernel), through its main,
  as lambda-sweep and movielens-eval run theirs;
  ``bin/pio-tpu-torch-start-all`` and ``-stop-all`` on a scratch
  ``$PIO_TPU_HOME`` (three servers answering, none holding the card,
  none left, the reference's pid files untouched);
* probe smoke: ``gather_probe.smoke``, the probe module's own entry
  point.

Inside those paths it holds the observability layer (``obs/``) and the
fault plan (``resilience/faults.py``) to the invariants of the
reference's ``tools/*_smoke.py`` (and phase dist's checks), each set
printed as one ``{"obs":
{check: bool}, "detail": ...}`` line (a false check fails the run): a
``"pallas"`` iteration at ML-20M under ``PIO_TPU_TRACE_ALS=1`` (phase
spans, the SPD solve launched in each traced half); the console
``train``'s run manifest; the ``deploy`` process's ``/metrics``,
``/status``, segments, flight recorder, device-memory gauges, burn
rates and a 2 s ``torch.profiler`` capture, and the same load with
``--no-metrics``; the fleet's ``/metrics`` federation through a worker's
death, a traced write in its owner's journal and a ``store.shard_down``
worker; at ML-1M the ``storage.write``, ``wal.torn``,
``device.dispatch``, ``reload.load_model``, ``http.feedback`` and
``http.remote_log`` faults, a traced query in the journal, and
``train.nan`` aborting a console ``train``.

Prints the card's name and power limit (``nvidia-smi``), one line per
phase, a ``{"kernels": [...]}`` JSON line, and as its last line
``{"ok": true, "device": {...}}``.  Any failed phase raises and the script
exits non-zero without that last line; so does a run without a CUDA
device or without the package beside the script.

    python3 chip_smoke.py --breakdown

builds the kernels and runs only the ML-20M breakdown (the last phase:
an iteration of each solver after a warm-up one, under the profiler
too, on the ratings the store gives), with no result line:
a copy of this script run from the root of another tree of the port
times that tree by the same method.

    python3 chip_smoke.py --store

builds and runs only the ML-20M store phases (write and import, the
ingest fleet, the sharded read and its check) and the host sort's
timing, with the import's writers timed between the import and the
fleet: one writer against a process a shard, the same file into fresh
4-shard stores, each held against phase store's rows rowid for rowid,
and the same two on heads of the file (4 to 256 MiB), held against each
other, with no result line.

    python3 chip_smoke.py --store-npz

runs the same store phases, then the same ratings written as a columnar
``.npz`` and imported into a fresh 4-shard store (timed beside the JSON
lines), with no result line.

    python3 chip_smoke.py --edge-ab

trains the ML-20M ratings in process, deploys the instance twice (the
default recording and ``--no-metrics``) and loads each from 64 clients
in 5 alternating turns, printing each turn and each arm's median and
spread, then the recording arm's time beyond the predict window at 4
clients in 5 light loads, with no result line.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import logging
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.parse
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

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

# split targets (waves of blocks over the SMs) that phase breakdown times
# bucket by bucket, and those whose whole fused iteration it times
SWEEP_WAVES = (1, 2, 4, 6, 8, 12, 16, 24, 32)
ITERATION_WAVES = (8, 16, 24, 32)

# the ML-1M sweep of phase pio: two candidates that differ only in
# lambda, k folds (2, not the reference's 3: the whole script stays well
# inside its time)
SWEEP_LAMBDAS = (0.01, 0.1)
# phase eval at ML-20M scores one of them, the winner of every earlier
# run: a depth cut that keeps the script near its target
# with phase engines; the two-candidate sweep runs at ML-1M in phase pio
ML20M_EVAL_LAMBDAS = (0.1,)
EVAL_K = 2
EVAL_SEED = 3

# the ML-20M store: a sqlite-sharded source of the reference's default
# count, behind an ingest fleet of as many worker processes
STORE_SHARDS = 4
FLEET_WORKERS = 4
# phase fleet's chaos check: keep-alive clients, single rate events each
CHAOS_CLIENTS = 8
CHAOS_EVENTS = 60


def sweep_variant(app: str, lam: float) -> dict:
    """One candidate of the sweep as an engine.json variant: rank 64, 2
    iterations, ``solver="fused"`` with ``fusedGather`` "auto", over
    :data:`EVAL_K` folds of ``app``'s rate events."""
    return {
        "datasource": {"params": {"appName": app, "eventNames": ["rate"],
                                  "evalK": EVAL_K, "evalSeed": EVAL_SEED}},
        "algorithms": [{"name": "als", "params": {
            "rank": RANK, "numIterations": 2, "lambda": lam,
            "solver": "fused", "fusedGather": "auto"}}],
    }


class ML20MSweep:
    """The ``EngineParamsGenerator`` phase eval names on the console
    (``eval --engine recommendation __main__.ML20MSweep``): one candidate
    per λ of ``LAMBDAS`` over the ML-20M store's app.  The console
    instantiates the class, so the port is imported only then."""

    APP = "ml20m"
    LAMBDAS = ML20M_EVAL_LAMBDAS

    def __init__(self):
        from predictionio_tpu_torch.templates.recommendation import (
            recommendation_evaluation,
        )

        engine = recommendation_evaluation().engine
        self.engine_params_list = [
            engine.params_from_variant(sweep_variant(self.APP, lam))
            for lam in self.LAMBDAS]


class ML1MSweep(ML20MSweep):
    """The sweep of both :data:`SWEEP_LAMBDAS` over phase pio's ML-1M
    app."""

    APP = "ml1m"
    LAMBDAS = SWEEP_LAMBDAS


def synth_ratings(n_users: int, n_items: int, n_ratings: int, seed: int = 0,
                  distinct: bool = False):
    """MovieLens-shaped ratings: Zipf 0.8 user activity, Zipf 1.0 item
    popularity, half-star values 0.5..5 (the repository's ``bench.py``
    generator).  With ``distinct``, every (user, item) pair is drawn
    once, as in MovieLens: a pair drawn again keeps its place in the
    draw order and is redrawn, both ends from the same marginals, until
    it is new (so the heaviest users and items fill their whole row)."""
    rng = np.random.default_rng(seed)
    w_u = 1.0 / np.arange(1, n_users + 1) ** 0.8
    w_u /= w_u.sum()
    u = rng.choice(n_users, size=n_ratings, p=w_u).astype(np.int32)
    w_i = 1.0 / np.arange(1, n_items + 1) ** 1.0
    w_i /= w_i.sum()
    i = rng.choice(n_items, size=n_ratings, p=w_i).astype(np.int32)
    v = (rng.integers(1, 11, size=n_ratings) * 0.5).astype(np.float32)
    if not distinct:
        return u, i, v
    key = u.astype(np.int64) * n_items + i
    order = np.argsort(key, kind="stable")
    ks = key[order]
    first = np.r_[True, ks[1:] != ks[:-1]]
    seen = ks[first]                  # the pairs taken, sorted
    todo = np.sort(order[~first])     # the later draws of a taken pair
    while len(todo):
        cu = rng.choice(n_users, size=len(todo), p=w_u).astype(np.int32)
        ci = rng.choice(n_items, size=len(todo), p=w_i).astype(np.int32)
        ck = cu.astype(np.int64) * n_items + ci
        # sorted candidates: the first of equal ones, if not yet taken
        o = np.argsort(ck, kind="stable")
        cs = ck[o]
        pos = np.searchsorted(seen, cs)
        fresh = np.r_[True, cs[1:] != cs[:-1]] & (
            seen[np.minimum(pos, len(seen) - 1)] != cs)
        ok = np.zeros(len(ck), bool)
        ok[o[fresh]] = True
        u[todo[ok]], i[todo[ok]] = cu[ok], ci[ok]
        seen = np.insert(seen, pos[fresh], cs[fresh])
        todo = todo[~ok]
    return u, i, v


def synth_ml20m(seed: int = 0):
    """The ``bench.py`` generator at MovieLens-20M's counts, every
    (user, item) pair distinct as in MovieLens-20M."""
    return synth_ratings(N_USERS, N_ITEMS, N_RATINGS, seed, distinct=True)


def user_id(k) -> str:
    return f"u{int(k):06d}"


def item_id(k) -> str:
    return f"i{int(k):05d}"


# the event time of the k-th synthetic rating: T0_MS + k ms, so that
# dedup "last" keeps each (user, item) pair's last draw
T0_MS = 1_420_070_400_000   # 2015-01-01T00:00:00Z


def rate_line(a, b, r, k) -> dict:
    """One synthetic rating as the event JSON a user posts."""
    return {"event": "rate", "entityType": "user", "entityId": user_id(a),
            "targetEntityType": "item", "targetEntityId": item_id(b),
            "properties": {"rating": float(r)},
            "eventTime": str(np.datetime64(T0_MS + int(k), "ms")) + "Z"}


_LINE = (b'{"event":"rate","entityType":"user","entityId":"u', 6,
         b'","targetEntityType":"item","targetEntityId":"i', 5,
         b'","properties":{"rating":', "r", b'},"eventTime":"', "t",
         b'Z"}\n')


def _digits(m, col: int, x, n: int) -> None:
    for d in range(n):
        m[:, col + d] = 48 + (x // 10 ** (n - 1 - d)) % 10


def write_rate_lines(f, u, i, v, k0: int, chunk: int = 1 << 20) -> None:
    """Write ratings ``(u, i, v)`` (the ``k0``-th synthetic rating first)
    to ``f`` as JSON lines equal to :func:`rate_line`'s, built as one
    fixed-width byte matrix per ``chunk`` ratings (ids zero-padded, the
    half-star rating as three characters, the time to the millisecond)."""
    if k0 + len(v) > 86_400_000:
        raise ValueError("the event times must fall within one day")
    widths = [len(x) if isinstance(x, bytes) else
              {"r": 3, "t": 23}.get(x, x) for x in _LINE]
    width = sum(widths)
    for s in range(0, len(v), chunk):
        uu, ii = u[s:s + chunk], i[s:s + chunk]
        n = len(uu)
        m = np.empty((n, width), np.uint8)
        col = 0
        for part, w in zip(_LINE, widths):
            if isinstance(part, bytes):
                m[:, col:col + w] = np.frombuffer(part, np.uint8)
            elif part == "r":
                twice = np.rint(v[s:s + chunk] * 2).astype(np.int64)
                m[:, col] = 48 + twice // 2
                m[:, col + 1] = ord(".")
                m[:, col + 2] = 48 + 5 * (twice % 2)
            elif part == "t":
                # within the first day: "2015-01-01T" and HH:MM:SS.mmm
                ms = np.arange(k0 + s, k0 + s + n, dtype=np.int64)
                m[:, col:col + 11] = np.frombuffer(b"2015-01-01T", np.uint8)
                for c, (unit, mod, digits) in zip(
                        (11, 14, 17, 20),
                        ((3_600_000, 24, 2), (60_000, 60, 2),
                         (1000, 60, 2), (1, 1000, 3))):
                    _digits(m, col + c, (ms // unit) % mod, digits)
                m[:, col + 13] = m[:, col + 16] = ord(":")
                m[:, col + 19] = ord(".")
            else:
                _digits(m, col, uu if w == 6 else ii, w)
            col += w
        f.write(m.tobytes())


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


def interleaved_ms(fns: dict, turns: int = 5) -> dict:
    """Median over ``turns`` turns of :func:`cuda_ms` for each
    ``fns[name] = (fn, iters)``, after one warm-up call of each.  In each
    turn every function runs once, the order rotating from turn to turn,
    so that drift of the host or the card hits all of them alike and an
    outlier run does not stand as anyone's time."""
    names = list(fns)
    for fn, _ in fns.values():
        fn()
    times = {n: [] for n in names}
    for t in range(turns):
        for n in names[t % len(names):] + names[:t % len(names)]:
            fn, iters = fns[n]
            times[n].append(cuda_ms(fn, iters, warmup=0))
    return {n: float(np.median(v)) for n, v in times.items()}


def bound(nbytes: float, flops: float, tc_flops: float = 0.0,
          tc_rate: float = TF32_FLOP_PER_S) -> tuple[float, str]:
    """Least ms for work that moves ``nbytes`` and does ``flops`` on the
    CUDA cores (f32) and ``tc_flops`` on the tensor cores at ``tc_rate``:
    the larger of the bytes' time and the operations' time."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / F32_FLOP_PER_S + tc_flops / tc_rate) * 1e3
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

def als_systems(torch, dev, ratings, lo: int = 33, hi: int = 64,
                most: int = 16_384, lam: float = 0.01):
    """Normal equations as the trainer builds them for the rank-64
    user-half bucket of ML-20M: users with ``lo``..``hi`` ratings (the
    K = 64 bucket), at most ``most`` of them; the Gram of the item factor
    rows they rated (MLlib's init, N(0, 1) / sqrt(64), seed 3) plus
    ``lam * n * I`` (ALS-WR) and the right-hand side ``sum r v``."""
    u, i, v = ratings
    counts = np.bincount(u, minlength=N_USERS)
    users = np.flatnonzero((counts >= lo) & (counts <= hi))[:most]
    chosen = np.zeros(N_USERS, bool)
    chosen[users] = True
    keep = chosen[u]
    uu, ii, vv = u[keep], i[keep], v[keep]
    order = np.argsort(uu, kind="stable")
    uu, ii, vv = uu[order], ii[order], vv[order]
    row = np.searchsorted(users, uu)
    pos = np.arange(len(uu)) - np.searchsorted(uu, users)[row]
    B = len(users)
    idx = np.zeros((B, hi), np.int64)
    val = np.zeros((B, hi), np.float32)
    mask = np.zeros((B, hi), np.float32)
    idx[row, pos], val[row, pos], mask[row, pos] = ii, vv, 1.0
    V = torch.randn((N_ITEMS, RANK), generator=torch.Generator().manual_seed(
        3)) / math.sqrt(RANK)
    mask_t = torch.from_numpy(mask).to(dev)
    Vm = V.to(dev)[torch.from_numpy(idx).to(dev)] * mask_t[..., None]
    n = torch.from_numpy(counts[users].astype(np.float32)).to(dev)
    A = torch.einsum("bkr,bks->brs", Vm, Vm) + (lam * n)[:, None, None] * \
        torch.eye(RANK, device=dev)
    b = torch.einsum("bk,bkr->br", torch.from_numpy(val).to(dev), Vm)
    return A.contiguous(), b.contiguous()


def phase_gj(torch, dev, ratings) -> dict:
    """The SPD solve kernel against its plain version (the lock-step
    Gauss-Jordan of the TPU kernel), 1e-4 of the solution's scale (other
    steps, Cholesky against Gauss-Jordan, in f32), and against a float64
    solve on the host, 1e-3: on systems built as ALS builds them (the
    ML-20M user-half bucket of rank 64, :func:`als_systems`), on a batch
    of zero systems (x must be 0 exactly, as the plain version gives: a
    zero system has no float64 solve), and at every padded-rank boundary
    (R = 16, 17, 32, 33, 64, 65, 127, 128) and R = 10, in batches with a
    ragged last block and batches too small to fill the card.  Times at
    the main path's rank-64 bucket shape beside the plain version and
    the library's Cholesky, and so at rank 128 (16,384 systems)."""
    from predictionio_tpu_torch.ops.solve import (
        gj_plan, sm_count, spd_solve_batched, spd_solve_reference,
    )

    g = torch.Generator(device=dev).manual_seed(1)
    sms = sm_count(dev)

    def spd(B, R):
        G = torch.randn((B, R, R), generator=g, device=dev)
        A = torch.bmm(G, G.mT) / R + 0.5 * torch.eye(R, device=dev)
        return A.contiguous(), torch.randn((B, R), generator=g, device=dev)

    def check(A, b, what):
        x = spd_solve_batched(A, b)
        err = max_err(x, spd_solve_reference(A, b), 1e-4, what)
        want = torch.linalg.solve(A.double().cpu(), b.double().cpu())
        err64 = max_err(x.cpu(), want, 1e-3, what + " (float64)")
        return err, err64

    errs, err64s = [], []
    cases = [("ALS user-half bucket", *als_systems(torch, dev, ratings))]
    for R, B in ((10, 4099), (16, 1031), (17, 1031), (32, 1031), (33, 7),
                 (64, 1031), (65, 1031), (127, 3), (128, 4099)):
        cases.append((f"R={R} B={B}", *spd(B, R)))
    for what, A, b in cases:
        B, R = b.shape
        e, e64 = check(A, b, f"gj {what}")
        errs.append(e)
        err64s.append(e64)
        log(f"phase gj {what} [{B},{R},{R}] plan {tuple(gj_plan(R, B, sms))}: "
            f"max_abs_err {e:.3e} against the plain version (tol 1e-4 x "
            f"scale), {e64:.3e} against float64 (tol 1e-3 x scale)")
    del cases
    # a zero system has no float64 solve: x must be 0 exactly, as the
    # plain version's clamped pivot gives
    zero = torch.zeros((1031, RANK, RANK), device=dev)
    zb = torch.zeros((1031, RANK), device=dev)
    x = spd_solve_batched(zero, zb)
    torch.cuda.synchronize()
    if not (torch.equal(x, torch.zeros_like(x))
            and torch.equal(spd_solve_reference(zero, zb), x)):
        raise AssertionError("gj: a batch of zero systems does not solve to 0")
    log("phase gj zero systems [1031,64,64]: x == 0 exactly, as the plain "
        "version gives")

    def timed(R, B, kernel_iters):
        """Kernel, plain version and library in turns on B random
        systems of rank R: (ms, plain ms, library ms, bound ms, bound
        by, max_abs_err)."""
        A, b = spd(B, R)
        err = max_err(spd_solve_batched(A, b), spd_solve_reference(A, b),
                      1e-4, f"gj R={R} B={B}")

        def library():
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.cholesky_solve(b[..., None], L)

        t = interleaved_ms({
            "kernel": (lambda: spd_solve_batched(A, b), kernel_iters),
            "plain": (lambda: spd_solve_reference(A, b),
                      max(1, kernel_iters // 10)),
            "library": (library, 3)})
        bound_ms, bound_by = bound(spd_bytes(B, R), B * spd_solve_flops(R))
        log(f"phase gj R={R} B={B} (medians of 5 interleaved turns): kernel "
            f"{t['kernel']:.4f} ms ({t['kernel'] / bound_ms:.1f}x bound), "
            f"plain {t['plain']:.3f} ms, library {t['library']:.3f} ms, "
            f"bound {bound_ms:.3f} ms ({bound_by}), max_abs_err {err:.3e}, "
            f"plan {tuple(gj_plan(R, B, sms))}")
        return t["kernel"], t["plain"], t["library"], bound_ms, bound_by, err

    # the main path's shape: a full rank-64 bucket of the user half
    ms, plain_ms, library_ms, bound_ms, bound_by, err = timed(RANK, 65_536,
                                                              20)
    errs.append(err)
    # rank 128, the largest the kernel takes (one row a thread, a block a
    # system), as the iALS++ subspace sweep will give it
    ms128, plain128, library128, bound128, _, err = timed(128, 16_384, 10)
    errs.append(err)
    return dict(
        name="gj_solve", route="cuda",
        source="predictionio_tpu_torch/ops/csrc/gj_solve.cu",
        replaces="predictionio_tpu/ops/solve.py:162",
        max_abs_err=max(errs), max_abs_err_float64=max(err64s), ms=ms,
        plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
        library_ms=library_ms, shape=f"A[65536,{RANK},{RANK}] f32",
        rank_128=dict(shape="A[16384,128,128] f32", ms=ms128,
                      plain_ms=plain128, library_ms=library128,
                      bound_ms=bound128),
    )


def rand_bucket(torch, g, B: int, K: int, M: int, lo: int, hi: int):
    """A [B, K] bucket against an [M, *] table from the card's generator
    ``g``: counts in [lo, hi] (masked tails), half-star ratings, explicit
    weights (cw = 1, bw = r), reg = 0.01 * count: (idx, cw, bw, reg,
    nnz)."""
    dev = g.device
    counts = torch.randint(lo, hi + 1, (B,), generator=g, device=dev)
    valid = torch.arange(K, device=dev)[None, :] < counts[:, None]
    idx = torch.randint(0, M, (B, K), generator=g, device=dev)
    idx = torch.where(valid, idx, 0).to(torch.int32)
    val = torch.randint(1, 11, (B, K), generator=g, device=dev) * 0.5
    cw = valid.float()
    bw = (val * cw).float()
    reg = 0.01 * counts.clamp(min=1).float()
    return idx, cw, bw, reg, int(counts.sum().item())


def ml20m_split_buckets(ratings, sms: int) -> list:
    """Every bucket of the ML-20M trainer's two halves that the fused
    planner splits on this card (either form, f32 tables), bucketed from
    the ratings' counts as the trainer buckets them: (B, K, S, seg_len,
    the opposite table's rows), one for each (B, S), sorted."""
    from predictionio_tpu_torch.models.als import ALSConfig, _assemble_buckets
    from predictionio_tpu_torch.ops.fused_als import fused_tile_plan

    cfg = ALSConfig(rank=RANK)
    shapes = {}
    for rows, n, m in ((ratings.user_ix, N_USERS, N_ITEMS),
                       (ratings.item_ix, N_ITEMS, N_USERS)):
        counts = np.bincount(rows, minlength=n)
        for bk in _assemble_buckets(counts, np.zeros_like(counts),
                                    cfg.min_bucket_k,
                                    cfg.max_ratings_per_row):
            for impl in ("taa", "dma"):
                plan = fused_tile_plan(m, RANK, bk.k, 4, impl,
                                       b=len(bk.rows), sms=sms)
                if plan.segments > 1:
                    shapes.setdefault((len(bk.rows), plan.segments), (
                        len(bk.rows), bk.k, plan.segments, plan.seg_len, m))
    return sorted(shapes.values())


def fused_cases(torch, dev):
    """The fused phases' inputs, made on the card from generator seed 2:
    the item table [26,744, 64] and a rank-64 user-half bucket [32768,
    128] against it (masked tails: counts in [65, 128]); the user table
    [138,493, 64], a split item-half bucket [229, 8192] (counts in
    [4097, 8192]) and the heaviest item's row [1, 2^21] with 1,860,000
    ratings against it.  Each bucket is (idx, cw, bw, reg, nnz) with
    explicit weights (cw = 1, bw = r)."""
    g = torch.Generator(device=dev).manual_seed(2)

    def bucket(B, K, M, lo, hi):
        return rand_bucket(torch, g, B, K, M, lo, hi)

    table = torch.randn((N_ITEMS, RANK), generator=g, device=dev) / 8
    short = bucket(32_768, 128, N_ITEMS, 65, 128)
    users = torch.randn((N_USERS, RANK), generator=g, device=dev) / 8
    split = bucket(229, 8192, N_USERS, 4097, 8192)
    long = bucket(1, 1 << 21, N_USERS, 1_860_000, 1_860_000)
    return table, short, users, split, long


def implicit_of(torch, bucket, alpha: float = 1.5):
    """The same bucket with implicit weights: cw = alpha * r for integer
    r in {0, 1, 2} (zero confidence where r = 0), bw = 1 + cw."""
    idx, cw, bw, reg, nnz = bucket
    r = torch.remainder(bw * 2, 3).floor()
    cwi = (alpha * r * cw).contiguous()
    return idx, cwi, ((1.0 + cwi) * cw).contiguous(), reg, nnz


def fused_bound(B: int, nnz: int, m: int,
                table_bytes: int = 4) -> tuple[float, str]:
    """The fused function's least work on a [B, *] bucket of nnz real
    entries against an [m, 64] table of ``table_bytes`` elements:
    idx/cw/bw of the real entries, reg, gram0, the table once and x out;
    one triangle of each Gram (nnz * R(R+1) flop) and the right-hand
    sides (2 nnz R) on the TF32 tensor cores at the f32 accuracy the
    function asks for (an operand split into high and low TF32 parts:
    three products for an f32 table, two for a bf16 table, whose values
    are exact in TF32), and one SPD solve per row in f32."""
    nbytes = (nnz * 12 + B * 4 + RANK * RANK * 4 + m * RANK * table_bytes
              + B * RANK * 4)
    products = 3 if table_bytes == 4 else 2
    return bound(nbytes, B * spd_solve_flops(RANK),
                 nnz * RANK * (RANK + 1) + 2 * nnz * RANK,
                 TF32_FLOP_PER_S / products)


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


def reduce_bound(parts) -> tuple[float, str]:
    """Pass 2's least work on [B, S, P] partials: each partial read once,
    reg, gram0 and x; an add per partial float and an SPD solve a row."""
    b, _, _ = parts.shape
    return bound(parts.numel() * 4 + RANK * RANK * 4 + b * 4 + b * RANK * 4,
                 parts.numel() + b * spd_solve_flops(RANK))


def queued_ms(torch, fn, iters: int = 20, turns: int = 3) -> float:
    """Device ms a call of ``fn`` with its host work out of the way:
    ``iters`` calls queued behind a ``torch.cuda._sleep`` kernel that
    outlasts their enqueueing (checked, and lengthened where it did not),
    CUDA events around the calls alone, the median of ``turns`` turns.
    The device's own gaps between launches stay in."""
    fn()
    cycles, out = 4_000_000, []
    while len(out) < turns:
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        torch.cuda._sleep(cycles)
        ev[1].record()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        ev[2].record()
        ev[2].synchronize()
        if ev[0].elapsed_time(ev[1]) <= host_ms:
            cycles *= 2
            continue
        out.append(ev[1].elapsed_time(ev[2]) / iters)
    return float(np.median(out))


def reduce_at_split_shapes(torch, buckets, table, users) -> list:
    """Pass 2 at every split bucket of the ML-20M trainer
    (:func:`ml20m_split_buckets`): partials from the plain pass 1 on a
    bucket of that shape (counts in (K/2, K], against the item or the
    user table), held against the plain pass 2 (1e-4 of the solution's
    scale), two calls the same bits, timed through the wrapper (CUDA
    events, median of 5 turns) and on the device alone
    (:func:`queued_ms`) beside its bound."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_partials_reference, reduce_plan, sm_count,
    )

    sms = sm_count(table.device)
    g = torch.Generator(device=table.device).manual_seed(7)
    t0 = time.perf_counter()
    recs = []
    for B, K, S, seg, m in buckets:
        t = table if m == N_ITEMS else users
        idx, cw, bw, reg, _ = rand_bucket(torch, g, B, K, m, K // 2 + 1, K)
        parts = fused_partials_reference(t, idx, cw, bw, seg)
        del idx, cw, bw
        rec = reduce_case(torch, parts, reg, f"K={K}")
        rec.update(K=K, groups=reduce_plan(B, S, RANK, sms).groups)
        recs.append(rec)
        del parts
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase fused reduce at the ML-20M split buckets ({len(recs)} "
        f"shapes, {time.perf_counter() - t0:.2f} s; B x S, groups, ms "
        "through the wrapper, device ms, bound ms, max_abs_err; two calls "
        "equal bitwise): " + "; ".join(
            f"{r['shape'][0]}x{r['shape'][1]} G={r['groups']} "
            f"{r['ms']:.4f} {r['device_ms']:.4f} {r['bound_ms']:.4f} "
            f"{r['max_abs_err']:.2e}" for r in recs))
    return recs


def reduce_case(torch, parts, reg, what: str) -> dict:
    """Pass 2 on ``parts``: against its plain version (1e-4 of the
    scale), two calls bitwise, the wrapper's time (CUDA events around 10
    calls, median of 5 turns), its device time (:func:`queued_ms`) and
    its bound."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_reduce_solve, fused_reduce_solve_reference,
    )

    x = fused_reduce_solve(parts, reg)
    y = fused_reduce_solve(parts, reg)
    torch.cuda.synchronize()
    what = f"fused_als_reduce {list(parts.shape)} {what}"
    if not torch.equal(x, y):
        raise AssertionError(f"{what}: two calls differ")
    err = max_err(x, fused_reduce_solve_reference(parts, reg), 1e-4, what)

    def call():
        return fused_reduce_solve(parts, reg)

    ms = interleaved_ms({"kernel": (call, 10)})["kernel"]
    bnd, by = reduce_bound(parts)
    return dict(shape=list(parts.shape), ms=ms,
                device_ms=queued_ms(torch, call), bound_ms=bnd,
                bound_by=by, max_abs_err=err)


def phase_fused(torch, dev, ratings) -> list[dict]:
    """Both forms of the fused kernel ("taa": rows loaded through L2;
    "dma": rows staged by cp.async into a double tile) and pass 2 of a
    split bucket, against their plain versions, on the [32768, 128]
    bucket (f32 and bf16 tables, explicit and implicit weights with a
    gram0), the split [229, 8192] bucket and the heavy [1, 2^21] row
    (f32 and bf16 tables); pass 2 alone (:func:`reduce_case`, through
    its wrapper) on the heavy row's partials in 1024 segments and in the
    planner's, at every split bucket the planner gives the ML-20M
    trainer (:func:`reduce_at_split_shapes`), and at [1, 1, P] (one
    slice: the one-block solve's floor, device time).
    Tolerance: 1e-4 of the solution's scale, 1e-3 on the heavy row (TF32
    parts with a high/low split against f32 products, Cholesky against
    Gauss-Jordan, sums in another order; the long row sums 1.86M terms).
    Two calls give the same bits.  Times (:func:`interleaved_ms`: the two
    forms, and at the [32768, 128] bucket and the heavy row the plain
    version and the library call too, in the same turns) beside their
    bounds."""
    from predictionio_tpu_torch.ops.fused_als import (
        fused_gather_gram_solve, fused_gather_gram_solve_reference,
        fused_partials_reference, fused_reduce_solve,
        fused_reduce_solve_reference, fused_tile_plan, sm_count,
    )

    sms = sm_count(dev)
    split_buckets = ml20m_split_buckets(ratings, sms)
    table, short, users, split, long = fused_cases(torch, dev)
    t16, u16 = table.to(torch.bfloat16), users.to(torch.bfloat16)
    gram_i = (table.T @ table).contiguous()
    forms = ("taa", "dma")
    errs = {impl: [] for impl in forms}
    checks = (
        ("[32768,128] f32", table, short[:4], None, 1e-4),
        ("[32768,128] bf16", t16, short[:4], None, 1e-4),
        ("[32768,128] implicit", table, implicit_of(torch, short)[:4],
         gram_i, 1e-4),
        ("[229,8192] f32", users, split[:4], None, 1e-4),
        ("[229,8192] bf16", u16, split[:4], None, 1e-4),
        ("[1,2^21] f32", users, long[:4], None, 1e-3),
        ("[1,2^21] bf16", u16, long[:4], None, 1e-3),
    )
    for what, t, args, g0, tol in checks:
        want = fused_gather_gram_solve_reference(t, *args, g0)
        for impl in forms:
            x = fused_gather_gram_solve(t, *args, g0, gather_impl=impl)
            y = fused_gather_gram_solve(t, *args, g0, gather_impl=impl)
            torch.cuda.synchronize()
            if not torch.equal(x, y):
                raise AssertionError(f"fused {impl} {what}: two calls differ")
            errs[impl].append(max_err(x, want, tol, f"fused {impl} {what}"))
        del want
    log("phase fused checks (max_abs_err, taa / dma; two calls equal "
        "bitwise): " + "; ".join(
            f"{c[0]} {errs['taa'][k]:.2e} / {errs['dma'][k]:.2e}"
            for k, c in enumerate(checks)))

    recs = {impl: {} for impl in forms}
    for tag, t, bucket, m, iters in (
            ("", table, short, N_ITEMS, 10),
            ("bf16_", t16, short, N_ITEMS, 10),
            ("split_", users, split, N_USERS, 5),
            ("long_row_", users, long, N_USERS, 3),
            ("long_row_bf16_", u16, long, N_USERS, 3)):
        args = bucket[:4]
        fns = {impl: (functools.partial(fused_gather_gram_solve, t, *args,
                                        gather_impl=impl), iters)
               for impl in forms}
        if tag in ("", "long_row_"):
            fns["plain"] = (functools.partial(
                fused_gather_gram_solve_reference, t, *args), 1 if tag else 2)
            fns["library"] = (functools.partial(
                fused_library, torch, t, *args), 1)
        ms = interleaved_ms(fns)
        plans = {impl: fused_tile_plan(*t.shape, args[0].shape[1],
                                       t.element_size(), impl,
                                       b=args[0].shape[0], sms=sms)
                 for impl in forms}
        bnd, by = fused_bound(args[0].shape[0], bucket[4], m,
                              t.element_size())
        for impl in forms:
            recs[impl].update({tag + "ms": ms[impl],
                               tag + "segments": plans[impl].segments,
                               tag + "bound_ms": bnd, tag + "bound_by": by})
        if tag in ("", "long_row_"):
            plain, lib = ms["plain"], ms["library"]
            for impl in forms:
                recs[impl].update({tag + "plain_ms": plain,
                                   tag + "library_ms": lib})
        log(f"phase fused {tag or 'f32_'}[{args[0].shape[0]},"
            f"{args[0].shape[1]}] (segments taa {plans['taa'].segments}, "
            f"dma {plans['dma'].segments}): taa {ms['taa']:.3f} ms, dma "
            f"{ms['dma']:.3f} ms, bound {bnd:.3f} ms ({by}; taa "
            f"{ms['taa'] / bnd:.1f}x, dma {ms['dma'] / bnd:.1f}x)" + (
                f"; plain {plain:.3f} ms, library {lib:.3f} ms"
                if tag in ("", "long_row_") else ""))

    # pass 2 alone, on the heavy row's partials from the plain pass 1: in
    # 1024 segments (the shape PERF.md's kernel table tracks, timed in the
    # same turns as the plain version) and in the planner's segments
    idx, cw, bw, reg, _ = long
    parts = fused_partials_reference(users, idx, cw, bw, idx.shape[1] // 1024)
    red = reduce_case(torch, parts, reg, "heavy row")

    def wrapper():
        return fused_reduce_solve(parts, reg)

    t = interleaved_ms({
        "kernel": (wrapper, 20),
        "plain": (lambda: fused_reduce_solve_reference(parts, reg), 2)})
    red["ms"], red_plain = t["kernel"], t["plain"]
    red["host_us"] = host_us(torch, {"kernel": wrapper})["kernel"]
    # the floor at B = 1: one slice read and the one-block solve
    one = parts[:, :1].contiguous()
    solve_ms = queued_ms(torch, lambda: fused_reduce_solve(one, reg))
    del parts, one
    plan = fused_tile_plan(N_USERS, RANK, idx.shape[1], 4, "taa", b=1,
                           sms=sms)
    parts = fused_partials_reference(users, idx, cw, bw, plan.seg_len)
    heavy = reduce_case(torch, parts, reg, "heavy row, the planner's split")
    del parts
    log(f"phase fused reduce {red['shape']}: kernel {red['ms']:.4f} ms "
        f"through the wrapper (host {red['host_us']:.2f} us, device "
        f"{red['device_ms']:.4f} ms a call), plain {red_plain:.3f} ms, "
        f"bound {red['bound_ms']:.4f} ms ({red['bound_by']}), max_abs_err "
        f"{red['max_abs_err']:.3e}; the one-block solve (device, at "
        f"[1,1,{red['shape'][2]}]) {solve_ms:.4f} ms; the planner's "
        f"{heavy['shape']}: {heavy['ms']:.4f} ms (device "
        f"{heavy['device_ms']:.4f}), bound {heavy['bound_ms']:.4f} ms, "
        f"max_abs_err {heavy['max_abs_err']:.3e}")
    split_recs = reduce_at_split_shapes(torch, split_buckets, table, users)
    out = []
    for impl, line in (("taa", 368), ("dma", 500)):
        r = recs[impl]
        out.append(dict(
            name="fused_als" if impl == "taa" else "fused_als_dma",
            route="cuda", source="predictionio_tpu_torch/ops/csrc/fused_als.cu",
            replaces=f"predictionio_tpu/ops/fused_als.py:{line}",
            max_abs_err=max(errs[impl]), ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            shape=f"table[{N_ITEMS},{RANK}] f32, idx[32768,128]",
            **{k: v for k, v in r.items()
               if k not in ("ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms")}))
    out.append(dict(
        name="fused_als_reduce", route="cuda",
        source="predictionio_tpu_torch/ops/csrc/fused_als.cu",
        replaces="predictionio_tpu/ops/fused_als.py:368",
        part_of=["fused_als", "fused_als_dma"],
        max_abs_err=max(r["max_abs_err"] for r in (red, heavy, *split_recs)),
        ms=red["ms"], plain_ms=red_plain, bound_ms=red["bound_ms"],
        bound_by=red["bound_by"], library_ms=None,
        device_ms=red["device_ms"], host_us=red["host_us"],
        solve_floor_ms=solve_ms,
        shape=f"partials[1,1024,{RANK * (RANK + 1) // 2 + RANK}]",
        planner_heavy=heavy, split_shapes=split_recs))
    del table, users, t16, u16, short, split, long
    torch.cuda.empty_cache()
    return out


def host_us(torch, fns: dict, calls: int = 200, turns: int = 5) -> dict:
    """Host microseconds a call of each ``fns[name]``: the clock around
    ``calls`` calls that only enqueue (the card keeps up with them), the
    median of ``turns`` turns in which every function takes its turn,
    the order rotating.  Run it before any ``torch.profiler`` session of
    the process: once one has run, every PyTorch call costs the host
    more (:func:`phase_gather` times the host first for that reason)."""
    names = list(fns)
    host = {n: [] for n in names}
    for fn in fns.values():
        fn()
    for t in range(turns):
        for n in names[t % len(names):] + names[:t % len(names)]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[n]()
            host[n].append((time.perf_counter() - t0) / calls * 1e6)
    return {n: float(np.median(v)) for n, v in host.items()}


def device_us(torch, fn, calls: int = 200) -> float:
    """Device microseconds a call of ``fn``: ``torch.profiler`` kernel
    time over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / calls


def launch_steps_us(torch, kind: str, t, i, calls: int = 1000,
                    turns: int = 3) -> dict:
    """Host microseconds a call of each step of the ``taa0_gather``,
    ``taa1_gather`` or ``dma_row_gather`` wrapper (``kind`` "taa0",
    "taa1" or "dma") on the table ``t`` and ids ``i``, each step timed
    alone over ``calls`` calls, the median of ``turns`` turns taken in
    turns, less the cost of the timing loop itself: the device branch
    (for taa1 also as its wrapper took it in its first form,
    ``device.type`` twice), the checks, the row-copy plan (from its
    cache, and computed), the output's allocation, the three
    pointers, the current device and its stream's raw handle (and, for
    comparison, through ``torch.cuda.current_device`` and
    ``current_stream``, which builds a ``Stream`` object), packing the
    argument block, the bare ctypes call into ``pio_noop`` with the GIL
    released (the loaded library) and kept (a ``ctypes.PyDLL`` handle on
    the same library), and for comparison with the 7 arguments as a list
    (ctypes converting each), the entry point itself (packing, ctypes
    and the CUDA launch), ``launch``, the whole wrapper and the library
    call it is held against."""
    import ctypes

    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import gather_probe as gp
    from predictionio_tpu_torch.ops.fused_als import sm_count

    dev = t.device
    index = dev.index
    m, r = t.shape
    nout = i.shape[0]
    sms = sm_count(index)
    stream = torch._C._cuda_getCurrentRawStream(index)
    noop, pack_taa = _build._ENTRY["pio_noop"]
    gil_kept = ctypes.PyDLL(str(_build.BUILD_DIR / _build.LIB_NAME))
    kept = _build._declare(gil_kept, ["pio_noop"])["pio_noop"][0]
    as_list = _build.library().pio_noop_list
    as_list.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    as_list.restype = ctypes.c_int
    noop_args = (t.data_ptr(), i.data_ptr(), t.data_ptr(), m, r, 4, stream)
    block = pack_taa(*noop_args)
    if kind in ("taa0", "taa1"):
        out = torch.empty_like(t)
        i64 = i.long()
        entry = f"pio_{kind}_gather"
        args = (t.data_ptr(), i.data_ptr(), out.data_ptr(), m, r, 4)
        steps = {
            "device branch": lambda: t.is_cuda,
            "checks": lambda: gp._gather_checks(t, i, (m, r)),
            "output (empty_like)": lambda: torch.empty_like(t),
        }
        if kind == "taa0":
            wrapper = lambda: gp.taa0_gather(t, i)  # noqa: E731
            library = lambda: torch.gather(t, 0, i64)  # noqa: E731
        else:
            steps["device branch by device.type"] = lambda: (
                t.device.type == "cpu", t.device.type != "cuda")
            wrapper = lambda: gp.taa1_gather(t, i)  # noqa: E731
            library = lambda: torch.gather(t, 1, i64)  # noqa: E731
    else:
        out = t.new_empty((nout, r))
        plan = gp.dma_row_plan(r, 4, nout, True, sms)
        entry = "pio_dma_row_gather"
        args = (t.data_ptr(), i.data_ptr(), out.data_ptr(), m, nout, r, 4,
                plan.vec, plan.rows_per_group, plan.blocks, plan.smem_bytes)
        shape = (nout,)
        steps = {
            "device branch": lambda: (i.shape != shape, t.is_cuda),
            "checks": lambda: gp._gather_checks(t, i, shape),
            "plan (cached)": lambda: gp.dma_row_plan(
                r, 4, nout, t.data_ptr() % 16 == 0, sm_count(index)),
            "plan (computed)": lambda: gp.dma_row_plan.__wrapped__(
                r, 4, nout, True, sms),
            "output (new_empty)": lambda: t.new_empty((nout, r)),
        }
        wrapper = lambda: gp.dma_row_gather(t, i, nout=nout)  # noqa: E731
        library = lambda: torch.index_select(t, 0, i)  # noqa: E731
    fn, pack = _build._ENTRY[entry]
    key = {"taa0": "taa0_gather", "taa1": "taa1_gather"}.get(
        kind, "dma_row_gather")
    steps.update({
        "pointers (3 data_ptr)": lambda: (
            t.data_ptr(), i.data_ptr(), out.data_ptr()),
        "device + raw stream": lambda: (
            torch._C._cuda_getDevice() == index
            and torch._C._cuda_getCurrentRawStream(index)),
        "device + Stream object": lambda: (
            torch.cuda.current_device() == index
            and torch.cuda.current_stream(dev).cuda_stream),
        f"pack ({len(args) + 1} fields)": lambda: pack(*args, stream),
        "noop, block": lambda: noop(block),
        "noop, block, GIL kept": lambda: kept(block),
        "noop, 7 arguments": lambda: as_list(*noop_args),
        "entry point (pack + launch)": lambda: fn(pack(*args, stream)),
        "launch()": lambda: _build.launch(entry, key, dev, *args),
        "wrapper": wrapper,
        "library": library,
    })
    names = list(steps)
    times = {n: [] for n in names}
    empty = []
    for f in steps.values():
        f()
    for turn in range(turns):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            pass
        empty.append(time.perf_counter() - t0)
        for n in names[turn % len(names):] + names[:turn % len(names)]:
            f = steps[n]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                f()
            times[n].append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    loop = float(np.median(empty))
    return {n: (float(np.median(v)) - loop) / calls * 1e6
            for n, v in times.items()}


def phase_gather(torch, dev) -> list[dict]:
    """The three gather probe kernels vs their plain versions, exactly
    (a gather is a copy): f32 and bf16 tables, R in {16, 64}, the row
    copy at fewer rows than one block takes and at a count that is not a
    whole number of its runs, a table that is not 16-byte aligned (the
    row copy's 4-byte pieces), taa1 rows that are not whole 16-byte
    vectors and a taa1 table and ids one element off their start, and
    ids outside the table (NaN rows, or columns for taa1).
    Each kernel is timed at the shape its path gives it
    (preferred_order's 2,048 rows for taa0 and the row copy, smoke(64)'s
    [64, 256] for taa1) and at a shape where bytes dominate (2^20 rows
    or columns of 64 f32), beside its plain version, the library call
    (``torch.gather`` or ``torch.index_select``) and its bound: the
    bytes of the indices, of the distinct table rows (or columns) they
    name, and of the output, over 3.35 TB/s.  At the probe shape it
    adds host and device microseconds a call, and each wrapper's launch
    path step by step (:func:`launch_steps_us`); every
    host time is taken before the phase's profiler sessions.  Then
    ``preferred_order`` three times, from an empty cache each time."""
    from predictionio_tpu_torch.ops import gather_probe as gp
    from predictionio_tpu_torch.ops.fused_als import sm_count

    rng = np.random.default_rng(5)
    sms = sm_count(dev)

    def table_of(n, r, dtype):
        return torch.from_numpy(
            rng.normal(size=(n, r)).astype(np.float32)).to(dev).to(dtype)

    def ids(n, hi):
        return torch.from_numpy(
            rng.integers(0, hi, size=n).astype(np.int32)).to(dev)

    def exact(got, want, what):
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: kernel and plain version differ")

    for dtype in (torch.float32, torch.bfloat16):
        for r in (16, 64):
            n = 4099
            t = table_of(n, r, dtype)
            rows = ids(n, n)
            i0 = rows[:, None].expand(n, r).contiguous()
            exact(gp.taa0_gather(t, i0), gp.taa0_gather_reference(t, i0),
                  f"taa0 {dtype} R={r}")
            t1 = table_of(r, n, dtype)
            i1 = rows[None, :].expand(r, n).contiguous()
            exact(gp.taa1_gather(t1, i1), gp.taa1_gather_reference(t1, i1),
                  f"taa1 {dtype} R={r}")
            for nout in (3, 3001, 32771):
                rr = ids(nout, n)
                exact(gp.dma_row_gather(t, rr, nout=nout),
                      gp.dma_row_gather_reference(t, rr),
                      f"dma_row_gather {dtype} R={r} nout={nout}")
            # ids outside the table: NaN rows (columns for taa1)
            bad = rows.clone()
            bad[1::3] = n
            bad[2::3] = -1
            want = gp.dma_row_gather_reference(t, bad.clamp(0, n - 1))
            want[1::3] = float("nan")
            want[2::3] = float("nan")
            for what, got in (
                    ("dma_row_gather", gp.dma_row_gather(t, bad, nout=n)),
                    ("taa0", gp.taa0_gather(
                        t, bad[:, None].expand(n, r).contiguous()))):
                torch.cuda.synchronize()
                if not torch.equal(got.isnan(), want.isnan()) or \
                        not torch.equal(got[~got.isnan()],
                                        want[~want.isnan()]):
                    raise AssertionError(f"{what} {dtype} R={r}: ids out "
                                         "of range do not give NaN rows")
            got = gp.taa1_gather(t1, bad[None, :].expand(r, n).contiguous())
            torch.cuda.synchronize()
            if not (got[:, 1::3].isnan().all() and got[:, 2::3].isnan().all()
                    and not got[:, 0::3].isnan().any()):
                raise AssertionError(f"taa1 {dtype} R={r}: ids out of range "
                                     "do not give NaN columns")
    # a table that starts 4 bytes past an allocation: 4-byte pieces
    base = table_of(400 * RANK + 1, 1, torch.float32).view(-1)
    t = base[1:].view(400, RANK)
    rr = ids(3001, 400)
    if t.data_ptr() % 16 == 0 or gp.dma_row_plan(
            RANK, 4, 3001, False, sms).vec != 4:
        raise AssertionError("the unaligned table is not copied in 4-byte "
                             "pieces")
    exact(gp.dma_row_gather(t, rr, nout=3001),
          gp.dma_row_gather_reference(t, rr), "dma_row_gather unaligned")
    # taa1: rows whose length is not a whole number of 16-byte vectors
    # (f32 vectors hold 4 columns, bf16 vectors 8), and a table and ids
    # that start one element past their allocations (ids off the output's
    # 16-byte boundaries: one element at a time)
    for dtype in (torch.float32, torch.bfloat16):
        for r, m in ((3, 1), (5, 3), (7, 5), (64, 7), (9, 9), (16, 4100),
                     (64, 4104), (64, 4097), (2, 40_001)):
            t1 = table_of(r, m, dtype)
            i1 = torch.from_numpy(rng.integers(0, m, size=(r, m)).astype(
                np.int32)).to(dev)
            exact(gp.taa1_gather(t1, i1), gp.taa1_gather_reference(t1, i1),
                  f"taa1 {dtype} [{r},{m}]")
            tb = table_of(r * m + 1, 1, dtype).view(-1)[1:].view(r, m)
            ib = torch.from_numpy(rng.integers(0, m, size=r * m + 1).astype(
                np.int32)).to(dev)[1:].view(r, m)
            if ib.data_ptr() % 16 == 0 or tb.data_ptr() % 16 == 0:
                raise AssertionError("taa1's sliced table or ids is aligned")
            exact(gp.taa1_gather(tb, ib), gp.taa1_gather_reference(tb, ib),
                  f"taa1 {dtype} [{r},{m}] unaligned")
    probe_plan = gp.dma_row_plan(RANK, 4, PROBE_N, True, sms)
    if probe_plan.blocks < sms:
        raise AssertionError(f"row copy at the probe shape: {probe_plan} "
                             f"leaves SMs of {sms} idle")
    log(f"phase gather: taa0, taa1 and the row copy equal their plain "
        f"versions exactly (f32 and bf16, R in {{16, 64}}, the row copy at "
        f"3, 3001 and 32771 rows and from an unaligned table, taa1 at rows "
        f"of 1 to 40,001 columns that are not whole vectors and from a "
        f"table and ids one element off their start; ids out of range "
        f"give NaN); row copy plan at [{PROBE_N},{RANK}] f32: "
        f"{probe_plan} on {sms} SMs")

    def shapes(kind, n):
        """(kernel, plain, library, least bytes, table, ids) at n rows
        of 64 f32."""
        r = RANK
        if kind == "taa1":
            t = table_of(r, n, torch.float32)
            cols = ids(n, n)
            i = cols[None, :].expand(r, n).contiguous()
            i64 = i.long()
            named = torch.unique(cols).numel()
            nbytes = named * r * 4 + i.numel() * 4 + t.numel() * 4
            return (lambda: gp.taa1_gather(t, i),
                    lambda: gp.taa1_gather_reference(t, i),
                    lambda: torch.gather(t, 1, i64), nbytes, t, i)
        t = table_of(n, r, torch.float32)
        rows = ids(n, n)
        named = torch.unique(rows).numel()
        if kind == "taa0":
            i = rows[:, None].expand(n, r).contiguous()
            i64 = i.long()
            nbytes = named * r * 4 + i.numel() * 4 + t.numel() * 4
            return (lambda: gp.taa0_gather(t, i),
                    lambda: gp.taa0_gather_reference(t, i),
                    lambda: torch.gather(t, 0, i64), nbytes, t, i)
        nbytes = named * r * 4 + n * 4 + n * r * 4
        return (lambda: gp.dma_row_gather(t, rows, nout=n),
                lambda: gp.dma_row_gather_reference(t, rows),
                lambda: torch.index_select(t, 0, rows), nbytes, t, rows)

    out, probe_fns = [], []
    for name, kind, line, n_main in (
            ("taa0_gather", "taa0", 98, PROBE_N),
            ("taa1_gather", "taa1", 144, 256),
            ("dma_row_gather", "dma", 224, PROBE_N)):
        rec = dict(name=name, route="cuda",
                   source="predictionio_tpu_torch/ops/csrc/gather_probe.cu",
                   replaces=f"predictionio_tpu/ops/gather_probe.py:{line}",
                   max_abs_err=0.0)
        for tag, n, iters in (("", n_main, 200), ("big_", BIG_N, 20)):
            fn, plain, lib, nbytes, t, i = shapes(kind, n)
            exact(fn(), plain(), f"{name} n={n}")
            ms = interleaved_ms({"kernel": (fn, iters),
                                 "plain": (plain, iters),
                                 "library": (lib, iters)})
            rec[tag + "ms"] = ms["kernel"]
            rec[tag + "plain_ms"] = ms["plain"]
            rec[tag + "library_ms"] = ms["library"]
            rec[tag + "bound_ms"], rec[tag + "bound_by"] = bound(nbytes, 0)
            if not tag:
                # the probe shape: where the host's work shows
                hu = host_us(torch, {"kernel": fn, "library": lib})
                rec["host_us"], rec["library_host_us"] = \
                    hu["kernel"], hu["library"]
                rec["launch_steps_us"] = launch_steps_us(torch, kind, t, i)
                probe_fns.append((rec, fn, lib))
            rec[tag + "shape"] = (f"[{RANK},{n}]" if kind == "taa1"
                                  else f"[{n},{RANK}]") + " f32"
            del fn, plain, lib, t, i
        out.append(rec)
    # device time a call at the probe shape, after every host time; then
    # the host time once more, to show what a profiler session leaves
    for rec, fn, lib in probe_fns:
        rec["device_us"] = device_us(torch, fn)
        rec["library_device_us"] = device_us(torch, lib)
    for rec, fn, lib in probe_fns:
        hu = host_us(torch, {"kernel": fn, "library": lib})
        rec["host_us_after_profiler"] = hu["kernel"]
        rec["library_host_us_after_profiler"] = hu["library"]
    del probe_fns
    for rec in out:
        log(f"phase gather {rec['name']} (medians of 5 interleaved turns): "
            f"{rec['shape']} kernel {rec['ms']:.4f} ms (host "
            f"{rec['host_us']:.2f} us, device {rec['device_us']:.2f} us a "
            f"call; library host {rec['library_host_us']:.2f} us, device "
            f"{rec['library_device_us']:.2f} us; after the profiler ran, "
            f"host {rec['host_us_after_profiler']:.2f} us, library "
            f"{rec['library_host_us_after_profiler']:.2f} us), plain "
            f"{rec['plain_ms']:.4f} ms, library {rec['library_ms']:.4f} ms, "
            f"bound {rec['bound_ms']:.4f} ms; {rec['big_shape']} kernel "
            f"{rec['big_ms']:.4f} ms, plain {rec['big_plain_ms']:.4f} ms, "
            f"library {rec['big_library_ms']:.4f} ms, bound "
            f"{rec['big_bound_ms']:.4f} ms (bytes)")
        if "launch_steps_us" in rec:
            log(f"phase gather {rec['name']} launch steps at {rec['shape']} "
                f"(host us a call, median of 3 turns of 1000 calls, the "
                f"loop's own cost taken out): " + "; ".join(
                    f"{k} {v:.3f}" for k, v in rec["launch_steps_us"].items()))
    # the order fused_gather="auto" takes, from the card's time of the
    # probes it rests on, three times from an empty cache; cleared after,
    # so that each main path ranks the forms itself
    for tb in (4, 2):
        for k in range(3):
            gp._ORDER_CACHE.clear()
            order = gp.preferred_order(RANK, tb)
            ns = gp.PROBE_NS[(torch.cuda.get_device_name(dev), RANK, tb)]
            log(f"phase gather preferred_order({RANK}, {tb}) call {k + 1} of "
                f"3 = {order}: taa0 {ns['taa']:.3f} ns/row, row copy "
                f"{ns['dma']:.3f} ns/row (device time at n={PROBE_N})")
    gp._ORDER_CACHE.clear()
    torch.cuda.empty_cache()
    return out


def phase_small_reference(torch) -> None:
    """What comes out is right: on a small input, both kernel solvers on
    the card agree with the library (Cholesky) solver on the host, from
    the same start, within 1e-3 of the factors' scale."""
    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
    from predictionio_tpu_torch.ops.fused_als import WAVES

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


def expected_ratings(u, i, v, n_items: int):
    """The synthetic triples as the event store must give them back: ids
    through :func:`user_id` and :func:`item_id` (zero-padded, so their
    sorted order is the numeric one), each (user, item) pair deduplicated
    "last" (its last draw: event times grow with the draw), pairs in
    ascending order."""
    from predictionio_tpu_torch.storage import Ratings, StringIndex

    pair = u.astype(np.int64) * n_items + i
    order = np.argsort(pair, kind="stable")
    ps = pair[order]
    sel = order[np.r_[ps[1:] != ps[:-1], True]]
    uu, ii = u[sel], i[sel]
    users, items = np.unique(uu), np.unique(ii)
    return Ratings(
        user_ix=np.searchsorted(users, uu).astype(np.int32),
        item_ix=np.searchsorted(items, ii).astype(np.int32),
        rating=np.ascontiguousarray(v[sel], dtype=np.float32),
        users=StringIndex([user_id(k) for k in users]),
        items=StringIndex([item_id(k) for k in items]),
    )


def same_ratings(got, want, what: str) -> None:
    """Two ``Ratings`` bit for bit: the id lists and the COO arrays."""
    if list(got.users.ids) != list(want.users.ids) or \
            list(got.items.ids) != list(want.items.ids):
        raise AssertionError(f"{what}: the id lists differ")
    for f in ("user_ix", "item_ix", "rating"):
        a, b = getattr(got, f), getattr(want, f)
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: {f} differs")


# the port's log messages (their formats) that phases store and cli read
_IMPORT_LOG = ("import of %s: %d events by the native scanner, %d parsed "
               "in Python")
_READ_LOG = "read_training: %.3f s"
_ALS_LOG = "ALS trained: %s"
_SAVE_LOG = "models of instance %s saved: %.3f s"
# ... and phase eval
_EVAL_READ_LOG = "read_eval: %.3f s"
_SERVE_LOG = "eval set %d: %d queries served in %.3f s"
_CANDIDATE_LOG = ("MetricEvaluator: candidate %d/%d -> %s = %s (%.3f s: "
                  "eval %.3f s, metrics %.3f s)")


class CaptureLog(logging.Handler):
    """The port's log records of one step (the CLI's import branches,
    the training read, the ALS report, the model save), by message."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records: list[logging.LogRecord] = []

    def __enter__(self):
        logging.getLogger("predictionio_tpu_torch").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("predictionio_tpu_torch").removeHandler(self)

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)

    def args(self, msg: str) -> tuple:
        found = self.all(msg)
        if len(found) != 1:
            raise AssertionError(f"{len(found)} log records {msg!r}")
        return found[0]

    def all(self, msg: str) -> list:
        """The arguments of every record of ``msg``, in order."""
        return [r.args for r in self.records if r.msg == msg]


def trainer_form(report) -> str:
    """What one ALS report says of the fused kernel's launches: the
    resolved ``fused_gather``, the kernel's form (entry point, buckets
    that split per side) and the bucket count per side."""
    form = report["fused_form"]
    return (f"fused_gather {report['fused_gather']!r}, form "
            f"{form['kernel']} (split buckets {form['split_buckets']}), "
            f"buckets {report['buckets']}")


def _rss_gib() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**30


class PeakRss:
    """This process's resident set while a block runs, sampled every
    0.1 s by a thread: ``start_gib`` and ``peak_gib``."""

    def __enter__(self):
        self.start_gib = self.peak_gib = _rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(0.1):
            self.peak_gib = max(self.peak_gib, _rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak_gib = max(self.peak_gib, _rss_gib())


@contextlib.contextmanager
def recording(cls, name: str, sink: list):
    """While the block runs, every call of the method ``cls.name``
    appends ``(self, result)`` to ``sink`` (the phase reads what the
    console's run made: folds, models)."""
    own = cls.__dict__.get(name)
    orig = getattr(cls, name)

    @functools.wraps(orig)
    def kept(self, *args, **kw):
        out = orig(self, *args, **kw)
        sink.append((self, out))
        return out

    setattr(cls, name, kept)
    try:
        yield sink
    finally:
        if own is None:
            delattr(cls, name)
        else:
            setattr(cls, name, own)


def cli(argv: list, storage=None) -> str:
    """The port's console in this process, on the card: its stdout;
    raises unless it exits with 0."""
    from predictionio_tpu_torch.cli.main import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv, storage=storage)
    if rc != 0:
        raise AssertionError(f"{argv} exited with {rc}: {out.getvalue()}")
    return out.getvalue()


class Console:
    """``python -m predictionio_tpu_torch <argv>`` as a process on a
    store's home (``env`` adds to this process's environment), its
    output kept in a log file: started, waited for its ``--port-file``,
    stopped.  A failure prints the log."""

    def __init__(self, home, argv: list, name: str, env=None):
        from pathlib import Path

        self.log_path = Path(home) / f"{name}.log"
        self.port_file = Path(home) / f"{name}.port"
        self.port_file.unlink(missing_ok=True)
        root = str(Path(__file__).resolve().parent)
        env = {**os.environ, "PIO_TPU_HOME": str(home),
               "PYTHONPATH": root, **(env or {})}
        self.t0 = time.perf_counter()
        with open(self.log_path, "wb") as logf:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch", *argv,
                 "--port-file", str(self.port_file)],
                cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)

    def wait_port(self, timeout: float = 300.0) -> int:
        """The bound port, once the process has written it; the boot
        seconds are kept in ``boot_s``."""
        deadline = time.monotonic() + timeout
        while not (self.port_file.exists()
                   and self.port_file.read_text().endswith("\n")):
            if self.proc.poll() is not None or time.monotonic() > deadline:
                self.fail("did not announce its port")
            time.sleep(0.05)
        self.boot_s = time.perf_counter() - self.t0
        return int(self.port_file.read_text())

    def fail(self, what: str):
        raise AssertionError(
            f"{self.proc.args[3]} {what} (rc {self.proc.poll()}); its log:\n"
            + self.log_path.read_text(errors="replace")[-8000:])

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()


class StoreHome:
    """The ML-20M store of phase store: a ``$PIO_TPU_HOME`` whose event
    data is a ``sqlite-sharded`` source of ``STORE_SHARDS`` files (the
    variables of ``docs/TUTORIAL.md``; ``env``, which ``main`` also puts
    in this process's environment for the console's processes), with
    the app, its access key and its ``Storage``; it lives until phase
    eval ends."""

    def __init__(self):
        import tempfile

        from predictionio_tpu_torch.storage import Storage

        self.home = tempfile.mkdtemp(prefix="pio_ml20m_")
        self.env = {
            "PIO_TPU_HOME": self.home,
            "PIO_STORAGE_SOURCES_ML20M_TYPE": "sqlite-sharded",
            "PIO_STORAGE_SOURCES_ML20M_PATH": os.path.join(
                self.home, "eventdata-shards"),
            "PIO_STORAGE_SOURCES_ML20M_SHARDS": str(STORE_SHARDS),
            "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ML20M",
        }
        self.storage = Storage(self.env)
        self.app_id = self.key = None

    def shard_paths(self) -> list:
        from pathlib import Path

        d = Path(self.env["PIO_STORAGE_SOURCES_ML20M_PATH"])
        return [d / f"shard-{k}.db" for k in range(STORE_SHARDS)]

    def close(self) -> None:
        import shutil

        self.storage.close()
        shutil.rmtree(self.home, ignore_errors=True)


def entity_shard(entity_type: str, entity_id: str) -> int:
    """The shard an entity belongs to, by the store's documented rule
    ``crc32(type \\0 id) % shards``, computed here on its own so that a
    routing fault in the store cannot also move what it is checked
    against."""
    return zlib.crc32(f"{entity_type}\x00{entity_id}".encode(
        "utf-8", "surrogatepass")) % STORE_SHARDS


def shard_of_ids(ids, entity_type: str = "user") -> np.ndarray:
    """:func:`entity_shard` of each id."""
    return np.asarray([entity_shard(entity_type, e) for e in ids],
                      dtype=np.int64)


def expected_sharded(u, i, v, n_items: int):
    """:func:`expected_ratings` in the sharded store's order: each
    shard's ratings in the single store's (user, item) order, the shards
    one after another; the id lists are the same sorted unions."""
    from predictionio_tpu_torch.storage import Ratings

    want = expected_ratings(u, i, v, n_items)
    shard = shard_of_ids(list(want.users.ids))[want.user_ix]
    order = np.argsort(shard, kind="stable")
    return Ratings(
        user_ix=np.ascontiguousarray(want.user_ix[order]),
        item_ix=np.ascontiguousarray(want.item_ix[order]),
        rating=np.ascontiguousarray(want.rating[order]),
        users=want.users, items=want.items,
    )


def phase_store(store: StoreHome, u, i, v, keep_src: bool = False) -> dict:
    """ML-20M into the sharded event store, as a user loads it: ``app
    new`` through the port's console → the 20,000,263 synthetic ratings
    (event time ``T0_MS`` + draw ms) written as one JSON-lines file in
    chunks → the console's ``import`` (the native scanner; every line
    routed to its user's shard and written by that shard's worker
    process, one transaction a shard file; the file deleted after unless
    ``keep_src``).  Logs the sqlite bytes and the rows of each shard
    (the split of Zipf 0.8 users)."""
    import sqlite3
    from pathlib import Path

    home = Path(store.home)
    out = cli(["app", "new", "ml20m"], store.storage)
    store.key = out.split("Access key: ")[1].split()[0]
    store.app_id = store.storage.get_metadata().app_get_by_name("ml20m").id
    src = home / "ratings.jsonl"
    t0 = time.perf_counter()
    with open(src, "wb") as f:
        write_rate_lines(f, u, i, v, 0)
    write_s = time.perf_counter() - t0
    file_gb = src.stat().st_size / 1e9
    t0 = time.perf_counter()
    with CaptureLog() as records:
        out = cli(["import", "--appid", str(store.app_id), "--input",
                   str(src)], store.storage)
    import_s = time.perf_counter() - t0
    if not keep_src:
        src.unlink()
    counts = records.args(_IMPORT_LOG)[1:]
    if out != f"Imported {len(v)} events.\n" or counts != (len(v), 0):
        raise AssertionError(f"{out!r}, (native, python) branches {counts}")
    shard_gb, shard_rows = [], []
    for path in store.shard_paths():
        shard_gb.append(sum(q.stat().st_size
                            for q in path.parent.glob(path.name + "*")) / 1e9)
        with contextlib.closing(sqlite3.connect(path)) as conn:
            shard_rows.append(conn.execute(
                f"SELECT COUNT(*) FROM events_{store.app_id}").fetchone()[0])
    if sum(shard_rows) != len(v):
        raise AssertionError(f"the shards hold {shard_rows} rows")
    log(f"phase store ML-20M: {len(v):,} rate events written as JSON "
        f"lines ({file_gb:.2f} GB) in {write_s:.1f} s; console import "
        f"into the {STORE_SHARDS}-shard store {import_s:.1f} s "
        f"({len(v) / import_s:,.0f} events/s, all through the native "
        f"scanner); rows per shard {shard_rows} (largest / mean "
        f"{max(shard_rows) * STORE_SHARDS / len(v):.3f}); sqlite GB per "
        f"shard {[round(g, 3) for g in shard_gb]} ({sum(shard_gb):.2f} GB)")
    return {"import_s": import_s, "rows": shard_rows, "src": src}


def _same_shard_rows(a, b, app_id: int) -> int:
    """Rows of shard file ``a`` that equal shard file ``b``'s row of the
    same rowid in every column but the event id and the creation time
    (each import draws its own); raises unless that is every row of
    both files."""
    import sqlite3

    t = f"events_{app_id}"
    cols = ("event", "entity_type", "entity_id", "target_entity_type",
            "target_entity_id", "properties", "event_time", "tags",
            "pr_id")
    same = " AND ".join(f"x.{c} IS y.{c}" for c in cols)
    with contextlib.closing(sqlite3.connect(a)) as conn:
        conn.execute("ATTACH DATABASE ? AS other", (str(b),))
        n_a = conn.execute(f"SELECT COUNT(*) FROM main.{t}").fetchone()[0]
        n_b = conn.execute(f"SELECT COUNT(*) FROM other.{t}").fetchone()[0]
        n = conn.execute(
            f"SELECT COUNT(*) FROM main.{t} x JOIN other.{t} y "
            f"ON x.rowid = y.rowid WHERE {same}").fetchone()[0]
    if not n == n_a == n_b:
        raise AssertionError(f"shard {a} against {b}: {n} equal rows of "
                             f"{n_a} and {n_b}")
    return n


# the sizes of the file's heads the writer A/B also imports both ways:
# they place the cutoff below which the JSON-lines import stays in one
# process (``tools/import_export.py`` ``_PROCESS_MIN_BYTES``)
AB_HEAD_MIB = (4, 16, 32, 64, 128, 256)


def _import_fresh(src, d, app_id: int, processes: bool):
    """``src`` through ``import_events`` into a fresh 4-shard store at
    ``d``: by a worker process a shard at any size (``processes``), or
    every shard on this thread (the store then offers no shard files to
    the workers).  Returns (seconds, events, the import's counts)."""
    from unittest import mock

    from predictionio_tpu_torch.storage import ShardedSQLiteEventStore
    from predictionio_tpu_torch.tools import import_export

    es = ShardedSQLiteEventStore(d, STORE_SHARDS)
    try:
        if not processes:
            es.import_shard_files = lambda: None
        counts = {}
        with mock.patch.object(import_export, "_PROCESS_MIN_BYTES", 0):
            t0 = time.perf_counter()
            n = import_export.import_events(src, es, app_id, counts=counts)
            secs = time.perf_counter() - t0
    finally:
        es.close()
    return secs, n, counts


def _same_stores(a, b, app_id: int) -> list:
    """Every shard of the store directory ``a`` holds shard file ``b[k]``'s
    rows, rowid for rowid (:func:`_same_shard_rows`); the rows a shard."""
    from pathlib import Path

    with ThreadPoolExecutor(STORE_SHARDS) as ex:
        return list(ex.map(
            lambda k: _same_shard_rows(Path(a) / f"shard-{k}.db", b[k],
                                       app_id),
            range(STORE_SHARDS)))


def store_writer_ab(store: StoreHome, src, n_events: int,
                    console_s: float) -> dict:
    """The JSON-lines import by one writer against a worker process a
    shard, on the file phase store imported (``console_s`` its time
    through the console, by the workers), each into a fresh 4-shard
    store, one store at a time: the whole file, whose every arm's shards
    must hold phase store's rows rowid for rowid (every column but the
    event id and the creation time), and heads of ``AB_HEAD_MIB``,
    where the two arms' shards must hold the same rows.  Each store is
    removed after its turn."""
    import shutil
    import tempfile
    from pathlib import Path

    def arm(path, processes: bool, want: int | None, like):
        d = Path(tempfile.mkdtemp(prefix="pio_writer_ab_"))
        try:
            secs, n, counts = _import_fresh(path, d, store.app_id,
                                            processes)
            if (want is not None and n != want) or counts["python"]:
                raise AssertionError(f"{path} by "
                                     f"{'processes' if processes else 'one'}"
                                     f": {n} events, {counts}")
            if like is None:
                return secs, n, d
            _same_stores(d, like, store.app_id)
            shutil.rmtree(d, ignore_errors=True)
            return secs, n, None
        except BaseException:
            shutil.rmtree(d, ignore_errors=True)
            raise

    heads = {}
    tmp = Path(tempfile.mkdtemp(prefix="pio_writer_heads_"))
    try:
        with open(src, "rb") as fh:
            whole = fh.read((AB_HEAD_MIB[-1] << 20) + (1 << 20))
        for mib in AB_HEAD_MIB:
            cut = whole.rindex(b"\n", 0, mib << 20) + 1
            head = tmp / f"head-{mib}.jsonl"
            head.write_bytes(whole[:cut])
            one_s, n, one_dir = arm(head, False, None, None)
            try:
                proc_s, _, _ = arm(head, True, n, [
                    one_dir / f"shard-{k}.db" for k in range(STORE_SHARDS)])
            finally:
                shutil.rmtree(one_dir, ignore_errors=True)
            heads[mib] = {"events": n, "one": round(one_s, 3),
                          "processes": round(proc_s, 3)}
            log(f"phase store writers head {mib} MiB ({n:,} events): one "
                f"writer {one_s:.3f} s, a process a shard {proc_s:.3f} s; "
                "the same rows rowid for rowid")
        del whole
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = {"processes (phase store, console)": console_s}
    for name, processes in (("one", False), ("processes", True)):
        secs[name], _, _ = arm(src, processes, n_events,
                               store.shard_paths())
    log(f"phase store writers ML-20M: JSON-lines import of {n_events:,} "
        f"events into a fresh {STORE_SHARDS}-shard store, seconds "
        f"{ {k: round(t, 1) for k, t in secs.items()} }; every arm's "
        f"shards equal phase store's rowid for rowid")
    return {"whole": secs, "heads": heads}


def phase_read(store: StoreHome, u, i, v):
    """The store's training read at ML-20M: ``find_ratings`` as the
    template's data source calls it, with the scan cache on (the
    snapshots phase cli's training read finds), after phase fleet posted
    the items' ``$set`` events.  Every shard must take the native scan,
    the four at once; the result is held bit for bit against
    :func:`expected_sharded` (the draws' pairs are distinct, so every
    rating must come back).  Logs the read's seconds, each shard's own
    (its scan and encode on its thread) and the dictionary merge's.
    Returns the store's ``Ratings``."""
    es = store.storage.get_event_store()
    t0 = time.perf_counter()
    ratings = es.find_ratings(store.app_id, entity_type="user", cache=True)
    read_s = time.perf_counter() - t0
    paths = [s.last_ratings_scan_path for s in es.shards]
    if paths != ["native"] * STORE_SHARDS:
        raise AssertionError(
            f"find_ratings took the branches {paths} "
            f"({[s.last_ratings_scan_reason for s in es.shards]})")
    t0 = time.perf_counter()
    same_ratings(ratings, expected_sharded(u, i, v, N_ITEMS),
                 "ML-20M from the sharded store")
    if len(ratings.rating) != len(v):
        raise AssertionError(
            f"the store gave back {len(ratings.rating):,} of "
            f"{len(v):,} distinct ratings")
    check_s = time.perf_counter() - t0
    shard_s = es.last_ratings_shard_seconds
    log(f"phase read ML-20M: find_ratings {read_s:.1f} s with the scan "
        f"cache on, the {STORE_SHARDS} shards at once (each shard's "
        f"last_ratings_scan_path 'native'): seconds per shard "
        f"{[round(t, 1) for t in shard_s]} (slowest {max(shard_s):.1f} s), "
        f"merge {es.last_ratings_merge_seconds:.2f} s; "
        f"{len(ratings.rating):,} ratings ({ratings.n_users:,} users x "
        f"{ratings.n_items:,} items), equal to the synthetic triples in "
        f"the shards' order ({check_s:.1f} s)")
    return ratings


def _call(conn, method: str, path: str, body=None) -> tuple:
    """One request on a keep-alive ``http.client`` connection:
    ``(status, JSON reply, Retry-After)``."""
    conn.request(method, path, None if body is None else json.dumps(body),
                 {"Content-Type": "application/json"})
    r = conn.getresponse()
    return r.status, json.loads(r.read()), r.getheader("Retry-After")


def _pid_alive(pid: int) -> bool:
    """True while ``pid`` runs (a zombie awaiting its parent counts as
    dead)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _pids_with(text: str) -> list:
    """Every live process whose command line holds ``text``."""
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    cmd = f.read().decode(errors="replace")
            except OSError:
                continue
            if text in cmd and _pid_alive(int(d)):
                out.append(int(d))
    return out


def _stats_total(stats: dict) -> int:
    cur = stats.get("currentHour") or {}
    return sum(r["count"] for r in cur.get("statusCount", []))


def _structured_503(answer, shard: int) -> bool:
    status, body, retry = answer[:3]
    return (status == 503 and body.get("error") == "ShardUnavailable"
            and body.get("shard") == shard and bool(retry))


def fleet_chaos(port: int, store: StoreHome, workers: list) -> dict:
    """The five checks of ``tools/ingest_smoke.py`` on the fleet, on an
    app of its own (``app new chaos``: the ML-20M app's tables are not
    touched), with ``CHAOS_CLIENTS`` keep-alive clients posting single
    rate events:

    1. ``steady_all_acked``: a load with every worker up answers 201 for
       every event, and every worker owned some of them;
    2. ``healthy_zero_errors``: worker 1 is SIGKILLed when a third of a
       second load has been answered; every event of the other workers'
       shards still answers 201;
    3. ``dead_structured_503``: the dead owner's events answer 201 or a
       structured 503 (``ShardUnavailable``, the event's shard, a
       ``Retry-After``), at least one 503; a mixed batch posted just
       after the kill answers by position;
    4. ``stats_monotone``: the federated ``/stats.json``, polled through
       the load, reports all four workers and its total never goes down,
       and it saw the worker down;
    5. ``zero_acked_loss``: the supervisor respawns the worker on its
       WAL directory; then every event id ever answered 201 reads back
       through the router.

    Returns the checks, the respawn seconds and the rows the respawned
    worker replayed from its WAL."""
    import http.client
    import re
    import signal

    out = cli(["app", "new", "chaos"], store.storage)
    key = out.split("Access key: ")[1].split()[0]
    victim = workers[1]
    vix, vpid = victim["index"], victim["pid"]

    def shard(u: str) -> int:
        return entity_shard("user", u)

    def owner(u: str) -> int:
        return shard(u) % FLEET_WORKERS

    def rate(u: str) -> dict:
        return {"event": "rate", "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": item_id(1),
                "properties": {"rating": 4.0},
                "eventTime": "2015-02-01T00:00:00.000Z"}

    def load(users: list, at_a_third=None) -> list:
        """Each user's event from CHAOS_CLIENTS clients in turn:
        ``(status, reply, Retry-After, posted after at_a_third ran)``;
        ``at_a_third`` runs once, when a third of the answers are in."""
        lock = threading.Lock()
        answered = [0]
        started = threading.Event()
        done = threading.Event()
        results = [None] * len(users)

        def run(c: int) -> None:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
            try:
                for k in range(c, len(users), CHAOS_CLIENTS):
                    after = done.is_set()
                    results[k] = (*_call(conn, "POST",
                                         f"/events.json?accessKey={key}",
                                         rate(users[k])), after)
                    with lock:
                        answered[0] += 1
                        fire = (at_a_third is not None
                                and answered[0] >= len(users) // 3
                                and not started.is_set())
                        if fire:
                            started.set()
                    if fire:
                        at_a_third()
                        done.set()
            finally:
                conn.close()

        with ThreadPoolExecutor(max_workers=CHAOS_CLIENTS) as pool:
            list(pool.map(run, range(CHAOS_CLIENTS)))
        return results

    checks, acked = {}, []
    n = CHAOS_CLIENTS * CHAOS_EVENTS
    steady_users = [f"s{k}" for k in range(n)]
    steady = load(steady_users)
    acked += [r[1]["eventId"] for r in steady if r[0] == 201]
    checks["steady_all_acked"] = (
        len(acked) == n
        and {owner(u) for u in steady_users} == set(range(FLEET_WORKERS)))

    samples, msamples = [], []
    polling = threading.Event()

    def poll_stats() -> None:
        from predictionio_tpu_torch.obs.fleet import (
            parse_prometheus, state_counter_total,
        )

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            while not polling.is_set():
                st, body, _ = _call(conn, "GET",
                                    f"/stats.json?accessKey={key}")
                if st != 200:
                    samples.append((st, None, None, None))
                else:
                    w = body["workers"]
                    samples.append((st, _stats_total(body), w["reporting"],
                                    w["healthy"]))
                # the federated exposition through the death (fleet_smoke)
                conn.request("GET", "/metrics")
                r = conn.getresponse()
                text = r.read().decode()
                try:
                    total = state_counter_total(parse_prometheus(text),
                                                "pio_events_requests_total")
                except ValueError:
                    total = None
                msamples.append((r.status, total))
                time.sleep(0.05)
        finally:
            conn.close()

    dead_users = [u for u in (f"m{k}" for k in range(200))
                  if owner(u) == vix][:2]
    live_users = [u for u in (f"m{k}" for k in range(200))
                  if owner(u) != vix][:2]
    mixed_users = [dead_users[0], live_users[0], dead_users[1],
                   live_users[1]]
    kill = {}

    def sigkill() -> None:
        os.kill(vpid, signal.SIGKILL)
        kill["t"] = time.perf_counter()
        while _pid_alive(vpid):
            time.sleep(0.001)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            kill["batch"] = _call(conn, "POST",
                                  f"/batch/events.json?accessKey={key}",
                                  [rate(u) for u in mixed_users])
        finally:
            conn.close()

    poller = threading.Thread(target=poll_stats, daemon=True)
    poller.start()
    time.sleep(0.2)
    chaos_users = [f"k{k}" for k in range(n)]
    chaos = load(chaos_users, at_a_third=sigkill)
    time.sleep(0.2)
    polling.set()
    poller.join(timeout=60)

    healthy = [r for u, r in zip(chaos_users, chaos) if owner(u) != vix]
    dead = [(u, r) for u, r in zip(chaos_users, chaos) if owner(u) == vix]
    acked += [r[1]["eventId"] for r in chaos if r[0] == 201]
    checks["healthy_zero_errors"] = bool(healthy) and all(
        r[0] == 201 for r in healthy)
    st, body, retry = kill["batch"]
    batch_ok = (
        st == 200 and bool(retry)
        and [r["status"] for r in body] == [503, 201, 503, 201]
        and all(_structured_503((r["status"], r, retry), shard(u))
                for u, r in zip(mixed_users, body) if r["status"] == 503))
    acked += [r["eventId"] for r in body if r.get("status") == 201]
    refused = [r for u, r in dead if r[0] != 201]
    checks["dead_structured_503"] = (
        batch_ok and bool(refused)
        and all(_structured_503(r, shard(u)) for u, r in dead
                if r[0] != 201)
        and any(r[3] for r in refused))
    totals = [t for st, t, _, _ in samples if st == 200]
    checks["stats_monotone"] = (
        len(totals) == len(samples) > 2
        and all(b >= a for a, b in zip(totals, totals[1:]))
        and all(rep == FLEET_WORKERS for _, _, rep, _ in samples)
        and any(h == FLEET_WORKERS - 1 for _, _, _, h in samples))

    # the supervisor respawns the worker on its WAL directory
    deadline = time.monotonic() + 180
    while True:
        status = _http(port, "/")
        if (status["supervisor"]["respawns"] >= 1
                and status["workers"][vix]["healthy"]):
            break
        if time.monotonic() > deadline:
            raise AssertionError(f"worker {vix} never came back: {status}")
        time.sleep(0.05)
    respawn_s = time.perf_counter() - kill["t"]
    m = re.search(r"ingest WAL replay: (\d+) records",
                  open(victim["log"]).read())
    replayed = int(m.group(1)) if m else 0

    def read_back(part: list) -> list:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        missing = []
        try:
            for eid in part:
                for _ in range(50):
                    # a read may land on a worker other than the owner:
                    # allow it one group-commit drain
                    conn.request("GET", f"/events/{eid}.json?accessKey={key}")
                    r = conn.getresponse()
                    r.read()
                    if r.status == 200:
                        break
                    time.sleep(0.02)
                else:
                    missing.append(eid)
        finally:
            conn.close()
        return missing

    with ThreadPoolExecutor(max_workers=CHAOS_CLIENTS) as pool:
        missing = sum(pool.map(read_back, [acked[c::CHAOS_CLIENTS]
                                           for c in range(CHAOS_CLIENTS)]),
                      [])
    checks["zero_acked_loss"] = bool(acked) and not missing
    from predictionio_tpu_torch.obs.fleet import (
        parse_prometheus, state_counter_total,
    )

    mtotals = [t for st, t in msamples if st == 200 and t is not None]
    scrape_errors = state_counter_total(
        parse_prometheus(_raw(port, "/metrics")[1].decode()),
        "pio_replica_scrape_errors_total")
    obs = {
        "federated_metrics_parse": len(mtotals) == len(msamples) > 2,
        "federated_metrics_monotone": all(
            b >= a for a, b in zip(mtotals, mtotals[1:])),
        "replica_scrape_errors_booked": scrape_errors > 0,
    }
    return {"checks": checks, "obs": obs, "obs_detail": {
                "metrics_samples": len(msamples),
                "events_total": mtotals[-1] if mtotals else None,
                "scrape_errors": scrape_errors},
            "respawn_s": respawn_s, "replayed": replayed,
            "acked": len(acked), "missing": len(missing),
            "refused": len(refused), "healthy": len(healthy),
            "stats_samples": len(samples)}


def phase_fleet(store: StoreHome) -> dict:
    """The multi-process ingest fleet on the ML-20M store: ``python -m
    predictionio_tpu_torch eventserver --workers 4 --wal-dir DIR --port
    0`` (the ingest router in that process, four shard-owner worker
    processes, one shard each, every worker with its WAL under DIR) →
    the items' ``$set`` category events (26,744, in batches of 50 from
    one keep-alive client) through the router, every status 201, then
    an entity-scoped read per shard, which the owner answers after its
    WAL barrier (every acknowledged row committed) → the chaos check on
    an app of its own (:func:`fleet_chaos`) → ``POST /stop``: the fleet
    process must exit with 0 and no worker may outlive it.  No worker
    may hold the card (``nvidia-smi --query-compute-apps``)."""
    import re
    import sqlite3
    from pathlib import Path

    wal_dir = Path(store.home) / "fleet-wal"
    # the router and every worker journal their spans here
    journal = Path(store.home) / "fleet-telemetry"
    fleet = Console(store.home, [
        "eventserver", "--workers", str(FLEET_WORKERS), "--wal-dir",
        str(wal_dir), "--ip", "127.0.0.1", "--port", "0"], "fleet",
        env={"PIO_TPU_TELEMETRY_DIR": str(journal)})
    try:
        port = fleet.wait_port(timeout=300)
        pattern = re.compile(
            r"Ingest worker (\d+) \(pid (\d+)\) up on 127\.0\.0\.1:(\d+) "
            r"owning shards \[([\d, ]*)\] in ([\d.]+) s \(log: (.+)\)$")
        workers = [{"index": int(m[1]), "pid": int(m[2]), "port": int(m[3]),
                    "shards": m[4], "boot_s": float(m[5]), "log": m[6]}
                   for m in map(pattern.match,
                                fleet.log_path.read_text().splitlines())
                   if m]
        status = _http(port, "/")
        if (len(workers) != FLEET_WORKERS
                or status["healthyWorkers"] != FLEET_WORKERS
                or status["nShards"] != STORE_SHARDS):
            fleet.fail(f"booted workers {workers}, status {status}")
        coord = str(Path(workers[0]["log"]).parent)
        gpu_pids = subprocess.run(
            ["nvidia-smi", "--query-compute-apps=pid",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.split()
        if {str(w["pid"]) for w in workers} & set(gpu_pids):
            fleet.fail(f"a worker holds the card: {gpu_pids}")

        sets = [{"event": "$set", "entityType": "item",
                 "entityId": item_id(j),
                 "properties": {"categories": ["even" if j % 2 == 0
                                               else "odd"]},
                 "eventTime": "2014-12-31T00:00:00.000Z"}
                for j in range(N_ITEMS)]
        t0 = time.perf_counter()
        replies = _post_all(port, f"/batch/events.json?accessKey={store.key}",
                            [sets[k:k + 50] for k in range(0, N_ITEMS, 50)],
                            1)
        post_s = time.perf_counter() - t0
        if any(st != 200 or any(e["status"] != 201 for e in r)
               for st, r in replies):
            fleet.fail("refused an item $set event")
        # phase engines' unavailable-items constraint goes in now, before
        # phase read stores the ratings' scan-cache snapshots: written
        # later to the same app, it would outdate its shard's snapshot,
        # and every train after it would scan that shard again
        status = _raw(port, f"/events.json?accessKey={store.key}",
                      unavailable_set())[0]
        if status != 201:
            fleet.fail(f"answered the constraint $set with {status}")
        item_shard = shard_of_ids([item_id(j) for j in range(64)], "item")
        for k in range(STORE_SHARDS):
            j = int(np.flatnonzero(item_shard == k)[0])
            _http(port, f"/events.json?accessKey={store.key}&entityType="
                        f"item&entityId={item_id(j)}&limit=1")
        n_sets = 0
        for path in store.shard_paths():
            with contextlib.closing(sqlite3.connect(path)) as conn:
                n_sets += conn.execute(
                    f"SELECT COUNT(*) FROM events_{store.app_id} "
                    "WHERE event = '$set' AND entity_type = 'item'"
                ).fetchone()[0]
        if n_sets != N_ITEMS:
            fleet.fail(f"the store holds {n_sets} of {N_ITEMS} $set events")
        federated = obs_fleet_federation(port, workers, journal, store)

        chaos = fleet_chaos(port, store, workers)
        _http(port, "/stop", {})
        try:
            rc = fleet.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            fleet.fail("did not stop after POST /stop")
        if rc != 0:
            fleet.fail("exited after POST /stop")
        left = _pids_with(coord)
        if left:
            fleet.fail(f"left worker processes {left} running")
        if Path(coord).exists():
            fleet.fail(f"left its directory {coord} after a clean stop")
    finally:
        fleet.stop()
    obs_report("fleet chaos", chaos["obs"], chaos["obs_detail"])
    ok = all(chaos["checks"].values()) and len(chaos["checks"]) == 5
    log(f"phase fleet: eventserver --workers {FLEET_WORKERS} (a router "
        f"and {FLEET_WORKERS} shard-owner processes, shards "
        f"{[w['shards'] for w in workers]}) booted in {fleet.boot_s:.1f} s "
        f"(workers at {[w['boot_s'] for w in workers]} s; none on the "
        f"card); {N_ITEMS:,} item $set events through the router in "
        f"{post_s:.2f} s ({N_ITEMS / post_s:,.0f} events/s, every status "
        f"201, all {n_sets:,} in the store); chaos on app 'chaos', "
        f"{CHAOS_CLIENTS} keep-alive clients: checks {chaos['checks']}; "
        f"worker 1 SIGKILLed, respawned and healthy in "
        f"{chaos['respawn_s']:.2f} s, {chaos['replayed']} rows replayed "
        f"from its WAL; {chaos['acked']} acknowledged event ids, "
        f"{chaos['missing']} missing; {chaos['refused']} dead-shard "
        f"events answered 503, {chaos['healthy']} healthy-shard events "
        f"all 201; {chaos['stats_samples']} federated stats samples; the "
        f"fleet exited 0 after POST /stop and left no worker and no "
        f"directory")
    if not ok:
        raise AssertionError(f"phase fleet: a chaos check failed: "
                             f"{chaos['checks']}")
    down = obs_shard_down()
    return {"boot_s": fleet.boot_s, "sets_per_s": N_ITEMS / post_s,
            "federated": federated, "shard_down": down, **chaos}


def phase_sort(ratings, u, i, v, turns: int = 1) -> None:
    """Staging's host sort at ML-20M: the native counting sort
    (``sort_coo_by_row``, by user, as ``_stage_device`` calls it) against
    its plain version, the stable NumPy argsort, on the store's
    ``Ratings`` (the main path's input: the store gives them in (user,
    item) order within each shard) and on the same triples in draw order
    (the order the trainers took them in from memory before they read
    the store).  Outputs equal bit for bit; host seconds of one turn
    (the median of ``turns`` turns in which each runs once, the order
    alternating)."""
    from predictionio_tpu_torch.native import (
        sort_coo_by_row, sort_coo_by_row_numpy,
    )

    inputs = {
        "store order": (ratings.user_ix, ratings.item_ix, ratings.rating,
                        ratings.n_users),
        "draw order": (u, i, v, N_USERS),
    }
    sorts = [("native", sort_coo_by_row), ("numpy", sort_coo_by_row_numpy)]
    for what, args in inputs.items():
        secs = {name: [] for name, _ in sorts}
        out = {}
        for turn in range(turns):
            for name, fn in (sorts if turn % 2 == 0 else sorts[::-1]):
                t0 = time.perf_counter()
                out[name] = fn(*args)
                secs[name].append(time.perf_counter() - t0)
        for a, b in zip(out["native"], out["numpy"]):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(
                    f"sort_coo_by_row differs from the plain version "
                    f"({what})")
        med = {name: float(np.median(t)) for name, t in secs.items()}
        log(f"phase sort ML-20M {what} ({len(args[2]):,} ratings by user): "
            f"native counting sort {med['native']:.3f} s, NumPy stable "
            f"argsort {med['numpy']:.3f} s "
            f"({med['numpy'] / med['native']:.1f}x), bit for bit equal "
            f"({'one turn' if turns == 1 else f'median of {turns} turns'})")


def engine_over(ratings, items):
    """The recommendation engine's own components with a data source
    that hands over the ratings phase read took from the event store
    (``find_ratings``, the call the template's data source makes), so
    that the store is filled and read once for the three trainers."""
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
        f"{wall:.1f} s, "
        f"{trainer_form(rep) if solver == 'fused' else rep['buckets']}, "
        f"staging ({rep['staging']}, native counting sort) "
        f"{rep['staging_seconds']:.2f} s, halves [{halves}], sweep losses "
        f"{[round(x, 5) for x in rep['sweep_losses']]}, training RMSE "
        f"{train_rmse:.5f}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    zero_rmse = float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
    if not (math.isfinite(train_rmse) and train_rmse < zero_rmse):
        raise AssertionError(
            f"training RMSE {train_rmse} does not beat the zero model "
            f"({zero_rmse})")
    if model.user_factors.shape != (ratings.n_users, RANK) or \
            model.item_factors.shape != (ratings.n_items, RANK):
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
    solo = [Query(user=user_id(k), num=10) for k in range(6)]
    solo.append(Query(user=user_id(7), num=10, categories=("even",)))
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
    evens = {item_id(j) for j in range(0, N_ITEMS, 2)}
    if not all(s.item in evens for s in answers[6].item_scores):
        raise AssertionError("the category filter let an odd item through")
    batch = solo + [Query(user=user_id(k), num=10) for k in range(100, 156)]
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


def _post_timed(port: int, path: str, bodies, clients: int) -> list:
    """POST each body to ``path`` from ``clients`` threads, each over one
    keep-alive connection; returns ``(status, reply, ms)`` in body
    order."""
    import http.client

    def run(part):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        out = []
        try:
            for body in part:
                t0 = time.perf_counter()
                conn.request("POST", path, json.dumps(body),
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                reply = json.loads(r.read())
                out.append((r.status, reply,
                            (time.perf_counter() - t0) * 1e3))
        finally:
            conn.close()
        return out

    parts = [bodies[c::clients] for c in range(clients)]
    with ThreadPoolExecutor(max_workers=clients) as pool:
        done = list(pool.map(run, parts))
    out = [None] * len(bodies)
    for c, part in enumerate(done):
        out[c::clients] = part
    return out


def _post_all(port: int, path: str, bodies, clients: int) -> list:
    """:func:`_post_timed` without the times: ``(status, reply)``."""
    return [(st, r) for st, r, _ in _post_timed(port, path, bodies, clients)]


def query_mix(n: int, seed: int, n_users: int, n_items: int) -> list:
    """``n`` serving queries from a seed, num 10, in turn: plain, with a
    category filter, a white list of 50 items, a black list of 20."""
    rng = np.random.default_rng(seed)
    items = [item_id(j) for j in range(n_items)]
    out = []
    for k in range(n):
        q = {"user": user_id(rng.integers(0, n_users)), "num": 10}
        if k % 4 == 1:
            q["categories"] = ["even"]
        elif k % 4 == 2:
            q["whiteList"] = list(rng.choice(items, 50, replace=False))
        elif k % 4 == 3:
            q["blackList"] = list(rng.choice(items, 20, replace=False))
        out.append(q)
    return out


def ingest_ml1m(storage, app_id: int, u, i, v) -> dict:
    """The ML-1M-shaped events through the user's two entry points, each
    event with an explicit ``eventTime``: the REST event server (default
    config) takes the 3,706 item ``$set`` events (32 as solo ``POST
    /events.json``, the rest as ``POST /batch/events.json`` of 50); a
    second event server on the same store, with the group-commit WAL,
    takes the first 50,000 rate events as batches of 50 from 8
    concurrent clients (every status must be 201; ``barrier()`` before
    the read); ``import_events`` loads the remaining rate events from a
    JSON-lines file.  Returns each entry point's seconds."""
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.storage import AccessKey
    from predictionio_tpu_torch.tools import import_events

    md = storage.get_metadata()
    key = md.access_key_insert(AccessKey(key="", appid=app_id))
    sets = [{"event": "$set", "entityType": "item", "entityId": item_id(j),
             "properties": {"categories": ["even" if j % 2 == 0 else "odd"]},
             "eventTime": "2014-12-31T00:00:00.000Z"}
            for j in range(ML1M_ITEMS)]
    out = {}

    srv = EventServer(storage, EventServerConfig(host="127.0.0.1", port=0))
    srv.start_background()
    try:
        t0 = time.perf_counter()
        solo = _post_all(srv.port, f"/events.json?accessKey={key}",
                         sets[:32], 1)
        out["solo_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        batched = _post_all(srv.port, f"/batch/events.json?accessKey={key}",
                            [sets[s:s + 50] for s in range(32, len(sets), 50)],
                            1)
        out["set_batches_s"] = time.perf_counter() - t0
    finally:
        srv.stop()
    if any(st != 201 for st, _ in solo) or any(
            st != 200 or any(e["status"] != 201 for e in r)
            for st, r in batched):
        raise AssertionError("the event server refused a $set event")

    n_http = 50_000
    wal_dir = Path(tempfile.mkdtemp(prefix="pio_wal_"))
    srv = EventServer(storage, EventServerConfig(
        host="127.0.0.1", port=0, wal_dir=str(wal_dir)))
    srv.start_background()
    try:
        rates = [rate_line(a, b, r, k) for k, (a, b, r) in enumerate(zip(
            u[:n_http].tolist(), i[:n_http].tolist(), v[:n_http].tolist()))]
        t0 = time.perf_counter()
        replies = _post_all(
            srv.port, f"/batch/events.json?accessKey={key}",
            [rates[s:s + 50] for s in range(0, n_http, 50)], 8)
        out["wal_post_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        srv.barrier()
        out["wal_barrier_s"] = time.perf_counter() - t0
    finally:
        srv.stop()
        import shutil

        shutil.rmtree(wal_dir, ignore_errors=True)
    statuses = [e["status"] for st, r in replies for e in r]
    if any(st != 200 for st, _ in replies) or statuses != [201] * n_http:
        raise AssertionError("the group-commit event server refused a rate "
                             "event")

    es = storage.get_event_store()
    src = Path(tempfile.mkdtemp(prefix="pio_import_")) / "ratings.jsonl"
    try:
        with open(src, "wb") as f:
            write_rate_lines(f, u[n_http:], i[n_http:], v[n_http:], n_http)
        counts = {}
        t0 = time.perf_counter()
        n = import_events(src, es, app_id, counts=counts)
        out["import_s"] = time.perf_counter() - t0
    finally:
        src.unlink(missing_ok=True)
        src.parent.rmdir()
    if n != len(v) - n_http or counts["python"]:
        raise AssertionError(f"imported {n} events, branches {counts}")
    log(f"phase pio ingest: event server {ML1M_ITEMS:,} $set events (32 solo "
        f"POST /events.json in {out['solo_s']:.2f} s, "
        f"{32 / out['solo_s']:,.0f} events/s; the rest in "
        f"{len(batched)} batches in {out['set_batches_s']:.2f} s, "
        f"{(ML1M_ITEMS - 32) / out['set_batches_s']:,.0f} events/s); "
        f"group-commit event server {n_http:,} rate events in "
        f"{n_http // 50:,} batches from 8 clients in "
        f"{out['wal_post_s']:.2f} s ({n_http / out['wal_post_s']:,.0f} "
        f"events/s, every status 201), barrier {out['wal_barrier_s']:.2f} "
        f"s; import_events {n:,} rate events in {out['import_s']:.2f} s "
        f"({n / out['import_s']:,.0f} events/s, branches {counts})")
    return out


def phase_pio(torch, cli_views: dict) -> dict:
    """The event-store path, as a user runs it: a fresh ``$PIO_TPU_HOME``,
    an app, MovieLens-1M-shaped rate events (6,040 users x 3,706 items x
    1,000,209 ratings, seed 0) and a ``$set`` of categories for every
    item through the event server and ``import_events``
    (:func:`ingest_ml1m`) → the training read, native against the
    Python branch → ``run_train`` (rank 64,
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

    from predictionio_tpu_torch.controller import (
        Engine, IdentityPreparator, WorkflowContext,
    )
    from predictionio_tpu_torch.ops import _build, gather_probe
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.storage import Storage, reset_storage
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
        ingest = ingest_ml1m(storage, app.id, u, i, v)
        # the training read, both branches: the native fused scan (the
        # one the data source takes) and the Python one
        t0 = time.perf_counter()
        got = es.find_ratings(app.id)
        native_s = time.perf_counter() - t0
        if es.last_ratings_scan_path != "native":
            raise AssertionError(
                f"find_ratings took the {es.last_ratings_scan_path} branch "
                f"({es.last_ratings_scan_reason})")
        t0 = time.perf_counter()
        plain = es.find_columnar(
            app.id, event_names=["rate"], float_property="rating",
            minimal=True).to_ratings(rating_property="rating", dedup="last")
        python_s = time.perf_counter() - t0
        same_ratings(got, plain, "ML-1M native against the Python branch")
        same_ratings(got, expected_ratings(u, i, v, ML1M_ITEMS),
                     "ML-1M from the store")
        log(f"phase pio read: find_ratings native {native_s:.2f} s "
            f"(last_ratings_scan_path {es.last_ratings_scan_path!r}), "
            f"Python branch {python_s:.2f} s, bit for bit equal; "
            f"{len(got.rating):,} ratings after dedup 'last', equal to the "
            f"synthetic triples deduplicated")

        def variant(**algo):
            return engine.params_from_variant({
                "datasource": {"params": {"appName": "ml1m"}},
                "algorithms": [{"name": "als", "params": dict(
                    rank=RANK, numIterations=2, solver="fused", **algo)}]})

        # a `pio train` is a process of its own: no probe order cached
        gather_probe._ORDER_CACHE.clear()
        # only the data source's own read may set the scan path now
        es.last_ratings_scan_path = None
        _build.reset_launches()
        ep = variant()
        t0 = time.perf_counter()
        iid = run_train(engine, ep)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        after_auto = dict(_build.LAUNCHES)
        if es.last_ratings_scan_path != "native":
            raise AssertionError("the data source's read took the "
                                 f"{es.last_ratings_scan_path} branch")
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
        model_file = (storage.model_data_dir() / iid
                      / f"{iid}-0-als-arrays.npz")
        if status != "COMPLETED" or not model_file.is_file():
            raise AssertionError(f"instance {iid}: {status}, {model_file}")
        t0 = time.perf_counter()
        iid_other = run_train(engine, variant(fusedGather=other))
        torch.cuda.synchronize()
        other_s = time.perf_counter() - t0
        if md.engine_instance_get(iid_other).status != "COMPLETED":
            raise AssertionError(f"the fusedGather={other!r} run failed")
        log(f"phase pio train: read_training {read_s[0]:.2f} s (native "
            f"scan), run_train "
            f"wall {train_s:.2f} s, fused_gather 'auto' resolved to "
            f"{resolved!r} (probe order {gather_probe._ORDER_CACHE}, "
            f"device ns/row {gather_probe.PROBE_NS}); "
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
        queries = query_mix(96, 11, ML1M_USERS, ML1M_ITEMS)
        solo_q, conc_q = queries[:32], queries[32:]
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
        # chaos and trace checks on this server and on event servers
        obs_pio_chaos(storage, srv)
        obs_delivery_chaos(storage, engine, ep, iid)
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
        # the other import and export formats on this store (no kernel)
        _build.reset_launches()
        t0 = time.perf_counter()
        formats = phase_formats(storage, u, i, v)
        formats["launches"] = dict(_build.LAUNCHES)
        formats["s"] = time.perf_counter() - t0
        # the evaluation sweep, sequential and parallel, on this store
        eval_parallel(storage, home)
        # the watchdog's abort through the console at ML-1M counts
        obs_train_nan(storage, home, cli_views)
        # phase dist (c): the console's two-process sharded train
        dist = dist_console(torch, storage, home)
        return dict(launches=launches, resolved=resolved, ingest=ingest,
                    read_s=read_s[0], train_s=train_s, solo_ms=solo_ms,
                    conc_wall_ms=conc_wall, conc_ms=conc_ms, formats=formats,
                    dist=dist)
    finally:
        reset_storage(None)
        if old_home is None:
            os.environ.pop("PIO_TPU_HOME", None)
        else:
            os.environ["PIO_TPU_HOME"] = old_home
        import shutil

        shutil.rmtree(home, ignore_errors=True)


DIST_PHASE_LIMIT_S = 90.0
DIST_SHARDS = 4
DIST_CONSOLE_PROCESSES = 2
DIST_QUERIES = 32
# the coded straggler: the reference's chaos suite's own placement, a
# delay on shard 1 at the seventh half of an 8-sweep train
# (tests/test_chaos_distributed.py:102); the two-hole plan fails at
# the first poll
DIST_ITERATIONS = 8
DIST_DELAY_PLAN = "dist.shard_delay:nth=7,times=1,shard=1,delay=0.05"
DIST_TWO_HOLES = ("dist.worker_kill:nth=1,shard=2;"
                  "dist.shard_drop:nth=1,shard=1")
DIST_ENGINE = ("predictionio_tpu_torch.templates.recommendation."
               "recommendation_engine")


def scale_err(torch, got, want) -> float:
    """max |got - want| over the scale of ``want`` (its max |x|)."""
    return ((got.double() - want.double()).abs().max()
            / want.double().abs().max()).item()


def _free_port() -> int:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def dist_console(torch, storage, home) -> dict:
    """Phase dist (c), on phase pio's ML-1M store: ``train --coordinator
    127.0.0.1:P --num-processes 2 --process-id K`` as two console
    processes sharing the card (``factorPlacement: "sharded"``, ``coo:
    "local"``, ``"fused"``), then the instance they made against a
    single-process train of the same store from the same seed, and a
    deploy of it answering :data:`DIST_QUERIES` queries, each held
    against ``predict`` in this process."""
    from pathlib import Path

    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.templates.recommendation import (
        Query, recommendation_engine,
    )
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    t0 = time.perf_counter()
    params = {"rank": RANK, "numIterations": 2, "lambda": 0.01, "seed": 3,
              "solver": "fused", "factorPlacement": "sharded"}
    variant = {"id": "dist", "engineFactory": DIST_ENGINE,
               "datasource": {"params": {"appName": "ml1m", "coo": "local"}},
               "algorithms": [{"name": "als", "params": params}]}
    ej = Path(home) / "engine-dist.json"
    ej.write_text(json.dumps(variant))
    root = str(Path(__file__).resolve().parent)
    env = {**os.environ, "PIO_TPU_HOME": str(home), "PYTHONPATH": root,
           "PIO_TPU_COORD_DIR": str(Path(home) / "coord")}
    addr = f"127.0.0.1:{_free_port()}"
    logs = [Path(home) / f"dist-train-{k}.log"
            for k in range(DIST_CONSOLE_PROCESSES)]
    procs = []
    for k, lp in enumerate(logs):
        with open(lp, "wb") as logf:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "predictionio_tpu_torch", "train",
                 "--engine-json", str(ej), "--coordinator", addr,
                 "--num-processes", str(DIST_CONSOLE_PROCESSES),
                 "--process-id", str(k)],
                cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=DIST_PHASE_LIMIT_S)
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    texts = [lp.read_text(errors="replace") for lp in logs]
    if any(p.returncode != 0 for p in procs):
        for k, text in enumerate(texts):
            log(f"phase dist console process {k} log:\n{text[-4000:]}")
        raise AssertionError("a console train process of phase dist failed "
                             f"({[p.returncode for p in procs]})")
    train_s = time.perf_counter() - t0
    iids = {line.rsplit(" ", 1)[1] for text in texts
            for line in text.splitlines()
            if line.startswith("Training completed. Engine instance id:")}
    # the console's own line: "Process K of N joined the run over B."
    backend = [line.rsplit(" ", 1)[1].rstrip(".") for line in
               texts[0].splitlines()
               if line.startswith("Process 0 of ")
               and "joined the run over" in line]
    if len(iids) != 1 or backend != ["gloo"]:
        raise AssertionError(f"phase dist console: instance ids {iids}, "
                             f"backend {backend}")
    (iid,) = iids
    md = storage.get_metadata()
    key = f"{iid}-0-als"
    manifest = json.loads(md.model_get(key).models.decode())
    npz = storage.model_data_dir() / iid / manifest.get("npz", "?")
    if (md.engine_instance_get(iid).status != "COMPLETED"
            or manifest.get("kind") != "sharded" or not npz.is_file()):
        raise AssertionError(f"phase dist console: instance {iid}, model "
                             f"manifest {manifest}")
    # the same store, one process, the same seed: one card is a mesh of
    # one shard, which trains replicated (and reads the gathered COO)
    engine = recommendation_engine()
    one_ep = engine.params_from_variant(dict(variant, datasource={
        "params": {"appName": "ml1m"}}))
    t1 = time.perf_counter()
    (one,) = engine.train(WorkflowContext(device="cuda", storage=storage),
                          one_ep)
    one_s = time.perf_counter() - t1
    ep = engine.params_from_variant(variant)
    ctx = WorkflowContext(device="cuda", storage=storage, mode="Serving")
    algos, models, _ = prepare_deploy_components(engine, ep, iid, ctx=ctx)
    algo, model = algos[0], models[0]
    if list(model.users.ids) != list(one.users.ids) or \
            list(model.items.ids) != list(one.items.ids):
        raise AssertionError("phase dist console: the id dictionaries "
                             "differ from the single-process train's")
    errs = [scale_err(torch, torch.from_numpy(a), torch.from_numpy(b))
            for a, b in ((model.user_factors, one.user_factors),
                         (model.item_factors, one.item_factors))]
    srv = EngineServer(engine, ep, iid, ctx=ctx,
                       config=ServerConfig(host="127.0.0.1", port=0))
    thread = srv.start_background()
    trades = 0
    try:
        for q in query_mix(DIST_QUERIES, 17, ML1M_USERS, ML1M_ITEMS):
            trades += _same_reply(_http(srv.port, "/queries.json", q),
                                  algo.predict(model,
                                               Query.from_json(q)).to_json(),
                                  f"phase dist deploy query {q}")
    finally:
        _http(srv.port, "/stop", {})
        thread.join(timeout=30)
    return {"s": time.perf_counter() - t0, "train_s": train_s,
            "one_s": one_s, "iid": iid, "backend": backend[0],
            "factor_err": errs, "npz": npz.name, "trades": trades,
            "queries": DIST_QUERIES}


def phase_dist(torch, ratings, console: dict) -> dict:
    """Phase dist: the sharded and coded ALS trainer at ML-20M (rank 64,
    ALS-WR, λ 0.01) on the ratings phase read returned.

    (a) One iteration on a mesh of :data:`DIST_SHARDS` shards on
    ``cuda:0`` with ``"fused"`` and with ``"pallas"``, each from the
    single-card trainer's initial factors padded with zero rows, held
    against a single-card iteration from the same start (1e-4 of the
    factors' scale); every shard must launch the kernel.  (b) A clean
    coded iteration equals the plain sharded one (1e-6 of scale); a
    :data:`DIST_ITERATIONS`-sweep coded train under a delay plan on
    shard 1 books the degradation and a ``dist.parity_serve`` span and
    keeps the training RMSE within 1% of the clean coded train's; a
    two-hole plan raises ``ParityExhausted``.  (c) ran in phase pio
    (:func:`dist_console`): ``console`` holds its results.  The launch
    counts are set to 0 just before the sharded runs and read after."""
    from predictionio_tpu_torch.models.als import (
        SHARD_LAUNCHES, ALSConfig, ALSFactors, ALSTrainer, rmse,
    )
    from predictionio_tpu_torch.obs import SHARD_DEGRADED_TOTAL, get_tracer
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.parallel import ParityExhausted, make_mesh
    from predictionio_tpu_torch.resilience import faults

    t_phase = time.perf_counter()
    nu, ni = ratings.n_users, ratings.n_items
    base = dict(rank=RANK, lam=0.01, seed=3, loss_every=0)
    mesh = make_mesh(devices=[f"cuda:{torch.cuda.current_device()}"]
                     * DIST_SHARDS)
    # the single-card iterations the sharded ones are held against
    single, half_s = {}, {}
    for solver in ("fused", "pallas"):
        tr = ALSTrainer(ratings, cfg=ALSConfig(
            solver=solver, num_iterations=1, **base))
        U0, V0 = tr.init_factors()
        single[solver] = tr.run(U0, V0, 1)
        half_s[solver] = {"single": [round(t, 4) for _, t in
                                     tr.half_seconds]}
        del tr
    pad = torch.nn.functional.pad
    Up = pad(U0, (0, 0, 0, -nu % DIST_SHARDS))
    Vp = pad(V0, (0, 0, 0, -ni % DIST_SHARDS))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    SHARD_LAUNCHES.clear()
    tracer = get_tracer()
    errs, per_shard, sharded, staging = {}, {}, {}, {}
    for solver in ("fused", "pallas"):
        tr = ALSTrainer(ratings, cfg=ALSConfig(
            solver=solver, num_iterations=1, factor_placement="sharded",
            **base), mesh=mesh)
        staging[solver] = round(tr.staging_seconds, 2)
        sharded[solver] = tr.run(Up, Vp, 1)
        torch.cuda.synchronize()
        spans = [sp.duration_s for sp in tracer.spans()
                 if sp.name == "als.sharded_half"][-2:]
        half_s[solver]["sharded_span"] = [round(t, 4) for t in spans]
        (Us, Vs), (U1, V1) = sharded[solver], single[solver]
        errs[solver] = [scale_err(torch, Us[:nu], U1),
                        scale_err(torch, Vs[:ni], V1)]
        per_shard[solver] = {f"{k}@{s}": n
                             for (s, k), n in sorted(SHARD_LAUNCHES.items())}
        kernel = "gj_solve" if solver == "pallas" else None
        for s in range(DIST_SHARDS):
            n = (SHARD_LAUNCHES[(s, kernel)] if kernel else
                 SHARD_LAUNCHES[(s, "fused_als")]
                 + SHARD_LAUNCHES[(s, "fused_als_dma")])
            if n <= 0:
                raise AssertionError(f"phase dist: shard {s} never launched "
                                     f"the {solver} kernel")
        SHARD_LAUNCHES.clear()
        del tr
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # (b) coded: clean, then a straggler mid-train, then two holes
    tr = ALSTrainer(ratings, cfg=ALSConfig(
        solver="fused", num_iterations=DIST_ITERATIONS,
        factor_placement="sharded", coded_shards=True, **base), mesh=mesh)
    Uc, Vc = tr.run(Up, Vp, 1)
    Uf, Vf = sharded["fused"]
    coded_err = [scale_err(torch, Uc, Uf), scale_err(torch, Vc, Vf)]
    del Uc, Vc, sharded, single

    def train_rmse(U, V):
        return rmse(ALSFactors(U[:nu].cpu().numpy(), V[:ni].cpu().numpy()),
                    ratings.user_ix, ratings.item_ix, ratings.rating)

    clean_rmse = train_rmse(*tr.run(Up, Vp, DIST_ITERATIONS))
    degraded0 = SHARD_DEGRADED_TOTAL.labels(shard="1").value()
    polls0 = tr.shard_health.degraded_polls
    faults.arm(DIST_DELAY_PLAN)
    try:
        straggler_rmse = train_rmse(*tr.run(Up, Vp, DIST_ITERATIONS))
    finally:
        faults.disarm()
    parity_spans = [sp for sp in tracer.spans()
                    if sp.name == "dist.parity_serve"
                    and sp.attrs.get("shard") == 1]
    booked = SHARD_DEGRADED_TOTAL.labels(shard="1").value() - degraded0
    faults.arm(DIST_TWO_HOLES)
    try:
        tr.run(Up, Vp, 1)
        exhausted = False
    except ParityExhausted:
        exhausted = True
    finally:
        faults.disarm()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    del tr
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t_phase + console["s"]
    checks = {
        "sharded_fused_within_1e-4": max(errs["fused"]) <= 1e-4,
        "sharded_pallas_within_1e-4": max(errs["pallas"]) <= 1e-4,
        "coded_clean_within_1e-6": max(coded_err) <= 1e-6,
        "straggler_booked_once": booked == 1 and polls0 == 0,
        "parity_serve_span": bool(parity_spans),
        "straggler_rmse_within_1pct": straggler_rmse <= 1.01 * clean_rmse,
        "two_holes_raise": exhausted,
        "console_one_instance_gloo": console["backend"] == "gloo",
        "console_factors_within_1e-4": max(console["factor_err"]) <= 1e-4,
        "console_deploy_answers": console["queries"] == DIST_QUERIES,
        "within_limit": phase_s <= DIST_PHASE_LIMIT_S,
    }
    obs_report("dist", checks, {
        "shards": DIST_SHARDS, "errors": errs, "coded_clean_err": coded_err,
        "launches_by_shard": per_shard, "half_s": half_s,
        "staging_s": staging, "peak_gib": round(peak_gib, 2),
        "rmse": {"clean": clean_rmse, "straggler": straggler_rmse},
        "console": {k: console[k] for k in (
            "iid", "backend", "factor_err", "npz", "trades", "train_s",
            "one_s", "s")},
        "phase_s": round(phase_s, 1)})
    return {"launches": launches}


RING_PHASE_LIMIT_S = 30.0
RING_SHARDS = 4
RING_QUERIES = 512
RING_BATCH = 64
RING_K = 10
RING_FACTOR = 10
RING_TOL = 1e-5
RING_PAD_CUT = 3          # rows cut from the table so that the mesh pads
RING_DELAY_PLAN = "dist.shard_delay:shard=1,delay=30,times=1"
RING_KILL_PLAN = "dist.worker_kill:shard=2,times=1"
RING_DROP_PLAN = "dist.shard_drop:shard=0,times=1"


def _ring_same(got, want, what: str) -> int:
    """A ring answer ``(values, ids)`` against the single-card one: scores
    within :data:`RING_TOL` relative, the same ids apart from ties (an id
    may differ only where its score ties the other's within the
    tolerance).  Returns the number of tied ids that traded places."""
    gv, gi = (x.cpu().numpy() for x in got)
    wv, wi = (x.cpu().numpy() for x in want)
    scale = np.maximum(np.abs(wv), 1e-30)
    if gv.shape != wv.shape or (np.abs(gv - wv) > RING_TOL * scale).any():
        raise AssertionError(f"phase ring {what}: scores differ from the "
                             "single card's")
    traded = 0
    for r in range(len(gi)):
        for c in np.flatnonzero(gi[r] != wi[r]):
            if abs(gv[r, c] - wv[r, c]) > RING_TOL * scale[r, c] or not (
                    np.abs(wv[r] - gv[r, c]) <= RING_TOL * scale[r]).sum() > 1:
                raise AssertionError(f"phase ring {what}: query {r} has id "
                                     f"{gi[r, c]} for {wi[r, c]}")
            traded += 1
    return traded


def phase_ring(torch, store: StoreHome, row_model, cli_out: dict) -> dict:
    """Phase ring: the ring top-k (``ops/distributed_topk.py``) on phase
    train's ML-20M model (``row_model``: 138,493 x 26,744, rank 64), over
    a mesh of :data:`RING_SHARDS` shards on ``cuda:0`` in this process,
    with :data:`RING_QUERIES` users of :func:`query_mix` and k
    :data:`RING_K`.  Checks: the exact ring, solo and in batches of
    :data:`RING_BATCH`, gives the single-card ``topk_scores`` answers
    (ids apart from ties, scores within :data:`RING_TOL` relative), and
    on a table cut to a count the mesh pads, the padding rows never win;
    the template with ``"distributedTopk": true`` (an engine.json of its
    own, trained through the console with the ``"xla"`` solver: no
    kernel) deployed in this process through ``EngineServer`` answers
    ``/queries.json`` as in-process ``predict`` and carries the
    ``distributedTopk`` block in its status; under
    :data:`RING_DELAY_PLAN` inside a 0.4 s deadline the coded ring
    answers the clean answer in under 2 s, books one
    ``pio_shard_degraded_total{shard="1"}`` and a ``dist.parity_serve``
    span; a killed shard (:data:`RING_KILL_PLAN`) stays killed with no
    plan armed; the int8 ring at a covering ``candidateFactor`` gives
    the exact ids, and at :data:`RING_FACTOR` a recall@10 at least the
    single-card ``retrieval="int8"`` one, each shard's int8 shortlist
    holding every item of the single-card shortlist that lies in it;
    with a shard dropped the int8 index answers exactly (the coded exact
    ring).  Logs the per-call ms, solo and batched, beside the single
    card's.  No kernel lies on this path; the phase fails past
    :data:`RING_PHASE_LIMIT_S`."""
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.obs import SHARD_DEGRADED_TOTAL, get_tracer
    from predictionio_tpu_torch.ops import ann
    from predictionio_tpu_torch.ops.distributed_topk import ShardedTopK
    from predictionio_tpu_torch.ops.topk import batch_topk_scores, topk_scores
    from predictionio_tpu_torch.parallel import make_mesh
    from predictionio_tpu_torch.resilience import (
        Deadline, deadline_scope, faults)
    from predictionio_tpu_torch.retrieval import RetrievalConfig
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.templates.recommendation import Query
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    t_phase = time.perf_counter()
    model = row_model
    dev = model.device
    mesh = make_mesh(devices=[dev] * RING_SHARDS)
    V = model.item_factors
    table = torch.as_tensor(V, device=dev)
    queries = query_mix(RING_QUERIES, 29, N_USERS, N_ITEMS)
    uix = model.users.encode(np.asarray([q["user"] for q in queries],
                                        dtype=object))
    Q = torch.as_tensor(model.user_factors[uix], device=dev)
    t_build = time.perf_counter()
    idx = ShardedTopK(V, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t_build

    # exact ring: solo and batched, against the single card
    single = [topk_scores(Q[r], table, RING_K) for r in range(len(Q))]
    want = tuple(torch.stack([s[j] for s in single]) for j in (0, 1))
    solo = [idx(Q[r:r + 1], RING_K) for r in range(len(Q))]
    got = tuple(torch.cat([s[j] for s in solo]) for j in (0, 1))
    traded = {"solo": _ring_same(got, want, "solo")}
    got = [idx(Q[b:b + RING_BATCH], RING_K)
           for b in range(0, len(Q), RING_BATCH)]
    got = tuple(torch.cat([g[j] for g in got]) for j in (0, 1))
    traded["batched"] = _ring_same(got, want, "batched")
    cut = N_ITEMS - RING_PAD_CUT
    padded = ShardedTopK(V[:cut], mesh)
    pv, pi = padded(Q, RING_K)
    pad_ok = (padded.table[0].shape[0] * RING_SHARDS > cut
              and int(pi.max()) < cut)
    traded["padded"] = _ring_same(
        (pv, pi), batch_topk_scores(Q, table[:cut], RING_K), "padded")
    ms = interleaved_ms({
        "ring_solo": (lambda: idx(Q[:1], RING_K), 20),
        "ring_batched": (lambda: idx(Q[:RING_BATCH], RING_K), 10),
        "single_solo": (lambda: topk_scores(Q[0], table, RING_K), 20),
        "single_batched": (lambda: batch_topk_scores(
            Q[:RING_BATCH], table, RING_K), 10),
    }, turns=3)

    # the coded ring under a delay past the deadline's hop budget
    clean = idx(Q[:RING_BATCH], RING_K)
    tracer = get_tracer()
    n_spans = len(tracer.spans())
    booked0 = SHARD_DEGRADED_TOTAL.labels(shard="1").value()
    faults.arm(RING_DELAY_PLAN)
    try:
        t0 = time.perf_counter()
        with deadline_scope(Deadline.after(0.4)):
            degraded = idx(Q[:RING_BATCH], RING_K)
        torch.cuda.synchronize()
        degraded_s = time.perf_counter() - t0
    finally:
        faults.disarm()
    booked = SHARD_DEGRADED_TOTAL.labels(shard="1").value() - booked0
    spans = [s for s in tracer.spans()[n_spans:]
             if s.name == "dist.parity_serve" and s.attrs.get("shard") == 1]
    traded["delayed"] = _ring_same(degraded, clean, "delayed")

    # a killed worker stays killed across requests
    killed = ShardedTopK(V, mesh)
    faults.arm(RING_KILL_PLAN)
    try:
        first = killed(Q[:RING_BATCH], RING_K)
    finally:
        faults.disarm()
    again = killed(Q[:RING_BATCH], RING_K)
    traded["killed"] = (_ring_same(first, clean, "killed")
                        + _ring_same(again, clean, "killed again"))
    kill_summary = killed.summary()
    del killed

    # the int8 ring: covering, then at RING_FACTOR against the single card
    rows = idx.shard_rows
    cover = ShardedTopK(V, mesh, retrieval="int8",
                        candidate_factor=-(-rows // RING_K))
    traded["int8_covering"] = _ring_same(cover(Q, RING_K), want,
                                         "int8 covering")
    del cover
    idx8 = ShardedTopK(V, mesh, retrieval="int8",
                       candidate_factor=RING_FACTOR)
    ring8 = idx8(Q, RING_K)[1].cpu().numpy()
    single8 = model.device_ann_index(RetrievalConfig(
        mode="int8", candidate_factor=RING_FACTOR))
    one8 = single8.search(Q, RING_K, table)[1].cpu().numpy()
    exact_ix = want[1].cpu().numpy()
    recall = {"ring": ann.recall_at_k(exact_ix, ring8),
              "single": ann.recall_at_k(exact_ix, one8)}
    # each shard's int8 top-c holds every item of the whole table's int8
    # top-c (the same c, from the single card's int8 stage) that lies in
    # that shard (boundary ties within RING_TOL excepted)
    kc_ring = idx8._candidate_k(RING_K)
    kc_one = single8.shortlist_width(RING_K)
    glob = ann.int8_candidate_topk(Q, single8._state["q_table_t"],
                                   single8._state["scale"], kc_ring)
    glob = glob.cpu().numpy()
    missing = 0
    for s in range(RING_SHARDS):
        sc = ((Q @ idx8.q_table[s].T.float()) * idx8.q_scale[s][None, :]
              + idx8.row_bias[s][None, :])
        top_v, top_i = torch.topk(sc, kc_ring, dim=1)
        sc, top_v = sc.cpu().numpy(), top_v.cpu().numpy()
        top_i = top_i.cpu().numpy() + s * rows
        for r in range(len(Q)):
            mine = glob[r][(glob[r] // rows) == s]
            held = set(top_i[r].tolist())
            for g in mine.tolist():
                if g in held:
                    continue
                edge = top_v[r, -1]
                if sc[r, g - s * rows] < edge - RING_TOL * abs(edge):
                    missing += 1
    faults.arm(RING_DROP_PLAN)
    try:
        dropped = idx8(Q[:RING_BATCH], RING_K)
    finally:
        faults.disarm()
    traded["int8_degraded"] = _ring_same(
        dropped, tuple(w[:RING_BATCH] for w in want), "int8 degraded")
    int8_summary = idx8.summary()
    del idx8, single8

    # the template through the HTTP edge, from an engine.json of its own
    st = store.storage
    eng = Path(store.home) / "engine-ring"
    cli(["template", "get", "recommendation", str(eng)], st)
    ej = eng / "engine.json"
    variant = json.loads(Path(cli_out["engine_json"]).read_text())
    variant["algorithms"] = [{"name": "als", "params": {
        "rank": RANK, "numIterations": 1, "lambda": 0.01, "solver": "xla",
        "distributedTopk": True}}]
    ej.write_text(json.dumps(variant, indent=2))
    cli(["build", "--engine-json", str(ej)], st)
    t0 = time.perf_counter()
    iid = cli(["train", "--scan-cache", "--engine-json", str(ej)],
              st).split()[-1]
    train_s = time.perf_counter() - t0
    engine, ep, _ = load_engine_from_variant(ej)
    ctx = WorkflowContext(mode="Serving", storage=st, mesh=mesh)
    algos, models, _ = prepare_deploy_components(engine, ep, iid, ctx=ctx)
    http_q = queries[:64]
    want_json = [algos[0].predict(models[0], Query.from_json(q)).to_json()
                 for q in http_q]
    srv = EngineServer(engine, ep, iid, ctx=ctx, config=ServerConfig(
        host="127.0.0.1", port=0))
    srv.start_background()
    try:
        load = http_load(srv.port, http_q[:16], http_q[16:], 16)
        status = _http(srv.port, "/")
    finally:
        srv.stop()
    http_trades = sum(_same_reply(g, w, f"ring deploy query {q}")
                      for q, g, w in zip(http_q, load["replies"], want_json))
    block = status.get("distributedTopk") or {}
    del algos, models
    torch.cuda.synchronize()
    phase_s = time.perf_counter() - t_phase
    checks = {
        # (_ring_same raised on any answer off the single card's)
        "exact_ring_answered_every_query": tuple(got[0].shape) == (
            RING_QUERIES, RING_K),
        "padding_rows_never_win": pad_ok,
        "delayed_shard_served_from_parity": degraded_s < 2.0,
        "delayed_shard_booked_once": booked == 1,
        "parity_serve_span": bool(spans),
        "killed_shard_sticky": (kill_summary["killed"] == [2]
                                and kill_summary["degradedPolls"] == 2),
        "int8_recall_at_least_single_card": recall["ring"]
        >= recall["single"],
        "int8_shard_shortlists_hold_the_single_cards": missing == 0,
        "http_replies_equal_predict": len(load["replies"]) == len(http_q),
        "status_carries_distributed_topk": (
            block.get("shards") == RING_SHARDS
            and block.get("items") == N_ITEMS),
        "phase_within_its_limit": phase_s <= RING_PHASE_LIMIT_S,
    }
    obs_report("ring", checks, {
        "shards": RING_SHARDS, "queries": RING_QUERIES, "k": RING_K,
        "build_s": round(build_s, 3), "ms": ms, "traded": traded,
        "delayed_s": round(degraded_s, 3), "recall_at_10": recall,
        "candidate_k": {"ring_per_shard": kc_ring, "single": kc_one},
        "shortlist_misses": missing,
        "int8_summary": int8_summary, "train_s": round(train_s, 1),
        "http": {"iid": iid, "solo_ms": pcts(load["solo_ms"]),
                 "conc_ms": pcts(load["conc_ms"]), "trades": http_trades,
                 "status": block},
        "phase_s": round(phase_s, 1)})
    return {"s": phase_s}


def http_load(port: int, solo_q: list, conc_q: list, clients: int) -> dict:
    """The solo queries one after another over one keep-alive connection,
    then the concurrent ones from ``clients`` threads; every status must
    be 200.  Returns the replies, each request's ms, the concurrent
    run's wall ms and its queries/s."""
    solo = _post_timed(port, "/queries.json", solo_q, 1)
    t0 = time.perf_counter()
    conc = _post_timed(port, "/queries.json", conc_q, clients)
    wall = time.perf_counter() - t0
    bad = [(st, r) for st, r, _ in solo + conc if st != 200]
    if bad:
        raise AssertionError(f"{len(bad)} queries failed, e.g. {bad[0]}")
    return {"replies": [r for _, r, _ in solo + conc],
            "solo_ms": [ms for _, _, ms in solo],
            "conc_ms": [ms for _, _, ms in conc],
            "wall_ms": wall * 1e3, "qps": len(conc_q) / wall}


def pcts(ms: list) -> str:
    p50, p99 = np.percentile(ms, [50, 99])
    return f"p50 {p50:.3f} ms p99 {p99:.3f} ms"


def phase_cli(torch, store: StoreHome) -> dict:
    """The quickstart at ML-20M through the port's console, on the
    sharded store phase store filled (its app imported through
    ``import``, its items' ``$set`` events through the ingest fleet of
    phase fleet, its ratings read once with the scan cache on by phase
    read): ``template get recommendation`` →
    engine.json (rank 64, 2 iterations, lambda 0.01, ``solver="fused"``,
    ``fusedGather`` "auto") → ``build`` → ``train --scan-cache`` in this
    process on the card (the read must hit the scan cache; the launch
    counts are set to 0 just before it and read just after) →
    ``deploy`` as a process of its own on the default event-loop edge
    with the shared batcher, answering 32 solo and 256 queries from 64
    client threads, each reply held against an in-process ``predict`` on
    the same instance → a shorter load on an in-process threads-edge
    ``EngineServer`` (96 queries, as on a ``--no-metrics`` deploy) →
    ``undeploy``, after which the deploy process must exit with 0."""
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.ops import _build, gather_probe
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.templates.recommendation import Query
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    st = store.storage
    es = st.get_event_store()
    eng = Path(store.home) / "engine"
    cli(["template", "get", "recommendation", str(eng)], st)
    ej = eng / "engine.json"
    variant = json.loads(ej.read_text())
    variant["datasource"] = {"params": {"appName": "ml20m",
                                        "eventNames": ["rate"]}}
    variant["algorithms"] = [{"name": "als", "params": {
        "rank": RANK, "numIterations": 2, "lambda": 0.01,
        "solver": "fused"}}]
    ej.write_text(json.dumps(variant, indent=2))
    cli(["build", "--engine-json", str(ej)], st)

    # a `train` is a process of its own: no probe order cached
    gather_probe._ORDER_CACHE.clear()
    es.last_ratings_scan_path = None
    _build.reset_launches()
    t0 = time.perf_counter()
    with CaptureLog() as records:
        out = cli(["train", "--scan-cache", "--engine-json", str(ej),
                   "--telemetry-dir", str(Path(store.home) / "telemetry")],
                  st)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    iid = out.split()[-1]
    if st.get_metadata().engine_instance_get(iid).status != "COMPLETED":
        raise AssertionError(f"instance {iid} did not complete: {out}")
    read_path = es.last_ratings_scan_path
    (read_s,) = records.args(_READ_LOG)
    report = records.args(_ALS_LOG)  # one Mapping argument: the report
    save_s = records.args(_SAVE_LOG)[1]
    halves = ", ".join(f"{n} {t * 1e3:.1f} ms"
                       for n, t in report["half_seconds"])
    log(f"phase cli train: console train {train_s:.1f} s; read_training "
        f"{read_s:.2f} s (last_ratings_scan_path {read_path!r}: the scan "
        f"cache {'hit' if read_path == 'cache' else 'MISSED'}), staging "
        f"{report['staging_seconds']:.2f} s, halves [{halves}], "
        f"{trainer_form(report)}, model save {save_s:.2f} s; "
        f"instance {iid} COMPLETED; launches {launches}")
    if launches["fused_als"] + launches["fused_als_dma"] <= 0:
        raise AssertionError("the console's train never launched the fused "
                             "kernel")
    views = {}
    obs_cli_train(store, iid, views)

    engine, ep, _ = load_engine_from_variant(ej)
    algos, models, _ = prepare_deploy_components(
        engine, ep, iid, ctx=WorkflowContext(mode="Serving", storage=st))
    queries = query_mix(32 + 256, 17, N_USERS, N_ITEMS)
    solo_q, conc_q = queries[:32], queries[32:]
    want = [algos[0].predict(models[0], Query.from_json(q)).to_json()
            for q in queries]

    def held(replies, what) -> int:
        if not any(r["itemScores"] for r in replies):
            raise AssertionError(f"{what}: no query got recommendations")
        return sum(_same_reply(g, w, f"{what} query {q}")
                   for q, g, w in zip(queries, replies, want))

    edges = {}
    tdir = Path(store.home) / "telemetry-deploy"
    # a flight recorder that holds every answered query's span tree:
    # under 64 clients a whole batch shares the slowest latency bucket,
    # whose exemplar must still resolve to a record (xray_smoke 4 runs
    # light enough for 16 to do); both deploys keep the same capacity
    flight = ["--flight-capacity", "2048"]
    proc = Console(store.home, [
        "deploy", "--engine-json", str(ej), "--ip", "127.0.0.1", "--port",
        "0", "--telemetry-dir", str(tdir), "--slo-ms", "250",
        "--xray-sample-s", "1", *flight], "deploy")
    try:
        port = proc.wait_port()
        try:
            load = http_load(port, solo_q, conc_q, 64)
            load["trades"] = held(load["replies"], "deploy")
            status = _http(port, "/")
        except Exception as e:
            proc.fail(f"failed its queries: {e!r}")
        mb = status["microbatch"]
        if status["requestCount"] != len(queries) or mb["maxBatchSeen"] <= 1:
            proc.fail(f"counted {status['requestCount']} queries, batches "
                      f"{mb}")
        edges["eventloop"] = dict(load, batches=mb)
        # no router lives in a plain deploy's process
        fleet_code = _raw(port, "/debug/fleet")[0]
        if fleet_code != 404:
            proc.fail(f"answered GET /debug/fleet with {fleet_code}")
        obs = obs_deploy(torch, port, len(queries), solo_q[0], tdir)
        boot_s = proc.boot_s
        if "Undeployed" not in cli(["undeploy", "--port", str(port)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
        if rc != 0:
            proc.fail("exited after undeploy")
    finally:
        proc.stop()

    # a shorter load with --no-metrics: the mounts close, recording
    # stays (--edge-ab times the two against each other, in turns)
    short_q = conc_q[:64]
    proc = Console(store.home, [
        "deploy", "--engine-json", str(ej), "--ip", "127.0.0.1", "--port",
        "0", "--no-metrics", *flight], "deploy-no-metrics")
    try:
        port = proc.wait_port()
        try:
            load = http_load(port, solo_q, short_q, 64)
            load["trades"] = held(load["replies"], "deploy --no-metrics")
            closed = _raw(port, "/metrics")[0]
            status = _http(port, "/")
        except Exception as e:
            proc.fail(f"failed its queries: {e!r}")
        if closed != 404:
            proc.fail(f"answered GET /metrics with {closed}")
        edges["eventloop --no-metrics"] = dict(load,
                                               batches=status["microbatch"])
        cli(["undeploy", "--port", str(port)], st)
        proc.proc.wait(timeout=60)
    finally:
        proc.stop()

    srv = EngineServer(engine, ep, iid, ctx=WorkflowContext(
        mode="Serving", storage=st), config=ServerConfig(
        host="127.0.0.1", port=0, edge="threads"))
    thread = srv.start_background()
    try:
        load = http_load(srv.port, solo_q, short_q, 64)
        load["trades"] = held(load["replies"], "threads edge")
        edges["threads"] = dict(load, batches=srv.status_json()["microbatch"])
    finally:
        srv.stop()
        thread.join(timeout=30)
    for name, e in edges.items():
        b = e["batches"]
        n = len(e["conc_ms"])
        log(f"phase cli serve {name} edge: 32 solo {pcts(e['solo_ms'])}; "
            f"{n:,} from 64 clients {pcts(e['conc_ms'])}, "
            f"{e['qps']:,.0f} queries/s; batches {b['batches']} for "
            f"{b['requests']} requests (largest {b['maxBatchSeen']}); all "
            f"{32 + n} replies match in-process predict "
            f"({e['trades']} tied items traded places)")
    log(f"phase cli deploy: the process booted in {boot_s:.1f} s "
        f"(python -m predictionio_tpu_torch deploy to its port), answered "
        f"on the event-loop edge with the shared batcher, and exited 0 "
        f"after undeploy")
    return {"launches": launches, "train_s": train_s, "read_path": read_path,
            "boot_s": boot_s, "edges": edges, "views": views,
            "obs": obs, "engine_json": str(ej), "iid": iid,
            "predict": lambda q: algos[0].predict(
                models[0], Query.from_json(q)).to_json()}


def eval_record(storage, out: str):
    """The console's two eval lines → the EvaluationInstance they name
    and its parsed JSON result; raises unless the record is
    EVALCOMPLETED and carries the printed one-liner, the HTML and the
    JSON."""
    one_liner, done = out.splitlines()
    eid = done.rsplit(" ", 1)[1]
    if done != f"Evaluation completed. Instance id: {eid}":
        raise AssertionError(f"eval printed {out!r}")
    rec = storage.get_metadata().evaluation_instance_get(eid)
    if (rec is None or rec.status != "EVALCOMPLETED"
            or rec.evaluator_results != one_liner
            or not rec.evaluator_results_html.startswith("<html>")):
        raise AssertionError(f"evaluation instance {eid}: {rec}")
    return rec, json.loads(rec.evaluator_results_json)


def phase_eval(torch, store: StoreHome, ratings) -> dict:
    """``pio eval`` at ML-20M through the port's console, in this process
    on the card, on the sharded store phase store filled (its ratings in
    the scan cache since phase read): ``eval --engine recommendation __main__.ML20MSweep
    --scan-cache`` (:class:`ML20MSweep`: its candidates, :data:`EVAL_K`
    folds each; FastEval reads and splits the store once and trains a
    model per candidate and fold) from a
    scratch working directory, where ``best.json`` lands.  The launch
    counts are set to 0 just before it and read just after.  Checks:
    the folds' held-out sizes add up to the ratings phase read took, and
    each of a sample of 10,000 ratings is missing from exactly one fold's
    training set, the one a numpy recomputation of the seeded
    permutation gives, and stands at its place in that fold's held-out
    (query, actual) list; each
    candidate's RMSE is finite and beats the zero model's; the winner's
    RMSE recomputed in float64 over its models' host factors
    agrees within 1e-6 relative; the best index is the argmin;
    ``best.json`` reads back into the winner's params; the record is
    EVALCOMPLETED.  Logs ``read_eval``, the host's peak RSS, and per
    candidate and fold the trainer's form, staging, halves and serving
    seconds."""
    from pathlib import Path

    from predictionio_tpu_torch.ops import _build, gather_probe
    from predictionio_tpu_torch.templates.recommendation import (
        RatingAlgorithm, RecommendationDataSource, recommendation_evaluation,
    )

    st = store.storage
    work = Path(store.home) / "eval"
    work.mkdir()
    folds, models = [], []
    # a `pio eval` is a process of its own: no probe order cached
    gather_probe._ORDER_CACHE.clear()
    cwd = os.getcwd()
    os.chdir(work)
    _build.reset_launches()
    t0 = time.perf_counter()
    try:
        with CaptureLog() as records, PeakRss() as rss, \
                recording(RecommendationDataSource, "read_eval", folds), \
                recording(RatingAlgorithm, "train", models):
            out = cli(["eval", "--engine", "recommendation",
                       "__main__.ML20MSweep", "--scan-cache"], st)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    eval_s = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    rec, res = eval_record(st, out)
    scores = [r["score"] for r in res["results"]]
    best = res["bestIndex"]

    # the folds: sizes, and a sample of ratings against numpy
    ((_, sets),) = folds
    n = len(ratings)
    # each rating's fold as read_eval must assign it, by numpy alone
    fold = np.empty(n, dtype=np.int64)
    fold[np.random.default_rng(EVAL_SEED).permutation(n)] = (
        np.arange(n) % EVAL_K)
    keys = ratings.user_ix.astype(np.int64) * ratings.n_items + ratings.item_ix
    sample = np.random.default_rng(1).choice(n, size=min(n, 10_000),
                                             replace=False)
    held, lacking = [], np.zeros(len(sample), np.int64)
    for f, (td, ei, qa) in enumerate(sets):
        train = np.sort(td.ratings.user_ix.astype(np.int64)
                        * ratings.n_items + td.ratings.item_ix)
        pos = np.minimum(np.searchsorted(train, keys[sample]), len(train) - 1)
        out_f = train[pos] != keys[sample]
        lacking += out_f
        mine = np.flatnonzero(fold == f)
        # the sample's held-out pairs, at their place in the fold's list
        at = np.searchsorted(mine, sample[fold[sample] == f])
        if (ei != {"fold": f} or len(qa) != n - len(train)
                or len(mine) != len(qa)
                or not np.array_equal(out_f, fold[sample] == f)
                or any((qa[a][0].user, qa[a][1].item, qa[a][1].rating) != (
                    ratings.users.id_of(ratings.user_ix[mine[a]]),
                    ratings.items.id_of(ratings.item_ix[mine[a]]),
                    float(ratings.rating[mine[a]])) for a in at)):
            raise AssertionError(f"fold {f} differs from the numpy split")
        held.append(len(qa))
    if len(sets) != EVAL_K or sum(held) != n or (lacking != 1).any():
        raise AssertionError(f"folds hold out {held} of {n:,} ratings")
    del folds, sets

    zero = float(np.sqrt(np.mean(ratings.rating.astype(np.float64) ** 2)))
    if not all(math.isfinite(x) and x < zero for x in scores):
        raise AssertionError(f"RMSEs {scores} against the zero model's "
                             f"{zero}")
    if best != int(np.argmin(scores)) or rec.evaluator_results != (
            f"[{scores[best]}] RMSE"):
        raise AssertionError(f"best index {best} of {scores}")
    # the winner's score, recomputed in float64 over its models
    lams = ML20MSweep.LAMBDAS
    won = [m for a, m in models if a.params.lam == lams[best]]
    if len(models) != EVAL_K * len(lams) or len(won) != EVAL_K:
        raise AssertionError(f"{len(models)} models trained")
    # in float64 on the card: the same sum as numpy's, without moving
    # 20M gathered float64 rows through the host
    dev = torch.device("cuda", torch.cuda.current_device())
    ui = torch.from_numpy(ratings.user_ix).to(dev)
    ii = torch.from_numpy(ratings.item_ix).to(dev)
    rr = torch.from_numpy(ratings.rating).to(dev, torch.float64)
    sq = 0.0
    for f, model in enumerate(won):
        Uf = torch.from_numpy(model.user_factors).to(dev, torch.float64)
        Vf = torch.from_numpy(model.item_factors).to(dev, torch.float64)
        mine = torch.from_numpy(np.flatnonzero(fold == f)).to(dev)
        for c in range(0, len(mine), 1 << 21):
            j = mine[c:c + (1 << 21)]
            pred = (Uf[ui[j]] * Vf[ii[j]]).sum(-1)
            sq += float(((pred - rr[j]) ** 2).sum())
    del ui, ii, rr, Uf, Vf, mine
    again = math.sqrt(sq / n)
    if abs(again - scores[best]) > 1e-6 * scores[best]:
        raise AssertionError(f"the winner's RMSE {scores[best]} against "
                             f"{again} recomputed in float64")
    engine = recommendation_evaluation().engine
    back = engine.params_from_variant(
        json.loads((work / "best.json").read_text()))
    want = ML20MSweep().engine_params_list[best]
    if (back.algorithms, back.data_source) != (want.algorithms,
                                               want.data_source):
        raise AssertionError("best.json does not name the winner")
    check_s = time.perf_counter() - t0

    (read_s,) = records.args(_EVAL_READ_LOG)
    reports = records.all(_ALS_LOG)
    served = records.all(_SERVE_LOG)
    cands = records.all(_CANDIDATE_LOG)
    log(f"phase eval ML-20M: console eval {eval_s:.1f} s in all; "
        f"read_eval {read_s:.2f} s (the store read from the scan cache and "
        f"the {EVAL_K}-fold split into {n:,} held-out (query, actual) "
        f"pairs: {held}); host RSS {rss.start_gib:.2f} GiB before, peak "
        f"{rss.peak_gib:.2f} GiB; launches {launches}")
    for c, (_, _, _, _, cand_s, cand_eval_s, metric_s) in enumerate(cands):
        log(f"phase eval candidate {c} (lambda {lams[c]}): "
            f"{cand_s:.1f} s (eval {cand_eval_s:.1f} s, RMSEMetric "
            f"{metric_s:.2f} s), RMSE {scores[c]:.6f}")
        for f in range(EVAL_K):
            rep = reports[c * EVAL_K + f]  # one Mapping argument
            halves = ", ".join(f"{s} {t * 1e3:.1f} ms"
                               for s, t in rep["half_seconds"])
            log(f"phase eval candidate {c} fold {f}: staging "
                f"{rep['staging_seconds']:.2f} s, halves [{halves}], "
                f"{trainer_form(rep)}; {served[c * EVAL_K + f][1]:,} "
                f"queries served in {served[c * EVAL_K + f][2]:.1f} s")
    log(f"phase eval checks ({check_s:.1f} s): the folds' sizes add up, "
        f"and {len(sample):,} sampled ratings are held out once, by the "
        f"fold and at the place a numpy split gives them; RMSEs {scores} "
        f"all below the zero model's "
        f"{zero:.6f}; best index {best} (the argmin), its RMSE recomputed "
        f"in float64 {again:.9f}; best.json names the winner; instance "
        f"{rec.id} EVALCOMPLETED")
    if launches["fused_als"] + launches["fused_als_dma"] <= 0:
        raise AssertionError("eval never launched the fused kernel")
    return {"launches": launches, "eval_s": eval_s, "read_s": read_s,
            "peak_rss_gib": rss.peak_gib, "scores": scores}


def eval_parallel(storage, home) -> None:
    """The sweep of :class:`ML1MSweep` through the console twice on
    phase pio's store: sequentially (FastEval: one read, a model per
    candidate and fold) and
    with ``--parallelism 2`` (two threads training on the card at once,
    each reading the store itself).  The two must give the same best
    index and every RMSE within 1e-5 relative."""
    from pathlib import Path

    work = Path(home) / "eval"
    work.mkdir()
    cwd = os.getcwd()
    os.chdir(work)
    runs = {}
    try:
        for name, extra in (("sequential", []),
                            ("parallel", ["--parallelism", "2"])):
            t0 = time.perf_counter()
            with CaptureLog() as records:
                out = cli(["eval", "--engine", "recommendation",
                           "__main__.ML1MSweep", *extra], storage)
            secs = time.perf_counter() - t0
            _, res = eval_record(storage, out)
            forms = {rep["fused_gather"] for rep in records.all(_ALS_LOG)}
            runs[name] = (res["bestIndex"],
                          [r["score"] for r in res["results"]], secs, forms)
    finally:
        os.chdir(cwd)
    (b_seq, s_seq, t_seq, f_seq), (b_par, s_par, t_par, f_par) = (
        runs["sequential"], runs["parallel"])
    if b_seq != b_par or any(abs(a - b) > 1e-5 * b
                             for a, b in zip(s_par, s_seq)):
        raise AssertionError(f"the parallel sweep ({b_par}, {s_par}) "
                             f"differs from the sequential ({b_seq}, "
                             f"{s_seq})")
    log(f"phase pio eval ML-1M: sequential {t_seq:.1f} s (fused_gather "
        f"{sorted(f_seq)}), --parallelism 2 {t_par:.1f} s (fused_gather "
        f"{sorted(f_par)}); best index {b_seq} both, RMSEs {s_seq} and "
        f"{s_par} (max relative difference "
        f"{max(abs(a - b) / b for a, b in zip(s_par, s_seq)):.2e})")


# ------------------------------------------------------------ obs checks --
#
# The invariants of the reference's tools/*_smoke.py (obs, pulse, xray,
# fleet, train_obs, chaos), held on the port inside the phases that
# already run: each check set prints one {"obs": {check: bool},
# "detail": ...} line, and a false check fails the run.


def obs_report(phase: str, checks: dict, detail: dict) -> None:
    log(json.dumps({"obs": checks, "detail": {"phase": phase, **detail}},
                   default=str))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase {phase}: obs checks failed: {bad}")


def _raw(port: int, path: str, body=None, headers=None,
         timeout: float = 120.0) -> tuple:
    """``(status, body bytes, headers)``; an HTTP error status is an
    answer, not an exception."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data,
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), r.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _scrape(port: int) -> tuple:
    """``(exposition text, parsed state)`` of ``GET /metrics``."""
    from predictionio_tpu_torch.obs.fleet import parse_prometheus

    status, text, _ = _raw(port, "/metrics")
    if status != 200:
        raise AssertionError(f"GET /metrics answered {status}")
    text = text.decode()
    return text, parse_prometheus(text)


def _children(state: dict, name: str) -> dict:
    """``{labels dict as a sorted tuple: child state}`` of a family."""
    for fam in state["families"]:
        if fam["name"] == name:
            return {tuple(sorted(tuple(kv) for kv in c["labels"])): c
                    for c in fam["children"]}
    return {}


def _journal(dirpath) -> list:
    from pathlib import Path

    out = []
    for f in sorted(Path(dirpath).glob("spans-*.jsonl*")):
        out += [json.loads(x) for x in f.read_text().splitlines() if x]
    return out


def obs_traced_iteration(torch, ratings) -> dict:
    """ML-20M, rank 64: one fenced ``"pallas"`` iteration, then one under
    ``PIO_TPU_TRACE_ALS=1`` from the same factors (the xray_smoke
    split): each traced half must record ``als.gather``, ``als.gram``
    and ``als.solve`` spans, and launch the SPD solve kernel inside its
    full half.  Prints each phase's ms beside the untraced half's."""
    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
    from predictionio_tpu_torch.obs import get_tracer
    from predictionio_tpu_torch.ops import _build

    tr = ALSTrainer(ratings, cfg=ALSConfig(
        rank=RANK, num_iterations=1, lam=0.01, seed=3, solver="pallas"))
    U0, V0 = tr.init_factors()
    tr.run(U0, V0, 1)  # warm: the first halves pay one-time set-up
    tr.run(U0, V0, 1)
    untraced = dict(tr.half_seconds)
    full = tr._half
    gj = []

    def counted(upd, opp, side, lam=None):
        n0 = _build.LAUNCHES["gj_solve"]
        out = full(upd, opp, side, lam=lam)
        torch.cuda.synchronize()
        gj.append(_build.LAUNCHES["gj_solve"] - n0)
        return out

    tr._half = counted
    tracer = get_tracer()
    tracer.clear()
    os.environ["PIO_TPU_TRACE_ALS"] = "1"
    try:
        tr.run(U0, V0, 1)
    finally:
        os.environ.pop("PIO_TPU_TRACE_ALS")
    spans = {}
    for s in tracer.spans():
        if s.name.startswith("als."):
            spans.setdefault(s.attrs["side"], {})[s.name] = (
                s.duration_s * 1e3)
    phases = ("als.gather", "als.gram", "als.solve")
    del tr
    torch.cuda.empty_cache()
    ms = {side: {p.split(".")[1]: round(got.get(p, float("nan")), 2)
                 for p in phases} | {
              "untraced_half": round(untraced[side] * 1e3, 2)}
          for side, got in spans.items()}
    obs_report("train", {
        "traced_halves_record_phase_spans": set(spans) == {"user", "item"}
        and all(set(got) == set(phases) for got in spans.values()),
        "gj_launches_in_each_traced_half": len(gj) == 2 and min(gj) > 0,
    }, {"ms": ms, "gj_launches": gj})
    return ms


def obs_cli_train(store, iid: str, out_views: dict) -> None:
    """The console ``train`` under its tower session (train_obs_smoke
    1-2, 5): one sweep record per iteration with its phases, a
    ``final`` record ``completed``; each sweep's phases sum to its wall
    within 2%; setup + sweeps + tail reconcile with ``train.run`` within
    2%; ``runlog.summarize`` reads it."""
    from predictionio_tpu_torch.obs import runlog

    view = runlog.read_manifest(runlog.runs_root() / iid
                                / runlog.MANIFEST_NAME)
    final = view["final"]
    sweeps = view["sweeps"]
    phase_err = [abs(sum(s["phases"].values()) - s["seconds"])
                 / s["seconds"] for s in sweeps]
    total = (final["setupSeconds"] + sum(s["seconds"] for s in sweeps)
             + final["tailSeconds"])
    recon = abs(total - final["trainRunSeconds"]) / final["trainRunSeconds"]
    summary = runlog.summarize(view)
    out_views["cli"] = view
    obs_report("cli train", {
        "manifest_sweep_per_iteration": len(sweeps) == 2
        and all(s["phases"] for s in sweeps),
        "manifest_final_completed": final["status"] == "completed",
        "sweep_phases_sum_to_wall": max(phase_err) <= 0.02,
        "setup_sweeps_tail_reconcile": recon <= 0.02,
        "runlog_summarize": summary["status"] == "completed",
    }, {"sweeps": [{"seconds": s["seconds"], "phases": s["phases"]}
                   for s in sweeps],
        "phase_sum_err": phase_err, "train_run_s": final["trainRunSeconds"],
        "setup_s": final["setupSeconds"], "tail_s": final["tailSeconds"],
        "reconcile_err": recon})


def light_segment_extra_ms(port: int, query: dict, state=None) -> float:
    """pulse_smoke's overhead bound is per request at 4 clients: the
    handler window beyond the predict window (the reply's bookkeeping
    and socket write) over a light load of 128 queries, as deltas of the
    serving segments' and the latency histogram's sums (``state``: the
    ``/metrics`` before the load, scraped here when not given)."""
    if state is None:
        state = _scrape(port)[1]

    def sums(st):
        (lat,) = _children(st, "pio_query_latency_seconds").values()
        return lat["hist"]["sum"], sum(c["hist"]["sum"] for c in _children(
            st, "pio_serve_segment_seconds").values())

    lat0, seg0 = sums(state)
    light = [query] * 128
    _post_timed(port, "/queries.json", light, 4)
    lat1, seg1 = sums(_scrape(port)[1])
    return ((seg1 - seg0) - (lat1 - lat0)) / len(light) * 1e3


def obs_deploy(torch, port: int, n_answered: int, query: dict,
               telemetry_dir) -> dict:
    """A ``deploy`` process after its load (obs_smoke 1, 3; pulse_smoke
    1-5; xray_smoke 3-4): ``/metrics`` parses, the latency histogram
    counts every answered query, its buckets are monotone and its p50 and
    p99 agree with ``/status``; the seven serving segments have equal
    counts and reconcile with the latency sum; the batch-size histogram
    moved; a 2 s profile during live traffic writes a trace naming a CUDA
    kernel; the worst flight record carries ``segmentsMs`` and a latency
    exemplar's trace id joins a span tree on ``/debug/xray``; the card's
    memory gauges hold; the burn-rate gauges exist."""
    from predictionio_tpu_torch.obs.fleet import hist_quantile
    from predictionio_tpu_torch.obs.timeline import SERVE_SEGMENTS

    text, state = _scrape(port)
    status = _http(port, "/")
    (lat,) = _children(state, "pio_query_latency_seconds").values()
    hist = lat["hist"]
    cum = [int(float(x.rsplit(" ", 1)[1])) for x in text.splitlines()
           if x.startswith("pio_query_latency_seconds_bucket")]
    p50, p99 = hist_quantile(hist, 50), hist_quantile(hist, 99)
    sp50, sp99 = status["p50ServingSec"], status["p99ServingSec"]
    segs = {dict(k)["segment"]: c["hist"]
            for k, c in _children(state, "pio_serve_segment_seconds").items()}
    seg_counts = {s: segs[s]["count"] for s in SERVE_SEGMENTS}
    seg_sum = sum(h["sum"] for h in segs.values())
    extra_ms = (seg_sum - hist["sum"]) / max(hist["count"], 1) * 1e3
    light_extra_ms = light_segment_extra_ms(port, query, state)
    (bs,) = _children(state, "pio_microbatch_batch_size").values()
    mem = {dict(k)["stat"]: c["value"] for k, c in
           _children(state, "pio_device_memory_bytes").items()
           if dict(k)["device"] == "cuda:0"}
    total_mem = torch.cuda.get_device_properties(0).total_memory
    burn = {dict(k)["window"] for k in
            _children(state, "pio_slo_burn_rate")}

    # a 2 s capture while a thread keeps the server busy
    stop = threading.Event()

    def pepper():
        while not stop.is_set():
            _raw(port, "/queries.json", query)

    t = threading.Thread(target=pepper, daemon=True)
    t.start()
    try:
        code, prof, _ = _raw(port, "/debug/profile?seconds=2")
    finally:
        stop.set()
        t.join(timeout=60)
    prof = json.loads(prof)

    status = _http(port, "/")
    worst = status["xray"]["flight"]["worst"]
    xray = _http(port, "/debug/xray")
    records = {r["traceId"]: r for r in xray["flight"]["worst"]}
    joined = [e["traceId"] for e in xray["latencyExemplars"]
              if e["traceId"] in records and any(
                  s["name"] == "serve.query"
                  for s in records[e["traceId"]]["spans"])]
    journal = [s for s in _journal(telemetry_dir)
               if s["name"] == "serve.query"]
    checks = {
        "metrics_parse": bool(state["families"]),
        "latency_counts_every_query": hist["count"] == n_answered,
        "latency_buckets_monotone": bool(cum) and all(
            b >= a for a, b in zip(cum, cum[1:])) and cum[-1] == hist["count"],
        "p50_p99_agree_with_status": abs(p50 - sp50) <= max(0.15 * sp50,
                                                           1e-4)
        and abs(p99 - sp99) <= max(0.15 * sp99, 1e-4),
        "serve_segments_equal_counts": len(set(seg_counts.values())) == 1
        and seg_counts["parse"] >= n_answered,
        "segments_reconcile_with_latency": seg_sum >= 0.95 * hist["sum"]
        and 0.0 <= light_extra_ms <= 3.0,
        "batch_size_histogram_moved": bs["hist"]["count"] > 0
        and bs["hist"]["sum"] > bs["hist"]["count"],
        "profile_names_a_cuda_kernel": code == 200
        and prof.get("totalBytes", 0) > 0 and bool(prof.get("cudaKernels")),
        "flight_worst_has_segments": bool(worst)
        and "segmentsMs" in worst[0].get("attrs", {}),
        "exemplar_joins_a_span_tree": bool(joined),
        "device_memory_gauges": 0 < mem.get("bytes_in_use", 0)
        <= mem.get("peak_bytes_in_use", 0) <= total_mem
        and 0 < mem.get("bytes_limit", 0),
        "slo_burn_rate_windows": burn == {"1m", "5m", "1h"},
        "serve_spans_journaled": len(journal) >= n_answered,
    }
    detail = {
        "latency_count": hist["count"], "p50_s": [p50, sp50],
        "p99_s": [p99, sp99], "segment_counts": seg_counts,
        "segment_extra_ms": {"64 clients": extra_ms,
                             "4 clients": light_extra_ms},
        "batch_size_mean": bs["hist"]["sum"] / max(bs["hist"]["count"], 1),
        "profile": {k: prof.get(k) for k in ("totalBytes", "files")}
        | {"cudaKernels": len(prof.get("cudaKernels", [])),
           "status": code},
        "flight_worst_ms": [round(w["durationSec"] * 1e3, 2)
                            for w in worst[:3]],
        "device_memory": mem, "card_total_memory": total_mem,
        "journal_spans": len(journal),
    }
    obs_report("cli deploy", checks, detail)
    return detail


def obs_train_nan(storage, home, cli_views: dict) -> dict:
    """train_obs_smoke 3 at ML-1M counts: a console ``train`` under the
    plan ``train.nan:nth=2,times=1`` (what ``PIO_FAULT_PLAN`` arms at
    import) dies with ``ConvergenceError`` (``nan_factors``) with its
    manifest ``aborted`` on sweep 2 and ``pio_train_aborts_total
    {reason="nan_factors"}`` booked; ``diff_runs`` reads it beside the
    console train of phase cli (train_obs_smoke 5)."""
    from pathlib import Path

    from predictionio_tpu_torch.obs import get_registry, runlog, tower
    from predictionio_tpu_torch.resilience import faults

    def aborts() -> float:
        for key, c in _children(get_registry().dump_state(),
                                "pio_train_aborts_total").items():
            if dict(key).get("reason") == "nan_factors":
                return c["value"]
        return 0.0

    eng = Path(home) / "nan-engine"
    cli(["template", "get", "recommendation", str(eng)], storage)
    ej = eng / "engine.json"
    variant = json.loads(ej.read_text())
    variant["datasource"] = {"params": {"appName": "ml1m"}}
    variant["algorithms"] = [{"name": "als", "params": {
        "rank": RANK, "numIterations": 4, "lambda": 0.01,
        "solver": "fused"}}]
    ej.write_text(json.dumps(variant))
    before = aborts()
    faults.arm("train.nan:nth=2,times=1")
    err = None
    try:
        cli(["train", "--engine-json", str(ej)], storage)
    except tower.ConvergenceError as e:
        err = e
    finally:
        faults.disarm()
    recs = storage.get_metadata().engine_instance_get_all()
    rec = max(recs, key=lambda r: r.start_time)
    view = runlog.read_manifest(runlog.runs_root() / rec.id
                                / runlog.MANIFEST_NAME)
    final = view["final"]
    diff = runlog.diff_runs(cli_views["cli"], view)
    checks = {
        "convergence_error_nan_factors": err is not None
        and err.reason == "nan_factors",
        "instance_failed": rec.status == "FAILED",
        "manifest_aborted_on_sweep_2": final["status"] == "aborted"
        and final["sweeps"] == 2 and final.get("reason") == "nan_factors",
        "aborts_total_booked": aborts() - before == 1,
        "runlog_diff_parses": isinstance(diff, dict) and bool(diff),
    }
    detail = {"error": str(err), "final": {k: final.get(k) for k in (
        "status", "sweeps", "reason")}, "diff_keys": sorted(diff)}
    obs_report("pio train.nan", checks, detail)
    return detail


def obs_pio_chaos(storage, srv) -> dict:
    """At ML-1M, in process (chaos_smoke 1 and 3, obs_smoke 2):
    ``storage.write:nth=1,times=2,exc=operational`` is retried to a 201,
    on exhaustion the event server answers 503 + Retry-After, recovers,
    and ``/stats.json`` shows the rejections; ``wal.torn:times=1`` on a
    WAL server loses exactly the torn tail on restart and keeps every
    acknowledged event; on the engine server ``srv``,
    ``device.dispatch:times=1`` fails one query and the next answers
    200, ``reload.load_model`` makes ``/reload`` answer 500 while the old
    model serves and ``lastReloadError`` surfaces and heals, and a query
    sent with ``X-PIO-Trace`` has its ``serve.query`` span in the journal
    under that id."""
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.obs import get_tracer
    from predictionio_tpu_torch.obs.trace import collect_spans
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server import EventServer, EventServerConfig
    from predictionio_tpu_torch.storage import AccessKey

    # an app of its own: the ML-1M app's events stay as phase pio wrote
    md = storage.get_metadata()
    app = md.app_insert("chaos")
    storage.get_event_store().init_channel(app.id)
    key = md.access_key_insert(AccessKey(key="", appid=app.id))

    def rate(k: int) -> dict:
        return {"event": "rate", "entityType": "user",
                "entityId": f"chaos{k}", "targetEntityType": "item",
                "targetEntityId": item_id(k % 7),
                "properties": {"rating": 3.0},
                "eventTime": "2016-01-01T00:00:00.000Z"}

    post = f"/events.json?accessKey={key}"
    checks, detail = {}, {}
    ev = EventServer(storage, EventServerConfig(host="127.0.0.1", port=0))
    ev.start_background()
    try:
        faults.arm("storage.write:nth=1,times=2,exc=operational")
        retried = _raw(ev.port, post, rate(0))[0]
        faults.arm("storage.write:nth=1,times=3,exc=operational")
        st, body, hdrs = _raw(ev.port, post, rate(1))
        faults.disarm()
        recovered = _raw(ev.port, post, rate(2))[0]
        stats = _http(ev.port, f"/stats.json?accessKey={key}")
    finally:
        faults.disarm()
        ev.stop()
    statuses = {}
    for s in stats["lifetime"]["statusCount"]:
        statuses[s["status"]] = statuses.get(s["status"], 0) + s["count"]
    checks["write_retried_to_201"] = retried == 201
    checks["exhausted_write_503_retry_after"] = (
        st == 503 and hdrs.get("Retry-After") is not None
        and json.loads(body).get("error") == "StorageUnavailable")
    checks["write_recovers"] = recovered == 201
    checks["stats_book_rejections"] = statuses.get(503, 0) >= 1
    detail["stats"] = {"statusCount": statuses,
                       "resilience": stats.get("resilience")}

    wal = Path(tempfile.mkdtemp(prefix="pio_torn_"))
    try:
        ev = EventServer(storage, EventServerConfig(
            host="127.0.0.1", port=0, wal_dir=str(wal)))
        ev.start_background()
        try:
            acked = [_raw(ev.port, post, rate(k)) for k in range(10, 14)]
            faults.arm("wal.torn:times=1")
            torn = _raw(ev.port, post, rate(14))[0]
        finally:
            faults.disarm()
            ev.stop()
        ev = EventServer(storage, EventServerConfig(
            host="127.0.0.1", port=0, wal_dir=str(wal)))
        ev.start_background()
        try:
            ev.barrier()
            ids = [json.loads(b)["eventId"] for st, b, _ in acked
                   if st == 201]
            back = [_raw(ev.port, f"/events/{e}.json?accessKey={key}")[0]
                    for e in ids]
            tail = _raw(ev.port, f"/events.json?accessKey={key}"
                                 f"&entityType=user&entityId=chaos14")
        finally:
            ev.stop()
    finally:
        import shutil

        shutil.rmtree(wal, ignore_errors=True)
    checks["torn_write_refused"] = torn == 503
    checks["replay_keeps_every_acked_event"] = (
        len(ids) == 4 and back == [200] * 4)
    checks["replay_drops_the_torn_tail"] = (
        tail[0] == 404 or json.loads(tail[1]) == [])

    faults.arm("device.dispatch:times=1")
    q = {"user": user_id(3), "num": 5}
    try:
        dispatch = [_raw(srv.port, "/queries.json", q)[0] for _ in range(2)]
    finally:
        faults.disarm()
    checks["device_dispatch_fails_one_query"] = dispatch == [500, 200]
    faults.arm("reload.load_model:times=1")
    try:
        reload_code = _raw(srv.port, "/reload")[0]
        err = _http(srv.port, "/")["resilience"]["lastReloadError"]
        serves = _raw(srv.port, "/queries.json", q)[0]
    finally:
        faults.disarm()
    healed = _raw(srv.port, "/reload")[0]
    err_after = _http(srv.port, "/")["resilience"]["lastReloadError"]
    checks["reload_fault_500_old_model_serves"] = (
        reload_code == 500 and serves == 200
        and (err or "").startswith("InjectedFault"))
    checks["reload_error_heals"] = healed == 200 and err_after is None

    tracer = get_tracer()
    jdir = Path(tempfile.mkdtemp(prefix="pio_journal_"))
    tracer.configure(jdir)
    try:
        st, _, hdrs = _raw(srv.port, "/queries.json", q,
                           headers={"X-PIO-Trace": "t-chip-smoke-pio"})
        spans = collect_spans("t-chip-smoke-pio", jdir)
    finally:
        tracer.configure(None)
        import shutil

        shutil.rmtree(jdir, ignore_errors=True)
    checks["trace_header_span_journaled"] = (
        st == 200 and hdrs.get("X-PIO-Trace") == "t-chip-smoke-pio"
        and [s["name"] for s in spans] == ["serve.query"])
    detail.update(dispatch=dispatch, reload=[reload_code, err, healed],
                  trace_spans=[s["name"] for s in spans])
    obs_report("pio chaos", checks, detail)
    return detail


def obs_fleet_federation(port: int, workers: list, journal,
                         store: StoreHome) -> dict:
    """fleet_smoke on the quiet fleet: the router's ``GET /metrics``
    parses and its ``pio_events_requests_total`` equals the sum of the
    workers' own expositions; an item ``$set`` sent with ``X-PIO-Trace``
    is an ``events.write`` span under that id in its owner's journal."""
    from predictionio_tpu_torch.obs.fleet import state_counter_total
    from predictionio_tpu_torch.obs.trace import collect_spans

    trace = "t-chip-smoke-fleet"
    st, _, hdrs = _raw(port, f"/events.json?accessKey={store.key}", {
        "event": "$set", "entityType": "item", "entityId": item_id(0),
        "properties": {"categories": ["even"]},
        "eventTime": "2014-12-31T00:00:00.000Z"},
        headers={"X-PIO-Trace": trace})
    owner = entity_shard("item", item_id(0)) % FLEET_WORKERS
    opid = next(w["pid"] for w in workers if w["index"] == owner)
    # two health sweeps: the router holds every worker's newest snapshot
    time.sleep(2.5)
    own = sum(state_counter_total(_scrape(w["port"])[1],
                                  "pio_events_requests_total")
              for w in workers)
    _, merged = _scrape(port)
    fed = state_counter_total(merged, "pio_events_requests_total")
    spans = collect_spans(trace, journal)
    checks = {
        "router_metrics_parse": bool(merged["families"]),
        "router_events_equal_worker_sum": own > 0 and fed == own,
        "trace_reaches_owner_journal": st == 201
        and hdrs.get("X-PIO-Trace") == trace and any(
            s["name"] == "events.write" and s["pid"] == opid
            for s in spans),
    }
    detail = {"router_events_total": fed, "worker_sum": own,
              "trace_spans": [(s["name"], s["pid"]) for s in spans],
              "owner_pid": opid}
    obs_report("fleet", checks, detail)
    return detail


def obs_shard_down() -> dict:
    """A worker started with ``PIO_FAULT_PLAN="store.shard_down:shard=1"``
    on a 4-shard store of its own answers the structured 503 for shard
    1's entities and 201 for the others."""
    import shutil
    import tempfile

    from predictionio_tpu_torch.storage import Storage

    home = tempfile.mkdtemp(prefix="pio_down_")
    env = {
        "PIO_TPU_HOME": home,
        "PIO_STORAGE_SOURCES_ML20M_PATH": os.path.join(home, "shards"),
        "PIO_STORAGE_SOURCES_ML20M_TYPE": "sqlite-sharded",
        "PIO_STORAGE_SOURCES_ML20M_SHARDS": str(STORE_SHARDS),
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "ML20M",
    }
    st = Storage(env)
    out = cli(["app", "new", "down"], st)
    key = out.split("Access key: ")[1].split()[0]
    st.close()
    proc = Console(home, ["eventserver", "--ip", "127.0.0.1", "--port", "0",
                          "--wal-dir", os.path.join(home, "wal")],
                   "down", env={**env,
                                "PIO_FAULT_PLAN": "store.shard_down:shard=1"})
    try:
        port = proc.wait_port()
        got = []
        for k in range(24):
            u = f"d{k}"
            st_, body, hdrs = _raw(port, f"/events.json?accessKey={key}", {
                "event": "rate", "entityType": "user", "entityId": u,
                "targetEntityType": "item", "targetEntityId": item_id(0),
                "properties": {"rating": 4.0}})
            got.append((entity_shard("user", u), st_, json.loads(body),
                        hdrs.get("Retry-After")))
    finally:
        proc.stop()
        shutil.rmtree(home, ignore_errors=True)
    down = [g for g in got if g[0] == 1]
    up = [g for g in got if g[0] != 1]
    checks = {
        "shard_down_structured_503": bool(down) and all(
            s == 503 and b.get("error") == "ShardUnavailable"
            and b.get("shard") == 1 and retry for _, s, b, retry in down),
        "other_shards_201": bool(up) and all(s == 201 for _, s, _, _ in up),
    }
    detail = {"shard_1": len(down), "others": len(up)}
    obs_report("fleet shard_down", checks, detail)
    return detail


class PostSink:
    """A small HTTP collector in this process: keeps every POST's path,
    body and ``X-PIO-Trace`` and answers 200 (the remote log's target)."""

    def __init__(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        sink = self
        self.posts = []
        self.lock = threading.Lock()

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = self.rfile.read(int(self.headers["Content-Length"]))
                with sink.lock:
                    sink.posts.append((self.path, body,
                                       self.headers.get("X-PIO-Trace")))
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}/log"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.thread.start()

    def bodies(self) -> list:
        with self.lock:
            return [b for _, b, _ in self.posts]

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(10)


def _wait_for(pred, timeout: float, what: str, step: float = 0.1):
    """Poll ``pred()`` until it returns a true value (returned), or fail
    after ``timeout`` seconds naming ``what``."""
    deadline = time.monotonic() + timeout
    while True:
        got = pred()
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out after {timeout:.0f} s waiting "
                                 f"for {what}")
        time.sleep(step)


# phase formats' depth: the first ratings of the ML-1M draw
FORMATS_RATINGS = 100_000


def phase_formats(storage, u, i, v) -> dict:
    """The other import and export formats on the store of phase pio, at
    a cut depth: the first ``FORMATS_RATINGS`` of its ML-1M ratings, as
    JSON lines through the console's ``import`` into an app of their own
    (``ml1m-head``) → the console's ``export`` to ``.npz`` and to
    Parquet, each file imported by the console's ``import`` into an app
    of its own, and the deduplicated ratings written as a MovieLens
    ``::`` file and imported by ``import_ratings_csv``; each new app's
    ``find_ratings`` is held bit for bit against the synthetic triples.
    Without pyarrow on this host the console's Parquet export must fail
    with the reference's ``ImportError``.  Each export and import is
    timed."""
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import main as cli_main
    from predictionio_tpu_torch.tools import import_ratings_csv

    try:
        import pyarrow  # noqa: F401
        have_pyarrow = True
    except ImportError:
        have_pyarrow = False
    es = storage.get_event_store()
    md = storage.get_metadata()
    n_events = FORMATS_RATINGS
    u, i, v = u[:n_events], i[:n_events], v[:n_events]
    want = expected_ratings(u, i, v, ML1M_ITEMS)
    tmp = Path(tempfile.mkdtemp(prefix="pio_formats_"))
    secs, sizes = {}, {}
    files = {"npz": tmp / "ml1m.npz", "parquet": tmp / "ml1m.parquet"}
    try:
        src = tmp / "head.jsonl"
        with open(src, "wb") as f:
            write_rate_lines(f, u, i, v, 0)
        cli(["app", "new", "ml1m-head"], storage)
        app_id = md.app_get_by_name("ml1m-head").id
        out = cli(["import", "--appid", str(app_id), "--input", str(src)],
                  storage)
        if out != f"Imported {n_events} events.\n":
            raise AssertionError(f"import of the head: {out!r}")
        same_ratings(es.find_ratings(app_id), want,
                     "the head of ML-1M through JSON lines")
        for fmt, path in files.items():
            argv = ["export", "--appid", str(app_id), "--output", str(path)]
            if fmt == "parquet" and not have_pyarrow:
                try:
                    with contextlib.redirect_stdout(io.StringIO()):
                        cli_main(argv, storage=storage)
                except ImportError as e:
                    if "pyarrow" not in str(e):
                        raise
                    log(f"phase formats: no pyarrow on this host; the "
                        f"console's Parquet export raised {e!r}")
                    continue
                raise AssertionError("a Parquet export without pyarrow "
                                     "did not raise ImportError")
            t0 = time.perf_counter()
            out = cli(argv, storage)
            secs[f"export {fmt}"] = time.perf_counter() - t0
            if out != f"Exported {n_events} events to {path}.\n":
                raise AssertionError(f"export {fmt}: {out!r}")
            sizes[fmt] = path.stat().st_size / 1e6
            out = cli(["app", "new", f"ml1m-{fmt}"], storage)
            new_id = md.app_get_by_name(f"ml1m-{fmt}").id
            t0 = time.perf_counter()
            out = cli(["import", "--appid", str(new_id), "--input",
                       str(path)], storage)
            secs[f"import {fmt}"] = time.perf_counter() - t0
            if out != f"Imported {n_events} events.\n":
                raise AssertionError(f"import {fmt}: {out!r}")
            same_ratings(es.find_ratings(new_id), want,
                         f"ML-1M through the {fmt} format")
        # the ratings a user holds (one per pair), as MovieLens writes them
        src = tmp / "ratings.dat"
        uids = np.asarray(want.users.ids)[want.user_ix]
        iids = np.asarray(want.items.ids)[want.item_ix]
        with open(src, "w") as f:
            for a, b, r in zip(uids.tolist(), iids.tolist(),
                               want.rating.tolist()):
                f.write(f"{a}::{b}::{r:.1f}::978300760\n")
        cli(["app", "new", "ml1m-csv"], storage)
        csv_id = md.app_get_by_name("ml1m-csv").id
        t0 = time.perf_counter()
        n = import_ratings_csv(src, es, csv_id)
        secs["import csv"] = time.perf_counter() - t0
        if n != len(want.rating):
            raise AssertionError(f"import_ratings_csv imported {n}")
        same_ratings(es.find_ratings(csv_id), want,
                     "ML-1M through the MovieLens file")
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    rows = {k: len(want.rating) if k == "import csv" else n_events
            for k in secs}
    log(f"phase formats (the first {n_events:,} ML-1M ratings): "
        + "; ".join(f"{k} {t:.2f} s ({rows[k] / t:,.0f} events/s)"
                    for k, t in secs.items())
        + f"; files MB {({k: round(m, 1) for k, m in sizes.items()})}; "
        f"pyarrow {'present' if have_pyarrow else 'absent'}; every "
        f"imported app's find_ratings equals the synthetic triples")
    return {"seconds": secs, "pyarrow": have_pyarrow}


def obs_delivery_chaos(storage, engine, ep, iid) -> dict:
    """At ML-1M, the fault points of the serving edge's delivery queues:
    an ``EngineServer`` with feedback to an in-process event server (the
    ``chaos`` app's key) and its remote log to a sink in this script,
    under ``seed=5;http.feedback:prob=0.5`` for 16 queries and
    ``seed=5;http.remote_log:prob=0.5`` for 4 invalid ones.  No query
    fails, each queue's delivered plus dropped equals what it was given,
    the fault fired, and the event server and the sink hold what was
    delivered."""
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server import (
        EngineServer, EventServer, EventServerConfig, ServerConfig,
    )

    md = storage.get_metadata()
    app = md.app_get_by_name("chaos")
    key = md.access_key_get_by_app(app.id)[0].key
    es = storage.get_event_store()
    before = sum(1 for _ in es.find(app_id=app.id, entity_type="pio_pr"))
    sink = PostSink()
    ev = EventServer(storage, EventServerConfig(host="127.0.0.1", port=0))
    ev.start_background()
    srv = EngineServer(engine, ep, iid, ctx=WorkflowContext(
        mode="Serving"), config=ServerConfig(
        host="127.0.0.1", port=0, feedback=True,
        event_server_url=f"http://127.0.0.1:{ev.port}", access_key=key,
        log_url=sink.url, breaker_reset_s=0.5))
    thread = srv.start_background()
    checks, detail = {}, {}
    try:
        queries = query_mix(16, 29, ML1M_USERS, ML1M_ITEMS)
        faults.arm("seed=5;http.feedback:prob=0.5")
        try:
            codes = [_raw(srv.port, "/queries.json", q)[0] for q in queries]
            drained = srv._feedback_queue.flush(120)
        finally:
            faults.disarm()
        fb = srv.status_json()["resilience"]["feedback"]
        stored = sum(1 for _ in es.find(app_id=app.id,
                                        entity_type="pio_pr")) - before
        checks["feedback_fault_fails_no_query"] = codes == [200] * 16
        checks["feedback_delivered_plus_dropped"] = drained and (
            fb["delivered"] + fb["dropped"] == fb["submitted"] == 16)
        checks["feedback_fault_fired"] = fb["sendFailures"] > 0
        checks["feedback_stored_as_delivered"] = stored == fb["delivered"]
        faults.arm("seed=5;http.remote_log:prob=0.5")
        try:
            bad = [_raw(srv.port, "/queries.json", {"num": 3})[0]
                   for _ in range(4)]
            drained = srv._log_queue.flush(120)
        finally:
            faults.disarm()
        rl = srv.status_json()["resilience"]["remoteLog"]
        checks["remote_log_fault_answers_400s"] = bad == [400] * 4
        checks["remote_log_delivered_plus_dropped"] = drained and (
            rl["delivered"] + rl["dropped"] == rl["submitted"] == 4)
        checks["remote_log_fault_fired"] = rl["sendFailures"] > 0
        checks["remote_log_sink_holds_delivered"] = (
            len(sink.bodies()) == rl["delivered"])
        detail.update(feedback=fb, remoteLog=rl, stored=stored)
    finally:
        srv.stop()
        thread.join(timeout=30)
        ev.stop()
        sink.stop()
    obs_report("pio delivery chaos", checks, detail)
    return detail


def _replica_pids(log_path) -> dict:
    """``{replica index: pid}`` from a fleet deploy's replica lines."""
    out = {}
    for line in log_path.read_text(errors="replace").splitlines():
        if line.startswith("Replica ") and "(pid " in line:
            out[int(line.split()[1])] = int(line.split("(pid ")[1]
                                            .split(")")[0])
    return out


def phase_router(torch, store: StoreHome, cli_out: dict) -> dict:
    """The replica router at ML-20M on the instance phase cli's console
    ``train`` produced: ``deploy --replicas 2 --feedback`` as a process
    (a router and two replica processes, each its own CUDA context on
    the card), feedback to an in-process event server on an app of its
    own in the same store (``app new feedback``; the ML-20M app stays as
    phases read and eval check it), the remote log to a sink here.
    512 queries from 64 clients (and one traced query) through the
    router, each reply held against an in-process ``predict`` apart from
    its ``prId``; both replicas forward; the event server holds exactly
    one ``pio_pr`` ``predict`` event per answered query, named by its
    reply's ``prId`` and carrying its query, and each replica's feedback
    queue delivered all it was given; the traced query's id is on its
    feedback write in the journal; one invalid query gives one POST to
    the sink; ``/debug/fleet`` lists both replicas; a replica's ``GET /``
    for ``text/html`` is the status page.  Then a replica is SIGKILLed
    under a second load of 256 queries: none fails, and the router books
    the failover and the supervisor's respawn.  ``undeploy`` stops the
    router and every replica."""
    import signal
    from pathlib import Path

    from predictionio_tpu_torch.obs import get_tracer
    from predictionio_tpu_torch.obs.trace import collect_spans
    from predictionio_tpu_torch.server import EventServer, EventServerConfig

    st = store.storage
    md = st.get_metadata()
    es = st.get_event_store()
    out = cli(["app", "new", "feedback"], st)
    key = out.split("Access key: ")[1].split()[0]
    fb_app = md.app_get_by_name("feedback").id
    predict = cli_out["predict"]
    sink = PostSink()
    tracer = get_tracer()
    # this process, the router and its replicas journal here (phase lint
    # stitches the traced query from it); the store's close removes it
    jdir = Path(store.home) / "router-telemetry"
    tracer.configure(jdir)
    ev = EventServer(st, EventServerConfig(host="127.0.0.1", port=0))
    ev.start_background()
    checks, detail = {}, {}
    proc = Console(store.home, [
        "deploy", "--engine-json", cli_out["engine_json"],
        "--engine-instance-id", cli_out["iid"], "--ip", "127.0.0.1",
        "--port", "0", "--replicas", "2", "--health-interval", "0.5",
        "--feedback", "--event-server-url", f"http://127.0.0.1:{ev.port}",
        "--accesskey", key, "--log-url", sink.url,
        "--log-prefix", "pio-router "], "router",
        env={"PIO_TPU_TELEMETRY_DIR": str(jdir)})
    try:
        port = proc.wait_port(timeout=600)
        boot_s = proc.boot_s
        pids = _replica_pids(proc.log_path)
        try:
            traced_q = {"user": user_id(7), "num": 10}
            st_tr, body, _ = _raw(port, "/queries.json", traced_q, headers={
                "X-PIO-Trace": "t-chip-router-fb"})
            queries = query_mix(512, 23, N_USERS, N_ITEMS)
            load = http_load(port, [], queries, 64)
        except Exception as e:
            proc.fail(f"failed its queries: {e!r}")
        replies = [json.loads(body)] + load["replies"]
        asked = [traced_q] + queries
        trades = sum(_same_reply(r, predict(q), f"router query {q}")
                     for q, r in zip(asked, replies))
        checks["replies_equal_predict"] = st_tr == 200
        checks["every_reply_has_a_prId"] = all(
            r.get("prId") for r in replies) and len(
            {r["prId"] for r in replies}) == len(replies)
        fleet = _http(port, "/debug/fleet")
        reps = fleet["replicas"]
        checks["debug_fleet_lists_both"] = [r["name"] for r in reps] == [
            "replica-0", "replica-1"]
        checks["both_replicas_forward"] = all(r["forwarded"] > 0
                                              for r in reps)
        urls = [r["url"] for r in reps]

        def drained():
            blocks = [_http(int(u.rsplit(":", 1)[1]), "/")["resilience"][
                "feedback"] for u in urls]
            ok = all(b["depth"] == 0 and b["delivered"] == b["submitted"]
                     for b in blocks)
            return blocks if ok else None

        blocks = _wait_for(drained, 120, "the replicas' feedback queues")
        checks["feedback_none_dropped"] = all(
            b["dropped"] == 0 for b in blocks) and sum(
            b["submitted"] for b in blocks) == len(replies)
        events = list(es.find(app_id=fb_app, entity_type="pio_pr"))
        by_pr = {e.entity_id: e for e in events}
        checks["one_feedback_event_per_query"] = (
            len(events) == len(replies) == len(by_pr)
            and all(e.event == "predict" for e in events))
        checks["feedback_named_by_prId_with_its_query"] = all(
            r["prId"] in by_pr
            and by_pr[r["prId"]].properties.to_json()["query"] == q
            for q, r in zip(asked, replies))
        spans = collect_spans("t-chip-router-fb", jdir)
        checks["traced_feedback_write_journaled"] = "events.write" in [
            s["name"] for s in spans]
        bad = _raw(port, "/queries.json", {"num": 3})[0]
        logs = _wait_for(lambda: sink.bodies(), 60, "the remote log")
        time.sleep(1.0)  # a second POST would have landed by now
        logs = sink.bodies()
        msg = (json.loads(logs[0][len(b"pio-router "):])["message"]
               if len(logs) == 1 and logs[0].startswith(b"pio-router {")
               else "")
        checks["invalid_query_one_remote_log"] = (
            bad == 400 and msg.startswith("Query is invalid"))
        html_st, html, hdrs = _raw(int(urls[0].rsplit(":", 1)[1]), "/",
                                   headers={"Accept": "text/html"})
        checks["replica_status_page_html"] = (
            html_st == 200 and hdrs["Content-Type"].startswith("text/html")
            and cli_out["iid"].encode() in html)
        profcat = router_profcat(port, urls, Path(store.home))
        checks["profcat_fleet_profile"] = all(profcat["checks"].values())

        # failover: SIGKILL replica 0 once the router has taken 64
        # queries of the second load
        second = query_mix(256, 31, N_USERS, N_ITEMS)
        start = _http(port, "/")["requestCount"]

        def kill():
            _wait_for(lambda: _http(port, "/")["requestCount"]
                      >= start + 64, 120, "the second load", 0.01)
            os.kill(pids[0], signal.SIGKILL)

        killer = threading.Thread(target=kill)
        killer.start()
        try:
            load2 = _post_timed(port, "/queries.json", second, 64)
        finally:
            killer.join()
        codes = [s for s, _, _ in load2]
        checks["no_query_fails_through_a_kill"] = codes == [200] * 256
        seen = {}

        def respawned():
            f = seen["fleet"] = _http(port, "/debug/fleet")
            r0 = f["replicas"][0]
            return f if (r0["respawns"] >= 1 and r0["failovers"] >= 1
                         and f["healthyReplicas"] == 2) else None

        t0 = time.perf_counter()
        try:
            fleet2 = _wait_for(respawned, 300, "the respawn of replica 0",
                               0.5)
        except AssertionError as e:
            proc.fail(f"{e}; /debug/fleet {seen.get('fleet')}")
        respawn_s = time.perf_counter() - t0
        checks["failover_and_respawn_booked"] = True
        detail.update(fleet=[{k: r.get(k) for k in (
            "name", "forwarded", "failovers", "respawns", "healthy",
            "p50Ms", "p99Ms")} for r in fleet2["replicas"]],
            feedback=blocks, trades=trades)
        if "Undeployed" not in cli(["undeploy", "--port", str(port)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
        checks["undeploy_stops_router_and_replicas"] = rc == 0 and not \
            _pids_with("pio-serve-fleet-")
    finally:
        proc.stop()
        ev.stop()
        sink.stop()
        tracer.configure(None)
    obs_report("router", checks, detail)
    single = cli_out["edges"]["eventloop"]
    conc2 = [ms for _, _, ms in load2]
    log(f"phase router ML-20M: deploy --replicas 2 up in {boot_s:.1f} s; "
        f"512 queries from 64 clients {pcts(load['conc_ms'])}, "
        f"{load['qps']:,.0f} queries/s (single deploy of phase cli: "
        f"{pcts(single['conc_ms'])}, {single['qps']:,.0f} queries/s); "
        f"forwarded {[r['forwarded'] for r in reps]}; {len(events)} "
        f"feedback events, one per answered query; through a SIGKILL of "
        f"replica 0: 256 queries {pcts(conc2)}, none failed, failovers "
        f"{fleet2['replicas'][0]['failovers']}, respawned and healthy "
        f"{respawn_s:.1f} s after the load")
    return {"qps": load["qps"], "conc_ms": load["conc_ms"],
            "boot_s": boot_s, "respawn_s": respawn_s, "journal": jdir,
            "trace": "t-chip-router-fb", "profcat": profcat}


def router_profcat(port: int, replica_urls: list, scratch) -> dict:
    """``python -m predictionio_tpu_torch.tools.profcat --fleet URL
    --seconds 1 --out F`` against the live router: it must exit 0, the
    merged profile must carry the router's root and each replica's (the
    source tag is the port), and ``F`` must parse with
    ``obs.scope.parse_folded`` to the total its table printed."""
    from predictionio_tpu_torch.obs import scope

    root = os.path.dirname(os.path.abspath(__file__))
    out = scratch / "fleet.folded"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.profcat",
         "--fleet", f"http://127.0.0.1:{port}", "--seconds", "1",
         "--out", str(out)], capture_output=True, text=True, timeout=120,
        cwd=root, env={**os.environ, "PYTHONPATH": root})
    merged = scope.parse_folded(out.read_text()) if out.exists() else {}
    roots = {stack.split("/", 1)[0] for stack in merged}
    want = {str(port)} | {u.rsplit(":", 1)[1] for u in replica_urls}
    head = re.search(r"# (\d+) profile\(s\), (\d+) samples", proc.stdout)
    return {"checks": {
        "exits_0": proc.returncode == 0,
        "router_and_every_replica": want <= roots,
        "file_total_is_the_tables": bool(head) and int(head[1]) == len(want)
        and int(head[2]) == sum(merged.values()) > 0},
        "detail": {"roots": sorted(roots), "samples": sum(merged.values()),
                   "s": round(time.perf_counter() - t0, 1),
                   "stderr": proc.stderr[-500:]}}


LINT_PHASE_LIMIT_S = 30.0


def _stitched(node: dict) -> dict:
    """A span tree node as the ``tracecat --json`` document gives it:
    the span's own keys and its children by start."""
    out = {k: v for k, v in node.items()
           if k not in ("children", "_start", "_end", "_journal")}
    out["children"] = [_stitched(c) for c in sorted(
        node["children"], key=lambda c: c["_start"])]
    return out


def phase_lint(store: StoreHome, router_out: dict) -> dict:
    """Phase lint: the port's static gate and its two obs commands, each
    a process of its own on this host, all started at once after phase
    router (whose span journals it reads):

    * ``python -m predictionio_tpu_torch.analysis --format json --report
      F`` over the gate scope (``predictionio_tpu_torch/``, this script,
      ``kernel_variants.py``): exit 0, no active finding, the report the
      one it printed;
    * ``python -m predictionio_tpu_torch.tools.runlog`` ``list --json``,
      ``summarize RUN`` and ``diff A B --json`` over the run manifests
      the console trains of phases ring and cli wrote (at least two):
      each output equal to ``obs.runlog`` computed in this process;
    * ``python -m predictionio_tpu_torch.tools.tracecat ID --json`` on
      phase router's traced query, journaled by the router, the replica
      that answered it and this process's event server (its feedback
      write): at least 2 processes, and the tree ``obs.trace.build_tree``
      gives in this process.

    Checks go on one ``{"obs": ...}`` line with the findings; a false
    one, or the phase past :data:`LINT_PHASE_LIMIT_S`, fails the run."""
    from pathlib import Path

    from predictionio_tpu_torch.obs import runlog
    from predictionio_tpu_torch.obs.trace import build_tree, collect_spans

    t_phase = time.perf_counter()
    root = str(Path(__file__).resolve().parent)
    report = Path(store.home) / "piolint-report.json"
    runs = runlog.runs_root()
    views = runlog.list_runs(runs)
    ids = [v["header"]["instanceId"] for v in views]
    jdir, trace = router_out["journal"], router_out["trace"]
    argv = {
        "analysis": ["predictionio_tpu_torch.analysis", "--format", "json",
                     "--report", str(report)],
        "runlog_list": ["predictionio_tpu_torch.tools.runlog", "--root",
                        str(runs), "list", "--json"],
        "runlog_summarize": ["predictionio_tpu_torch.tools.runlog",
                             "--root", str(runs), "summarize", ids[-1]],
        "runlog_diff": ["predictionio_tpu_torch.tools.runlog", "--root",
                        str(runs), "diff", ids[-1], ids[0], "--json"],
        "tracecat": ["predictionio_tpu_torch.tools.tracecat", trace,
                     "--dir", str(jdir), "--json"],
    }
    procs, outs, secs = {}, {}, {}
    files = {name: (Path(store.home) / f"lint-{name}.out",
                    Path(store.home) / f"lint-{name}.err") for name in argv}
    try:
        t0 = time.perf_counter()
        for name, args in argv.items():
            with open(files[name][0], "wb") as out, \
                    open(files[name][1], "wb") as err:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", *args], cwd=root,
                    env={**os.environ, "PYTHONPATH": root},
                    stdout=out, stderr=err)
        # each command's seconds from the common start to its exit
        while len(secs) < len(procs):
            if time.perf_counter() - t0 > LINT_PHASE_LIMIT_S:
                raise AssertionError("phase lint: commands still running "
                                     f"after {LINT_PHASE_LIMIT_S} s")
            for name, proc in procs.items():
                if name not in secs and proc.poll() is not None:
                    secs[name] = time.perf_counter() - t0
            time.sleep(0.01)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for name, proc in procs.items():
        out, err = (f.read_text() for f in files[name])
        if proc.returncode != 0 and name != "analysis":
            raise AssertionError(f"phase lint: {name} exited with "
                                 f"{proc.returncode}: {err[-4000:]}")
        outs[name] = (proc.returncode, out, err)

    def same(got: str, want) -> bool:
        return json.loads(got) == json.loads(json.dumps(want))

    rc, out, err = outs["analysis"]
    lint = json.loads(out) if out.strip().startswith("{") else {}
    counts = lint.get("counts", {})
    view = {v["header"]["instanceId"]: v for v in views}
    card = runlog.summarize(view[ids[-1]])
    if view[ids[-1]]["events"]:
        card["eventRecords"] = view[ids[-1]]["events"][-20:]
    spans = collect_spans(trace, jdir)
    processes = {(s.get("pid"), s.get("worker")) for s in spans}
    tree = [_stitched(r) for r in build_tree(spans)]
    cat = json.loads(outs["tracecat"][1])
    checks = {
        "analysis_exit_0_no_active_finding": rc == 0
        and counts.get("active") == 0,
        "analysis_report_is_what_it_printed": bool(lint)
        and json.loads(report.read_text()) == lint,
        "runlog_list_equals_obs_runlog": len(views) >= 2 and same(
            outs["runlog_list"][1], [runlog.summarize(v) for v in views]),
        "runlog_summarize_equals_obs_runlog": same(
            outs["runlog_summarize"][1], card),
        "runlog_diff_equals_obs_runlog": same(
            outs["runlog_diff"][1], runlog.diff_runs(view[ids[-1]],
                                                     view[ids[0]])),
        "tracecat_stitches_2_processes": len(processes) >= 2
        and cat["processCount"] == len(processes)
        and cat["spanCount"] == len(spans)
        and {"router.request", "serve.query", "events.write"} <= {
            s["name"] for s in spans},
        "tracecat_equals_build_tree": cat["roots"] == json.loads(
            json.dumps(tree)) and cat["rootCount"] == len(tree),
    }
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_its_limit"] = phase_s <= LINT_PHASE_LIMIT_S
    detail = {"counts": counts, "engines": lint.get("engines"),
              "findings": [f"{f['path']}:{f['line']} {f['rule']}"
                           + (" (baselined)" if f["baselined"] else "")
                           for f in lint.get("findings", [])],
              "analysis_stderr": err[-2000:] if rc else "",
              "runs": ids, "spans": len(spans),
              "processes": len(processes),
              "seconds": {k: round(v, 3) for k, v in secs.items()},
              "phase_s": phase_s}
    obs_report("lint", checks, detail)
    log(f"phase lint: piolint {counts.get('active')} active, "
        f"{counts.get('baselined')} baselined finding(s) in "
        f"{secs['analysis']:.1f} s; runlog over {len(ids)} runs and "
        f"tracecat over {len(spans)} spans of {len(processes)} processes "
        f"equal to obs in process; phase {phase_s:.1f} s")
    return {"phase_s": phase_s}


# the fold-in windows of phase foldin: cold-start users with their
# ratings of existing items, existing users with new ratings, brand-new
# items rated by some of those users, then two same-shaped windows
FOLDIN_COLD, FOLDIN_COLD_K = 500, 20
FOLDIN_WARM, FOLDIN_WARM_K = 500, 5
FOLDIN_NEW_ITEMS, FOLDIN_NEW_ITEM_K = 20, 50
FOLDIN_SMALL = 100
FOLDIN_FRESH = 5
# phase foldin's own limit, the GJ timing at the cycles' rungs included
FOLDIN_PHASE_LIMIT_S = 75.0


def foldin_window(rng, cold, warm=(), new_items=0) -> list:
    """A fold-in window as the events a user posts: each id of ``cold``
    rates ``FOLDIN_COLD_K`` existing items (Zipf 1.0, distinct), each
    existing user index of ``warm`` rates ``FOLDIN_WARM_K`` items, and
    ``new_items`` new items each get ``FOLDIN_NEW_ITEM_K`` ratings from
    users of ``warm``.  No event time: the import stamps them now, after
    every rating the model was trained on."""
    w = 1.0 / np.arange(1, N_ITEMS + 1)
    w /= w.sum()
    out = []

    def rate(user, item, r):
        out.append({"event": "rate", "entityType": "user",
                    "entityId": user, "targetEntityType": "item",
                    "targetEntityId": item,
                    "properties": {"rating": float(r)}})

    for u in cold:
        for j in rng.choice(N_ITEMS, FOLDIN_COLD_K, replace=False, p=w):
            rate(u, item_id(j), rng.integers(1, 11) * 0.5)
    for u in warm:
        for j in rng.choice(N_ITEMS, FOLDIN_WARM_K, replace=False, p=w):
            rate(user_id(u), item_id(j), rng.integers(1, 11) * 0.5)
    for k in range(new_items):
        for u in rng.choice(list(warm), FOLDIN_NEW_ITEM_K, replace=False):
            rate(user_id(u), f"new{k:03d}", rng.integers(1, 11) * 0.5)
    return out


class Float64Solve:
    """``FoldInSolver.solve`` in float64 on the host, one row at a
    time: the same (B, K) rung and the same truncation to a row's most
    recent K ratings, the ALS-WR normal equations built and solved by
    numpy (explicit ratings only)."""

    def __init__(self, solver):
        if solver.cfg.implicit:
            raise ValueError("the float64 solve takes explicit ratings")
        self.s = solver

    def solve(self, opp, row_ratings, lam=None):
        cfg = self.s.cfg
        lam = cfg.lam if lam is None else lam
        out = np.zeros((len(row_ratings), opp.shape[1]))
        if not row_ratings:
            return out
        _, k = self.s.padded_shape(len(row_ratings),
                                   max(len(v) for _, v in row_ratings))
        table = np.asarray(opp, np.float64)
        for j, (ixs, vals) in enumerate(row_ratings):
            ixs, vals = np.asarray(ixs)[-k:], np.asarray(vals, np.float64)[-k:]
            y = table[ixs]
            reg = lam * max(len(ixs), 1) if cfg.weighted_lambda else lam
            out[j] = np.linalg.solve(y.T @ y + reg * np.eye(len(table[0])),
                                     y.T @ vals)
        return out


def import_lines(store: StoreHome, events: list, name: str) -> float:
    """``events`` through the console's ``import`` as a JSON-lines file;
    the seconds to its return."""
    from pathlib import Path

    src = Path(store.home) / f"{name}.jsonl"
    src.write_text("".join(json.dumps(e) + "\n" for e in events))
    t0 = time.perf_counter()
    out = cli(["import", "--appid", str(store.app_id), "--input", str(src)],
              store.storage)
    dt = time.perf_counter() - t0
    src.unlink()
    if out != f"Imported {len(events)} events.\n":
        raise AssertionError(f"import of {name}: {out!r}")
    return dt


def _reloads(port: int) -> float:
    """``pio_reloads_total`` of a server, all outcomes."""
    from predictionio_tpu_torch.obs import fleet

    state = fleet.parse_prometheus(_raw(port, "/metrics")[1].decode())
    return sum(c["value"] for c in state.get(
        "pio_reloads_total", {}).get("children", []))


def phase_foldin(torch, store: StoreHome, cli_out: dict) -> dict:
    """Fold-in at ML-20M on the 4-shard store, after phase eval (its
    writes outdate the scan cache: nothing reads the store after it).
    Console ``train`` of a ``"pallas"`` variant of phase cli's
    engine.json (rank 64) → ``deploy --replicas 2 --push-foldin 1`` as a
    process on the event-loop edge → ``foldin --from-now`` in process,
    which must find nothing past the high-water mark (cursor 0 would
    re-solve every user) → the launch counts set to 0 → a
    ``FoldInRunner`` from now, in process on the card → a window through
    the console's ``import`` (``FOLDIN_COLD`` cold-start users, existing
    users with new ratings, brand-new items) and one cycle, held against
    the same ``compute_foldin`` solved in float64 on the host (1e-3 of
    the factors' scale) → two same-shaped windows of ``FOLDIN_SMALL``
    cold-start users, a cycle each → the reference smoke's invariants
    (``tools/foldin_smoke.py``) as an ``obs`` line, every replica's
    reply for folded users held against an in-process ``predict`` on
    the model and the chain → freshness: ``FOLDIN_FRESH`` cold-start
    users imported one at a time with ``FoldInRunner.watch(interval_s=
    0.2)`` in a thread, from the import's return to the first
    non-fallback reply through the router → ``undeploy``.  Then the SPD
    solve kernel is timed on the systems the cycles gave it (recorded
    on the way, one batch a rung) beside the library's Cholesky, its
    bound and its host microseconds a call.  The phase fails past
    ``FOLDIN_PHASE_LIMIT_S``."""
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.live import (
        FoldInRunner, FoldInSolver, compute_foldin, scan_new_ratings,
    )
    from predictionio_tpu_torch.obs import get_tracer
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import solve as solve_mod
    from predictionio_tpu_torch.storage.bimap import StringIndex
    from predictionio_tpu_torch.templates.recommendation import Query
    from predictionio_tpu_torch.workflow.model_io import load_model_delta

    st = store.storage
    es = st.get_event_store()
    rng = np.random.default_rng(41)
    t_phase = time.perf_counter()
    ej = Path(cli_out["engine_json"]).with_name("engine-pallas.json")
    variant = json.loads(Path(cli_out["engine_json"]).read_text())
    variant["algorithms"][0]["params"]["solver"] = "pallas"
    ej.write_text(json.dumps(variant, indent=2))
    # phase sessions wrote to the store since phase read stored this
    # app's snapshot: the train's read must still hit it (the key is
    # the table's own version, not the shard file's ctime)
    es.last_ratings_scan_path = None
    t0 = time.perf_counter()
    _build.reset_launches()
    with CaptureLog() as records:
        iid = cli(["train", "--scan-cache", "--engine-json", str(ej)],
                  st).split()[-1]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    (read_s,) = records.args(_READ_LOG)
    read_path = es.last_ratings_scan_path
    train_launches = dict(_build.LAUNCHES)
    if train_launches["gj_solve"] <= 0:
        raise AssertionError("the pallas train never launched gj_solve")
    proc = Console(store.home, [
        "deploy", "--engine-json", str(ej), "--engine-instance-id", iid,
        "--ip", "127.0.0.1", "--port", "0", "--replicas", "2",
        "--health-interval", "0.5", "--push-foldin", "1"], "foldin-fleet")
    checks = {"train_read_hit_the_snapshot": read_path == "cache"}
    detail = {"train_read_s": read_s, "train_read_path": read_path}
    try:
        out = cli(["foldin", "--engine-json", str(ej), "--from-now"], st)
        hw = es.high_water_cursor(store.app_id)
        checks["from_now_starts_at_the_high_water_mark"] = (
            f"No new events past watermark rowid {hw}; nothing to fold "
            "in." in out)
        engine, ep, _ = load_engine_from_variant(ej)
        # the systems the kernel solves, kept for its timing below (the
        # launches stay the path's own)
        systems = {}
        solve_fn = solve_mod.spd_solve_batched

        def keep(A, b):
            systems.setdefault(A.shape[0], (A, b))
            return solve_fn(A, b)

        solve_mod.spd_solve_batched = keep
        rungs = []
        _build.reset_launches()
        runner = FoldInRunner(st, engine, ep, iid, ctx=WorkflowContext(
            mode="Serving", storage=st), from_now=True)
        shape = runner.solver.padded_shape
        runner.solver.padded_shape = lambda n, k: rungs.append(
            shape(n, k)) or shape(n, k)
        cold = [f"cold{k:05d}" for k in range(FOLDIN_COLD)]
        warm = rng.choice(N_USERS, FOLDIN_WARM, replace=False)
        window = foldin_window(rng, cold, warm, FOLDIN_NEW_ITEMS)
        port = proc.wait_port(timeout=600)
        boot_s = proc.boot_s
        checks["cold_start_is_fallback"] = _http(port, "/queries.json", {
            "user": cold[0], "num": 10}) == {"itemScores": []}
        cycles = []
        m0 = runner.model
        before = (m0.user_factors, m0.item_factors,
                  StringIndex(m0.users.ids.tolist()),
                  StringIndex(m0.items.ids.tolist()), runner.cursor)
        tracer = get_tracer()

        def cycle(events, name):
            imp_s = import_lines(store, events, name)
            n0 = len(rungs)
            t0 = time.perf_counter()
            stats = runner.cycle()
            torch.cuda.synchronize()
            stats["wallSec"] = time.perf_counter() - t0
            stats["importSec"] = imp_s
            stats["spans"] = {s.name: round(s.duration_s, 4)
                              for s in tracer.spans()[-8:]
                              if s.name.startswith("live.")}
            stats["rungs"] = rungs[n0:]
            stats["deltaBytes"] = os.path.getsize(stats["delta"])
            stats["signatures"] = FoldInSolver.cache_size()
            cycles.append(stats)
            return stats

        s1 = cycle(window, "foldin-1")
        checks["foldin_produces_delta"] = (
            s1["appendedUsers"] == FOLDIN_COLD
            and s1["patchedUsers"] == FOLDIN_WARM
            and s1["appendedItems"] == FOLDIN_NEW_ITEMS)
        # the first cycle's rows against a float64 solve of the same
        # window, read the same way
        scan = scan_new_ratings(
            es, store.app_id, cursor=before[4],
            event_names=runner.event_names,
            rating_property=runner.rating_property,
            entity_type=runner.entity_type, tolerate_unavailable=True)
        plan = compute_foldin(
            Float64Solve(runner.solver), *before[:4], scan,
            runner._history(dict.fromkeys(scan.user_ids)))
        delta = load_model_delta(Path(s1["delta"]))
        if not (delta.user_rows_ix.tolist() == plan.user_rows_ix.tolist()
                and list(delta.new_user_ids) == plan.new_user_ids
                and list(delta.new_item_ids) == plan.new_item_ids):
            raise AssertionError("cycle 1's rows are not the float64 plan's")
        err64 = max(max_err(torch.from_numpy(getattr(delta, f)),
                            torch.from_numpy(getattr(plan, f)), 1e-3,
                            f"fold-in cycle 1 {f} against float64")
                    for f in ("user_rows", "new_user_rows", "new_item_rows"))
        for k in (2, 3):
            cycle(foldin_window(rng, [f"small{k}-{j:03d}"
                                      for j in range(FOLDIN_SMALL)]),
                  f"foldin-{k}")
        checks["solver_signature_stable"] = (
            cycles[2]["signatures"] == cycles[1]["signatures"]
            and cycles[1]["rungs"] == cycles[2]["rungs"])
        launches = dict(_build.LAUNCHES)

        # every replica applies the chain (the router pushes each second)
        reps = _http(port, "/debug/fleet")["replicas"]
        rports = [int(r["url"].rsplit(":", 1)[1]) for r in reps]

        def applied():
            got = [_http(p, "/") for p in rports]
            return got if all(g.get("foldinDeltasApplied") == 3
                              for g in got) else None

        statuses = _wait_for(applied, 60, "the replicas' applies", 0.2)
        folded = ([cold[0], cold[-1], user_id(int(warm[0])),
                   user_id(int(warm[-1])), "small3-007"])
        algo = runner.algo
        trades = 0
        for u in folded:
            want = algo.predict(runner.model, Query(user=u, num=10)).to_json()
            for p in rports:
                trades += _same_reply(_http(p, "/queries.json", {
                    "user": u, "num": 10}), want, f"replica {p} user {u}")
        checks["serving_applies_without_reload"] = (
            sum(_reloads(p) for p in rports) == 0 and all(s["engineInstanceId"] == iid
                                  for s in statuses))
        metrics = _raw(rports[0], "/metrics")[1].decode()
        checks["status_reports_freshness"] = all(
            "modelFreshnessSec" in s and s["foldinWatermarkLag"] == 0
            for s in statuses) and all(f in metrics for f in (
                "pio_model_freshness_seconds", "pio_foldin_watermark_lag",
                "pio_foldin_applies_total"))

        # freshness through the router, the daemon watching every 0.2 s
        stop = threading.Event()
        watcher = threading.Thread(target=runner.watch, kwargs=dict(
            interval_s=0.2, stop=stop))
        watcher.start()
        fresh_s = []
        try:
            for k in range(FOLDIN_FRESH):
                user = f"fresh{k}"
                import_lines(store, foldin_window(rng, [user]),
                             f"fresh-{k}")
                t0 = time.perf_counter()
                _wait_for(lambda: _http(port, "/queries.json", {
                    "user": user, "num": 10})["itemScores"], 60,
                    f"a fresh reply for {user}", 0.02)
                fresh_s.append(time.perf_counter() - t0)
        finally:
            stop.set()
            watcher.join()
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        solve_mod.spd_solve_batched = solve_fn
        # what phase hive's tenant of this instance must answer: the
        # model and every link the runner published
        replies = {u: algo.predict(runner.model, Query(user=u, num=10))
                   .to_json() for u in folded + [f"fresh{k}" for k in
                                                 range(FOLDIN_FRESH)]}
        links = runner.seq
        if "Undeployed" not in cli(["undeploy", "--port", str(port)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
        checks["undeploy_stops_router_and_replicas"] = rc == 0
    finally:
        solve_mod.spd_solve_batched = solve_fn
        proc.stop()
    gj = foldin_gj_shapes(torch, systems)
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_its_limit"] = phase_s <= FOLDIN_PHASE_LIMIT_S
    detail.update(cycles=[{k: c[k] for k in (
        "seq", "events", "ratings", "patchedUsers", "appendedUsers",
        "appendedItems", "cycleSec", "wallSec", "importSec", "spans",
        "rungs", "deltaBytes", "signatures")} for c in cycles],
        freshness_s=fresh_s, trades=trades, err64=err64, phase_s=phase_s)
    obs_report("foldin", checks, detail)
    log(f"phase foldin ML-20M: console train (pallas) {train_s:.1f} s, "
        f"its read {read_s:.1f} s from {read_path!r} (launches "
        f"{train_launches}); deploy --replicas 2 --push-foldin 1 "
        f"up in {boot_s:.1f} s; cycles (s, live.* spans, (B, K) rungs, "
        f"rows, delta bytes): "
        + "; ".join(
            f"{c['seq']}: {c['cycleSec']:.3f} s {c['spans']} {c['rungs']} "
            f"patched {c['patchedUsers']} appended {c['appendedUsers']} "
            f"users {c['appendedItems']} items, {c['deltaBytes']:,} B"
            for c in cycles)
        + f"; cycle 1 against float64 {err64:.3e} (tol 1e-3 x scale); "
        f"freshness through the router {[round(x, 3) for x in fresh_s]} s, "
        f"median {float(np.median(fresh_s)):.3f} s; fold-in launches "
        f"{launches}; phase {phase_s:.1f} s")
    return {"launches": launches, "gj": gj, "phase_s": phase_s,
            "train_launches": train_launches, "iid": iid,
            "engine_json": str(ej), "replies": replies, "links": links}


def foldin_gj_shapes(torch, systems: dict) -> list:
    """The SPD solve kernel on the systems phase foldin's cycles gave it
    (one batch a B), by :func:`gj_at_shapes`."""
    return gj_at_shapes(torch, "phase foldin gj", "the cycles' systems",
                        [systems[B] for B in sorted(systems)])


def gj_at_shapes(torch, phase: str, what: str, systems: list) -> list:
    """The SPD solve kernel on a main path's own systems (``(A, b)``
    pairs): kernel, plain version and the library's Cholesky
    (``cholesky_ex`` + ``cholesky_solve``) in turns, the bound, and the
    host microseconds a call of the kernel and of the library (after the
    profiler captures of earlier phases, which make every PyTorch call
    dearer on the host)."""
    from predictionio_tpu_torch.ops.solve import (
        spd_solve_batched, spd_solve_reference,
    )

    out = []
    for A, b in systems:
        B, R = b.shape
        err = max_err(spd_solve_batched(A, b), spd_solve_reference(A, b),
                      1e-4, f"{phase} A[{B},{R},{R}]")

        def library():
            L, _ = torch.linalg.cholesky_ex(A)
            return torch.cholesky_solve(b[..., None], L)

        t = interleaved_ms({
            "kernel": (lambda: spd_solve_batched(A, b), 50),
            "plain": (lambda: spd_solve_reference(A, b), 3),
            "library": (library, 20)})
        host = host_us(torch, {"kernel": lambda: spd_solve_batched(A, b),
                               "library": library})
        bound_ms, bound_by = bound(spd_bytes(B, R), B * spd_solve_flops(R))
        rec = dict(shape=f"A[{B},{R},{R}] f32", ms=t["kernel"],
                   plain_ms=t["plain"], library_ms=t["library"],
                   bound_ms=bound_ms, bound_by=bound_by,
                   host_us=host["kernel"], library_host_us=host["library"],
                   max_abs_err=err)
        out.append(rec)
        log(f"{phase} A[{B},{R},{R}] ({what}): kernel "
            f"{t['kernel']:.4f} ms, plain {t['plain']:.3f} ms, library "
            f"{t['library']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}); "
            f"host {host['kernel']:.2f} us a call (library "
            f"{host['library']:.2f}); max_abs_err {err:.3e}")
    return out


# path subspace: the iALS++ block width, the rows of the largest user
# bucket held against a float64 block sweep, and the λ of the sweep at
# ML-1M counts
SUBSPACE_B = 16
SUBSPACE_CHECK_ROWS = 256
SUBSPACE_SWEEP_LAMBDAS = (0.01, 0.05, 0.1)
# the swept models against sequential trains: the batched product of a
# single-row bucket (the heaviest user and item rate 41,379 and 113,465
# items at ML-1M counts) rounds its long sum otherwise than the
# unbatched one, by about 1e-5 of the row, and two iterations carry
# that to 0.9-1.8e-4 of the factors' scale (a 1e-7 perturbation of a
# sequential train's start moves it by 7.7e-5 of the scale): so 1e-3
SWEEP_FACTOR_TOL = 1e-3


def block_sweep_float64(Vm, val, x0, reg, block: int) -> np.ndarray:
    """The explicit iALS++ rank-block sweep in float64 numpy: per block
    S, ``H_S d = -g_S`` against the residual ``e = Vm x - val``, with
    ``H_S = VsᵀVs + reg I`` and ``g_S = Vsᵀe + reg x_S``."""
    x = np.array(x0, np.float64)
    e = np.einsum("bkr,br->bk", Vm, x) - val
    r = Vm.shape[-1]
    for s in range(0, r, block):
        w = min(block, r - s)
        Vs = Vm[:, :, s:s + w]
        H = np.einsum("bks,bkt->bst", Vs, Vs) + reg[:, None, None] * \
            np.eye(w)
        g = np.einsum("bk,bks->bs", e, Vs) + reg[:, None] * x[:, s:s + w]
        d = -np.linalg.solve(H, g[..., None])[..., 0]
        x[:, s:s + w] += d
        e += np.einsum("bks,bs->bk", Vs, d)
    return x


def path_subspace(torch, data, row_model) -> dict:
    """The rest of the trainer at ML-20M width (138,493 x 26,744 x
    20,000,263, rank 64, ALS-WR, lambda 0.01), its launch counts set to 0
    before it and read after it:

    * ``solver="pallas"``, ``solver_mode="subspace"``, ``subspace_size``
      16, 1 iteration from the initial factors of phase train's
      ``"pallas"`` train: the SPD solve kernel on 16 x 16 block systems;
      each half's fenced seconds, the kernel's launches and shapes, the
      RMSE (it must beat the zero model), and the first 256 rows of the
      largest user bucket held against a float64 block sweep from the
      same start (1e-3 of the factors' scale);
    * ``gather_mode="grouped"``, 1 iteration: the option is accepted
      and gathers rows, so its factors must equal phase train's row
      gather (``row_model``) bit for bit;
    * a checkpointed ``train``: 2 iterations saving every one, then a
      new trainer resuming from a checkpointer that holds step 1 only;
      its factors must equal the uninterrupted run's bit for bit;
    * ``sweep_train_als`` at ML-1M counts, lambda 0.01, 0.05 and 0.1, 2
      iterations in one batched run; each model's training RMSE within
      1e-6 of a sequential ``"xla"`` train's from the same start, and
      its factors within ``SWEEP_FACTOR_TOL`` of their scale (f32
      rounding alone moves them by about 1e-4 of it: see there).

    Returns the launches, the seconds of each part and the subspace
    systems the kernel is then timed on (:func:`gj_at_shapes`)."""
    import shutil
    import tempfile
    from collections import Counter

    import predictionio_tpu_torch.ops.solve as solve_mod
    from predictionio_tpu_torch.models.als import (
        ALSConfig, ALSTrainer, _bucket_inputs, rmse, sweep_train_als,
    )
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.workflow.checkpoint import StepCheckpointer

    ratings, _, (u, i, v) = data
    base = dict(rank=RANK, num_iterations=1, lam=0.01, seed=3,
                solver="pallas")
    out = {"s": {}}
    _build.reset_launches()
    t0 = time.perf_counter()
    # the shapes the kernel is given, by a shim around its wrapper
    shapes = Counter()
    kernel = solve_mod.spd_solve_batched

    def shaped(A, b):
        shapes[tuple(A.shape[1:])] += 1
        return kernel(A, b)

    solve_mod.spd_solve_batched = shaped
    try:
        tr = ALSTrainer(ratings, cfg=ALSConfig(
            **base, solver_mode="subspace", subspace_size=SUBSPACE_B))
        U0, V0 = tr.init_factors()
        fac = tr.train(init=(U0, V0))
        torch.cuda.synchronize()
    finally:
        solve_mod.spd_solve_batched = kernel
    train_rmse = rmse(fac, u, i, v)
    zero_rmse = float(np.sqrt(np.mean(v.astype(np.float64) ** 2)))
    halves = ", ".join(f"{n} {t * 1e3:.1f} ms"
                       for n, t in fac.report["half_seconds"])
    # the largest user bucket: its rows' sweep against float64
    side = tr._user_side
    j = max(range(len(side["ks"])), key=lambda b: len(side["buckets"][b][0]))
    rows, starts, counts = (t.cpu().numpy() for t in side["buckets"][j])
    n_big = len(rows)
    rows, starts, counts = (a[:SUBSPACE_CHECK_ROWS]
                            for a in (rows, starts, counts))
    k = side["ks"][j]
    c_sorted = side["c_sorted"].cpu().numpy()
    v_sorted = side["v_sorted"].cpu().numpy()
    V0h = V0.double().cpu().numpy()
    pos = starts[:, None] + np.arange(k)[None, :]
    ok = np.arange(k)[None, :] < counts[:, None]
    pos = np.minimum(pos, len(c_sorted) - 1)
    Vm = V0h[np.where(ok, c_sorted[pos], 0)] * ok[..., None]
    val = np.where(ok, v_sorted[pos], 0.0).astype(np.float64)
    reg = 0.01 * np.maximum(counts, 1).astype(np.float64)
    want = block_sweep_float64(Vm, val, U0.double().cpu().numpy()[rows],
                               reg, SUBSPACE_B)
    got = fac.user_factors[rows].astype(np.float64)
    sweep_err = float(np.abs(got - want).max())
    sweep_scale = max(float(np.abs(want).max()), 1.0)
    log(f"path subspace train: solver pallas, subspace_size {SUBSPACE_B}, "
        f"1 iteration, staging {fac.report['staging_seconds']:.2f} s, "
        f"halves [{halves}]; SPD solve shapes {dict(shapes)} "
        f"(calls {sum(shapes.values())}), launches "
        f"{_build.LAUNCHES['gj_solve']}; training RMSE {train_rmse:.5f} "
        f"(zero model {zero_rmse:.5f}); {len(rows)} rows of the largest "
        f"user bucket ({n_big:,} rows, K={k}) against a float64 block "
        f"sweep: max |err| {sweep_err:.3e} (tol 1e-3 x {sweep_scale:.3f})")
    if not (math.isfinite(train_rmse) and train_rmse < zero_rmse):
        raise AssertionError(f"subspace RMSE {train_rmse} does not beat the "
                             f"zero model ({zero_rmse})")
    if not sweep_err <= 1e-3 * sweep_scale:
        raise AssertionError(f"subspace sweep off float64 by {sweep_err}")
    if set(shapes) != {(SUBSPACE_B, SUBSPACE_B)}:
        raise AssertionError(f"subspace solved shapes {dict(shapes)}")
    # the kernel's systems at this path's shapes: the first block of the
    # largest user bucket, and a narrower tail block (rank 64 has none:
    # a rank of 60 would end in a block of 12)
    rows_big = side["buckets"][j][0]
    lam_t = torch.tensor(0.01, device=V0.device)
    idx, vals, valid, regb = _bucket_inputs(
        side["c_sorted"], side["v_sorted"], side["buckets"][j][1],
        side["buckets"][j][2], k, lam_t, True)
    Vs = V0[idx.long()] * valid[..., None]
    xb = U0[rows_big]
    e = torch.einsum("bkr,br->bk", Vs, xb) - vals
    systems = []
    for w in (SUBSPACE_B, 12):
        Vw = Vs[:, :, :w]
        A = (torch.einsum("bks,bkt->bst", Vw, Vw) + regb[:, None, None]
             * torch.eye(w, device=V0.device)).contiguous()
        b = (torch.einsum("bk,bks->bs", e, Vw) + regb[:, None] *
             xb[:, :w]).contiguous()
        systems.append((A, b))
    del Vs, e, idx, vals, valid
    out["systems"] = systems
    out["s"]["subspace"] = time.perf_counter() - t0
    out["subspace"] = dict(rmse=train_rmse, half_seconds=fac.report[
        "half_seconds"], shapes={f"{a}x{b}": n for (a, b), n in
                                 shapes.items()},
        largest_bucket=[n_big, k], sweep_err=sweep_err)
    del tr, fac
    torch.cuda.empty_cache()

    # the grouped gather: the row gather's factors, bit for bit
    t0 = time.perf_counter()
    grouped = ALSTrainer(ratings, cfg=ALSConfig(
        **base, gather_mode="grouped")).train()
    torch.cuda.synchronize()
    same = (np.array_equal(grouped.user_factors, row_model.user_factors)
            and np.array_equal(grouped.item_factors, row_model.item_factors))
    ghalves = ", ".join(f"{n} {t * 1e3:.1f} ms"
                        for n, t in grouped.report["half_seconds"])
    log(f"path subspace grouped: gather_mode grouped (a row gather), 1 "
        f"iteration, halves [{ghalves}]; factors equal phase train's row "
        f"gather bit for bit: {same}")
    if not same:
        du = np.abs(grouped.user_factors - row_model.user_factors).max()
        raise AssertionError(f"grouped factors differ from the row "
                             f"gather's (max |d| user {du})")
    out["s"]["grouped"] = time.perf_counter() - t0
    del grouped
    torch.cuda.empty_cache()

    # a checkpointed train, and a new trainer resuming from step 1
    t0 = time.perf_counter()
    cfg2 = ALSConfig(**{**base, "num_iterations": 2})
    with tempfile.TemporaryDirectory() as d:
        ck = StepCheckpointer(os.path.join(d, "all"))
        whole = ALSTrainer(ratings, cfg=cfg2).train(checkpointer=ck,
                                                    checkpoint_every=1)
        steps = ck.all_steps()
        one = StepCheckpointer(os.path.join(d, "one"))
        shutil.copy(ck.path(1), one.path(1))
        resumed = ALSTrainer(ratings, cfg=cfg2).train(checkpointer=one,
                                                      checkpoint_every=1)
        torch.cuda.synchronize()
    same = (one.last_restored_step == 1
            and np.array_equal(resumed.user_factors, whole.user_factors)
            and np.array_equal(resumed.item_factors, whole.item_factors))
    log(f"path subspace checkpoint: 2 iterations saving steps {steps}; a "
        f"new trainer resumed from step {one.last_restored_step} and ran "
        f"{len(resumed.report['half_seconds']) // 2} iteration: factors "
        f"equal the uninterrupted run's bit for bit: {same}")
    if not same:
        raise AssertionError("the resumed train differs from the "
                             "uninterrupted one")
    out["s"]["checkpoint"] = time.perf_counter() - t0
    del whole, resumed
    torch.cuda.empty_cache()

    # the λ sweep at ML-1M counts, against sequential "xla" trains
    t0 = time.perf_counter()
    u1, i1, v1 = synth_ratings(ML1M_USERS, ML1M_ITEMS, ML1M_RATINGS, seed=0)
    cfg_x = ALSConfig(rank=RANK, num_iterations=2, seed=3, solver="xla")
    t1 = time.perf_counter()
    swept = sweep_train_als((u1, i1, v1), ML1M_USERS, ML1M_ITEMS, cfg_x,
                            SUBSPACE_SWEEP_LAMBDAS)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t1
    rel, rmse_gap = [], []
    t1 = time.perf_counter()
    for lam, got in zip(SUBSPACE_SWEEP_LAMBDAS, swept):
        seq = ALSTrainer((u1, i1, v1), ML1M_USERS, ML1M_ITEMS, ALSConfig(
            rank=RANK, num_iterations=2, seed=3, solver="xla",
            lam=lam)).train()
        for a, b in ((got.user_factors, seq.user_factors),
                     (got.item_factors, seq.item_factors)):
            rel.append(float(np.abs(a - b).max())
                       / max(float(np.abs(b).max()), 1.0))
        rmse_gap.append(abs(rmse(got, u1, i1, v1) - rmse(seq, u1, i1, v1)))
        if not (rel[-1] <= SWEEP_FACTOR_TOL and rel[-2] <= SWEEP_FACTOR_TOL
                and rmse_gap[-1] <= 1e-6):
            raise AssertionError(
                f"sweep lambda {lam}: factors {rel[-2]:.3e}, {rel[-1]:.3e} "
                f"of the scale and RMSE {rmse_gap[-1]:.3e} off the "
                "sequential train")
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t1
    log(f"path subspace sweep: sweep_train_als at ML-1M counts, lambda "
        f"{SUBSPACE_SWEEP_LAMBDAS}, 2 iterations: {sweep_s:.2f} s batched "
        f"(3 sequential xla trains {seq_s:.2f} s with their RMSE); factors "
        f"off them by {[round(x, 7) for x in rel]} of the scale (user, "
        f"item a lambda; tol {SWEEP_FACTOR_TOL:g}), training RMSE by "
        f"{[float(f'{x:.3g}') for x in rmse_gap]} (tol 1e-6)")
    out["s"]["sweep"] = time.perf_counter() - t0
    out["sweep"] = dict(batched_s=sweep_s, sequential_s=seq_s,
                        factor_rel=rel, rmse_gap=rmse_gap)
    out["launches"] = dict(_build.LAUNCHES)
    log(f"path subspace seconds (host clock) "
        f"{ {k: round(t, 2) for k, t in out['s'].items()} }; launches "
        f"{out['launches']}")
    return out


# phase scout: two-stage retrieval at ML-20M width, before phase foldin
SCOUT_PHASE_LIMIT_S = 60.0
SCOUT_RECALL_USERS = 1024
SCOUT_QUERIES = 256
SCOUT_CLIENTS = 64


def scout_invariants(model, users: list) -> tuple[dict, dict]:
    """The reference ANN smoke's invariants (``tools/ann_smoke.py``) on
    ``model``, a recommendation ``ALSModel`` (it is patched: give it a
    copy), through the template's ``predict``/``batch_predict`` with
    ``retrieval`` int8 and ivf at a covering shortlist (every item, and
    every cluster for ivf) against the exact scan, for 8 of ``users``;
    the last 2 must be users with no other part to play.  Returns
    ``(checks, detail)``."""
    from predictionio_tpu_torch.live.apply import apply_model_delta
    from predictionio_tpu_torch.obs import RETRIEVAL_STAGE_SECONDS
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm, Query,
    )
    from predictionio_tpu_torch.workflow.model_io import ModelDelta

    m, rank = model.item_factors.shape
    checks, detail = {}, {}
    exact = ALSAlgorithm()
    exact.params = exact.params_class()
    queries = [Query(user=u, num=10) for u in users[:8]]
    exact_res = exact.batch_predict(model, queries)
    exact_ids = [[s.item for s in r.item_scores] for r in exact_res]
    exact_scores = [[s.score for s in r.item_scores] for r in exact_res]

    def covering(mode):
        algo = ALSAlgorithm()
        algo.params = algo.params_class(
            retrieval=mode, candidate_factor=m, nprobe=10 ** 6)
        return algo

    stage = {n: RETRIEVAL_STAGE_SECONDS.labels(stage=n)
             for n in ("candidate", "rerank")}
    searches = 0
    booked = {n: 0 for n in stage}
    for mode in ("int8", "ivf"):
        algo = covering(mode)
        algo.warmup(model, max_batch=8)
        before = {n: c.snapshot()["count"] for n, c in stage.items()}
        res = algo.batch_predict(model, queries)
        solo = algo.predict(model, queries[0])
        searches += 2
        for n, c in stage.items():
            booked[n] += c.snapshot()["count"] - before[n]
        ids = [[s.item for s in r.item_scores] for r in res]
        scores = [[s.score for s in r.item_scores] for r in res]
        recall = float(np.mean([len(set(e) & set(a)) / 10.0
                                for e, a in zip(exact_ids, ids)]))
        gap = max(abs(a - b) for ea, aa in zip(exact_scores, scores)
                  for a, b in zip(sorted(ea), sorted(aa)))
        checks[f"{mode}_covering_recall_is_1"] = recall == 1.0
        checks[f"{mode}_rerank_scores_exact"] = gap < 1e-4
        checks[f"{mode}_solo_matches_exact"] = (
            [s.item for s in solo.item_scores] == exact_ids[0])
        detail[mode] = {"recall": recall, "maxScoreGap": gap}
    checks["stage_metrics_booked"] = (
        booked["candidate"] == booked["rerank"] == searches)
    detail["stages"] = dict(booked, searches=searches)

    # a fold-in delta patches the same retriever in place, no rebuild:
    # an appended item becomes the 7th user's ideal one, item 3 the 8th's
    algo = covering("ivf")
    cfg = algo._retrieval_config()
    idx = model.device_ann_index(cfg)
    patches = idx.patches
    uf = model.user_factors
    u5, u6 = (model.users.get(u) for u in users[6:8])
    target5 = (uf[u5] / np.linalg.norm(uf[u5]) * 25).astype(np.float32)
    target6 = (uf[u6] / np.linalg.norm(uf[u6]) * 25).astype(np.float32)
    z = np.zeros((0, rank), np.float32)
    delta = ModelDelta(
        seq=1, meta={"baseUsers": len(model.users), "baseItems": m},
        user_rows_ix=np.zeros(0, np.int32), user_rows=z,
        new_user_ids=np.array([], dtype=str), new_user_rows=z,
        item_rows_ix=np.array([3], np.int32), item_rows=target6[None, :],
        new_item_ids=np.array(["i-new"]), new_item_rows=target5[None, :])
    counts = apply_model_delta(model, delta)
    same_idx = model.device_ann_index(cfg)
    checks["patch_in_place_no_rebuild"] = (
        same_idx is idx and idx.patches == patches + 1
        and counts.get("annIndexesPatched", 0) >= 1)
    r5 = algo.predict(model, Query(user=users[6], num=5))
    checks["appended_item_served"] = bool(
        r5.item_scores and r5.item_scores[0].item == "i-new")
    r6 = algo.predict(model, Query(user=users[7], num=5))
    item3 = model.items.decode(np.array([3]))[0]
    new_score = float(uf[u6].astype(np.float64) @ target6)
    checks["patched_row_served"] = bool(
        r6.item_scores and r6.item_scores[0].item == str(item3)
        and abs(r6.item_scores[0].score - new_score)
        <= 1e-4 * max(abs(new_score), 1.0))
    r6_exact = exact.predict(model, Query(user=users[7], num=5))
    checks["patched_ann_matches_exact"] = (
        [s.item for s in r6.item_scores]
        == [s.item for s in r6_exact.item_scores])
    detail["delta"] = {"counts": counts,
                       "top5": [s.item for s in r5.item_scores[:3]],
                       "top6": [s.item for s in r6.item_scores[:3]]}
    return checks, detail


def phase_scout(torch, store: StoreHome, row_model, cli_out: dict) -> dict:
    """Two-stage retrieval (``retrieval`` int8 and ivf) at ML-20M width,
    after phase eval and before phase foldin (whose writes would outdate
    the scan cache its console ``train`` reads):

    * in process, on phase train's ``"pallas"`` model: each retriever's
      build seconds (256 clusters for ivf by ``resolve_clusters``, the
      26,744 x 64 int8 table), recall@10 of each mode at the defaults
      (``candidateFactor`` 10, ``nprobe`` 8) against the exact scan over
      1,024 users, and the ms of a 64-query ``batch_predict``, two-stage
      against exact;
    * the reference ANN smoke's invariants (:func:`scout_invariants`) on
      a copy of that model, one ``{"obs": ...}`` line;
    * through the console: ``train`` with an engine.json whose algorithm
      sets ``"retrieval": "ivf"``, ``deploy``, 256 queries from 64
      clients, every reply held against the in-process two-stage
      ``predict``, p50/p99 and queries/s beside phase cli's exact scan,
      then ``undeploy`` with exit code 0.

    The phase fails past ``SCOUT_PHASE_LIMIT_S``."""
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.retrieval import (
        RetrievalConfig, TwoStageRetriever,
    )
    from predictionio_tpu_torch.storage import StringIndex
    from predictionio_tpu_torch.templates.recommendation import (
        ALSAlgorithm, ALSModel, Query,
    )
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    import dataclasses

    t_phase = time.perf_counter()
    out = {}
    # in process: builds, recall and batch ms on the pallas model
    builds = {}
    for mode in ("int8", "ivf"):
        cfg = RetrievalConfig(mode=mode)
        t0 = time.perf_counter()
        idx = TwoStageRetriever.build(row_model.item_factors, cfg,
                                      device=row_model.device)
        torch.cuda.synchronize()
        builds[mode] = dict(s=time.perf_counter() - t0, **idx.summary())
        del idx
    rng = np.random.default_rng(23)
    known = row_model.users.ids
    users = [str(known[k]) for k in rng.choice(
        len(known), SCOUT_RECALL_USERS, replace=False)]
    algos = {"exact": ALSAlgorithm()}
    algos["exact"].params = algos["exact"].params_class()
    for mode in ("int8", "ivf"):
        a = ALSAlgorithm()
        a.params = a.params_class(retrieval=mode)
        a.warmup(row_model, max_batch=64)
        algos[mode] = a
    got = {}
    for name, a in algos.items():
        ids = []
        for c in range(0, len(users), 64):
            res = a.batch_predict(row_model, [Query(user=u, num=10)
                                              for u in users[c:c + 64]])
            ids.extend([s.item for s in r.item_scores] for r in res)
        got[name] = ids
    # recall@10 as ops.ann.recall_at_k counts it; a two-stage answer may
    # hold fewer than 10 items (an ivf shortlist short of them)
    recall = {m: float(np.mean([len(set(e) & set(a)) / len(e)
                                for e, a in zip(got["exact"], got[m])]))
              for m in ("int8", "ivf")}
    short = {m: sum(len(a) < 10 for a in got[m]) for m in ("int8", "ivf")}
    # ivf's recall against nprobe: the same clusters, more of them probed
    ivf = row_model.device_ann_index(algos["ivf"]._retrieval_config())
    uix = torch.as_tensor(np.asarray(
        [row_model.users.get(u) for u in users]), device=row_model.device)
    uvecs = torch.as_tensor(row_model.user_factors,
                            device=row_model.device)[uix]
    table = row_model.device_item_factors()
    exact_ix = [set(row_model.items.get(x) for x in e) for e in got["exact"]]
    by_nprobe = {}
    for nprobe in (8, 32, 128):
        probe = TwoStageRetriever(dataclasses.replace(ivf.cfg, nprobe=nprobe),
                                  ivf.n_items, ivf.rank, ivf._state,
                                  ivf.device)
        # 64 queries a search: a probe's slabs are [64, nprobe, L, R]
        parts = [probe.search(uvecs[c:c + 64], 16, table)
                 for c in range(0, len(users), 64)]
        vals = torch.cat([p[0] for p in parts])[:, :10].cpu().numpy()
        ixs = torch.cat([p[1] for p in parts])[:, :10].cpu().numpy()
        by_nprobe[nprobe] = float(np.mean([
            len(e & set(x[np.isfinite(v)].tolist())) / len(e)
            for e, x, v in zip(exact_ix, ixs, vals)]))
    batch = [Query(user=u, num=10) for u in users[:64]]
    ms = {}
    for name, a in algos.items():
        times = []
        for _ in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.batch_predict(row_model, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = float(np.median(times[2:]))
    log(f"phase scout in process: builds {builds}; recall@10 over "
        f"{len(users):,} users (candidateFactor 10, nprobe 8) {recall} "
        f"(answers short of 10 items {short}); ivf recall@10 by nprobe "
        f"of its {ivf.summary()['clusters']} clusters {by_nprobe}; "
        f"64-query batch_predict ms (median of 5 after 2) {ms}")
    out.update(builds=builds, recall=recall, short=short, batch_ms=ms,
               ivf_recall_by_nprobe=by_nprobe)

    # the reference smoke's invariants, on a copy of the model
    copy = ALSModel(
        user_factors=row_model.user_factors.copy(),
        item_factors=row_model.item_factors.copy(),
        users=StringIndex(list(row_model.users.ids)),
        items=StringIndex(list(row_model.items.ids)),
        item_props={}, device=row_model.device)
    t0 = time.perf_counter()
    checks, detail = scout_invariants(copy, users[:8])
    detail["seconds"] = time.perf_counter() - t0
    del copy
    torch.cuda.empty_cache()

    # the console: train with retrieval ivf, deploy, query, undeploy
    st = store.storage
    ej = Path(store.home) / "engine" / "engine-scout.json"
    variant = json.loads(Path(cli_out["engine_json"]).read_text())
    variant["algorithms"][0]["params"] = {
        **variant["algorithms"][0]["params"], "numIterations": 1,
        "retrieval": "ivf"}
    ej.write_text(json.dumps(variant, indent=2))
    t0 = time.perf_counter()
    iid = cli(["train", "--scan-cache", "--engine-json", str(ej)],
              st).split()[-1]
    train_s = time.perf_counter() - t0
    engine, ep, _ = load_engine_from_variant(ej)
    dalgos, dmodels, _ = prepare_deploy_components(
        engine, ep, iid, ctx=WorkflowContext(mode="Serving", storage=st))
    queries = [{"user": str(known[k]), "num": 16}
               for k in rng.integers(0, len(known), SCOUT_QUERIES)]
    want = [dalgos[0].predict(dmodels[0], Query.from_json(q)).to_json()
            for q in queries]
    proc = Console(store.home, [
        "deploy", "--engine-json", str(ej), "--ip", "127.0.0.1", "--port",
        "0"], "deploy-scout")
    try:
        port = proc.wait_port()
        try:
            load = http_load(port, queries[:8], queries, SCOUT_CLIENTS)
            trades = sum(_same_reply(g, w, f"scout query {q}") for q, g, w
                         in zip(queries, load["replies"][8:], want))
        except Exception as e:
            proc.fail(f"failed its queries: {e!r}")
        boot_s = proc.boot_s
        if "Undeployed" not in cli(["undeploy", "--port", str(port)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
        if rc != 0:
            proc.fail("exited after undeploy")
    finally:
        proc.stop()
    cli_conc = cli_out["edges"]["eventloop"]
    p50, p99 = np.percentile(load["conc_ms"], [50, 99])
    e50, e99 = np.percentile(cli_conc["conc_ms"], [50, 99])
    log(f"phase scout console: train (retrieval ivf) {train_s:.1f} s, "
        f"deploy booted in {boot_s:.1f} s; {SCOUT_QUERIES} queries from "
        f"{SCOUT_CLIENTS} clients p50 {p50:.3f} ms p99 {p99:.3f} ms, "
        f"{load['qps']:,.0f} queries/s (phase cli's exact scan: p50 "
        f"{e50:.3f} ms p99 {e99:.3f} ms, {cli_conc['qps']:,.0f} queries/s, "
        f"with filtered queries in its mix); every reply equals in-process "
        f"two-stage predict ({trades} tied items traded places); "
        f"undeploy exit 0")
    out.update(console=dict(train_s=train_s, boot_s=boot_s, p50=p50,
                            p99=p99, qps=load["qps"]))
    total = time.perf_counter() - t_phase
    checks["phase_within_limit"] = total <= SCOUT_PHASE_LIMIT_S
    detail["phaseSeconds"] = total
    obs_report("scout", checks, detail)
    out["s"] = total
    return out


# phase engines: the model-backed engines through the console at ML-20M
# width, after phase scout and before phase foldin (whose writes would
# outdate the scan cache their trains read)
ENGINES_PHASE_LIMIT_S = 150.0
ENGINES_SOLO = 32
ENGINES_QUERIES = 256
ENGINES_CLIENTS = 64
ENGINES_RECALL_ITEMS = 1024
ENGINES_HEALTH_ROWS = 256
# the constraint/unavailableItems $set phase fleet posts: the most
# popular items of the generator (Zipf: the lowest indexes)
UNAVAILABLE_ITEMS = 100
# app "classify": users with a $set of three non-negative attributes
# drawn from a per-class mixture and a label of 4 classes
CLASSIFY_USERS = 100_000
CLASSIFY_HELD_OUT = 10_000
CLASSIFY_PRIORS = (0.4, 0.3, 0.2, 0.1)
CLASSIFY_CENTERS = ((4.0, 1.0, 0.5), (1.0, 4.0, 0.5), (0.5, 1.0, 4.0),
                    (3.0, 3.0, 3.0))


def unavailable_set() -> dict:
    """The ``constraint``/``unavailableItems`` ``$set`` event (ecommerce's
    predict-time filter) of the :data:`UNAVAILABLE_ITEMS` most popular
    items."""
    return {"event": "$set", "entityType": "constraint",
            "entityId": "unavailableItems",
            "properties": {"items": [item_id(j) for j in
                                     range(UNAVAILABLE_ITEMS)]},
            "eventTime": "2014-12-31T00:00:01.000Z"}


def classify_data(n: int, seed: int):
    """``n`` rows of the classification app: non-negative attributes of
    a per-class mixture (multinomial naive Bayes applies) and labels
    ``l0``..``l3`` drawn with :data:`CLASSIFY_PRIORS`."""
    rng = np.random.default_rng(seed)
    y = rng.choice(len(CLASSIFY_PRIORS), size=n, p=CLASSIFY_PRIORS)
    x = np.abs(np.asarray(CLASSIFY_CENTERS)[y]
               + rng.normal(size=(n, 3))).astype(np.float32)
    return x, np.asarray([f"l{k}" for k in range(4)], dtype=object)[y]


def _engine_ok(text: str, engine: str) -> float:
    """``pio_engine_queries_total{engine=..., status="ok"}`` of an
    exposition."""
    for line in text.splitlines():
        if (line.startswith("pio_engine_queries_total{")
                and f'engine="{engine}"' in line
                and 'status="ok"' in line):
            return float(line.rsplit(" ", 1)[1])
    return 0.0


def implicit_health(U, V, ratings, lam: float, alpha: float,
                    seed: int) -> float:
    """The RMSE-free health check of an implicit train: the item half
    was solved last, from the final user factors, so a float64 solve of
    :data:`ENGINES_HEALTH_ROWS` item rows from ``U`` (``UᵀU + Σ α r u uᵀ
    + λ max(n, 1) I``, rhs ``Σ (1 + α r) u``, the ALS-WR ridge the
    engines train with) must give ``V``'s rows.  Returns the largest
    difference over ``V``'s scale."""
    rng = np.random.default_rng(seed)
    rows = rng.choice(V.shape[0], ENGINES_HEALTH_ROWS, replace=False)
    sel = np.flatnonzero(np.isin(ratings.item_ix, rows))
    order = sel[np.argsort(ratings.item_ix[sel], kind="stable")]
    cuts = np.searchsorted(ratings.item_ix[order], np.sort(rows))
    U64 = U.astype(np.float64)
    G = U64.T @ U64
    err = 0.0
    for j, lo, hi in zip(np.sort(rows), cuts,
                         list(cuts[1:]) + [len(order)]):
        part = order[lo:hi]
        uu = U64[ratings.user_ix[part]]
        c = alpha * ratings.rating[part].astype(np.float64)
        A = G + (uu * c[:, None]).T @ uu + lam * max(len(part), 1) * \
            np.eye(U.shape[1])
        x = np.linalg.solve(A, ((1.0 + c)[:, None] * uu).sum(axis=0))
        err = max(err, float(np.abs(x - V[j]).max()))
    return err / float(np.abs(V).max())


def engine_scaffold(st, home, name: str, ds: dict, algorithms: list):
    """``template get NAME`` into the store's home, its engine.json set
    to the data source params ``ds`` and ``algorithms``, then ``build``;
    returns the engine.json path."""
    from pathlib import Path

    d = Path(home) / f"engine-{name}"
    cli(["template", "get", name, str(d)], st)
    ej = d / "engine.json"
    variant = json.loads(ej.read_text())
    variant["datasource"] = {"params": ds}
    variant["algorithms"] = algorithms
    ej.write_text(json.dumps(variant, indent=2))
    cli(["build", "--engine-json", str(ej)], st)
    return ej


def import_classify(store: StoreHome) -> dict:
    """Phase engines' app ``classify`` into the ML-20M store: ``app new``
    through the console, :data:`CLASSIFY_USERS` users' ``$set`` events
    written as JSON lines and imported by the console's ``import``.  It
    runs before phase read; an app of its own, it could run at any time
    (a snapshot's key is its table's write version: a write to another
    app's table leaves it valid)."""
    from pathlib import Path

    x, y = classify_data(CLASSIFY_USERS, seed=62)
    st = store.storage
    t0 = time.perf_counter()
    cli(["app", "new", "classify"], st)
    app_id = st.get_metadata().app_get_by_name("classify").id
    src = Path(store.home) / "classify.jsonl"
    with open(src, "w") as f:
        for n in range(CLASSIFY_USERS):
            f.write(json.dumps({
                "event": "$set", "entityType": "user",
                "entityId": f"c{n:06d}",
                "properties": {"attr0": float(x[n, 0]),
                               "attr1": float(x[n, 1]),
                               "attr2": float(x[n, 2]),
                               "label": str(y[n])},
                "eventTime": "2015-02-01T00:00:00.000Z"}) + "\n")
    out = cli(["import", "--appid", str(app_id), "--input", str(src)], st)
    import_s = time.perf_counter() - t0
    src.unlink()
    if out != f"Imported {CLASSIFY_USERS} events.\n":
        raise AssertionError(f"the classify import printed {out!r}")
    log(f"phase classify import: {CLASSIFY_USERS:,} users' $set events "
        f"through the console's import into app classify in "
        f"{import_s:.1f} s")
    return {"x": x, "y": y, "import_s": import_s}


def console_train(torch, st, es, ej, factors_sink=None) -> dict:
    """``train --scan-cache --engine-json EJ`` in this process on the
    card, the launch counts set to 0 just before it and read just after;
    the ALS factors the train made go to ``factors_sink``."""
    from predictionio_tpu_torch.models.als import ALSTrainer
    from predictionio_tpu_torch.ops import _build, gather_probe

    # a `train` is a process of its own: no probe order cached
    gather_probe._ORDER_CACHE.clear()
    es.last_ratings_scan_path = None
    for s in getattr(es, "shards", ()):
        s.last_ratings_scan_path = None
    _build.reset_launches()
    sink = [] if factors_sink is None else factors_sink
    t0 = time.perf_counter()
    with CaptureLog() as records, recording(ALSTrainer, "train", sink):
        out = cli(["train", "--scan-cache", "--engine-json", str(ej)], st)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    iid = out.split()[-1]
    if st.get_metadata().engine_instance_get(iid).status != "COMPLETED":
        raise AssertionError(f"instance {iid} did not complete: {out}")
    (read_s,) = records.args("read_training: %.3f s")
    return {"iid": iid, "train_s": train_s, "read_s": read_s,
            "launches": {k: n for k, n in _build.LAUNCHES.items() if n},
            "read_path": es.last_ratings_scan_path,
            "shard_paths": [s.last_ratings_scan_path
                            for s in getattr(es, "shards", ())]}


def phase_engines(torch, store: StoreHome, ratings, u, i,
                  classify: dict) -> dict:
    """The model-backed engines at ML-20M width through the port's
    console, as a user drives them, on the 4-shard store (after phase
    scout, before phase foldin): for each, ``template get`` → engine.json
    → ``build`` → ``train --scan-cache`` in this process on the card
    (the launch counts set to 0 just before it and read just after) →
    a ``deploy`` process on the event-loop edge (the four boot at once)
    → 32 solo queries and 256 from 64 clients, every HTTP reply held
    against an in-process ``predict`` on the same instance (the same
    items in the same order, scores within 1e-5 of their scale; labels
    equal), ``pio_engine_queries_total{engine=NAME,status="ok"}`` moved
    by the number of queries → ``undeploy`` with exit code 0.

    * similarproduct: ``viewEvents ["rate"]`` (the implicit read, every
      count 1: the generator's pairs are distinct; its counts held
      against a numpy recount of one shard), rank 64, 2 iterations,
      λ 0.01, α 1, ``"fused"``; queries ``{"items": [i], "num": 10}``
      over popular and tail items.
    * itemsimilarity: the same data source (its read must hit the
      snapshot similarproduct's train stored), ``"pallas"``, served by
      ``retrieval "ivf"``; recall@10 of ivf against an in-process exact
      scan of the same model at nprobe 8 and 32 over 1,024 items.
    * ecommerce: ``ratingProperty "rating"`` (the explicit snapshot of
      phase read), ``"fused"``, served with ``unseenOnly`` and
      ``seenEvents ["rate"]`` and the unavailable-items constraint
      phase fleet posted; no reply may hold a seen or unavailable item.
    * classification: the app ``classify`` of 100,000 users
      (:func:`import_classify`, before phase read), one train of
      ``naive``, ``logistic`` and ``randomforest`` (16 trees, depth 6);
      each model held in process against its CPU counterpart (naive
      Bayes within 1e-5, logistic weights within 1e-3 of their scale and
      the same label on 99.9% of 10,000 held-out rows, the forest walk's
      labels and votes equal), and each algorithm's held-out accuracy
      above the majority class's share.

    The ALS trains must launch the fused kernel or GJ, their factors be
    finite and a float64 solve of 256 item rows agree within 1e-3 of the
    factors' scale (:func:`implicit_health`).  The phase writes nothing
    to the shard files (their ctimes are the same at its end).  Checks go
    on one
    ``{"engines": ...}`` line; a false one, or the phase past
    ``ENGINES_PHASE_LIMIT_S``, fails the run."""
    import dataclasses
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.models.forest import forest_predict
    from predictionio_tpu_torch.models.logistic import train_logistic
    from predictionio_tpu_torch.models.naive_bayes import train_naive_bayes
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.templates import (
        classification, itemsimilarity, recommendation, similarproduct,
    )
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    t_phase = time.perf_counter()
    st = store.storage
    es = st.get_event_store()
    home = Path(store.home)
    rng = np.random.default_rng(61)
    ctimes = [os.stat(p).st_ctime_ns for p in store.shard_paths()]
    checks = {}
    als = {"rank": RANK, "numIterations": 2, "lambda": 0.01, "alpha": 1.0,
           "seed": 3}
    view = {"appName": "ml20m", "viewEvents": ["rate"]}

    # -- similarproduct: the implicit read, cold, then the fused train
    factors = {}
    ej_sim = engine_scaffold(st, home, "similarproduct", view, [
        {"name": "als", "params": {**als, "solver": "fused"}}])
    sink = []
    tr = {"similarproduct": console_train(torch, st, es, ej_sim, sink)}
    factors["similarproduct"] = sink[-1][1]
    # the implicit counts against a numpy recount of one shard
    t0 = time.perf_counter()
    imp = es.find_ratings(store.app_id, event_names=("rate",),
                          rating_property=None, dedup="sum",
                          entity_type="user", cache=True)
    imp_path = es.last_ratings_scan_path
    uid = np.asarray([int(s[1:]) for s in imp.users.ids], np.int64)
    iid_ = np.asarray([int(s[1:]) for s in imp.items.ids], np.int64)
    mine = shard_of_ids(imp.users.ids.tolist(), "user")[imp.user_ix] == 0
    got = np.sort(uid[imp.user_ix[mine]] * N_ITEMS + iid_[imp.item_ix[mine]])
    ushard = shard_of_ids([user_id(k) for k in range(N_USERS)], "user")
    keys, counts = np.unique(
        u[ushard[u] == 0].astype(np.int64) * N_ITEMS + i[ushard[u] == 0],
        return_counts=True)
    checks["implicit_counts_equal_a_numpy_recount_of_shard_0"] = bool(
        len(imp) == len(u) and np.array_equal(got, keys)
        and np.array_equal(np.sort(imp.rating[mine]),
                           np.sort(counts.astype(np.float32))))
    recount_s = time.perf_counter() - t0

    # -- itemsimilarity: the same read, which must hit the snapshot
    ej_cos = engine_scaffold(st, home, "itemsimilarity", view, [
        {"name": "cosine", "params": {**als, "solver": "pallas"}}])
    sink = []
    tr["itemsimilarity"] = console_train(torch, st, es, ej_cos, sink)
    factors["itemsimilarity"] = sink[-1][1]

    # -- ecommerce: the explicit snapshot of phase read
    ej_ecom = engine_scaffold(
        st, home, "ecommercerecommendation",
        {**view, "ratingProperty": "rating"},
        [{"name": "ecomm", "params": {**als, "solver": "fused",
                                      "unseenOnly": True,
                                      "seenEvents": ["rate"]}}])
    sink = []
    tr["ecommercerecommendation"] = console_train(torch, st, es, ej_ecom,
                                                  sink)
    factors["ecommercerecommendation"] = sink[-1][1]
    pm = es.aggregate_properties_single_entity(
        store.app_id, "constraint", "unavailableItems")
    unavailable = set(pm.get_string_list("items")) if pm else set()
    checks["the_constraint_is_in_the_store"] = unavailable == {
        item_id(j) for j in range(UNAVAILABLE_ITEMS)}

    # -- classification: one train of three on the imported app
    x, y, import_s = classify["x"], classify["y"], classify["import_s"]
    ej_cls = engine_scaffold(
        st, home, "classification", {"appName": "classify"},
        [{"name": "naive", "params": {"lambda": 1.0}},
         {"name": "logistic", "params": {}},
         {"name": "randomforest", "params": {"numTrees": 16,
                                             "maxDepth": 6}}])
    tr["classification"] = console_train(torch, st, es, ej_cls)
    tr["classification"]["import_s"] = import_s
    log(f"phase engines trains: {tr}; implicit read "
        f"{len(imp):,} pairs (again from {imp_path!r}), recount "
        f"{recount_s:.1f} s")

    # -- the four deploys boot at once
    procs = {}
    ejs = {"similarproduct": ej_sim, "itemsimilarity": ej_cos,
           "ecommercerecommendation": ej_ecom, "classification": ej_cls}
    try:
        for name, ej in ejs.items():
            procs[name] = Console(store.home, [
                "deploy", "--engine-json", str(ej), "--ip", "127.0.0.1",
                "--port", "0"], f"deploy-{name}")

        # meanwhile, in process: each instance's serving components
        serving = WorkflowContext(mode="Serving", storage=st)
        comp = {}
        for name, ej in ejs.items():
            engine, ep, _ = load_engine_from_variant(ej)
            algos, models, _ = prepare_deploy_components(
                engine, ep, tr[name]["iid"], ctx=serving)
            comp[name] = (algos, models)

        # the ALS engines' health
        health = {}
        for name, rated in (("similarproduct", imp),
                            ("itemsimilarity", imp),
                            ("ecommercerecommendation", ratings)):
            f = factors[name]
            finite = bool(np.isfinite(f.user_factors).all()
                          and np.isfinite(f.item_factors).all())
            health[name] = implicit_health(
                f.user_factors, f.item_factors, rated, als["lambda"],
                als["alpha"], seed=len(health))
            checks[f"{name}_factors_finite"] = finite
            checks[f"{name}_float64_solve_within_1e-3"] = (
                health[name] <= 1e-3)
            launched = tr[name]["launches"]
            checks[f"{name}_train_launched_a_kernel"] = (
                launched.get("fused_als", 0) + launched.get("fused_als_dma", 0)
                + launched.get("gj_solve", 0)) > 0
        ecom_model = comp["ecommercerecommendation"][1][0]
        checks["ecommerce_ids_are_phase_reads"] = (
            ecom_model.users.ids.tolist() == ratings.users.ids.tolist()
            and ecom_model.items.ids.tolist() == ratings.items.ids.tolist())
        checks["itemsimilarity_read_hit_the_implicit_snapshot"] = (
            tr["itemsimilarity"]["read_path"] == "cache")
        checks["ecommerce_read_hit_phase_reads_snapshot"] = (
            tr["ecommercerecommendation"]["read_path"] == "cache")

        # the queries, and what predict answers in process
        pop = [item_id(j) for j in rng.integers(0, 100, 144)]
        tail = [item_id(j) for j in rng.integers(100, N_ITEMS, 144)]
        item_q = [{"items": [a], "num": 10}
                  for pair in zip(pop, tail) for a in pair]
        users_q = [user_id(k) for k in rng.integers(0, N_USERS, 288)]
        user_q = [{"user": s, "num": 10} for s in users_q]
        xq, _ = classify_data(288, seed=63)
        cls_q = [{"attr0": float(a), "attr1": float(b), "attr2": float(c)}
                 for a, b, c in xq]
        queries = {"similarproduct": item_q, "itemsimilarity": item_q,
                   "ecommercerecommendation": user_q,
                   "classification": cls_q}
        qclass = {"similarproduct": similarproduct.Query,
                  "itemsimilarity": similarproduct.Query,
                  "ecommercerecommendation": recommendation.Query,
                  "classification": classification.Query}
        want, predict_ms = {}, {}
        for name, qs in queries.items():
            algos, models = comp[name]
            t0 = time.perf_counter()
            want[name] = [algos[0].predict(
                models[0], qclass[name].from_json(q)).to_json() for q in qs]
            predict_ms[name] = (time.perf_counter() - t0) * 1e3 / len(qs)

        # ecommerce: no seen or unavailable item in any answer
        qu = np.asarray([int(s[1:]) for s in users_q])
        sel = np.isin(u, qu)
        seen = {}
        for a, b in zip(u[sel].tolist(), i[sel].tolist()):
            seen.setdefault(a, set()).add(item_id(b))
        leaks = sum(
            1 for k, r in zip(qu.tolist(), want["ecommercerecommendation"])
            for s in r["itemScores"]
            if s["item"] in seen.get(k, ()) or s["item"] in unavailable)
        checks["ecommerce_predict_holds_no_seen_or_unavailable_item"] = (
            leaks == 0 and all(r["itemScores"]
                               for r in want["ecommercerecommendation"]))

        # itemsimilarity: recall@10 of ivf against the exact scan
        algo_ivf, model_cos = comp["itemsimilarity"][0][0], \
            comp["itemsimilarity"][1][0]
        probe_items = [{"items": [item_id(j)], "num": 10} for j in
                       rng.choice(N_ITEMS, ENGINES_RECALL_ITEMS,
                                  replace=False)]
        pq = [similarproduct.Query.from_json(q) for q in probe_items]

        def answers(params):
            a = itemsimilarity.ItemSimilarityAlgorithm()
            a.params = params
            ids = []
            for c in range(0, len(pq), 64):
                ids += [[s.item for s in r.item_scores]
                        for r in a.batch_predict(model_cos, pq[c:c + 64])]
            return ids

        exact = answers(dataclasses.replace(algo_ivf.params,
                                            retrieval="exact"))
        recall = {}
        for nprobe in (8, 32):
            got_ids = answers(dataclasses.replace(algo_ivf.params,
                                                  nprobe=nprobe))
            recall[nprobe] = float(np.mean([
                len(set(e) & set(g)) / len(e) for e, g in
                zip(exact, got_ids)]))
        ivf_summary = model_cos.device_ann_index(
            algo_ivf._retrieval_config()).summary()

        # classification: each card model against its CPU counterpart
        algos_c, models_c = comp["classification"]
        xh, yh = classify_data(CLASSIFY_HELD_OUT, seed=64)
        nb_card = train_naive_bayes(x, y, device="cuda")
        nb_cpu = train_naive_bayes(x, y, device="cpu")
        lr_card = train_logistic(x, y, device="cuda")
        lr_cpu = train_logistic(x, y, device="cpu")
        forest = models_c[2]["forest"]
        fl, fv = forest_predict(forest, xh, return_votes=True, device="cuda")
        hl, hv = forest_predict(forest, xh, return_votes=True, device="cpu")
        nb_err = float(np.abs(nb_card.log_likelihood
                              - nb_cpu.log_likelihood).max())
        lr_err = float(np.abs(lr_card.weights - lr_cpu.weights).max()
                       / np.abs(lr_cpu.weights).max())
        lr_same = float(np.mean(lr_card.predict(xh) == lr_cpu.predict(xh)))
        checks["naive_bayes_card_within_1e-5"] = nb_err <= 1e-5
        checks["logistic_card_within_1e-3_of_scale"] = lr_err <= 1e-3
        checks["logistic_card_same_label_on_99.9%"] = lr_same >= 0.999
        checks["forest_walk_labels_and_votes_equal_the_host_walk"] = bool(
            np.array_equal(fl, hl) and np.array_equal(fv, hv))
        accuracy = {}
        for a, m in zip(algos_c, models_c):
            pred = [r.label for r in a.batch_predict(
                m, [classification.Query(features=tuple(map(float, row)))
                    for row in xh])]
            accuracy[type(a).__name__] = float(np.mean(
                np.asarray(pred, dtype=object) == yh))
        majority = float(max(np.mean(yh == c) for c in np.unique(yh)))
        checks["every_algorithm_beats_the_majority_share"] = all(
            acc > majority for acc in accuracy.values())

        # the HTTP loads, one deploy at a time
        served = {}
        for name, proc in procs.items():
            port = proc.wait_port()
            qs = queries[name]
            try:
                before = _engine_ok(_scrape(port)[0], name)
                load = http_load(port, qs[:ENGINES_SOLO],
                                 qs[ENGINES_SOLO:], ENGINES_CLIENTS)
                after = _engine_ok(_scrape(port)[0], name)
            except Exception as e:
                proc.fail(f"failed its queries: {e!r}")
            if name == "classification":
                same = load["replies"] == want[name]
                trades = 0
            else:
                trades = sum(_same_reply(g, w, f"{name} query {q}")
                             for q, g, w in zip(qs, load["replies"],
                                                want[name]))
                same = True
            checks[f"{name}_http_equals_predict"] = same
            checks[f"{name}_queries_counted"] = after - before == len(qs)
            if "Undeployed" not in cli(["undeploy", "--port", str(port)],
                                       st):
                proc.fail("was not undeployed")
            try:
                rc = proc.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.fail("did not stop after undeploy")
            checks[f"{name}_undeploy_exit_0"] = rc == 0
            served[name] = dict(
                boot_s=proc.boot_s, trades=trades,
                query_s=(sum(load["solo_ms"]) + load["wall_ms"]) / 1e3,
                solo_p50_p99=list(np.percentile(load["solo_ms"], [50, 99])),
                conc_p50_p99=list(np.percentile(load["conc_ms"], [50, 99])),
                qps=load["qps"], predict_ms=predict_ms[name])
    finally:
        for proc in procs.values():
            proc.stop()
    checks["the_phase_left_the_shard_files_unwritten"] = ctimes == [
        os.stat(p).st_ctime_ns for p in store.shard_paths()]
    # each train's counts were set to 0 just before it and read just
    # after: the path's launches are their sum
    launches = {k: sum(t["launches"].get(k, 0) for t in tr.values())
                for k in _build.LAUNCHES}
    total = time.perf_counter() - t_phase
    checks["phase_within_limit"] = total <= ENGINES_PHASE_LIMIT_S
    detail = {
        "seconds": {n: {k: tr[n][k] for k in ("read_s", "train_s")
                        if k in tr[n]} for n in tr},
        "import_s": import_s, "read_paths": {
            n: (tr[n]["read_path"], tr[n]["shard_paths"]) for n in tr},
        "launches": {n: tr[n]["launches"] for n in tr},
        "served": served, "health": health,
        "ivf_recall_at_10": recall, "ivf": ivf_summary,
        "classification": {"accuracy": accuracy, "majority": majority,
                           "naive_bayes_err": nb_err,
                           "logistic_err": lr_err,
                           "logistic_same_label": lr_same},
        "phaseSeconds": total,
    }
    log(json.dumps({"engines": checks, "detail": detail}, default=str))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase engines: checks failed: {bad}")
    return {**detail, "launches": launches, "s": total}


# phase sessions: the engines that train no factor model (trending and
# nextitem) on a day of view events in the ML-20M store, after phase
# engines and before phase foldin
SESSIONS_PHASE_LIMIT_S = 90.0
# a day of a mid-size shop's views is 2,000,000; quartered to keep the
# script under its time budget (widths and sessions are not cut)
SESSIONS_EVENTS = 500_000
# sessions: mean length 8 (geometric), 5 to 120 s between a session's
# views, over 1,800 s between one user's sessions, at most 24 a user in
# the day before the phase; each next view one of 8 successors of the
# item (Zipf 1.0 over them) or, 1 time in 5, a restart (Zipf 1.0 items)
SESSIONS_MEAN_LEN = 8
SESSIONS_PER_USER = 24
SESSIONS_SUCCESSORS = 8
SESSIONS_RESTART = 0.2
SESSIONS_GAP_S = 1_800.0
SESSIONS_DAY_MS = 86_400_000
TRENDING_HALF_LIFE_S = 21_600.0
NEXTITEM_HALF_LIFE_S = 604_800.0
SESSIONS_SOLO = 32
SESSIONS_QUERIES = 256
SESSIONS_CLIENTS = 64
SESSIONS_CHECK_ITEMS = 100
SESSIONS_FRESH = 5
# the batching step after nextitem's 64-client load: rounds of 64 item
# queries, each round written on 64 connections before any reply is
# read; first back to back, then each after the deploy's refreshSec has
# run out (its next batch scans the store, which frees the GIL while the
# rest of the round queues behind it)
SESSIONS_BURST_ROUNDS = 3


def synth_views(n_events: int, t_end_ms: int, seed: int = 71):
    """A day of view events at ML-20M's widths, made from a seed: the
    ``(user, item, event ms)`` arrays, every time in the 24 h before
    ``t_end_ms``.  Sessions of geometric length (mean
    :data:`SESSIONS_MEAN_LEN`, cut to ``n_events`` in all) belong to
    users drawn Zipf 0.8, at most :data:`SESSIONS_PER_USER` a user (a
    draw past that is drawn again from the users with room); each user's
    sessions lie in the day in turn, more than :data:`SESSIONS_GAP_S`
    apart, the slack spread at random.  A session's first item is Zipf
    1.0 over the items; each next one is one of the item's
    :data:`SESSIONS_SUCCESSORS` fixed successors (Zipf 1.0 over them),
    or a restart with probability :data:`SESSIONS_RESTART`."""
    rng = np.random.default_rng(seed)
    lens = rng.geometric(1 / SESSIONS_MEAN_LEN,
                         size=n_events // SESSIONS_MEAN_LEN * 2 + 16)
    ends = np.cumsum(lens)
    n_s = int(np.searchsorted(ends, n_events)) + 1
    lens = lens[:n_s].copy()
    lens[-1] -= int(ends[n_s - 1] - n_events)
    w_u = 1.0 / np.arange(1, N_USERS + 1) ** 0.8
    w_u /= w_u.sum()
    counts = rng.multinomial(n_s, w_u)
    while (counts > SESSIONS_PER_USER).any():
        over = int(np.maximum(counts - SESSIONS_PER_USER, 0).sum())
        counts = np.minimum(counts, SESSIONS_PER_USER)
        room = np.where(counts < SESSIONS_PER_USER, w_u, 0.0)
        counts += rng.multinomial(over, room / room.sum())
    s_user = np.repeat(np.arange(N_USERS), counts)
    starts = np.r_[0, np.cumsum(lens)[:-1]]
    ev_s = np.repeat(np.arange(n_s), lens)
    gap = rng.integers(5_000, 120_001, n_events)
    gap[starts] = 0
    off = np.cumsum(gap)
    off -= off[starts][ev_s]
    dur = off[starts + lens - 1]
    # a user's sessions take dur + 1,801 s each; the slack of the day is
    # cut at sorted uniform points, one a session
    first = np.r_[True, s_user[1:] != s_user[:-1]]
    grp = np.cumsum(first) - 1
    span = SESSIONS_DAY_MS - 60_000
    gap_ms = int(SESSIONS_GAP_S * 1000) + 1_000
    step = dur + gap_ms
    slack = span - np.bincount(grp, weights=step) + gap_ms
    if slack.min() < 0:
        raise AssertionError("a user's sessions do not fit in the day")
    cut = rng.random(n_s) * slack[grp]
    cut = cut[np.lexsort((cut, grp))].astype(np.int64)
    before = np.cumsum(step) - step
    before -= before[first][grp]
    s_t0 = t_end_ms - span - 30_000 + cut + before
    t_ms = s_t0[ev_s] + off
    # the items, one position of every session at a time
    w_i = 1.0 / np.arange(1, N_ITEMS + 1)
    w_i /= w_i.sum()
    succ = (np.arange(N_ITEMS)[:, None] + 1 + rng.integers(
        0, N_ITEMS - 1, (N_ITEMS, SESSIONS_SUCCESSORS))) % N_ITEMS
    w_k = 1.0 / np.arange(1, SESSIONS_SUCCESSORS + 1)
    w_k /= w_k.sum()
    item = np.empty(n_events, np.int64)
    cur = rng.choice(N_ITEMS, n_s, p=w_i)
    for j in range(int(lens.max())):
        live = np.flatnonzero(lens > j)
        if j:
            nxt = succ[cur[live], rng.choice(SESSIONS_SUCCESSORS, len(live),
                                              p=w_k)]
            restart = rng.random(len(live)) < SESSIONS_RESTART
            nxt[restart] = rng.choice(N_ITEMS, int(restart.sum()), p=w_i)
            cur[live] = nxt
        item[starts[live] + j] = cur[live]
    return s_user[ev_s], item, t_ms


_VIEW_LINE = (b'{"event":"view","entityType":"user","entityId":"u', "u",
              b'","targetEntityType":"item","targetEntityId":"i', "i",
              b'","eventTime":"', "t", b'Z"}\n')


def write_view_lines(path, u, i, t_ms) -> None:
    """The view events ``(u, i, t_ms)`` as JSON lines (one app's import
    file), built as one fixed-width byte matrix: the ids as
    :func:`user_id` and :func:`item_id` give them, the time to the
    millisecond."""
    when = np.datetime_as_string(t_ms.astype("datetime64[ms]"), unit="ms")
    widths = [len(x) if isinstance(x, bytes) else {"u": 6, "i": 5, "t": 23}[x]
              for x in _VIEW_LINE]
    m = np.empty((len(u), sum(widths)), np.uint8)
    col = 0
    for part, w in zip(_VIEW_LINE, widths):
        if isinstance(part, bytes):
            m[:, col:col + w] = np.frombuffer(part, np.uint8)
        elif part == "t":
            m[:, col:col + w] = when.astype("S23").view(np.uint8).reshape(
                -1, w)
        else:
            _digits(m, col, u if part == "u" else i, w)
        col += w
    with open(path, "wb") as f:
        f.write(m.tobytes())


@contextlib.contextmanager
def seconds_in(cls, name: str, sink: list):
    """While the block runs, the seconds of every call of the method
    ``cls.name`` go to ``sink``."""
    orig = cls.__dict__[name]

    @functools.wraps(orig)
    def timed_call(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kw)
        finally:
            sink.append(time.perf_counter() - t0)

    setattr(cls, name, timed_call)
    try:
        yield sink
    finally:
        setattr(cls, name, orig)


@contextlib.contextmanager
def clock_at(t: float):
    """The host engines' modules (trending, the transition store) read
    ``t`` from the clock: an in-process ``predict`` scored at ``t``."""
    import types

    from predictionio_tpu_torch.sessions import store as store_mod
    from predictionio_tpu_torch.templates import trending

    pinned = types.SimpleNamespace(time=lambda: t, monotonic=time.monotonic)
    saved = trending.time, store_mod.time
    trending.time = store_mod.time = pinned
    try:
        yield
    finally:
        trending.time, store_mod.time = saved


def _same_at_query_time(got: dict, early: dict, late: dict,
                        what: str) -> None:
    """A reply whose scores decay with the clock, against an in-process
    ``predict`` scored at the start (``early``) and at the end
    (``late``) of the load it came in: the same items in the same order,
    each score between the two within 1e-6 relative."""
    items = [s["item"] for s in got["itemScores"]]
    if items != [s["item"] for s in early["itemScores"]] or items != [
            s["item"] for s in late["itemScores"]]:
        raise AssertionError(f"{what}: {got} where predict gives {early}")
    for s, hi, lo in zip(got["itemScores"], early["itemScores"],
                         late["itemScores"]):
        if not (lo["score"] * (1 - 1e-6) <= s["score"]
                <= hi["score"] * (1 + 1e-6)):
            raise AssertionError(f"{what}: score {s} outside "
                                 f"[{lo['score']}, {hi['score']}]")


def http_burst(port: int, bodies: list, clients: int) -> list:
    """``bodies`` POSTed to ``/queries.json`` in rounds of ``clients``:
    every request of a round is written, one on each of ``clients``
    keep-alive connections, before the first reply of the round is read.
    Returns ``(status, reply)`` in body order."""
    import http.client

    conns = [http.client.HTTPConnection("127.0.0.1", port, timeout=120)
             for _ in range(clients)]
    out = []
    try:
        for k in range(0, len(bodies), clients):
            part = bodies[k:k + clients]
            for conn, body in zip(conns, part):
                conn.request("POST", "/queries.json", json.dumps(body),
                             {"Content-Type": "application/json"})
            for conn in conns[:len(part)]:
                r = conn.getresponse()
                out.append((r.status, json.loads(r.read())))
    finally:
        for conn in conns:
            conn.close()
    return out


def _batch_delta(after: dict, before: dict) -> dict:
    """What a step added to a deploy's ``microbatch`` status: its
    requests, its batches, and the largest batch seen so far."""
    return {"requests": after["requests"] - before["requests"],
            "batches": after["batches"] - before["batches"],
            "maxBatchSeen": after["maxBatchSeen"]}


def _top_outside_ties(got: list, weights: np.ndarray, k: int) -> bool:
    """``got`` (item indexes, best first) is a top ``k`` of ``weights``:
    every index above the k-th weight is in it, and every one in it is at
    least the k-th weight (the same list outside exact ties)."""
    order = np.argsort(-weights, kind="stable")
    kth = weights[order[min(k, len(order)) - 1]]
    must = set(np.flatnonzero(weights > kth).tolist())
    may = set(np.flatnonzero((weights >= kth) & (weights > 0)).tolist())
    return (len(got) == min(k, len(may | must)) and must <= set(got) <= may)


def _stale_serves(port: int) -> float:
    """``pio_resilience_events_total{kind="trending.stale_serve"}`` of a
    server."""
    return sum(c["value"] for key, c in _children(
        _scrape(port)[1], "pio_resilience_events_total").items()
        if ("kind", "trending.stale_serve") in key)


def host_train(st, ej) -> dict:
    """``train --engine-json EJ`` in this process for an engine that
    trains no factor model: its seconds split into the store's scans
    (``find_rows_since``), the fold of the rows read (the rest of
    ``read_training``) and the rest (the model's save)."""
    scans = []
    t0 = time.perf_counter()
    with CaptureLog() as records, seconds_in(
            type(st.get_event_store()), "find_rows_since", scans):
        out = cli(["train", "--engine-json", str(ej)], st)
    train_s = time.perf_counter() - t0
    iid = out.split()[-1]
    if st.get_metadata().engine_instance_get(iid).status != "COMPLETED":
        raise AssertionError(f"instance {iid} did not complete: {out}")
    (read_s,) = records.args(_READ_LOG)
    return {"iid": iid, "train_s": train_s, "scan_s": sum(scans),
            "fold_s": read_s - sum(scans), "scans": len(scans)}


def host_train_child(ej: str) -> None:
    """:func:`host_train` in a child process, on the store its
    environment names; the result goes to stdout as its last line."""
    from predictionio_tpu_torch.storage import get_storage

    print(json.dumps(host_train(get_storage(), ej)))


def phase_sessions(torch, store: StoreHome) -> dict:
    """Trending and nextitem, the engines that train no factor model, on
    the 4-shard ML-20M store after phase engines (their writes leave the
    other apps' scan-cache snapshots valid: phase foldin's train read
    checks that).  App ``views`` through the console (``app new``, then
    ``import`` of :data:`SESSIONS_EVENTS` view events of
    :func:`synth_views` as JSON lines) → ``template get``, ``build`` and
    ``train`` of each, at once: nextitem in this process, trending in a
    child (trending: half-life 21,600 s, ``refreshSec`` 2; nextitem: gap
    1,800 s, half-life 604,800 s) → the two ``deploy`` processes booting at
    once on the event-loop edge, the trending one under
    ``PIO_FAULT_PLAN="storage.read:times=1"`` (its first refresh, at
    boot, fails) → meanwhile, in process:

    * trending's decayed weight of every item against a float64
      recomputation from the generator's (item, time) arrays within
      1e-9 relative, and its top 10 the same outside exact ties;
    * nextitem's successor weights of the 100 most-viewed items against
      a numpy recomputation of the gap-sessionized transitions (the
      reference's rules: a forward gap over 1,800 s breaks a session, a
      repeated item adds no transition) within 1e-9 relative;
    * ``e2.MarkovChain.train`` on the same transitions, undecayed: its
      top 10 successors of those items the same as a numpy count outside
      exact ties, each probability within 1e-6.

    Then each deploy answers 32 solo queries and 256 from 64 clients,
    every reply held against an in-process ``predict`` scored at the
    start and at the end of its load (:func:`_same_at_query_time`);
    trending's stale list served with
    ``pio_resilience_events_total{kind="trending.stale_serve"}`` above 0
    on ``/metrics``; nextitem's batches above 1, trending's none (no
    batcher).  Freshness, through an ``eventserver`` process on the
    store, :data:`SESSIONS_FRESH` times each: a burst of views of a cold
    item, a 1.05 share more than the top item's score (the earlier
    bursts' items black-listed), from the last ``201`` to the first
    reply with it at top 1; a cold item's new ``a → b`` sessions, one
    more than ``a``'s top successor weight, to the first reply with
    ``b`` first.  Checks go on one ``{"obs": ...}`` line; a false one,
    or the phase past :data:`SESSIONS_PHASE_LIMIT_S`, fails the run."""
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import load_engine_from_variant
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.e2 import MarkovChain
    from predictionio_tpu_torch.templates import nextitem, trending
    from predictionio_tpu_torch.workflow import prepare_deploy_components

    t_phase = time.perf_counter()
    t_end_ms = int(time.time() * 1000)
    st = store.storage
    home = Path(store.home)
    rng = np.random.default_rng(72)
    checks, detail = {}, {}
    # the event server the freshness bursts go through boots meanwhile
    events = Console(store.home, ["eventserver", "--ip", "127.0.0.1",
                                  "--port", "0"], "sessions-events")
    procs = {}
    try:
        out = cli(["app", "new", "views"], st)
        key = out.split("Access key: ")[1].split()[0]
        app_id = st.get_metadata().app_get_by_name("views").id
        t0 = time.perf_counter()
        u, i, t_ms = synth_views(SESSIONS_EVENTS, t_end_ms)
        src = home / "views.jsonl"
        write_view_lines(src, u, i, t_ms)
        made_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        with CaptureLog() as records:
            out = cli(["import", "--appid", str(app_id), "--input",
                       str(src)], st)
        import_s = time.perf_counter() - t0
        src.unlink()
        branches = records.args(_IMPORT_LOG)[1:]
        checks["import_took_every_view"] = (
            out == f"Imported {SESSIONS_EVENTS} events.\n")

        # the two engines through the console
        ds = {"appName": "views", "eventNames": ["view"],
              "refreshSec": 2.0}
        ejs = {
            "trending": engine_scaffold(st, home, "trending", {
                **ds, "halfLifeSec": TRENDING_HALF_LIFE_S},
                [{"name": "trending", "params": {}}]),
            "nextitem": engine_scaffold(st, home, "nextitem", {
                **ds, "sessionGapSec": SESSIONS_GAP_S,
                "halfLifeSec": NEXTITEM_HALF_LIFE_S},
                [{"name": "nextitem", "params": {}}]),
        }
        # trending trains in a child process while nextitem trains in
        # this one: both folds are Python, which one process would run
        # in turn
        root = str(Path(__file__).resolve().parent)
        with open(home / "train-trending.log", "wb") as child_log:
            child = subprocess.Popen(
                [sys.executable, "-c", "import sys, chip_smoke; "
                 "chip_smoke.host_train_child(sys.argv[1])",
                 str(ejs["trending"])], cwd=root,
                env={**os.environ, "PYTHONPATH": root},
                stdout=subprocess.PIPE, stderr=child_log)
            try:
                tr = {"nextitem": host_train(st, ejs["nextitem"])}
                out = child.communicate(timeout=600)[0].decode()
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        if child.returncode != 0:
            raise AssertionError(
                f"trending's train exited with {child.returncode}:\n"
                + (home / "train-trending.log").read_text()[-8000:])
        tr["trending"] = json.loads(out.splitlines()[-1])
        for name, ej in ejs.items():
            env = ({"PIO_FAULT_PLAN": "storage.read:times=1"}
                   if name == "trending" else None)
            procs[name] = Console(store.home, [
                "deploy", "--engine-json", str(ej), "--ip", "127.0.0.1",
                "--port", "0"], f"deploy-{name}", env=env)

        # meanwhile: the served models, in process
        serving = WorkflowContext(mode="Serving", storage=st)
        comp = {}
        for name, ej in ejs.items():
            engine, ep, _ = load_engine_from_variant(ej)
            algos, models, _ = prepare_deploy_components(
                engine, ep, tr[name]["iid"], ctx=serving)
            comp[name] = (algos[0], models[0])
        tm, nm = comp["trending"][1], comp["nextitem"][1]
        counts = np.bincount(i, minlength=N_ITEMS)

        # trending's weights against float64 from the generator's arrays
        t_checks = time.perf_counter()
        want = np.bincount(i, weights=2.0 ** ((t_ms / 1000.0 - tm.t0)
                                              / TRENDING_HALF_LIFE_S),
                           minlength=N_ITEMS)
        ix = np.asarray([int(s[1:]) for s in tm.item_ids])
        got = np.zeros(N_ITEMS)
        got[ix] = tm.weights
        rel_t = float(np.max(np.abs(got - want) / np.maximum(want, 1e-300)))
        checks["trending_weights_within_1e-9_of_float64"] = bool(
            rel_t <= 1e-9 and sorted(ix.tolist())
            == np.flatnonzero(counts).tolist())
        with clock_at(tm.t0):
            top10 = [int(s[1:]) for s, _ in tm.top(10)]
        checks["trending_top10_equal_outside_ties"] = _top_outside_ties(
            top10, want, 10)

        # nextitem's successor rows against numpy's transitions
        order = np.lexsort((t_ms, u))
        us, items_, ts = u[order], i[order], t_ms[order]
        cont = ((us[1:] == us[:-1])
                & (np.diff(ts) <= int(SESSIONS_GAP_S * 1000))
                & (items_[1:] != items_[:-1]))
        src_ix, dst_ix, te_ms = items_[:-1][cont], items_[1:][cont], \
            ts[1:][cont]
        hot = np.argsort(-counts, kind="stable")[:SESSIONS_CHECK_ITEMS]
        by_src = np.argsort(src_ix, kind="stable")
        cuts = np.searchsorted(src_ix[by_src], np.arange(N_ITEMS + 1))
        rel_n, same_keys = 0.0, True
        for a in hot:
            rows = by_src[cuts[a]:cuts[a + 1]]
            w = np.bincount(dst_ix[rows], weights=2.0 ** (
                (te_ms[rows] / 1000.0 - nm.store.t0) / NEXTITEM_HALF_LIFE_S),
                minlength=N_ITEMS)
            row = dict(nm.store.top_successors(item_id(a), N_ITEMS,
                                               now=nm.store.t0))
            keys = np.asarray(sorted(int(s[1:]) for s in row))
            same_keys &= keys.tolist() == np.flatnonzero(w).tolist()
            if len(keys):
                mine = np.asarray([row[item_id(b)] for b in keys])
                rel_n = max(rel_n, float(np.max(np.abs(mine - w[keys])
                                                / w[keys])))
        checks["nextitem_rows_within_1e-9_of_numpy"] = bool(
            same_keys and rel_n <= 1e-9
            and nm.store.transitions_folded == len(src_ix))
        checks_s = time.perf_counter() - t_checks

        # e2's Markov chain on the same transitions, undecayed
        names = np.asarray([item_id(k) for k in range(N_ITEMS)], dtype=object)
        t0 = time.perf_counter()
        chain = MarkovChain.train(
            list(zip(names[src_ix].tolist(), names[dst_ix].tolist())),
            top_n=10)
        chain_s = time.perf_counter() - t0
        chain_ok = True
        for a in hot:
            rows = by_src[cuts[a]:cuts[a + 1]]
            c = np.bincount(dst_ix[rows], minlength=N_ITEMS)
            pred = chain.predict(item_id(a))
            succ = [int(s[1:]) for s, _ in pred]
            chain_ok &= _top_outside_ties(succ, c.astype(np.float64), 10)
            chain_ok &= all(abs(p - c[b] / len(rows)) <= 1e-6 * c[b] / len(
                rows) for b, (_, p) in zip(succ, pred))
        checks["e2_markov_top10_equal_a_numpy_count"] = bool(chain_ok)

        # the queries, and what predict answers at both ends of a load
        pop = rng.choice(100, 144)
        tail = rng.choice(np.flatnonzero(counts)[100:], 144)
        queries = {
            "trending": [
                {"num": 10} if k % 3 == 0 else
                {"num": 5 + k % 7,
                 "blackList": [item_id(j) for j in rng.choice(50, 3)]}
                for k in range(SESSIONS_SOLO + SESSIONS_QUERIES)],
            "nextitem": [
                {"item": item_id(a), "num": 10} for pair in zip(pop, tail)
                for a in pair][:SESSIONS_SOLO + SESSIONS_QUERIES // 2] + [
                {"user": user_id(k), "num": 10}
                for k in rng.integers(0, N_USERS, SESSIONS_QUERIES // 2)],
        }
        qclass = {"trending": trending.Query, "nextitem": nextitem.Query}

        burst = [{"item": item_id(a), "num": 10} for a in rng.choice(
            np.flatnonzero(counts), SESSIONS_CLIENTS * SESSIONS_BURST_ROUNDS
            * 2)]

        def predict_at(name, t, qs=None):
            algo, model = comp[name]
            with clock_at(t):
                return [algo.predict(model, qclass[name].from_json(q))
                        .to_json() for q in (queries[name] if qs is None
                                             else qs)]

        # the HTTP loads, one deploy at a time
        served = {}
        for name, proc in procs.items():
            port = proc.wait_port()
            if name == "trending":
                checks["trending_fault_plan_booked_a_stale_serve"] = (
                    _stale_serves(port) > 0)
            qs = queries[name]
            t_a = time.time()
            load = http_load(port, qs[:SESSIONS_SOLO], qs[SESSIONS_SOLO:],
                             SESSIONS_CLIENTS)
            t_b = time.time()
            for q, g, hi, lo in zip(qs, load["replies"],
                                    predict_at(name, t_a),
                                    predict_at(name, t_b)):
                _same_at_query_time(g, hi, lo, f"{name} query {q}")
            checks[f"{name}_http_equals_predict_at_query_time"] = True
            checks[f"{name}_answered"] = sum(
                bool(r["itemScores"]) for r in load["replies"]) > len(qs) // 2
            status = _http(port, "/")
            served[name] = dict(
                boot_s=proc.boot_s,
                solo_p50_p99=list(np.percentile(load["solo_ms"], [50, 99])),
                conc_p50_p99=list(np.percentile(load["conc_ms"], [50, 99])),
                qps=load["qps"], batches=status.get("microbatch"))
        # nextitem's predict is Python on the host: under one GIL the
        # loop thread and the dispatcher take turns a request at a time,
        # and only a batch that scans the store (once a refreshSec)
        # frees the GIL long enough for others to queue.  The batching
        # step: rounds written all at once, back to back, then each
        # after refreshSec has run out; replies equal predict as above
        nport = procs["nextitem"].wait_port()
        last = served["nextitem"]["batches"]
        steps = {"load": _batch_delta(last, {"requests": 0, "batches": 0})}
        for step, wait in (("burst", 0.0), ("burst_after_refresh",
                                             ds["refreshSec"] + 0.1)):
            qs = burst[:SESSIONS_CLIENTS * SESSIONS_BURST_ROUNDS]
            burst = burst[len(qs):]
            t_a = time.time()
            replies = []
            for k in range(0, len(qs), SESSIONS_CLIENTS):
                time.sleep(wait)
                replies += http_burst(nport, qs[k:k + SESSIONS_CLIENTS],
                                      SESSIONS_CLIENTS)
            t_b = time.time()
            if any(st != 200 for st, _ in replies):
                raise AssertionError(f"nextitem {step}: {replies[:2]}")
            for q, (_, g), hi, lo in zip(qs, replies,
                                        predict_at("nextitem", t_a, qs),
                                        predict_at("nextitem", t_b, qs)):
                _same_at_query_time(g, hi, lo, f"nextitem {step} {q}")
            now = _http(nport, "/")["microbatch"]
            steps[step] = _batch_delta(now, last)
            last = now
        checks["nextitem_burst_equals_predict_at_query_time"] = True
        served["nextitem"]["batches"] = last
        served["nextitem"]["batch_steps"] = steps
        mb = served["nextitem"]["batches"]
        checks["nextitem_batches_above_1"] = bool(
            mb and mb["maxBatchSeen"] > 1 and mb["batches"] < mb["requests"])
        checks["trending_does_not_batch"] = (
            served["trending"]["batches"] is None)

        # freshness through the event server, both engines at once
        eport = events.wait_port()
        tport = procs["trending"].wait_port()
        url = f"/batch/events.json?accessKey={key}"

        def post(evs) -> float:
            replies = _post_all(eport, url, [evs[k:k + 50] for k in range(
                0, len(evs), 50)], 8)
            if any(s != 200 or any(e["status"] != 201 for e in r)
                   for s, r in replies):
                events.fail(f"refused a view: {replies[:2]}")
            return time.perf_counter()

        def trending_fresh() -> tuple:
            """A burst of views of each cold item, a 1.05 share more than
            the top 1's score (the earlier bursts' items black-listed),
            to the first reply with it at top 1."""
            fresh, bursts, shown = [], [], []
            for k, c in enumerate(np.argsort(counts, kind="stable")[
                    :SESSIONS_FRESH]):
                q = {"num": 1, "blackList": list(shown)}
                top = _http(tport, "/queries.json", q)["itemScores"][0]
                bursts.append(int(top["score"] * 1.05) + 50)
                acked = post([{"event": "view", "entityType": "user",
                               "entityId": f"burst{k}-{j:05d}",
                               "targetEntityType": "item",
                               "targetEntityId": item_id(c)}
                              for j in range(bursts[-1])])
                _wait_for(lambda: _http(tport, "/queries.json", q)[
                    "itemScores"][0]["item"] == item_id(c), 60,
                    f"trending's top 1 {item_id(c)}", 0.02)
                fresh.append(time.perf_counter() - acked)
                shown.append(item_id(c))
            return fresh, bursts

        def nextitem_fresh() -> tuple:
            """For anchors ``a`` whose top successor weighs 1 to 3, one
            more ``a → b`` session than that weight (``b`` no successor
            of ``a`` yet), to the first reply with ``b`` first."""
            anchors = []
            for a in np.random.default_rng(73).permutation(
                    np.flatnonzero(counts)):
                top = nm.store.top_successors(item_id(a), 1,
                                              now=nm.store.t0)
                if top and 1.0 <= top[0][1] <= 3.0:
                    anchors.append((item_id(a), top[0][1]))
                if len(anchors) == SESSIONS_FRESH:
                    break
            fresh, walks = [], []
            for k, (a, w1) in enumerate(anchors):
                b = next(item_id(j) for j in rng.integers(0, N_ITEMS, 64)
                         if nm.store.weight(a, item_id(j),
                                            now=nm.store.t0) == 0.0)
                walks.append(int(np.ceil(w1)) + 1)
                stamp = time.time()
                acked = post([{
                    "event": "view", "entityType": "user",
                    "entityId": f"walk{k}-{j}", "targetEntityType": "item",
                    "targetEntityId": item, "eventTime": np.datetime_as_string(
                        np.datetime64(int((stamp - back) * 1000), "ms"),
                        unit="ms") + "Z"}
                    for j in range(walks[-1])
                    for item, back in ((a, 10.0), (b, 5.0))])
                _wait_for(lambda: _http(nport, "/queries.json", {
                    "item": a, "num": 1})["itemScores"][0]["item"] == b,
                    60, f"nextitem's {b} after {a}", 0.02)
                fresh.append(time.perf_counter() - acked)
            return fresh, walks

        with ThreadPoolExecutor(max_workers=2) as pool:
            t_job, n_job = pool.submit(trending_fresh), pool.submit(
                nextitem_fresh)
            (fresh_t, bursts), (fresh_n, sessions_n) = (
                t_job.result(), n_job.result())
        checks["nextitem_found_its_anchors"] = len(fresh_n) == SESSIONS_FRESH

        for proc in procs.values():
            if "Undeployed" not in cli(["undeploy", "--port", str(
                    proc.wait_port())], st):
                proc.fail("was not undeployed")
        for name, proc in procs.items():
            try:
                rc = proc.proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.fail("did not stop after undeploy")
            checks[f"{name}_undeploy_exit_0"] = rc == 0
    finally:
        for proc in procs.values():
            proc.stop()
        events.stop()
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_its_limit"] = phase_s <= SESSIONS_PHASE_LIMIT_S
    detail.update(
        events=SESSIONS_EVENTS, transitions=int(len(src_ix)),
        made_s=made_s, import_s=import_s, import_branches=branches,
        trains=tr, served=served, trending_rel=rel_t, nextitem_rel=rel_n,
        weights_check_s=checks_s, markov_s=chain_s,
        trending_freshness_s=fresh_t, trending_bursts=bursts,
        nextitem_freshness_s=fresh_n, nextitem_sessions=sessions_n,
        phase_s=phase_s)
    obs_report("sessions", checks, detail)
    log(f"phase sessions: {SESSIONS_EVENTS:,} views "
        f"({len(src_ix):,} transitions) made in {made_s:.1f} s, imported "
        f"in {import_s:.1f} s; trains (scan / fold / all s) "
        + "; ".join(f"{n} {t['scan_s']:.1f} / {t['fold_s']:.1f} / "
                    f"{t['train_s']:.1f}" for n, t in tr.items())
        + "; deploys up in "
        + ", ".join(f"{n} {s['boot_s']:.1f} s" for n, s in served.items())
        + "; from 64 clients "
        + ", ".join(f"{n} {s['qps']:.0f} queries/s p50/p99 "
                    f"{s['conc_p50_p99'][0]:.1f}/{s['conc_p50_p99'][1]:.1f}"
                    f" ms" for n, s in served.items())
        + f"; e2 MarkovChain.train {chain_s:.1f} s; freshness median "
        f"trending {float(np.median(fresh_t)):.3f} s, nextitem "
        f"{float(np.median(fresh_n)):.3f} s; phase {phase_s:.1f} s")
    return {"phase_s": phase_s, "batch_steps": steps}


# phase hive: tenancy and experiments at ML-20M width, after phase foldin
# (it writes to the store).  The second app has MovieLens-100K's counts
HIVE_USERS, HIVE_ITEMS, HIVE_RATINGS = 943, 1_682, 100_000
HIVE_LAMBDAS = {"control": 0.01, "treatment": 0.1}
HIVE_SALT = "hive-chip"
# the fold-in tenant's quota (the quota stage's 429s) and the breaker of
# every tenant (3 failures open it, 1 s before it lets a probe through)
HIVE_QUOTA_QPS, HIVE_QUOTA_BURST = 20.0, 40.0
HIVE_BREAKER = dict(breaker_failures=3, breaker_reset_s=1.0)
# the reference smoke's bound on the sibling's p99 under the flood
HIVE_FLOOD_P99_MS = 1500.0
# the autopilot's knobs, and the conversion rates its gap is seeded at
HIVE_PILOT = dict(min_samples=60, max_step=0.10, min_weight=0.05,
                  min_lift=0.20)
HIVE_PILOT_RATES = {"control": 0.1, "treatment": 0.5}
# phase hive's own limit
HIVE_PHASE_LIMIT_S = 90.0


def plain_variant(salt: str, app: str, user: str, weights: dict) -> str:
    """A user's variant by the documented rule, computed here on its
    own: the first 8 bytes of SHA-256 of ``salt \\0 app \\0 user`` as a
    big-endian fraction of 2^64, placed on the cumulative weights of the
    variants in name order."""
    import hashlib

    r = int.from_bytes(hashlib.sha256(
        f"{salt}\x00{app}\x00{user}".encode()).digest()[:8], "big") / 2 ** 64
    total, acc = sum(weights.values()), 0.0
    for name in sorted(weights):
        acc += weights[name] / total
        if r < acc:
            return name
    return sorted(weights)[-1]


def _same_items(got: dict, want: dict, what: str) -> None:
    """A tenant's reply against an in-process ``predict``: the same items
    in the same order, scores within 1e-4 of their scale."""
    g, w = got["itemScores"], want["itemScores"]
    scale = max([abs(s["score"]) for s in w] + [1.0])
    if [s["item"] for s in g] != [s["item"] for s in w] or any(
            abs(a["score"] - b["score"]) > 1e-4 * scale
            for a, b in zip(g, w)):
        raise AssertionError(f"{what}: {g} where predict gives {w}")


def _cuda_bytes(models) -> int:
    """Bytes of the CUDA tensors the models hold (their device tables)."""
    import torch

    return sum(t.nbytes for m in models for t in vars(m).values()
               if isinstance(t, torch.Tensor) and t.is_cuda)


def phase_hive(torch, store: StoreHome, cli_out: dict,
               foldin_out: dict) -> dict:
    """Tenancy and experiments at ML-20M width on the 4-shard store,
    after phase foldin (it writes to the store).  A second app, ``beta``,
    gets MovieLens-100K's counts (``HIVE_USERS`` x ``HIVE_ITEMS`` x
    ``HIVE_RATINGS`` from ``synth_ratings``, seed 1) through the
    console's ``import`` and two console ``train``s at rank 64 (lambda
    0.01 and 0.1, ``"fused"``: the launch counts are set to 0 just before
    them).  Four tenants in one tenants.json: ``ml20m/control`` (phase
    cli's instance, the anchor), ``ml20m/treatment`` (phase foldin's
    instance with its delta chain; under a quota), ``beta/control`` and
    ``beta/treatment``.  An ``EngineServer`` in this process hosts them
    (registry from the console's ``_build_tenant_registry``, feedback to
    an event server, online eval every 0.5 s) and the stages of the
    reference's ``tools/hive_smoke.py`` and ``tools/pilot_smoke.py``
    run against it, each set of checks one ``obs`` line: routing
    (sticky, and the plain hash rule's variant), the fold-in tenant
    answering phase foldin's users as that phase did, the shared
    batcher mixing tenants, fair sharing under an 8-worker flood, breaker
    and quota isolation, eviction on the card (LRU order, an eviction
    under traffic with no failed request, ``torch.cuda.memory_allocated``
    falling by 90% of the evicted tenant's device bytes, its reload with
    the chain applied), attribution and online eval, and the autopilot
    concluding beta's experiment through real ``POST /tenants/weights``
    steps.  Last, ``deploy --multi tenants.json --memory-budget B
    --autopilot on`` as a process: one query a tenant, ``/debug/tenants``
    and ``/debug/experiments``, ``undeploy``.  The phase fails past
    ``HIVE_PHASE_LIMIT_S``."""
    import argparse
    import weakref
    from pathlib import Path

    from predictionio_tpu_torch.cli.main import (
        _build_tenant_registry, load_engine_from_variant,
    )
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.obs.runlog import read_manifest, runs_root
    from predictionio_tpu_torch.ops import _build, gather_probe
    from predictionio_tpu_torch.resilience import faults
    from predictionio_tpu_torch.server import EngineServer, ServerConfig
    from predictionio_tpu_torch.server.event_server import (
        EventServer, EventServerConfig,
    )
    from predictionio_tpu_torch.tenancy.autopilot import (
        STATE_CONCLUDED, AutopilotConfig,
    )

    t_phase = time.perf_counter()
    st = store.storage
    es = st.get_event_store()
    md = st.get_metadata()
    home = Path(store.home)
    cli(["app", "new", "beta"], st)
    beta_id = md.app_get_by_name("beta").id
    beta_key = md.access_key_get_by_app(beta_id)[0].key
    u, i, v = synth_ratings(HIVE_USERS, HIVE_ITEMS, HIVE_RATINGS, seed=1,
                            distinct=True)
    src = home / "beta.jsonl"
    with open(src, "wb") as f:
        write_rate_lines(f, u, i, v, 0)
    t0 = time.perf_counter()
    out = cli(["import", "--appid", str(beta_id), "--input", str(src)], st)
    import_s = time.perf_counter() - t0
    mib = src.stat().st_size / 2 ** 20
    src.unlink()
    if out != f"Imported {HIVE_RATINGS} events.\n":
        raise AssertionError(f"import of beta: {out!r}")
    # the tenants' engine.json: phase cli's with beta's app and lambda
    engines = {("ml20m", "control"): cli_out["engine_json"],
               ("ml20m", "treatment"): foldin_out["engine_json"]}
    base = json.loads(Path(cli_out["engine_json"]).read_text())
    gather_probe._ORDER_CACHE.clear()  # a train is a process of its own
    _build.reset_launches()
    train_s = {}
    for variant, lam in HIVE_LAMBDAS.items():
        doc = json.loads(json.dumps(base))
        doc["datasource"]["params"]["appName"] = "beta"
        doc["algorithms"][0]["params"]["lambda"] = lam
        ej = Path(cli_out["engine_json"]).with_name(f"engine-beta-{variant}"
                                                    ".json")
        ej.write_text(json.dumps(doc, indent=2))
        t0 = time.perf_counter()
        cli(["train", "--scan-cache", "--engine-json", str(ej)], st)
        torch.cuda.synchronize()
        train_s[variant] = time.perf_counter() - t0
        engines[("beta", variant)] = str(ej)
    launches = dict(_build.LAUNCHES)
    iids = {("ml20m", "control"): cli_out["iid"],
            ("ml20m", "treatment"): foldin_out["iid"]}
    tenants = []
    for (app, variant), ej in engines.items():
        t = {"app": app, "variant": variant, "engineJson": ej, "weight": 0.5}
        if (app, variant) in iids:
            t["engineInstanceId"] = iids[app, variant]
        if (app, variant) == ("ml20m", "treatment"):
            t.update(quotaQps=HIVE_QUOTA_QPS, quotaBurst=HIVE_QUOTA_BURST)
        tenants.append(t)
    manifest = home / "tenants.json"
    manifest.write_text(json.dumps({"experimentSalt": HIVE_SALT,
                                    "evalIntervalSec": 0.5,
                                    "tenants": tenants}, indent=2))
    A, T = ("ml20m", "control"), ("ml20m", "treatment")
    C, B = ("beta", "control"), ("beta", "treatment")

    reg = _build_tenant_registry(argparse.Namespace(
        multi=str(manifest), memory_budget=0, autopilot=None), st)
    ev = EventServer(st, EventServerConfig(host="127.0.0.1", port=0))
    ev.start_background()
    engine, ep, variant = load_engine_from_variant(cli_out["engine_json"])
    srv = EngineServer(
        engine, ep, cli_out["iid"],
        ctx=WorkflowContext(mode="Serving", storage=st),
        config=ServerConfig(host="127.0.0.1", port=0, feedback=True,
                            event_server_url=f"http://127.0.0.1:{ev.port}",
                            access_key=store.key, **HIVE_BREAKER),
        engine_id=variant.get("id", "default"),
        engine_variant=cli_out["engine_json"], tenants=reg)
    srv.start_background()
    port = srv.port
    stages, checks, detail = {}, {}, {
        "beta": {"importSec": import_s, "importMiB": mib,
                 "trainSec": train_s}}

    def q(app, user, variant=None, num=10):
        body = {"app": app, "user": user, "num": num}
        if variant is not None:
            body["variant"] = variant
        code, raw, _ = _raw(port, "/queries.json", body, timeout=60)
        return code, json.loads(raw)

    def drive(app, n, variant=None, users=None):
        codes, lats = [], []
        for k in range(n):
            t0 = time.perf_counter()
            codes.append(q(app, (users or beta_users)[k % 8],
                           variant)[0])
            lats.append(time.perf_counter() - t0)
        return codes, lats

    beta_users = [user_id(k) for k in range(8)]
    # 30 users: the fold-in tenant's share of them and phase foldin's
    # users stay inside its quota's burst
    ml_users = [user_id(k) for k in range(0, 300, 10)]
    stage_t = [time.perf_counter()]

    def stage(name):
        now = time.perf_counter()
        stages[name] = round(now - stage_t[0], 3)
        stage_t[0] = now

    try:
        # routing: sticky, both variants, the documented hash rule
        assigned = {}
        for user in ml_users:
            code, body = q("ml20m", user)
            if code != 200:
                raise AssertionError(f"ml20m query: {code} {body}")
            assigned[user] = body["variant"]
        weights = {"control": 0.5, "treatment": 0.5}
        checks["variant_routing_sticky"] = (
            all(q("ml20m", user)[1]["variant"] == var
                for user, var in list(assigned.items())[:10])
            and set(assigned.values()) == {"control", "treatment"})
        checks["assignment_is_the_hash_rule"] = all(
            plain_variant(HIVE_SALT, "ml20m", user, weights) == var
            for user, var in assigned.items())
        detail["assignmentSplit"] = {
            x: sum(1 for y in assigned.values() if y == x)
            for x in ("control", "treatment")}
        # the fold-in tenant answers phase foldin's users as it did
        for user, want in foldin_out["replies"].items():
            code, got = q("ml20m", user, "treatment")
            if code != 200 or not got["itemScores"]:
                raise AssertionError(f"fold-in tenant, user {user}: {code}"
                                     f" {got}")
            _same_items(got, want, f"fold-in tenant, user {user}")
        rt = reg.get_runtime(T)
        checks["foldin_tenant_serves_its_chain"] = (
            rt.foldin_deltas_applied == foldin_out["links"] >= 3)
        del rt
        codes, base_lats = drive("beta", 40)
        if any(c != 200 for c in codes):
            raise AssertionError(f"beta queries: {codes}")
        detail["betaBaselineP50Ms"] = float(np.percentile(base_lats, 50)
                                            * 1e3)
        stage("routing")

        # the shared batcher: a claim that mixes tenants
        core = srv._shared_core
        mixed0, rounds = core.stats()["mixedBatches"], 0
        while rounds < 8 and core.stats()["mixedBatches"] <= mixed0:
            rounds += 1
            with ThreadPoolExecutor(max_workers=4) as pool:
                list(pool.map(lambda a: drive(a, 25, users=(
                    ml_users if a == "ml20m" else beta_users)),
                    ("ml20m", "beta", "ml20m", "beta")))
        cs = core.stats()
        checks["mixed_tenant_batch_observed"] = cs["mixedBatches"] > mixed0
        detail["sharedBatcher"] = {k: cs[k] for k in (
            "mixedBatches", "tenantsRegistered", "tenantClaims")}
        detail["sharedBatcher"]["roundsToMix"] = rounds
        stage("shared batcher")

        # fair sharing: an 8-worker flood on the anchor, beta sequential
        stop = threading.Event()
        flood_codes = []

        def flood():
            while not stop.is_set():
                flood_codes.append(q("ml20m", ml_users[3], "control")[0])

        floods = [threading.Thread(target=flood) for _ in range(8)]
        for t in floods:
            t.start()
        time.sleep(0.2)
        try:
            b_codes, b_lats = drive("beta", 30)
        finally:
            stop.set()
            for t in floods:
                t.join(timeout=60)
        p99 = float(np.percentile(b_lats, 99) * 1e3)
        checks["sibling_zero_errors_under_flood"] = all(
            c == 200 for c in b_codes)
        checks["sibling_p99_bounded_under_flood"] = p99 < HIVE_FLOOD_P99_MS
        detail["fairSharing"] = {"floodRequests": len(flood_codes),
                                 "floodCodes": sorted(set(flood_codes)),
                                 "betaP99Ms": p99}
        stage("fair sharing")

        # breaker isolation: a fault plan on beta/treatment's dispatch
        faults.arm("tenant.dispatch:tenant=beta/treatment,exc=fault")
        try:
            bt_codes, _ = drive("beta", 12, "treatment")
            ml_codes = []
            for k in range(40):
                bt_codes.append(q("beta", beta_users[k % 8],
                                  "treatment")[0])
                ml_codes.append(q("ml20m", ml_users[k % 30])[0])
        finally:
            faults.disarm()
        checks["breaker_opens_and_sheds"] = (
            bt_codes.count(500) >= 3 and bt_codes.count(503) >= 1
            and set(bt_codes) <= {500, 503})
        checks["sibling_unaffected_by_breaker"] = all(
            c == 200 for c in ml_codes)
        time.sleep(HIVE_BREAKER["breaker_reset_s"] * 1.2)
        rec = [q("beta", beta_users[0], "treatment")[0] for _ in range(3)]
        checks["breaker_recovers_after_reset"] = rec[-1] == 200
        detail["breaker"] = {"codes": {c: bt_codes.count(c)
                                       for c in set(bt_codes)},
                             "recovery": rec}
        stage("breaker isolation")

        # quota isolation: the fold-in tenant over its quota, its sibling
        # in the same app clean
        t_codes, _ = drive("ml20m", 100, "treatment", ml_users)
        c_codes, _ = drive("ml20m", 20, "control", ml_users)
        checks["quota_sheds_429"] = 429 in t_codes
        checks["sibling_unaffected_by_quota"] = all(c == 200
                                                    for c in c_codes)
        detail["quota"] = {c: t_codes.count(c) for c in set(t_codes)}
        stage("quota isolation")

        # eviction on the card
        for key in (A, T, C, B):
            reg.get_runtime(key)  # every tenant resident
        sizes = {k: reg.get_runtime(k).resident_bytes for k in (A, T, C, B)}
        for key in (B, T, C):
            reg.get_runtime(key)  # recency: beta/treatment the oldest
        ev1 = reg.set_memory_budget(sizes[A] + sizes[T]
                                    + max(sizes[C], sizes[B]) + 1)
        held = set(reg.resident_keys())
        reg.get_runtime(T)  # now beta/control is the oldest
        lru = min((r for k, r in reg._runtimes.items() if k != A),
                  key=lambda r: r.last_used).key
        n_ev = reg.evictions
        code, _ = q("beta", beta_users[1], "treatment")
        checks["budget_holds_anchor_foldin_and_one_beta"] = (
            ev1 == [B] and held == {A, T, C})
        checks["load_evicts_the_lru_non_anchor"] = (
            code == 200 and lru == C and reg.evictions == n_ev + 1
            and set(reg.resident_keys()) == {A, T, B})
        rt = reg.get_runtime(T)
        dev_bytes, accounted = _cuda_bytes(rt.models), rt.resident_bytes
        model_ref = weakref.ref(rt.models[0])
        del rt
        sizes[B] = reg.get_runtime(B).resident_bytes
        failures, stop = [], threading.Event()

        def background():
            k = 0
            while not stop.is_set():
                c = q("beta", beta_users[k % 8], "treatment")[0]
                k += 1
                if c != 200:
                    failures.append(c)

        bg = threading.Thread(target=background)
        bg.start()
        try:
            time.sleep(0.2)
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            ev2 = reg.set_memory_budget(sizes[A] + sizes[B] + 1)
            torch.cuda.synchronize()
            m1 = torch.cuda.memory_allocated()
            freed_at_once = model_ref() is None
            time.sleep(0.3)
        finally:
            stop.set()
            bg.join(timeout=60)
        checks["shrink_evicts_the_foldin_tenant"] = ev2 == [T]
        checks["eviction_zero_failed_requests"] = not failures
        checks["evicted_model_freed_without_gc"] = freed_at_once
        checks["cuda_memory_falls_by_90pct_of_device_bytes"] = (
            m0 - m1 >= 0.9 * dev_bytes > 0)
        reg.set_memory_budget(0)
        t0 = time.perf_counter()
        for user, want in foldin_out["replies"].items():
            code, got = q("ml20m", user, "treatment")
            if code != 200:
                raise AssertionError(f"reloaded fold-in tenant: {code}")
            _same_items(got, want, f"reloaded fold-in tenant, user {user}")
        reload_s = time.perf_counter() - t0
        rt = reg.get_runtime(T)
        checks["evicted_tenant_reloads_with_its_chain"] = (
            rt.foldin_deltas_applied == foldin_out["links"])
        del rt
        detail["eviction"] = {
            "residentBytes": {"/".join(k): b for k, b in sizes.items()},
            "evicted": ["/".join(k) for k in ev1 + ev2],
            "lru": "/".join(lru), "deviceBytes": dev_bytes,
            "accountedBytes": accounted, "allocatedBefore": m0,
            "allocatedAfter": m1, "freed": m0 - m1,
            "backgroundFailures": failures, "reloadAndQueriesSec": reload_s,
            "summary": reg.summary()}
        stage("eviction")

        # attribution and online eval on beta
        conversions = {"control": 5, "treatment": 3}
        for var, n in conversions.items():
            for k in range(n):
                code = _raw(ev.port, f"/events.json?accessKey={beta_key}", {
                    "event": "click", "entityType": "user",
                    "entityId": beta_users[k], "targetEntityType": "item",
                    "targetEntityId": item_id(1),
                    "properties": {"variant": var}})[0]
                if code != 201:
                    raise AssertionError(f"conversion write: {code}")

        def tagged():
            got = [e for e in es.find(beta_id, entity_type="pio_pr",
                                      limit=50)
                   if e.properties.to_json().get("variant")]
            return got if len(got) >= 5 else None

        fb = _wait_for(tagged, 30, "variant-tagged feedback events")

        def counted():
            snap = reg.refresh_online_eval(es)
            return snap if all(
                snap.get(f"beta/{var}", {}).get("conversions") == n
                for var, n in conversions.items()) else None

        snap = _wait_for(counted, 60, "beta's conversions in online eval",
                         0.0)
        checks["feedback_events_variant_tagged"] = {
            e.properties.to_json()["variant"] for e in fb} <= {
            "control", "treatment"}
        checks["online_eval_counts_conversions"] = (
            snap["beta/control"]["impressions"] > 0
            and 0.0 < snap["beta/control"]["rate"] <= 1.0)
        metrics = _raw(port, "/metrics")[1].decode()
        checks["metrics_export_variant_families"] = all(f in metrics for f in (
            'pio_variant_requests_total{app="beta"',
            'pio_variant_feedback_total{app="beta"',
            'pio_variant_outcome_rate{app="beta"',
            'pio_tenant_queries_total{app="ml20m"',
            "pio_tenant_resident_bytes",
            "pio_microbatch_tenants_per_batch_bucket"))

        def bucket(le):
            for ln in metrics.splitlines():
                if ln.startswith("pio_microbatch_tenants_per_batch_bucket"
                                 f'{{le="{le}"}}'):
                    return float(ln.rsplit(" ", 1)[1])
            return None

        checks["tenants_per_batch_histogram_mixed"] = (
            bucket("+Inf") or 0.0) > (bucket("1") or 0.0)
        view = read_manifest(runs_root() / reg.online.manifest_id)
        checks["tower_manifest_has_variants"] = bool(view and any(
            c.get("app") == "beta" and c.get("variant") and "rate" in c
            for c in view["candidates"]))
        dbg = _http(port, "/debug/tenants")
        checks["debug_tenants_mounted"] = (
            dbg["tenants"] == 4 and "experiments" in dbg
            and "onlineEval" in dbg and bool(dbg.get("deviceMemory")))
        detail["onlineEval"] = {k: c for k, c in snap.items()
                                if k.startswith("beta/")}
        stage("attribution")

        # the autopilot concludes beta's experiment through real POSTs
        for var in ("control", "treatment"):
            drive("beta", 80, var)
        imp = reg.online.snapshot()
        seed = {}
        batch_post_s: list[float] = []
        for var, rate in HIVE_PILOT_RATES.items():
            n = int(rate * imp[f"beta/{var}"]["impressions"]) - \
                conversions[var]
            seed[var] = n
            # batches of 50, as a client reports its conversions, beside
            # the deploy's single feedback writes into the same shards
            events = [{
                "event": "click", "entityType": "user",
                "entityId": beta_users[k % 8], "targetEntityType": "item",
                "targetEntityId": item_id(k % HIVE_ITEMS),
                "properties": {"variant": var}} for k in range(n)]
            for a in range(0, n, 50):
                t_post = time.perf_counter()
                code, raw, _ = _raw(
                    ev.port, f"/batch/events.json?accessKey={beta_key}",
                    events[a:a + 50])
                post_s = time.perf_counter() - t_post
                statuses = ([r["status"] for r in json.loads(raw)]
                            if code == 200 else [])
                batch_post_s.append(post_s)
                if statuses != [201] * len(events[a:a + 50]):
                    raise AssertionError(
                        f"seeding conversions: {code} {raw[:300]!r}")
        applies = []

        def apply_over_http(app, w):
            code, raw, _ = _raw(port, "/tenants/weights",
                                {"app": app, "weights": w})
            applies.append({"app": app, "weights": dict(w),
                            "status": code})
            if code != 200:
                raise RuntimeError(f"weights POST answered {code}")
            return json.loads(raw)

        cfg = AutopilotConfig(**HIVE_PILOT)
        pilot = reg.enable_autopilot(
            config=cfg, apply_weights=apply_over_http,
            manifest_id=f"hive-pilot-{os.getpid()}")
        concluded = _wait_for(lambda: pilot.payload()["apps"].get(
            "beta", {}).get("state") == STATE_CONCLUDED, 60,
            "the autopilot to conclude beta's experiment", 0.1)
        trail = [0.5] + [a["weights"]["treatment"] for a in applies
                         if a["app"] == "beta"]
        served = _http(port, "/debug/tenants")["experiments"]["beta"][
            "weights"]
        last = [a for a in applies if a["app"] == "beta"][-1]["weights"]
        checks["sprt_concludes_experiment"] = concluded
        checks["ramp_steps_bounded"] = all(
            abs(b - a) <= cfg.max_step + 1e-6
            for a, b in zip(trail, trail[1:]))
        checks["loser_on_min_weight_floor"] = (
            abs(served["control"] - cfg.min_weight) < 1e-6)
        checks["weights_applied_via_http"] = (
            len(trail) >= 4 and served == last
            and all(a["status"] == 200 for a in applies))
        exp = _http(port, "/debug/experiments")
        checks["debug_experiments_mounted"] = (
            exp["enabled"] is True
            and exp["apps"]["beta"]["stateName"] == "concluded")
        decisions = [e for e in read_manifest(
            runs_root() / pilot.manifest_id)["events"]
            if e.get("event") == "decision" and e.get("app") == "beta"]
        checks["tower_manifest_decisions"] = (
            sum(e["decision"] == "ramp" for e in decisions)
            == len(trail) - 1 and any(e["decision"] == "conclude"
                                      for e in decisions))
        # the sharded store's batch and single writers no longer stall
        # each other for its 10 s busy timeout
        checks["batch_conversions_never_stall"] = max(batch_post_s) < 1.0
        detail["autopilot"] = {"seededConversions": seed,
                               "batchPostSec": [round(x, 4)
                                                for x in batch_post_s],
                               "treatmentTrail": trail, "ticks":
                               pilot.payload()["ticks"],
                               "last": exp["apps"]["beta"]["last"]}
        stage("autopilot")
    finally:
        faults.disarm()
        srv.stop()
        ev.stop()

    # the console: one deploy --multi process on the card
    budget = sizes[A] + sizes[T] + max(sizes[C], sizes[B]) + 1
    proc = Console(store.home, [
        "deploy", "--multi", str(manifest), "--memory-budget", str(budget),
        "--autopilot", "on", "--ip", "127.0.0.1", "--port", "0"],
        "hive-deploy")
    try:
        cport = proc.wait_port()
        try:
            codes = [_raw(cport, "/queries.json", {
                "app": a, "variant": var, "user": beta_users[0] if a == "beta"
                else ml_users[0], "num": 10})[0] for a, var in (A, T, C, B)]
            dbg_code, dbg_raw, _ = _raw(cport, "/debug/tenants")
            exp_code, exp_raw, _ = _raw(cport, "/debug/experiments")
        except Exception as e:
            proc.fail(f"failed its queries: {e!r}")
        boot_s = proc.boot_s
        if "Undeployed" not in cli(["undeploy", "--port", str(cport)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
    finally:
        proc.stop()
    cdbg = json.loads(dbg_raw)
    checks["console_multi_serves_every_tenant"] = codes == [200] * 4
    checks["console_debug_routes_answer"] = (
        dbg_code == exp_code == 200 and cdbg["tenants"] == 4
        and cdbg["memoryBudgetBytes"] == budget
        and json.loads(exp_raw)["enabled"] is True)
    checks["console_undeploy_exits_0"] = rc == 0
    detail["console"] = {"bootSec": boot_s, "resident": cdbg["resident"],
                         "evictions": cdbg["evictions"]}
    stage("console")
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_its_limit"] = phase_s <= HIVE_PHASE_LIMIT_S
    detail.update(stages=stages, phase_s=phase_s)
    obs_report("hive", checks, detail)
    trains = {k: round(x, 2) for k, x in train_s.items()}
    log(f"phase hive ML-20M + ML-100K: beta import {import_s:.2f} s "
        f"({mib:.1f} MiB), trains {trains} s; "
        f"stages {stages} s; evicted ml20m/treatment: allocated "
        f"{m0:,} -> {m1:,} B (freed {m0 - m1:,} B of its {dev_bytes:,} B "
        f"on the card, {accounted:,} B accounted); autopilot trail "
        f"{trail}; launches {launches}; phase {phase_s:.1f} s")
    return {"launches": launches, "phase_s": phase_s,
            "manifest": str(manifest), "tenants": [A, T, C, B]}


ADMIN_PHASE_LIMIT_S = 30.0
ADMIN_PAGES = ("/", "/metrics.html", "/xray.html", "/pulse.html",
               "/train.html", "/tenants.html", "/fleet.html")


@contextlib.contextmanager
def serving_instances(cls, sink: list):
    """While the block runs, every ``cls`` server that starts serving is
    appended to ``sink`` (a console command's server, to stop it)."""
    own = cls.__dict__.get("serve_forever")
    orig = cls.serve_forever

    def kept(self):
        sink.append(self)
        return orig(self)

    cls.serve_forever = kept
    try:
        yield sink
    finally:
        if own is None:
            del cls.serve_forever
        else:
            cls.serve_forever = own


def _console_server(cls, argv: list, storage, sink: list):
    """``cli(argv)`` (a server command) on a daemon thread; returns the
    thread once the server is up and answers its port."""
    thread = threading.Thread(target=cli, args=(argv, storage), daemon=True)
    n = len(sink)
    thread.start()
    port = int(argv[argv.index("--port") + 1])
    deadline = time.monotonic() + 30
    while True:
        try:
            if len(sink) > n and _raw(port, "/metrics")[0] in (200, 404):
                return thread
        except OSError:
            pass
        if not thread.is_alive() or time.monotonic() > deadline:
            raise AssertionError(f"{argv} did not start serving")
        time.sleep(0.05)


def phase_admin(torch, store: StoreHome, hive_out: dict) -> dict:
    """Phase admin: the admin API and the dashboard, each served through
    the console (``adminserver`` / ``dashboard``) on a thread of this
    process.  A ``deploy --multi`` process (phase hive's tenants.json,
    the autopilot on) boots meanwhile.  The admin server runs over a
    scratch ``jsonfs`` metadata store: an app created (201, with its
    access key), listed, a second key added through ``accesskey new``
    and listed, a duplicate and a nameless app refused (400), its data
    and the app deleted (200), a second delete answered 404.  The
    dashboard runs over the ML-20M store while the deploy serves
    queries: every page answers 200; ``events.html`` lists the ML-20M
    app's newest events; ``tenants.html`` shows phase hive's four
    tenants; ``experiments.html?server=`` shows the live deploy's
    autopilot rows; ``prof.html?target=`` renders the deploy's folded
    stacks; the deploy's ``/debug/profile`` capture names a CUDA kernel,
    and the deploy exits 0 at its ``undeploy``; an unknown path answers
    404.  No kernel lies on this path; the phase fails past
    :data:`ADMIN_PHASE_LIMIT_S`."""
    from pathlib import Path

    from predictionio_tpu_torch.server import AdminServer, DashboardServer
    from predictionio_tpu_torch.storage import Storage

    t_phase = time.perf_counter()
    stages = {}

    def stage(name: str, t0: float) -> float:
        now = time.perf_counter()
        stages[name] = round(now - t0, 2)
        return now

    home = Path(store.home)
    st = store.storage
    checks, servers = {}, []
    proc = Console(store.home, [
        "deploy", "--multi", hive_out["manifest"], "--autopilot", "on",
        "--ip", "127.0.0.1", "--port", "0"], "admin-deploy")
    try:
        # the admin API over a jsonfs metadata store, while it boots
        t0 = time.perf_counter()
        tree = home / "admin-jsonfs"
        ast = Storage({
            "PIO_TPU_HOME": str(home / "admin-home"),
            "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FS",
            "PIO_STORAGE_SOURCES_FS_TYPE": "jsonfs",
            "PIO_STORAGE_SOURCES_FS_PATH": str(tree),
        })
        aport = _free_port()
        codes = []

        def call(method, path, body=None):
            import urllib.request

            data = None if body is None else json.dumps(body).encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{aport}{path}", data=data, method=method,
                headers={"Content-Type": "application/json"})
            try:
                with urllib.request.urlopen(req, timeout=30) as r:
                    code, raw = r.status, r.read()
            except urllib.error.HTTPError as e:
                code, raw = e.code, e.read()
            codes.append(code)
            return json.loads(raw)

        try:
            with serving_instances(AdminServer, servers):
                _console_server(AdminServer,
                                ["adminserver", "--port", str(aport)],
                                ast, servers)
            created = call("POST", "/cmd/app", {"name": "adminapp"})
            listed = call("GET", "/cmd/app")
            cli(["accesskey", "new", "adminapp"], ast)
            keys = call("GET", "/cmd/app")[0]["accessKeys"]
            call("POST", "/cmd/app", {"name": "adminapp"})
            call("POST", "/cmd/app", {})
            call("DELETE", "/cmd/app/adminapp/data")
            call("DELETE", "/cmd/app/adminapp")
            call("DELETE", "/cmd/app/adminapp")
            left = call("GET", "/cmd/app")
            docs = sorted(p.relative_to(tree).as_posix()
                          for p in tree.rglob("*.json"))
        finally:
            for s in servers:
                s.stop()
            servers.clear()
            ast.close()
        checks["admin_status_codes"] = codes == [201, 200, 200, 400, 400,
                                                 200, 200, 404, 200]
        checks["admin_app_and_keys_listed"] = (
            [a["name"] for a in listed] == ["adminapp"]
            and listed[0]["accessKeys"] == [created["accessKey"]]
            and len(keys) == 2 and created["accessKey"] in keys
            and left == [])
        checks["admin_rides_jsonfs"] = (
            (tree / "_seq" / "apps").read_text() == "1")
        t0 = stage("admin", t0)

        # the dashboard over the ML-20M store, beside the live deploy
        app_id = st.get_metadata().app_get_by_name("ml20m").id
        port = proc.wait_port()
        t0 = stage("deploy boot (beyond admin)", t0)
        dport = _free_port()
        stop = threading.Event()

        def pepper():
            k = 0
            while not stop.is_set():
                _raw(port, "/queries.json", {
                    "app": "ml20m", "user": user_id(k % 1000), "num": 10})
                k += 1

        load = threading.Thread(target=pepper, daemon=True)
        load.start()
        try:
            with serving_instances(DashboardServer, servers):
                _console_server(DashboardServer,
                                ["dashboard", "--port", str(dport)], st,
                                servers)
            # the autopilot's first tick fills its apps (every 0.5 s)
            _wait_for(lambda: json.loads(_raw(port, "/debug/experiments")[1])
                      .get("apps"), 10, "the deploy's autopilot apps")
            pages = {p: _raw(dport, p) for p in ADMIN_PAGES}
            events = _raw(dport, f"/events.html?app={app_id}&n=50")
            exp = _raw(dport, "/experiments.html?server=" + urllib.parse.quote(
                f"http://127.0.0.1:{port}"))
            prof = _raw(dport, "/prof.html?seconds=30&target="
                        + urllib.parse.quote(f"http://127.0.0.1:{port}"))
            missing = _raw(dport, "/no/such/page")
            t0 = stage("pages", t0)
            capture_code, capture, _ = _raw(port, "/debug/profile?seconds=1")
            t0 = stage("capture", t0)
        finally:
            stop.set()
            load.join(timeout=60)
            for s in servers:
                s.stop()
        if "Undeployed" not in cli(["undeploy", "--port", str(port)], st):
            proc.fail("was not undeployed")
        try:
            rc = proc.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.fail("did not stop after undeploy")
        stage("undeploy", t0)
        boot_s = proc.boot_s
    finally:
        proc.stop()
    text = {p: b.decode(errors="replace") for p, (c, b, _) in pages.items()}
    ev_html = events[1].decode(errors="replace")
    exp_html = exp[1].decode(errors="replace")
    kernels = (json.loads(capture).get("cudaKernels", [])
               if capture_code == 200 else [])
    tenants = [f"{a}/{v}" for a, v in hive_out["tenants"]]
    checks["dashboard_pages_answer_200"] = all(
        c == 200 for c, _, _ in pages.values()) and all(
        x[0] == 200 for x in (events, exp, prof))
    # the app's newest 50 events (the first shard's: later phases' fold-in
    # ratings and feedback events)
    ev_rows = re.findall(r"<tr><td>[^<]*</td><td>([^<]*)</td><td>([^/<]*)/",
                         ev_html)
    checks["dashboard_events_of_the_ml20m_app"] = (
        len(ev_rows) == 50 and f"app {app_id}" in ev_html)
    checks["dashboard_tenants_rows"] = all(t in text["/tenants.html"]
                                           for t in tenants)
    checks["dashboard_experiments_of_the_live_deploy"] = (
        "source: http://127.0.0.1:" in exp_html
        and all(f"<td>{a}</td>" in exp_html
                for a in {a for a, _ in hive_out["tenants"]}))
    checks["dashboard_prof_renders_the_deploy"] = (
        f"127.0.0.1:{port}" in prof[1].decode(errors="replace"))
    checks["deploy_capture_names_a_cuda_kernel"] = bool(kernels)
    checks["deploy_undeploy_exits_0"] = rc == 0
    checks["dashboard_unknown_path_404"] = missing[0] == 404
    phase_s = time.perf_counter() - t_phase
    checks["phase_within_its_limit"] = phase_s <= ADMIN_PHASE_LIMIT_S
    obs_report("admin", checks, {
        "admin": {"codes": codes, "documents_left": docs},
        "deploy_boot_s": round(boot_s, 1), "app_id": app_id,
        "events_page": sorted({f"{e} {t}" for e, t in ev_rows}),
        "kernels": len(kernels), "stages": stages,
        "page_bytes": {p: len(t) for p, t in text.items()},
        "phase_s": round(phase_s, 1)})
    return {"s": phase_s}


EXAMPLES_PHASE_LIMIT_S = 40.0
# sharded-scale's mesh on the card: shards of cuda:0 (on the host the
# tests give it 8, the reference's virtual devices)
EXAMPLE_SHARDS = 4
# card against host, over each answer's scale (ids equal outside ties):
# the ALS examples 1e-4 (f32 solves in another order, as the parity
# tests), the dense products 1e-5, the mesh's normal equations 1e-4
EXAMPLE_ALS_TOL = 1e-4
EXAMPLE_DENSE_TOL = 1e-5
EXAMPLE_MEMORY = {
    "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
    "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEMDB",
    "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    "PIO_STORAGE_SOURCES_MEMDB_TYPE": "memory",
}


@contextlib.contextmanager
def example_module(name: str):
    """``examples/<name>/engine_torch.py`` imported under a name of its
    own, with the example's directory as the working directory (its data
    files resolve there) until the block ends."""
    import importlib.util
    from pathlib import Path

    d = Path(__file__).resolve().parent / "examples" / name
    mod_name = "example_" + name.replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name,
                                                  d / "engine_torch.py")
    mod = importlib.util.module_from_spec(spec)
    old = os.getcwd()
    os.chdir(d)
    sys.modules[mod_name] = mod
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        os.chdir(old)
        sys.modules.pop(mod_name, None)


def example_ctx(device, **kw):
    """A port context on ``device`` over a memory store of its own."""
    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.storage import Storage

    return WorkflowContext(device=device, storage=Storage(EXAMPLE_MEMORY),
                           **kw)


def example_train(m, ctx, variant: dict = None):
    """``(engine, params, models, first algorithm)`` of a counterpart
    trained on its ``engine_torch.json`` (or ``variant``)."""
    engine = m.engine_factory()
    if variant is None:
        with open("engine_torch.json") as f:
            variant = json.load(f)
    ep = engine.params_from_variant(variant)
    models = engine.train(ctx, ep)
    return engine, ep, models, engine._algorithms(ep)[0]


def _ranked(scores, key: str = "item") -> list:
    return [[getattr(s, key), float(s.score)] for s in scores]


def _same_answers(got, want, tol: float) -> bool:
    """Card against host: ``[id, score]`` rankings equal outside ties
    (scores within ``tol`` of the ranking's scale), floats within ``tol``
    of the scale of the list they are in, anything else equal."""
    if isinstance(want, dict):
        return got.keys() == want.keys() and all(
            _same_answers(got[k], want[k], tol) for k in want)
    if isinstance(want, list) and want and all(
            isinstance(w, list) and len(w) == 2 and isinstance(w[0], str)
            for w in want):
        if len(got) != len(want):
            return False
        scale = max(abs(s) for _, s in want) or 1.0
        scores = dict(want)
        return all(abs(gs - ws) <= tol * scale and (
            gi == wi or abs(scores.get(gi, want[-1][1]) - ws) <= tol * scale)
            for (gi, gs), (wi, ws) in zip(got, want))
    if isinstance(want, list):
        flat = np.asarray([w for w in want if isinstance(w, float)])
        scale = float(np.abs(flat).max()) if flat.size else 1.0
        return len(got) == len(want) and all(
            abs(g - w) <= tol * max(scale, 1e-30)
            if isinstance(w, float) else _same_answers(g, w, tol)
            for g, w in zip(got, want))
    if isinstance(want, float):
        return abs(got - want) <= tol * max(abs(want), 1e-30)
    return got == want


def ex_helloworld(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    t = algo.predict(models[0], m.Query(day="Mon")).temperature
    return {"Mon": t}, {"mon_mean": abs(t - (75 + 62) / 2) < 1e-9}


def ex_friendrec(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    pairs = [(u, i) for u in ("alice", "bob", "carol", "nobody")
             for i in ("jazz-club", "trail-group")]
    batch = algo.batch_predict(models[0], [m.Query(*p) for p in pairs])
    singles = [algo.predict(models[0], m.Query(*p)) for p in pairs]
    got = {p: (s.confidence, s.acceptance) for p, s in zip(pairs, singles)}
    return [[b.confidence, b.acceptance] for b in batch], {
        "alice_jazz_accepted": got["alice", "jazz-club"] == (2.0, True),
        "carol_jazz_rejected": got["carol", "jazz-club"] == (0.0, False),
        "nobody_rejected": got["nobody", "jazz-club"] == (0.0, False),
        "batch_equals_singles": all(
            abs(b.confidence - s.confidence) <= 1e-6 * max(
                abs(s.confidence), 1e-6) and b.acceptance == s.acceptance
            for b, s in zip(batch, singles))}


def ex_markovchain(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    ranked = [[s, float(p)] for s, p in
              algo.predict(models[0], m.Query(state="search"))]
    return ranked, {"search_then_product": bool(ranked)
                    and ranked[0][0] == "product"}


def ex_dimsum(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    res = _ranked(algo.predict(models[0], m.Query(items=("i1",), num=2)))
    res34 = _ranked(algo.predict(models[0], m.Query(items=("i3",), num=2)))
    return {"i1": res, "i3": res34}, {
        "i1_to_i2": bool(res) and res[0][0] == "i2",
        "i3_to_i4": bool(res34) and res34[0][0] == "i4",
        "never_itself": all(i != "i1" for i, _ in res)}


def ex_stock(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    preds = {t: algo.predict(models[0], m.Query(ticker=t))
             for t in ("UPCO", "DNCO", "FLAT", "NOPE")}
    return {"signals": [p.signal for p in preds.values()],
            "returns": [p.expected_return for p in preds.values()]}, {
        "signals": [p.signal for p in preds.values()] == [
            "long", "short", "flat", "flat"]}


def ex_regression(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    pred = algo.predict(models[0], m.Query(features=[2.0, 3.0]))
    return [float(x) for x in models[0]] + [pred], {
        "y_is_1_plus_x1_plus_x2": abs(pred - 6.0) <= 0.05}


def ex_parallel_regression(m, dev):
    from predictionio_tpu_torch.parallel import make_mesh

    ctx = example_ctx(dev, mesh=make_mesh(devices=[dev] * EXAMPLE_SHARDS))
    _, _, models, algo = example_train(m, ctx)
    w = [float(x) for x in models[0]]
    pred = algo.predict(models[0], m.Query(features=[1.0, 2.0]))
    return w + [pred], {
        "mesh_recovers_the_plane": abs(pred - (1 + 2 * 1.0 - 0.5 * 2.0))
        <= 0.05
        and all(abs(a - b) <= 0.05 for a, b in zip(w, (1.0, 2.0, -0.5)))}


def ex_custom_datasource(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    users = sorted(models[0].users.ids)
    got = {u: _ranked(algo.predict(models[0], m.Query(user=u, num=3)))
           for u in users}
    return got, {
        "u0_top_even": bool(got["u0"]) and int(got["u0"][0][0][1:]) % 2 == 0,
        "ghost_empty": algo.predict(models[0], m.Query(user="ghost",
                                                       num=3)) == []}


def ex_entitymap(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    model = models[0]
    got = {u: _ranked(algo.predict(model, m.Query(user=u, num=3)))
           for u in sorted(model.users.keys())}
    r = algo.predict(model, m.Query(user="u0", num=3))
    scores = [s.score for s in r]
    return got, {
        "required_attrs_filter": "u6" not in model.users
        and len(model.users) == 6 and "i5" not in model.items
        and len(model.items) == 5,
        "typed_payloads": model.users["u2"] == m.User(
            attr0=3.5, attr1=2, attr2=12)
        and model.items["i1"].attrA == "green"
        and isinstance(model.items["i0"].attrC, bool),
        "u0_three_payloads_sorted": len(r) == 3 and all(
            isinstance(s.payload, m.Item) for s in r)
        and scores == sorted(scores, reverse=True),
        "nobody_empty": algo.predict(model, m.Query(user="nobody")) == []}


def ex_movielens_filtering(m, dev):
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.controller import instantiate

    _, _, models, algo = example_train(m, example_ctx(dev))
    with tempfile.TemporaryDirectory() as tmp:
        blocked = Path(tmp) / "blocked.txt"
        blocked.write_text(Path("blocked.txt").read_text())
        serving = instantiate(m.BlocklistServing,
                              m.FilterParams(filepath=str(blocked)))

        def recommend(user, num=4):
            q = m.Query(user=user, num=num)
            return _ranked(serving.serve(
                q, [algo.predict(models[0], q)]).item_scores)

        got = {u: recommend(u) for u in sorted(models[0].users.ids)}
        items = [i for i, _ in got["u0"]]
        blocked.write_text("")
        reread = "m0" in [i for i, _ in recommend("u0", 10)]
    return got, {"four_unblocked": len(items) == 4 and "m0" not in items
                 and "m7" not in items,
                 "blocklist_read_per_request": reread}


def ex_similarproduct_local(m, dev):
    from predictionio_tpu_torch.controller import ModelPlacement

    _, _, models, algo = example_train(m, example_ctx(dev))
    r = _ranked(algo.predict(models[0], m.Query(items=("phone",), num=3)))
    got = [i for i, _ in r]
    return r, {
        "host_model": algo.placement is ModelPlacement.HOST
        and isinstance(models[0].item_factors, np.ndarray),
        "electronics_not_phone": len(r) == 3 and "phone" not in got
        and set(got[:2]) <= {"laptop", "tablet", "camera"},
        "unseen_empty": algo.predict(models[0], m.Query(
            items=("nothere",))) == []}


def ex_recommendation_cat(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    dramas = {"m2", "m3", "m6", "m7"}
    qs = {"all": dict(user="u0", num=5),
          "drama": dict(user="u0", num=3, categories=("drama",)),
          "drama_no_m2": dict(user="u0", num=3, categories=("drama",),
                              blacklist=("m2",))}
    got = {k: _ranked(algo.predict(models[0], m.Query(**q)).item_scores)
           for k, q in qs.items()}
    return got, {
        "five_unfiltered": len(got["all"]) == 5,
        "dramas_only": bool(got["drama"])
        and {i for i, _ in got["drama"]} <= dramas,
        "categories_with_blacklist": {i for i, _ in got["drama_no_m2"]}
        <= dramas - {"m2"}}


def ex_similarproduct_multi(m, dev):
    engine, ep, models, _ = example_train(m, example_ctx(dev))
    algos, serving = engine._algorithms(ep), engine._serving(ep)

    def serve(num):
        q = m.Query(items=("phone",), num=num)
        preds = [a.predict(mod, q) for a, mod in zip(algos, models)]
        return preds, serving.serve(q, preds)

    preds, r = serve(3)
    got = [s.item for s in r.item_scores]
    # the z-score blend magnifies the scores' last digits: the card is
    # held to the host on each algorithm's answer
    return [_ranked(p.item_scores) for p in preds], {
        "two_algorithms": len(algos) == 2 and len(models) == 2,
        "blend_prefers_electronics": len(got) == 3 and "phone" not in got
        and got[0] in {"laptop", "tablet", "camera"},
        "z_scores": all(abs(s.score) < 10 for s in r.item_scores),
        "single_item_query": len(serve(1)[1].item_scores) == 1}


def ex_trim_app(m, dev):
    import datetime as dt

    from predictionio_tpu_torch.storage.event import DataMap, Event

    ctx = example_ctx(dev)
    es = ctx.storage.get_event_store()
    for day in (1, 2, 3, 4, 5):
        es.insert(Event(event="rate", entity_type="user",
                        entity_id=f"u{day}", target_entity_type="item",
                        target_entity_id="i1",
                        properties=DataMap({"rating": 3.0}),
                        event_time=dt.datetime(2020, 1, day,
                                               tzinfo=dt.timezone.utc)),
                  app_id=1)
    engine, ep, models, _ = example_train(m, ctx)
    got = sorted(e.entity_id for e in es.find(app_id=2))
    src_ids = {e.event_id for e in es.find(app_id=1)}
    try:
        engine.train(ctx, ep)
        refused = False
    except RuntimeError as e:
        refused = "not empty" in str(e)
    return [models[0].copied, got], {
        "window_copied": models[0].copied == 2 and got == ["u2", "u3"],
        "event_ids_kept": {e.event_id for e in es.find(app_id=2)}
        <= src_ids,
        "refuses_a_full_destination": refused}


def ex_simrank(m, dev):
    _, _, models, algo = example_train(m, example_ctx(dev))
    model = models[0]
    S = model.scores
    got = {"S": [float(x) for x in S.ravel()]}
    for user in ("0", "4"):
        got[user] = _ranked(algo.predict(model, m.Query(user=user, num=3)),
                            "user")
    checks = {
        "structure": bool(np.allclose(np.diag(S), 1.0)
                          and np.allclose(S, S.T, atol=1e-5)),
        "0_and_4_each_others_top": bool(got["0"]) and got["0"][0][0] == "4"
        and bool(got["4"]) and got["4"][0][0] == "0",
        "unknown_empty": algo.predict(model, m.Query(user="nope",
                                                     num=3)) == []}
    for name in ("node", "forestfire"):
        sub = example_train(m, example_ctx(dev), {
            "datasource": {"name": name, "params": {
                "graph_edgelist_path": "edge_list_small.txt",
                "sample_fraction": 0.6}},
            "algorithms": [{"name": "simrank",
                            "params": {"num_iterations": 3}}]})[2][0]
        got[name] = [float(x) for x in sub.scores.ravel()]
        checks[f"{name}_subgraph"] = bool(
            2 <= len(sub.vertices) < 10
            and np.allclose(np.diag(sub.scores), 1.0))
    return got, checks


def ex_movielens_eval(m, dev):
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.workflow import run_evaluation

    data = str(Path("ratings.csv").resolve())
    candidates = [type(ep)(data_source=("", type(ep.data_source[1])(
        path=data)), algorithms=ep.algorithms)
        for ep in m.engine_params_list()]
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)  # best.json
        try:
            _, result = run_evaluation(m.evaluation_factory(), candidates,
                                       ctx=example_ctx(dev,
                                                       mode="Evaluation"))
        finally:
            os.chdir(old)
    scores = [float(s) for _, s, _ in result.results]
    return scores, {
        "mse_header": result.metric_header == "MSE",
        "finite": all(s == s for s in scores),
        "rank_6_wins": result.best_engine_params.algorithms[0][1].rank == 6
        and result.best_score == min(scores)}


def ex_lambda_sweep(m, dev):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        m.main(["--device", str(dev)])
    text = out.getvalue()
    table = {ln.split()[0]: [float(x) for x in ln.split()[1:]]
             for ln in text.splitlines()[1:] if len(ln.split()) == 3}
    best = float(text.rsplit("best lambda = ", 1)[1].split()[0])
    return table, {"every_row": all(f"{lam:>8}" in text
                                    for lam in m.LAMBDAS),
                   "interior_winner": best in (0.05, 0.1)}


# the counterparts in the order of ROADMAP Queue 1 item 10 (sharded-scale
# is held by phase examples itself)
EXAMPLE_DRIVES = {
    "helloworld": (ex_helloworld, EXAMPLE_DENSE_TOL),
    "friendrec": (ex_friendrec, EXAMPLE_DENSE_TOL),
    "markovchain": (ex_markovchain, EXAMPLE_DENSE_TOL),
    "lambda-sweep": (ex_lambda_sweep, EXAMPLE_ALS_TOL),
    "movielens-eval": (ex_movielens_eval, EXAMPLE_ALS_TOL),
    "recommendation-cat": (ex_recommendation_cat, EXAMPLE_ALS_TOL),
    "similarproduct-local": (ex_similarproduct_local, EXAMPLE_ALS_TOL),
    "trim-app": (ex_trim_app, EXAMPLE_DENSE_TOL),
    "custom-datasource": (ex_custom_datasource, EXAMPLE_ALS_TOL),
    "entitymap": (ex_entitymap, EXAMPLE_ALS_TOL),
    "movielens-filtering": (ex_movielens_filtering, EXAMPLE_ALS_TOL),
    "similarproduct-multi": (ex_similarproduct_multi, EXAMPLE_ALS_TOL),
    "dimsum": (ex_dimsum, EXAMPLE_DENSE_TOL),
    "simrank": (ex_simrank, EXAMPLE_DENSE_TOL),
    "regression": (ex_regression, EXAMPLE_DENSE_TOL),
    "stock": (ex_stock, EXAMPLE_DENSE_TOL),
    "parallel-regression": (ex_parallel_regression, EXAMPLE_ALS_TOL),
}


def movielens_eval_main(dev) -> bool:
    """movielens-eval's ``main(["--device", "cuda:0"])`` in this process,
    in a scratch copy of the example's directory with a store of its own
    in a scratch ``$PIO_TPU_HOME`` as the registry's: its one-line result
    and its ``best.json``, as its reference test reads them.
    (lambda-sweep's drive and sharded-scale's are their mains.)"""
    import shutil
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.storage import Storage, reset_storage

    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp) / "movielens-eval"
        reset_storage(Storage({"PIO_TPU_HOME": str(Path(tmp) / "home")}))
        out = io.StringIO()
        try:
            with example_module("movielens-eval") as m:
                # a copy of the example's directory, as a user runs it
                shutil.copytree(os.getcwd(), work)
                os.chdir(work)
                with contextlib.redirect_stdout(out):
                    m.main(["--device", str(dev)])
        finally:
            os.chdir(old)
            reset_storage(None)
        line = out.getvalue().strip().splitlines()[-1]
        return bool(re.fullmatch(r"\[\d+\.\d+\] MSE", line)) and (
            work / "best.json").is_file()


def example_launchers() -> dict:
    """``bin/pio-tpu-torch-start-all`` against a scratch
    ``$PIO_TPU_HOME`` on free ports: each server answers ``GET /`` with
    200 and none holds the card (``nvidia-smi --query-compute-apps``,
    the check of phase fleet); ``bin/pio-tpu-torch-stop-all`` leaves
    none running and a pid file of the reference's ``run/`` (and its
    process) untouched."""
    import tempfile
    from pathlib import Path

    bin_dir = Path(__file__).resolve().parent / "bin"
    checks, detail = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        home = Path(tmp) / "home"
        run = home / "run"
        run.mkdir(parents=True)
        ports = {k: _free_port()
                 for k in ("EVENTSERVER", "ADMINSERVER", "DASHBOARD")}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("PIO_STORAGE_", "PIO_TPU_"))}
        env.update(PIO_TPU_HOME=str(home),
                   PIO_TPU_EVENTSERVER_IP="127.0.0.1",
                   **{f"PIO_TPU_{k}_PORT": str(p) for k, p in ports.items()})
        bystander = subprocess.Popen(["sleep", "300"])
        (run / "eventserver.pid").write_text(f"{bystander.pid}\n")
        pids = []
        t0 = time.perf_counter()
        try:
            subprocess.run([str(bin_dir / "pio-tpu-torch-start-all")],
                           env=env, check=True, capture_output=True,
                           timeout=60)
            pids = [int(p.read_text()) for p in
                    sorted((run / "torch").glob("*.pid"))]
            codes = {}
            for name, port in ports.items():
                def up(port=port):
                    try:
                        with urllib.request.urlopen(
                                f"http://127.0.0.1:{port}/", timeout=5) as r:
                            return r.status
                    except OSError:
                        return None

                codes[name] = _wait_for(up, 60, f"{name} of start-all", 0.1)
            detail["up_s"] = round(time.perf_counter() - t0, 1)
            checks["three_servers_answer"] = len(pids) == 3 and all(
                c == 200 for c in codes.values())
            gpu_pids = subprocess.run(
                ["nvidia-smi", "--query-compute-apps=pid",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.split()
            checks["none_holds_the_card"] = not (
                {str(p) for p in pids} & set(gpu_pids))
            subprocess.run([str(bin_dir / "pio-tpu-torch-stop-all")],
                           env=env, check=True, capture_output=True,
                           timeout=60)
            deadline = time.monotonic() + 30
            while any(_pid_alive(p) for p in pids) and \
                    time.monotonic() < deadline:
                time.sleep(0.1)
            checks["stop_all_stops_them"] = not any(
                _pid_alive(p) for p in pids) and not list(
                (run / "torch").glob("*.pid"))
            checks["reference_pid_file_untouched"] = (
                (run / "eventserver.pid").read_text() == f"{bystander.pid}\n"
                and bystander.poll() is None)
        finally:
            for p in pids:
                with contextlib.suppress(ProcessLookupError):
                    os.kill(p, 9)
            bystander.kill()
            bystander.wait()
    detail["s"] = round(time.perf_counter() - t0, 1)
    return {"checks": checks, "detail": detail}


def phase_examples(torch, profcat: dict) -> dict:
    """Phase examples: the port's 18 example engines
    (``examples/*/engine_torch.py``), their mains and the ``bin/``
    launchers, in this process.

    Each counterpart trains and answers the queries of
    ``tests/test_examples.py`` on ``cuda:0`` and again with
    ``device="cpu"`` (its plain versions): every answer on the card must
    equal the host's within the example's tolerance (ids equal outside
    ties), and every assertion of the reference's test must hold on the
    card's answers.  sharded-scale trains on a mesh of
    :data:`EXAMPLE_SHARDS` shards of ``cuda:0`` (``solver="fused"``): each
    shard must launch the fused kernel (``models.als.SHARD_LAUNCHES``),
    its sharded factors must be within 1e-4 of the factors' scale of the
    same run on host shards from the same initial factors, and the
    example's own replicated-against-sharded assertion must hold.  Then
    movielens-eval's main (:func:`movielens_eval_main`) and the launchers
    (:func:`example_launchers`).  ``profcat`` holds phase router's fleet
    profile, printed here.  The launch counts are set to 0 just before
    the card runs and read after them."""
    from predictionio_tpu_torch.models.als import SHARD_LAUNCHES
    from predictionio_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    out, card_s = {}, 0.0
    _build.reset_launches()
    SHARD_LAUNCHES.clear()
    for name, (drive, tol) in EXAMPLE_DRIVES.items():
        t0 = time.perf_counter()
        with example_module(name) as m:
            got, checks = drive(m, dev)
            torch.cuda.synchronize()
            card = time.perf_counter() - t0
            want, _ = drive(m, "cpu")
        checks["card_equals_host"] = _same_answers(got, want, tol)
        card_s += card
        out[name] = {"s": round(time.perf_counter() - t0, 2),
                     "card_s": round(card, 2), "tol": tol, "checks": checks}
    t0 = time.perf_counter()
    text = io.StringIO()
    shards = ["--shards", str(EXAMPLE_SHARDS), "--device"]
    with example_module("sharded-scale") as m, \
            contextlib.redirect_stdout(text):
        f_rep, f_sh = m.main([*shards, str(dev)])
        torch.cuda.synchronize()
        card = time.perf_counter() - t0
        per_shard = {f"{k}@{s}": n
                     for (s, k), n in sorted(SHARD_LAUNCHES.items())}
        shards_fused = all(SHARD_LAUNCHES[(s, "fused_als")]
                           + SHARD_LAUNCHES[(s, "fused_als_dma")] > 0
                           for s in range(EXAMPLE_SHARDS))
        _, h_sh = m.main([*shards, "cpu"])
    printed = text.getvalue()
    stored = re.search(r"each device stores ([\d,]+)", printed)
    sh_err = [scale_err(torch, torch.as_tensor(a), torch.as_tensor(b))
              for a, b in ((f_sh.user_factors, h_sh.user_factors),
                           (f_sh.item_factors, h_sh.item_factors))]
    out["sharded-scale"] = {
        "s": round(time.perf_counter() - t0, 2), "card_s": round(card, 2),
        "tol": 1e-4, "launches_by_shard": per_shard, "errors": sh_err,
        "checks": {
            "every_shard_launched_fused": shards_fused,
            "card_within_1e-4_of_host": max(sh_err) <= 1e-4,
            "placements_agree": "sharded-scale OK" in printed,
            # the reference test's bound (a quarter of the ratings on its
            # 8 devices): under twice the even share
            "each_device_stores_under_twice_its_share": bool(stored) and int(
                stored.group(1).replace(",", "")) < 2 * 40_000 / EXAMPLE_SHARDS,
            "resolved_fused_no_probe": "resolved solver: 'fused'\n"
            in printed}}
    card_s += card
    t0 = time.perf_counter()
    main_ok = movielens_eval_main(dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    mains_s = time.perf_counter() - t0
    launchers = example_launchers()
    phase_s = time.perf_counter() - t_phase
    checks = {f"{n}:{k}": ok for n, r in out.items()
              for k, ok in r["checks"].items()}
    checks["movielens-eval:main"] = main_ok
    checks.update({f"launchers:{k}": ok
                   for k, ok in launchers["checks"].items()})
    checks.update({f"profcat:{k}": ok for k, ok in profcat["checks"].items()})
    checks["within_limit"] = phase_s <= EXAMPLES_PHASE_LIMIT_S
    log(json.dumps({"examples": out, "movielens_eval_main": {
        "ok": main_ok, "s": round(mains_s, 1)}, "launchers": launchers,
        "profcat": profcat, "card_s": round(card_s, 1),
        "phase_s": round(phase_s, 1)}, default=str))
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"phase examples: checks failed: {bad}")
    return {"launches": launches}


def edge_ab(torch, turns: int = 5) -> None:
    """Recording on against ``--no-metrics`` at ML-20M from 64 clients, in
    turns: the ML-20M ratings trained in process (rank 64, 2 fused
    iterations) into an instance of a scratch ``$PIO_TPU_HOME``, two
    ``deploy`` processes on it (one with the default recording, one with
    ``--no-metrics``), a warm-up load on each, then ``turns`` loads of
    1,024 queries on each in the order A B B A A B ...; every reply held
    against an in-process ``predict``.  Prints each turn's queries/s and
    p50/p99 and each arm's median and spread, and the recording arm's
    time beyond the predict window at 4 clients in ``turns`` light
    loads."""
    import shutil
    import tempfile
    from pathlib import Path

    from predictionio_tpu_torch.controller import WorkflowContext
    from predictionio_tpu_torch.storage import Storage
    from predictionio_tpu_torch.templates.recommendation import Query
    from predictionio_tpu_torch.workflow import (
        prepare_deploy_components, run_train,
    )

    u, i, v = synth_ml20m(seed=0)
    ratings = expected_ratings(u, i, v, N_ITEMS)
    items = {item_id(j): {"categories": ["even" if j % 2 == 0 else "odd"]}
             for j in range(N_ITEMS)}
    home = Path(tempfile.mkdtemp(prefix="pio_edge_ab_"))
    st = Storage({"PIO_TPU_HOME": str(home)})
    procs = {}
    try:
        engine = engine_over(ratings, items)
        variant = {"datasource": {"params": {"appName": "ml20m"}},
                   "algorithms": [{"name": "als", "params": {
                       "rank": RANK, "numIterations": 2, "lambda": 0.01,
                       "solver": "fused"}}]}
        ep = engine.params_from_variant(variant)
        iid = run_train(engine, ep, ctx=WorkflowContext(storage=st))
        eng = home / "engine"
        cli(["template", "get", "recommendation", str(eng)], st)
        ej = eng / "engine.json"
        ej.write_text(json.dumps({**json.loads(ej.read_text()), **variant}))
        algos, models, _ = prepare_deploy_components(
            engine, ep, iid, ctx=WorkflowContext(mode="Serving", storage=st))
        queries = query_mix(1024, 41, N_USERS, N_ITEMS)
        want = [algos[0].predict(models[0], Query.from_json(q)).to_json()
                for q in queries]
        arms = {"recording": [], "no-metrics": ["--no-metrics"]}
        ports = {}
        for name, extra in arms.items():
            procs[name] = Console(home, [
                "deploy", "--engine-json", str(ej), "--engine-instance-id",
                iid, "--ip", "127.0.0.1", "--port", "0", *extra],
                f"deploy-{name}")
            ports[name] = procs[name].wait_port()
        for name in arms:
            http_load(ports[name], [], queries[:256], 64)  # warm-up
        results = {name: [] for name in arms}
        order = []
        for t in range(turns):
            pair = ("recording", "no-metrics")
            order += list(pair if t % 2 == 0 else pair[::-1])
        for name in order:
            load = http_load(ports[name], [], queries, 64)
            for q, r, w in zip(queries, load["replies"], want):
                _same_reply(r, w, f"{name} query {q}")
            results[name].append(load)
            p50, p99 = np.percentile(load["conc_ms"], [50, 99])
            log(f"edge-ab turn {len(results[name])} {name}: "
                f"{load['qps']:.1f} queries/s, p50 {p50:.1f} ms p99 "
                f"{p99:.1f} ms")
        # the recording arm's per-request time beyond the predict window
        # at 4 clients (phase cli's segments_reconcile_with_latency bound)
        extra = [light_segment_extra_ms(ports["recording"], queries[0])
                 for _ in range(turns)]
        log(f"edge-ab recording: {turns} light loads of 128 queries from 4 "
            f"clients, ms beyond the predict window per query: median "
            f"{np.median(extra):.3f} (min {min(extra):.3f}, max "
            f"{max(extra):.3f}, all {extra})")
        for name, runs in results.items():
            qps = sorted(r["qps"] for r in runs)
            p50 = sorted(float(np.percentile(r["conc_ms"], 50))
                         for r in runs)
            log(f"edge-ab {name}: {turns} turns of 1,024 queries from 64 "
                f"clients, queries/s median {np.median(qps):.1f} (min "
                f"{qps[0]:.1f}, max {qps[-1]:.1f}, all {qps}); p50 ms "
                f"median {np.median(p50):.1f} (min {p50[0]:.1f}, max "
                f"{p50[-1]:.1f}); order {order}")
        for name, p in procs.items():
            cli(["undeploy", "--port", str(ports[name])], st)
            p.proc.wait(timeout=60)
    finally:
        for p in procs.values():
            p.stop()
        st.close()
        shutil.rmtree(home, ignore_errors=True)


def write_rate_npz(path, u, i, v) -> None:
    """The ratings ``(u, i, v)`` as the columnar ``.npz`` format, equal
    to :func:`write_rate_lines`' events: the same entity ids, half-star
    properties and event times (``T0_MS`` + draw ms), no event id and no
    creation time (the import gives both, as it does for the JSON
    lines); written uncompressed, each column built as one fixed-width
    byte matrix."""
    n = len(v)
    if n > 86_400_000:
        raise ValueError("the event times must fall within one day")

    def text(m):
        return m.view(f"S{m.shape[1]}").ravel().astype(f"<U{m.shape[1]}")

    def ids(prefix: bytes, x, w: int):
        m = np.empty((n, 1 + w), np.uint8)
        m[:, 0] = prefix[0]
        _digits(m, 1, x, w)
        return text(m)

    props = np.empty((n, 14), np.uint8)
    props[:] = np.frombuffer(b'{"rating":0.0}', np.uint8)
    twice = np.rint(v * 2).astype(np.int64)
    props[:, 10] = 48 + twice // 2
    props[:, 12] = 48 + 5 * (twice % 2)
    times = np.empty((n, 24), np.uint8)
    times[:] = np.frombuffer(b"2015-01-01T00:00:00.000Z", np.uint8)
    ms = np.arange(n, dtype=np.int64)
    for c, (unit, mod, digits) in zip(
            (11, 14, 17, 20), ((3_600_000, 24, 2), (60_000, 60, 2),
                               (1000, 60, 2), (1, 1000, 3))):
        _digits(times, c, (ms // unit) % mod, digits)
    empty = np.full(n, "", "<U1")
    np.savez(path, event=np.full(n, "rate", "<U4"),
             entityType=np.full(n, "user", "<U4"),
             entityId=ids(b"u", u, 6), targetEntityType=np.full(
                 n, "item", "<U4"), targetEntityId=ids(b"i", i, 5),
             eventTime=text(times), eventId=empty, prId=empty,
             creationTime=empty, properties=text(props))


def phase_store_npz(u, i, v) -> dict:
    """The ML-20M ratings as a columnar ``.npz`` (:func:`write_rate_npz`)
    into a fresh 4-shard store through the console's ``import`` (the
    reference's columnar import: validated batches of 5,000, no bulk
    scope), then the sharded read held against the synthetic triples in
    the shards' order, as phase read does.  Timed beside the JSON-lines
    import of phase store."""
    store = StoreHome()
    try:
        out = cli(["app", "new", "ml20m"], store.storage)
        app_id = store.storage.get_metadata().app_get_by_name("ml20m").id
        src = f"{store.home}/ratings.npz"
        t0 = time.perf_counter()
        write_rate_npz(src, u, i, v)
        write_s = time.perf_counter() - t0
        file_gb = os.path.getsize(src) / 1e9
        t0 = time.perf_counter()
        out = cli(["import", "--appid", str(app_id), "--input", src],
                  store.storage)
        import_s = time.perf_counter() - t0
        os.unlink(src)
        if out != f"Imported {len(v)} events.\n":
            raise AssertionError(f"npz import: {out!r}")
        es = store.storage.get_event_store()
        t0 = time.perf_counter()
        got = es.find_ratings(app_id, cache=False)
        read_s = time.perf_counter() - t0
        same_ratings(got, expected_sharded(u, i, v, N_ITEMS),
                     "ML-20M through the .npz import")
    finally:
        store.close()
    log(f"phase store npz ML-20M: {len(v):,} rate events written as an "
        f"uncompressed .npz ({file_gb:.2f} GB) in {write_s:.1f} s; console "
        f"import into a fresh {STORE_SHARDS}-shard store {import_s:.1f} s "
        f"({len(v) / import_s:,.0f} events/s); find_ratings {read_s:.1f} "
        f"s, equal to the synthetic triples in the shards' order")
    return {"import_s": import_s, "write_s": write_s}


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


def fused_half_by_bucket(torch, tr, U, V, side: str, waves) -> list:
    """One fused half taken bucket by bucket: for each bucket of
    ``side``, its rows B, width K, and for each split target in
    ``waves`` (the planner's ``WAVES``) the plan's segments S and the
    CUDA-event time of the fused call on the trainer's own inputs:
    ``[(B, K, {w: (S, ms)}), ...]``."""
    from predictionio_tpu_torch.models.als import (
        _bucket_inputs, _fused_weights,
    )
    from predictionio_tpu_torch.ops.fused_als import (
        fused_gather_gram_solve, fused_tile_plan, sm_count,
    )

    cfg = tr.cfg
    sd = tr._item_side if side == "item" else tr._user_side
    opp = (U if side == "item" else V).contiguous()
    sms = sm_count(opp.device)
    lam_t = torch.tensor(cfg.lam, dtype=torch.float32, device=opp.device)
    alpha_t = torch.tensor(cfg.alpha, dtype=torch.float32, device=opp.device)
    gram = (opp.T @ opp) if cfg.implicit else None
    impl = tr.fused_gather
    rows = []
    for (_, starts, counts), k in zip(sd["buckets"], sd["ks"]):
        idx, val, valid, reg = _bucket_inputs(
            sd["c_sorted"], sd["v_sorted"], starts, counts, k, lam_t,
            cfg.weighted_lambda)
        cw, bw = _fused_weights(val, valid, alpha_t, cfg.implicit)
        per = {}
        for w in waves:
            plan = fused_tile_plan(*opp.shape, k, opp.element_size(), impl,
                                   b=idx.shape[0], sms=sms, waves=w)
            per[w] = (plan.segments, cuda_ms(
                lambda: fused_gather_gram_solve(
                    opp, idx, cw, bw, reg, gram, plan=plan,
                    gather_impl=impl), iters=3))
        rows.append((int(idx.shape[0]), int(k), per))
    return rows


def fused_iteration_at_waves(tr, U, V, waves, turns: int = 5) -> dict:
    """Seconds of one whole fused iteration of ``tr`` (its fenced halves
    summed) from ``(U, V)`` at each split target in ``waves``: the
    planner's ``WAVES`` set for each run (it is read at every plan) and
    restored after, one warm-up run each, then ``turns`` turns in which
    every target runs once, the order rotating; medians."""
    from predictionio_tpu_torch.ops import fused_als as fmod

    planner = fmod.WAVES
    secs = {w: [] for w in waves}
    try:
        for turn in range(-1, turns):
            k = max(turn, 0) % len(waves)
            for w in waves[k:] + waves[:k]:
                fmod.WAVES = w
                tr.run(U, V, 1)
                if turn >= 0:
                    secs[w].append(sum(t for _, t in tr.half_seconds))
    finally:
        fmod.WAVES = planner
    return {w: float(np.median(v)) for w, v in secs.items()}


def phase_breakdown(torch, ratings) -> dict:
    """Where one full-width iteration's device time goes, per solver: a
    first iteration (it also pays the caching allocator's device
    allocations, after the ``empty_cache`` before it), one without the
    profiler (its fenced halves: the iteration time), then one under
    ``torch.profiler``: device time by kernel (top 6), pass 2's (both
    stages) and the device's busy share of that iteration's wall time.  For the fused
    solver, each half once more bucket by bucket (B, K, segments, ms) at
    every split target of SWEEP_WAVES, in turns within each bucket: the
    halves' sums say which target the planner's ``WAVES`` should be; and
    the whole fused iteration (its fenced halves) at each target of
    ITERATION_WAVES, in turns, median of 5, the planner's ``WAVES`` set
    for each run and restored after.  Returns each solver's unprofiled
    iteration seconds."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer
    from predictionio_tpu_torch.ops.fused_als import WAVES

    iteration = {}
    for solver in ("fused", "pallas"):
        tr = ALSTrainer(ratings, cfg=ALSConfig(
            rank=RANK, lam=0.01, solver=solver, loss_every=0))
        U, V = tr.init_factors()
        U, V = tr.run(U, V, 1)
        first = ", ".join(f"{s} {t * 1e3:.1f} ms" for s, t in tr.half_seconds)
        U, V = tr.run(U, V, 1)
        iteration[solver] = sum(t for _, t in tr.half_seconds)
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
        # pass 2 of the split buckets, both of its stages
        p2 = [(t, c) for t, k, c in rows
              if "fused_als_reduce_kernel" in k
              or "fused_als_group_sum_kernel" in k]
        p2_us = sum(t for t, _ in p2)
        log(f"phase breakdown solver={solver}"
            + (f" ({tr.fused_gather!r} form)" if solver == "fused" else "")
            + f": first iteration [{first}], unprofiled [{plain}]; profiled "
            f"wall {wall * 1e3:.1f} ms "
            f"[{halves}], device time {total / 1e3:.1f} ms (busy "
            f"{total / 1e6 / wall:.1%} of wall); top kernels: {top}"
            + (f"; pass 2 (both stages) {p2_us / 1e3:.3f} ms in "
               f"{sum(c for _, c in p2)} kernel launches "
               f"({p2_us / total:.2%} of device time)"
               if solver == "fused" and total else ""))
        if solver == "fused":
            sweep = sorted({WAVES, *SWEEP_WAVES})
            sums = {w: 0.0 for w in sweep}
            for side in ("user", "item"):
                by_bucket = fused_half_by_bucket(torch, tr, U, V, side,
                                                 sweep)
                log(f"phase breakdown fused {side} half by bucket (B x K, "
                    f"segments, ms) at WAVES={WAVES}: " + "; ".join(
                        f"{b} x {k} S={per[WAVES][0]} {per[WAVES][1]:.3f}"
                        for b, k, per in by_bucket)
                    + f"; sum {sum(p[WAVES][1] for *_, p in by_bucket):.3f}"
                    " ms")
                for w in sweep:
                    half = sum(p[w][1] for *_, p in by_bucket)
                    sums[w] += half
                    split = [(b, k, *p[w]) for b, k, p in by_bucket
                             if p[w][0] > 1]
                    log(f"phase breakdown fused {side} half at WAVES={w}: "
                        f"{half:.3f} ms; split buckets (B x K S ms) "
                        + ", ".join(f"{b} x {k} S={s} {ms:.3f}"
                                    for b, k, s, ms in split))
            best = min(sums, key=sums.get)
            log("phase breakdown fused split target (both halves, ms): "
                + ", ".join(f"WAVES={w} {t:.3f}" for w, t in sums.items())
                + f"; least at WAVES={best}, the planner uses {WAVES}")
            e2e = fused_iteration_at_waves(tr, U, V, ITERATION_WAVES)
            log("phase breakdown fused iteration by split target (fenced "
                "halves summed, median of 5 turns, ms): " + ", ".join(
                    f"WAVES={w} {t * 1e3:.2f}" for w, t in e2e.items())
                + f"; least at WAVES={min(e2e, key=e2e.get)}, the planner "
                f"uses {WAVES}")
        del tr, U, V
        torch.cuda.empty_cache()
    log(f"phase breakdown iteration (sum of the fenced halves): fused "
        f"{iteration['fused'] * 1e3:.1f} ms, pallas "
        f"{iteration['pallas'] * 1e3:.1f} ms")
    return iteration


def kernel_registers(build_log) -> dict:
    """Registers per thread of each kernel, from ptxas's report in the
    build log: ``{"fused_als_kernel<f32,3>": 64, ...}``."""
    import re

    regs, name = {}, None
    for ln in build_log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            mangled, name, args = m.group(1), m.group(1), ""
            # the kernel's own name is a length-prefixed "..._kernel"
            for k in re.finditer(r"(?=(\d+)([A-Za-z_]\w*))", mangled):
                n, rest = int(k.group(1)), k.group(2)
                if len(rest) >= n and rest[:n].endswith("_kernel"):
                    name, args = rest[:n], rest[n:]
                    break
            if args.startswith("I"):
                dtype = "bf16" if "bfloat16" in args else {
                    "f": "f32", "t": "u16", "j": "u32"}.get(args[1], "")
                n = re.match(r"I(?:f|13__nv_bfloat16|[a-z])?Li(\d+)E", args)
                targs = [x for x in (dtype, n and n.group(1)) if x]
                if targs:
                    name += f"<{','.join(targs)}>"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            regs[name] = int(m.group(1))
            name = None
    return regs


def repeat_sessions(torch, runs: int) -> int:
    """``--sessions N``: phase sessions alone, ``runs`` times, each on a
    4-shard store of its own; prints nextitem's batch counts of every
    run (after its 64-client load and after each batching step) and
    fails if any run failed."""
    failed, rows = 0, []
    for run in range(runs):
        store = StoreHome()
        saved = {k: os.environ.get(k) for k in store.env}
        os.environ.update(store.env)
        try:
            rows.append(phase_sessions(torch, store)["batch_steps"])
        except AssertionError as e:
            failed += 1
            log(f"sessions run {run + 1} failed: {e}")
        finally:
            store.close()
            for k, val in saved.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val
    log(json.dumps({"sessions_batch_steps": rows, "failed": failed}))
    return 1 if failed else 0


def main(argv: list[str]) -> int:
    t_start = time.perf_counter()
    sessions_runs = (int(argv[1]) if len(argv) == 2 and argv[0] ==
                     "--sessions" and argv[1].isdigit() else 0)
    if argv not in ([], ["--breakdown"], ["--store"], ["--store-npz"],
                    ["--edge-ab"]) and not sessions_runs:
        print("usage: chip_smoke.py [--breakdown | --store | --store-npz "
              "| --edge-ab | --sessions N]", file=sys.stderr)
        return 2
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

    from predictionio_tpu_torch import native

    if sessions_runs:
        native.build()
        return repeat_sessions(torch, sessions_runs)
    # both builds at once, the CUDA kernels (nvcc) and the native host
    # runtime (g++, build/native/), and the ML-20M data made meanwhile
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        host = pool.submit(native.build)
        kernels_built = pool.submit(_build.library)
        if argv != ["--edge-ab"]:
            t1 = time.perf_counter()
            u, i, v = synth_ml20m(seed=0)
            t_data = time.perf_counter() - t1
        kernels_built.result()
        host.result()
    log(f"phase build: {time.perf_counter() - t0:.1f} s (CUDA kernels and "
        f"{native.BUILD_DIR / native.LIB_NAME}); registers per thread "
        f"(ptxas): {kernel_registers(_build.BUILD_DIR / 'build.log')}")
    if argv == ["--edge-ab"]:
        edge_ab(torch)
        return 0
    log(f"phase data: {len(v):,} ratings, {N_USERS:,} users, "
        f"{N_ITEMS:,} items in {t_data:.1f} s (made while the builds ran)")
    if argv == ["--breakdown"]:
        # the input phase read takes from the store, made in memory (the
        # full run holds the two equal)
        phase_breakdown(torch, expected_sharded(u, i, v, N_ITEMS))
        return 0
    # host seconds of each phase, logged before the kernels line
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    # the ML-20M store lives from phase store to phase eval; the scan
    # cache keeps its snapshots under $PIO_TPU_HOME, and the console's
    # train --scan-cache turns the cache on for the whole process.  Its
    # sharded source rides the environment, as for a user: the console's
    # processes (the fleet, deploy) read the same store
    store = StoreHome()
    saved_env = {k: os.environ.get(k)
                 for k in (*store.env, "PIO_TPU_SCAN_CACHE")}
    os.environ.update(store.env)
    try:
        stored = timed("store", phase_store, store, u, i, v,
                       argv == ["--store"])
        if argv == ["--store"]:
            # the import by one writer against four processes, on the
            # file phase store imported
            timed("store writers", store_writer_ab, store, stored["src"],
                  len(v), stored["import_s"])
            stored["src"].unlink()
        # the items' $set events go in through the fleet before the read
        # that fills the scan cache (a later write to the app would
        # outdate its snapshot), and phase engines' classify app is
        # imported meanwhile (another app: it outdates no snapshot)
        timed("fleet", phase_fleet, store)
        if not argv:
            classify = timed("classify import", import_classify, store)
        ratings = timed("read", phase_read, store, u, i, v)
        timed("sort", phase_sort, ratings, u, i, v)
        if argv in (["--store"], ["--store-npz"]):
            if argv == ["--store-npz"]:
                # the same ratings through the columnar format, timed
                # beside the JSON lines of phase store
                timed("store npz", phase_store_npz, u, i, v)
            log(f"phase seconds (host clock): {secs}")
            return 0
        kernels = [timed("gj", phase_gj, torch, dev, (
            ratings.user_ix, ratings.item_ix, ratings.rating))]
        torch.cuda.empty_cache()
        kernels.extend(timed("fused", phase_fused, torch, dev, ratings))
        kernels.extend(timed("gather", phase_gather, torch, dev))
        timed("small reference", phase_small_reference, torch)
        timed("topk", phase_topk, torch, dev)

        items = {item_id(j): {"categories": ["even" if j % 2 == 0 else
                                             "odd"]}
                 for j in range(N_ITEMS)}
        data = (ratings, items, (ratings.user_ix, ratings.item_ix,
                                 ratings.rating))

        # The main paths, each with the counts set to 0 just before it
        # and read just after.  ML-20M: train both kernel solvers and
        # serve.
        t0 = time.perf_counter()
        _build.reset_launches()
        algo, model, _ = phase_train(torch, data, "fused", 2)
        del model
        torch.cuda.empty_cache()
        algo, model, _ = phase_train(torch, data, "pallas", 1)
        phase_serve(torch, algo, model)
        # the "pallas" model serves path subspace's row gather and
        # phase scout
        row_model = model
        del algo, model
        torch.cuda.empty_cache()
        obs_traced_iteration(torch, ratings)
        torch.cuda.synchronize()
        paths = {"ml20m": dict(_build.LAUNCHES)}
        secs["train and serve"] = round(time.perf_counter() - t0, 1)
        # the rest of the trainer (resets the counts itself), then the
        # SPD solve kernel timed on its block systems
        sub = timed("subspace", path_subspace, torch, data, row_model)
        paths["subspace"] = sub["launches"]
        gj_sub = gj_at_shapes(torch, "path subspace gj",
                              "the sweep's block systems",
                              sub.pop("systems"))
        del data
        torch.cuda.empty_cache()
        # the quickstart through the console (resets the counts itself)
        cli_out = timed("cli", phase_cli, torch, store)
        paths["cli"] = cli_out["launches"]
        torch.cuda.empty_cache()
        # the ring top-k on a mesh of shards on this card, on phase
        # train's model (no kernel on its path)
        _build.reset_launches()
        timed("ring", phase_ring, torch, store, row_model, cli_out)
        paths["ring"] = dict(_build.LAUNCHES)
        torch.cuda.empty_cache()
        # the replica router on the instance the console trained; its
        # replicas are processes of their own (no kernel in this one)
        _build.reset_launches()
        router_out = timed("router", phase_router, torch, store, cli_out)
        paths["router"] = dict(_build.LAUNCHES)
        # the port's static gate and its obs commands, on phase router's
        # journals and the runs the console trains wrote (no kernel)
        _build.reset_launches()
        timed("lint", phase_lint, store, router_out)
        paths["lint"] = dict(_build.LAUNCHES)
        del cli_out["predict"]
        # `pio eval` through the console on the same store (the same)
        paths["eval"] = timed("eval", phase_eval, torch, store,
                              ratings)["launches"]
        torch.cuda.empty_cache()
        # two-stage retrieval, before fold-in's writes outdate the scan
        # cache its console train reads (no kernel on its path)
        timed("scout", phase_scout, torch, store, row_model, cli_out)
        del row_model
        torch.cuda.empty_cache()
        # the model-backed engines through the console, before fold-in's
        # writes outdate the scan cache their trains read (it sets the
        # counts to 0 itself)
        paths["engines"] = timed("engines", phase_engines, torch, store,
                                 ratings, u, i, classify)["launches"]
        del classify
        torch.cuda.empty_cache()
        # the engines that train no factor model, on a day of views of
        # their own in the same store (no kernel on its path): their
        # writes leave the other apps' snapshots valid
        _build.reset_launches()
        timed("sessions", phase_sessions, torch, store)
        paths["sessions"] = dict(_build.LAUNCHES)
        # fold-in on the same store, last: its writes outdate the scan
        # cache of its app (it sets the counts to 0 itself, after its
        # train, whose read must hit phase read's snapshot)
        foldin_out = timed("foldin", phase_foldin, torch, store, cli_out)
        paths["foldin"] = foldin_out["launches"]
        torch.cuda.empty_cache()
        # tenancy and experiments on the same store, after fold-in: both
        # write to it (it sets the counts to 0 itself, before its trains)
        hive_out = timed("hive", phase_hive, torch, store, cli_out,
                         foldin_out)
        paths["hive"] = hive_out["launches"]
        # the admin API and the dashboard, beside a deploy --multi of
        # phase hive's tenants (no kernel on its path)
        _build.reset_launches()
        timed("admin", phase_admin, torch, store, hive_out)
        paths["admin"] = dict(_build.LAUNCHES)
    finally:
        store.close()
        for k, val in saved_env.items():
            if val is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = val
    torch.cuda.empty_cache()
    # events -> run_train -> EngineServer (resets the counts itself)
    pio_out = timed("pio", phase_pio, torch, cli_out["views"])
    paths["pio"] = pio_out["launches"]
    paths["formats"] = pio_out["formats"]["launches"]
    secs["formats (in pio)"] = round(pio_out["formats"]["s"], 1)
    secs["dist console (in pio)"] = round(pio_out["dist"]["s"], 1)
    # the sharded and coded trainer on a mesh of shards on this card, on
    # the ML-20M ratings (it sets the counts to 0 itself)
    paths["dist"] = timed("dist", phase_dist, torch, ratings,
                          pio_out["dist"])["launches"]
    torch.cuda.empty_cache()
    # the 18 example engines on the card and the host, their mains and
    # the bin/ launchers; sharded-scale on shards of this card (it sets
    # the counts to 0 itself)
    paths["examples"] = timed("examples", phase_examples, torch,
                              router_out["profcat"])["launches"]
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
        "ml20m": ("gj_solve", "fused_als_reduce", "taa0_gather",
                  "dma_row_gather"),
        "cli": ("fused_als_reduce", "taa0_gather", "dma_row_gather"),
        "eval": ("fused_als_reduce", "taa0_gather", "dma_row_gather"),
        "pio": ("fused_als", "fused_als_dma", "taa0_gather",
                "dma_row_gather"),
        "probe_smoke": ("taa0_gather", "taa1_gather", "dma_row_gather"),
        "foldin": ("gj_solve",),
        "subspace": ("gj_solve",),
        "hive": ("fused_als_reduce", "taa0_gather", "dma_row_gather"),
        "engines": ("gj_solve", "taa0_gather", "dma_row_gather"),
        "dist": ("gj_solve",),
    }
    for path, names in expected.items():
        for name in names:
            if paths[path][name] <= 0:
                raise AssertionError(f"path {path} never launched {name}")
    for path in ("ring", "admin", "lint"):
        if any(paths[path].values()):
            raise AssertionError(f"path {path} launched a kernel: "
                                 f"{paths[path]}")
    for path in ("ml20m", "cli", "eval", "hive", "engines", "dist",
                 "examples"):
        if paths[path]["fused_als"] + paths[path]["fused_als_dma"] <= 0:
            raise AssertionError(f"path {path} never launched the fused "
                                 "kernel")
    for k in kernels:
        k["launches"] = sum(p[k["name"]] for p in paths.values())
        k["launches_by_path"] = {n: p[k["name"]] for n, p in paths.items()}
        if k["name"] == "gj_solve":
            # the systems fold-in's cycles gave the kernel
            k["foldin_shapes"] = foldin_out["gj"]
            # and the systems of path subspace's block sweep
            k["subspace_shapes"] = gj_sub

    timed("breakdown", phase_breakdown, torch, ratings)
    log(f"phase seconds (host clock): {secs}")
    log(f"script seconds (host clock, start to the kernels line): "
        f"{time.perf_counter() - t_start:.1f}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
