"""One run of one benchmark cell of the PyTorch and CUDA port.

    python3 benchmark/run.py --workload ml20m-r64.fused --seed 7 \
        --seconds 20 --trace 0

The cell's configuration, traffic mix, correctness limits and metrics
are found by name (``BENCHMARK.json``, ``configs/``, ``traffic/``,
``limits/``, ``metrics/``).  A run:

1. set-up (``setup_s``): makes the ratings on the card from ``--seed``
   (``generator.py``) and the initial factors ``U0, V0``; constructs
   ``predictionio_tpu_torch.models.als.ALSTrainer``, which builds or
   loads the kernels and stages the buckets; runs one warm train;
2. the window: ``trainer.train(init=(U0, V0))`` back to back, whole
   trains, until ``--seconds`` have passed;
3. with ``--trace 1``, a profiled stretch of whole trains after the
   window (``tracing.py``) for the per-layer metrics;
4. the check: the plain float64 ALS of ``reference.py`` recomputes the
   factors from the same ratings and ``U0, V0``, and every train's
   tables are held to it (``compare.py``) within the cell's limits.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device`` and, last, the
numbers compared beside their limits (also the last lines of standard
error).  ``--device cpu`` rehearses the whole path on the host at a
tiny size and prints no device metric.  No card, fewer cards than the
cell asks for, an unknown cell, or the JAX package loaded: a code other
than 0 and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "predictionio_tpu")
# a profiled stretch holds whole trains until it lasts this long
TRACE_SECONDS = 2.0
# the CPU rehearsal: the cell's counts shrunk to about this many
# ratings, and at most this many iterations a train
REHEARSAL_RATINGS = 8_000
REHEARSAL_ITERATIONS = 3


class CellError(KeyError):
    """An unknown cell, or a file of it that is missing."""


def _read_json(path: Path) -> dict:
    if not path.is_file():
        raise CellError(f"{path.relative_to(ROOT)} does not exist")
    return json.loads(path.read_text())


def load_cell(name: str) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic mix, limits and the metrics it reports, each read from the
    file its name gives."""
    spec = _read_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise CellError(f"unknown workload {name!r}; the cells are "
                        f"{sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    if cell["config"] not in configs:
        raise CellError(f"cell {name!r} names no known config")

    def reported(metrics):
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return {
        "chips": cell["chips"],
        "config": _read_json(ROOT / configs[cell["config"]]["file"]),
        "traffic": _read_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": _read_json(HERE / "limits" / f"{name}.json"),
        "end_to_end": reported(spec["end_to_end"]),
        "per_layer": reported(spec["per_layer"]),
    }


def load_reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise CellError(f"metric {metric!r} has no reader {path.name}")
    mod_name = "benchmark_metric_" + metric.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def shrink(cfg: dict, ratings: int, iterations: int) -> dict:
    """The configuration's counts shrunk to about ``ratings`` (users and
    items each by the square root of the factor, so the density holds)
    and at most ``iterations`` iterations a train."""
    f = max(1.0, cfg["n_ratings"] / ratings)
    s = math.sqrt(f)
    return {**cfg,
            "n_users": max(16, round(cfg["n_users"] / s)),
            "n_items": max(16, round(cfg["n_items"] / s)),
            "n_ratings": round(cfg["n_ratings"] / f),
            "num_iterations": min(cfg["num_iterations"], iterations)}


def init_factors(n_users: int, n_items: int, rank: int, seed: int,
                 device):
    """``U0, V0``: N(0, 1) / sqrt(rank) in float32, drawn on ``device``
    from a generator of its own, seeded from ``seed``."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 0x9E3779B1 + 0x7F4A7C15) % (1 << 63))
    scale = 1.0 / math.sqrt(rank)
    U0 = torch.randn((n_users, rank), generator=gen, device=device) * scale
    V0 = torch.randn((n_items, rank), generator=gen, device=device) * scale
    return U0, V0


def _note(what: str) -> None:
    """A progress line on standard error, with the seconds since the
    process started."""
    print(f"[{time.perf_counter() - T_START:8.2f} s] {what}",
          file=sys.stderr, flush=True)


def _fence(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _install_half_ranges(trainer, dev):
    """Wrap the trainer's half-iteration in a ``bench.half`` profiler
    range, fenced at both ends, for the traced stretch only; returns the
    undo."""
    from torch.profiler import record_function

    inner = trainer._half

    def half(*args, **kwargs):
        _fence(dev)
        with record_function("bench.half"):
            out = inner(*args, **kwargs)
            _fence(dev)
        return out

    trainer._half = half
    return lambda: delattr(trainer, "_half")


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    return out.stdout.strip()


def make_inputs(cfg: dict, seed: int, dev) -> dict:
    """The run's inputs from ``seed``: the ratings (host arrays, as the
    trainer takes them), their shape and ``U0, V0`` on ``dev``."""
    import torch

    from benchmark.generator import synth_ratings

    nu, ni, rank = cfg["n_users"], cfg["n_items"], cfg["rank"]
    assumed = cfg["assumed"]
    u, i, v = synth_ratings(nu, ni, cfg["n_ratings"], seed, dev,
                            assumed["user_zipf"], assumed["item_zipf"])
    shape = {
        "nnz": int(v.numel()), "rank": rank, "n_users": nu, "n_items": ni,
        "active_users": int((torch.bincount(u, minlength=nu) > 0).sum()),
        "active_items": int((torch.bincount(i, minlength=ni) > 0).sum()),
    }
    U0, V0 = init_factors(nu, ni, rank, seed, dev)
    coo = (u.cpu().numpy(), i.cpu().numpy(), v.cpu().numpy())
    return {"coo": coo, "shape": shape, "init": (U0, V0)}


def make_trainer(cfg: dict, traffic: dict, coo, dev, **overrides):
    """The port's trainer for the configuration and the traffic mix, as
    the recommendation template builds it; ``overrides`` change
    ``ALSConfig`` fields (the control's precision)."""
    from predictionio_tpu_torch.models.als import ALSConfig, ALSTrainer

    fields = dict(
        rank=cfg["rank"], num_iterations=cfg["num_iterations"],
        lam=cfg["lambda"], implicit=cfg["implicit"],
        weighted_lambda=cfg["weighted_lambda"],
        compute_dtype=cfg["compute_dtype"],
        matmul_precision=cfg["matmul_precision"],
        solver=traffic["solver"], gather_dtype=traffic["gather_dtype"],
        fused_gather=traffic["fused_gather"],
    )
    fields.update(overrides)
    return ALSTrainer(coo, cfg["n_users"], cfg["n_items"],
                      cfg=ALSConfig(**fields), device=dev)


def reference_tables(cfg: dict, inputs: dict, dev, **options):
    """The plain reference's factor tables for the run's inputs."""
    import torch

    from benchmark import reference

    return reference.als_reference(
        *(torch.from_numpy(a).to(dev) for a in inputs["coo"]),
        cfg["n_users"], cfg["n_items"], *inputs["init"], cfg["lambda"],
        cfg["num_iterations"], **options)


def cell_device(device: str):
    import torch

    return (torch.device("cuda", 0) if device == "cuda"
            else torch.device("cpu"))


def cell_config(cell: dict, dev) -> dict:
    """The cell's configuration, shrunk for a rehearsal on the host."""
    if dev.type == "cuda":
        return cell["config"]
    return shrink(cell["config"], REHEARSAL_RATINGS, REHEARSAL_ITERATIONS)


def run_cell(cell: dict, seed: int, seconds: float, trace: bool,
             device: str) -> dict:
    """Set-up, window, optional traced stretch and check of one run;
    returns what the result line is made from."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import compare, tracing
    from predictionio_tpu_torch.ops import _build

    dev = cell_device(device)
    cfg = cell_config(cell, dev)
    iters = cfg["num_iterations"]

    # -- set-up ---------------------------------------------------------
    inputs = make_inputs(cfg, seed, dev)
    shape, (U0, V0) = inputs["shape"], inputs["init"]
    _note(f"ratings made: {shape}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    trainer = make_trainer(cfg, cell["traffic"], inputs["coo"], dev)
    _note(f"trainer staged in {trainer.staging_seconds:.3f} s")
    tables = []   # every train's (user, item) factor tables, host arrays
    warm = trainer.train(init=(U0, V0))
    tables.append((warm.user_factors, warm.item_factors))
    _fence(dev)
    setup_s = time.perf_counter() - T_START
    _note("warm train done")

    # -- the window -----------------------------------------------------
    _build.reset_launches()
    half_seconds = []
    ends = []   # each train's end, seconds into the window
    t0 = time.perf_counter()
    while True:
        got = trainer.train(init=(U0, V0))
        tables.append((got.user_factors, got.item_factors))
        half_seconds += got.report["half_seconds"]
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    window_s, trains = ends[-1], len(ends)
    launches = sum(_build.LAUNCHES.values())
    each = [round(b - a, 4) for a, b in zip([0.0] + ends, ends)]
    _note(f"window: {trains} trains in {window_s:.3f} s: {each}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)

    # -- the traced stretch ---------------------------------------------
    summary, traced_trains = None, 0
    if trace:
        undo = _install_half_ranges(trainer, dev)
        activities = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            with record_function("bench.stretch"):
                _fence(dev)
                t1 = time.perf_counter()
                while True:
                    with record_function("bench.train"):
                        got = trainer.train(init=(U0, V0))
                    traced_trains += 1
                    tables.append((got.user_factors, got.item_factors))
                    if time.perf_counter() - t1 >= TRACE_SECONDS:
                        break
                _fence(dev)
        undo()
        summary = tracing.summarize(prof.profiler.kineto_results.events())
        del prof

    resolved = {"solver": trainer.solver,
                "fused_gather": trainer.fused_gather,
                "staging": trainer.staging,
                "fused_form": trainer.fused_form()}
    staging_s = trainer.staging_seconds
    del trainer, got, warm
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- the check ------------------------------------------------------
    t_check = time.perf_counter()
    ref_u, ref_v = reference_tables(cfg, inputs, dev)
    per_train = [compare.readings(pu, pv, ref_u, ref_v)
                 for pu, pv in tables]
    verdict = compare.judge(per_train, cell["limits"])
    check_s = time.perf_counter() - t_check
    _note(f"checked {len(tables)} trains in {check_s:.3f} s")

    ctx = {
        "shape": shape, "precision": cfg["matmul_precision"],
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "setup_s": setup_s, "staging_s": staging_s,
        "window": {"seconds": window_s, "iterations": trains * iters,
                   "half_seconds": half_seconds, "launches": launches},
        "trace": summary, "trace_iterations": traced_trains * iters,
    }
    return {"verdict": verdict, "ctx": ctx, "peak": peak,
            "resolved": resolved, "summary": summary,
            "check_s": check_s}


def _finite_or_none(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def _metrics(cell: dict, ctx: dict, trace: bool) -> dict:
    out = {}
    for m in cell["per_layer"] if trace else cell["end_to_end"]:
        value = load_reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: rehearse on the host at a tiny size; no "
                         "device metric is printed")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = load_cell(args.workload)
    except CellError as exc:
        print(f"error: {exc.args[0]}", file=sys.stderr)
        return 2
    import torch

    if args.device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell["chips"]:
            print(f"error: the cell needs {cell['chips']} CUDA device(s); "
                  f"this machine has {have}", file=sys.stderr)
            return 3
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   args.device)
    bad = forbidden_modules()
    if bad:
        print(f"error: loaded in this process: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    verdict, ctx = out["verdict"], out["ctx"]
    checks = {n: {"value": _finite_or_none(c["value"]),
                  "limit": c["limit"]}
              for n, c in verdict["checks"].items()}
    metrics = _metrics(cell, ctx, bool(args.trace))
    if args.device == "cpu":
        line = {"rehearsal": True, "correct": verdict["correct"],
                "attempted": verdict["attempted"],
                "failed": verdict["failed"], "read": sorted(metrics),
                "resolved": out["resolved"], "checks": checks}
    else:
        device = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": cell["chips"],
            "memory_peak_bytes": out["peak"],
            "power": _power_limit(),
        }
        line = {"correct": verdict["correct"],
                "attempted": verdict["attempted"],
                "failed": verdict["failed"],
                "metrics": metrics, "device": device}
        summary = out["summary"]
        if summary is not None:
            device["busy_s"] = summary.busy_s
            device["window_s"] = summary.window_s
            line["breakdown"] = {"device_ops": summary.device_ops,
                                 "idle_gaps": summary.idle_gaps}
        line["resolved"] = out["resolved"]
        line["check_s"] = out["check_s"]
        line["checks"] = checks
    print(json.dumps(line))
    for n, c in checks.items():
        print(f"check {n} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
