#!/usr/bin/env python3
"""Design checks of the fused ALS kernel on one NVIDIA GPU.

    python3 fused_variants.py

Builds copies of ``predictionio_tpu_torch/ops/csrc/fused_als.cu`` with one
design choice changed or one phase cut out (into
``build/fused_variants/``), and times
pass 1 of each with CUDA events on the shapes that bound the fused
solver: a [32768, 128] rank-64 bucket against the item table, a
[454, 4096] bucket and the heaviest item's [1, 2^21] row against the
user table (``chip_smoke.fused_cases``' data, f32 tables), both forms.
The variants:

* ``as_built``: the source as it is;
* ``no_solve``: pass 1 writes the rhs instead of solving (what the solve
  costs);
* ``no_products``: no tensor-core products (what the Gram costs);
* ``no_table_read``: staged rows are constants (what the row gather
  costs);
* ``panel16``: the Cholesky in panels of 16 columns instead of 8;
* ``round_robin``: a warp's tiles dealt round-robin instead of in runs
  that share their row fragment.

It also times pass 2 alone on a [32768, 2, 2144] set of partials (one
solve a row).  The cut variants compute wrong answers by design: only
their times mean anything.  Prints one line per shape and the card's
name and power limit first.  (The split target, the planner's
``WAVES``, is swept over the trainer's own buckets by ``chip_smoke.py``
phase breakdown.)
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

SHAPES = ("[32768,128] items", "[454,4096] users", "[1,2^21] users")


def variants(src: str) -> dict:
    def cut(old: str, new: str) -> str:
        if old not in src:
            raise AssertionError(f"fused_als.cu no longer holds {old!r}")
        return src.replace(old, new)

    return {
        "as_built": src,
        "no_solve": cut(
            "  chol_solve_block<rows_per_lane<TPW>()>(M, R, xrow);",
            "  if (threadIdx.x < R) xrow[threadIdx.x] = "
            "M[threadIdx.x * (R + 1) + R];"),
        "no_products": cut(
            "  if (!__any_sync(0xffffffffu, live)) return;",
            "  if (!__any_sync(0xffffffffu, live) || true) return;"),
        "no_table_read": cut(
            "v[u][h] = ok && c < R ? widen(src[c]) :",
            "v[u][h] = ok && c < R ? 0.5f :").replace(
            "cp_async_zfill(dst, tab + (size_t)id * row_bytes + q * vec, "
            "vec, vec);", "cp_async_zfill(dst, tab, vec, 0);"),
        "panel16": cut("constexpr int kPanel = 8;",
                       "constexpr int kPanel = 16;"),
        "round_robin": cut(
            "const int t = warp * per + s;",
            "const int t = warp + kWarps * s;").replace(
            "if (s < per && t < total)", "if (t < total)"),
    }


def build(build_dir: Path) -> dict:
    """Compile every variant at once; returns name -> entry points."""
    from predictionio_tpu_torch.ops import _build

    build_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "fused_als.cu").read_text()
    procs = {}
    for name, text in variants(src).items():
        cu = build_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.CFLAGS, "-I", str(_build.CSRC),
             "-shared", str(cu), "-o", str(build_dir / f"lib{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name} failed to build:\n{out}")
        libs[name] = _build._declare(
            ctypes.CDLL(str(build_dir / f"lib{name}.so")),
            ("pio_fused_als_f32", "pio_fused_als_dma_f32",
             "pio_fused_als_reduce"))
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import fused_als as fmod

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = build(_build.BUILD_DIR.parent / "fused_variants")
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    table, short, users, _, long = cs.fused_cases(torch, dev)
    g = torch.Generator(device=dev).manual_seed(5)
    counts = torch.randint(2049, 4097, (454,), generator=g, device=dev)
    valid = torch.arange(4096, device=dev)[None, :] < counts[:, None]
    mid_idx = torch.where(valid, torch.randint(
        0, users.shape[0], (454, 4096), generator=g, device=dev), 0).int()
    mid = (mid_idx, valid.float(), valid.float() * 3,
           0.01 * counts.float())
    cases = dict(zip(SHAPES, ((table, short[:4]), (users, mid),
                              (users, long[:4]))))
    gram0 = torch.zeros((cs.RANK, cs.RANK), device=dev)
    for shape, (t, (idx, cw, bw, reg)) in cases.items():
        b, k = idx.shape
        for impl in ("taa", "dma"):
            plan = fmod.fused_tile_plan(*t.shape, k, 4, impl, b=b,
                                        sms=fmod.sm_count(dev))
            x = torch.empty((b, cs.RANK), device=dev)
            ws = torch.empty(max(plan.workspace_bytes // 4, 1), device=dev)
            vec = fmod.copy_piece_bytes(t) if impl == "dma" else 0
            args = [t.data_ptr(), idx.data_ptr(), cw.data_ptr(),
                    bw.data_ptr(), reg.data_ptr(), gram0.data_ptr(),
                    x.data_ptr(), ws.data_ptr(), b, k, t.shape[0], cs.RANK,
                    plan.kc, plan.tile, plan.smem_bytes, plan.segments,
                    plan.seg_len, plan.workspace_bytes, vec, stream]
            name = "pio_fused_als_f32" if impl == "taa" \
                else "pio_fused_als_dma_f32"
            times = []
            for var, entries in libs.items():
                def call(entry=entries[name]):
                    fn, pack = entry
                    _build.check_launch(fn(pack(*args)), var)

                times.append(f"{var} {cs.cuda_ms(call, iters=5):.3f}")
            print(f"pass 1 {shape} {impl} (segments {plan.segments}) ms: "
                  + ", ".join(times), flush=True)
    parts = fmod.fused_partials_reference(table, *short[:3], 64)
    reg = short[3]
    x = torch.empty((parts.shape[0], cs.RANK), device=dev)
    times = []
    for var, entries in libs.items():
        def call(entry=entries["pio_fused_als_reduce"]):
            fn, pack = entry
            _build.check_launch(fn(pack(
                parts.data_ptr(), reg.data_ptr(), gram0.data_ptr(),
                x.data_ptr(), parts.shape[0], cs.RANK, 2,
                parts.numel() * 4, stream)), var)

        times.append(f"{var} {cs.cuda_ms(call, iters=5):.3f}")
    print(f"pass 2 {list(parts.shape)} ms: " + ", ".join(times), flush=True)
    del parts
    return 0


if __name__ == "__main__":
    sys.exit(main())
