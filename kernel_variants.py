#!/usr/bin/env python3
"""Design checks of the hand-written kernels on one NVIDIA GPU.

    python3 kernel_variants.py fused|reduce|gj|taa1

Builds copies of one kernel's source (``predictionio_tpu_torch/ops/csrc/``)
with one design choice changed or one phase cut out, each by its own
``nvcc``, all started together (into ``build/variants/<kernel>/``), and
times every copy with CUDA events on the shapes that bound that kernel.
Prints the card's name and power limit first, then one line per shape
(or per variant).  Cut variants compute wrong answers by design: only
their times mean anything; the others are held to the plain version.

``fused`` (``fused_als.cu``): pass 1 of both forms on a [32768, 128]
rank-64 bucket against the item table, a [454, 4096] bucket and the
heaviest item's [1, 2^21] row against the user table
(``chip_smoke.fused_cases``' data, f32 tables), one variant after the
other, and pass 2 alone on a [32768, 2, 2144] set of partials:

* ``as_built``: the source as it is;
* ``no_solve``: pass 1 writes the rhs instead of solving (what the solve
  costs);
* ``no_products``: no tensor-core products (what the Gram costs);
* ``no_table_read``: staged rows are constants (what the row gather
  costs);
* ``panel16``: the Cholesky in panels of 16 columns instead of 8;
* ``round_robin``: a warp's tiles dealt round-robin instead of in runs
  that share their row fragment.

``reduce`` (``fused_als.cu``, pass 2 alone): at every split bucket of
the ML-20M trainer and at phase fused's heavy row (the planner's
segments at the card's SM count, ``taa`` form, on partials of two
random rows a segment), each variant with its own
:func:`reduce_plan`, in turns (medians of 5), every variant held to the
plain version (1e-4 of the scale), then the one-block solve's floor
(one slice of [1, 1, P]):

* ``as_built``: first-stage blocks of 64 threads, 8 loads in flight a
  thread in both stages;
* ``sum32``, ``sum128``: first-stage blocks of 32 or 128 threads
  (narrower tiles give the second stage fewer groups to sum);
* ``unroll16``: 16 loads in flight a thread (more registers a thread in
  the second stage, whose block also solves);
* ``one stage`` (the source as built, a plan with G = 1): the second
  stage sums every partial itself.

``gj`` (``gj_solve.cu``): 65,536 rank-64 systems (the ``"pallas"``
solver's main shape, ``chip_smoke.py`` phase gj's systems), the variants
in turns (medians of 5), with the rank-64 kernel's registers (ptxas):

* ``as_built``;
* ``no_solve``: the block stages A and writes x from shared memory (what
  the load of A costs alone);
* ``no_load``: the staged pieces are constants, no read of A (what the
  factorisation and the solves cost alone);
* ``row_at_a_time``: the staging waits on each 16-byte piece before
  loading the next, not once for a batch of 8;
* ``branched``: a runtime branch around each row's update of a chunk
  (rows above the pivot skip it) instead of c = 0 for them;
* ``one_row``: one row a thread (two warps and a block barrier a
  system) instead of two;
* ``unguarded``: no test of ``p < R`` around each step (right only
  where R is the padded rank, as here);
* ``early_next``: each step writes the next step's vector after its
  first chunk of updates, not after all of them.

``taa1`` (``gather_probe.cu``): ``taa1_gather`` at [64, 2^20] f32, from
16-byte aligned tensors and from a table and ids one element off their
start, beside ``torch.gather``, in turns (medians of 5); every variant
is held to the plain version bitwise:

* ``as_built``: 16-byte vectors of ids and output on long rows of whole
  aligned vectors, one column a thread on every other row;
* ``columns``: one column a thread on every row.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from pathlib import Path


def cut(src: str, source: str, old: str, new: str) -> str:
    """``src`` with ``old`` replaced by ``new``; raises where the source
    no longer holds ``old``."""
    if old not in src:
        raise AssertionError(f"{source} no longer holds {old!r}")
    return src.replace(old, new)


def build(source: str, texts: dict, entries) -> dict:
    """Compile each variant text of csrc/``source`` by its own ``nvcc``,
    all at once.  Returns name -> (``{entry: (function, pack)}``, nvcc's
    output, which holds ptxas's register counts)."""
    from predictionio_tpu_torch.ops import _build

    build_dir = _build.BUILD_DIR.parent / "variants" / source.split(".")[0]
    build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in texts.items():
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
        lib = ctypes.CDLL(str(build_dir / f"lib{name}.so"))
        libs[name] = (_build._declare(lib, entries), out)
    return libs


# ------------------------------------------------------------------ fused --

def fused_variants(src: str) -> dict:
    def c(old, new):
        return cut(src, "fused_als.cu", old, new)

    return {
        "as_built": src,
        "no_solve": c(
            "  chol_solve_block<rows_per_lane<TPW>()>(M, R, xrow);",
            "  if (threadIdx.x < R) xrow[threadIdx.x] = "
            "M[threadIdx.x * (R + 1) + R];"),
        "no_products": c(
            "  if (!__any_sync(0xffffffffu, live)) return;",
            "  if (!__any_sync(0xffffffffu, live) || true) return;"),
        "no_table_read": c(
            "v[u][h] = ok && c < R ? widen(src[c]) :",
            "v[u][h] = ok && c < R ? 0.5f :").replace(
            "cp_async_zfill(dst, tab + (size_t)id * row_bytes + q * vec, "
            "vec, vec);", "cp_async_zfill(dst, tab, vec, 0);"),
        "panel16": c("constexpr int kPanel = 8;",
                     "constexpr int kPanel = 16;"),
        "round_robin": c(
            "const int t = warp * per + s;",
            "const int t = warp + kWarps * s;").replace(
            "if (s < per && t < total)", "if (t < total)"),
    }


def run_fused(torch, cs, libs) -> None:
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import fused_als as fmod

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
    shapes = ("[32768,128] items", "[454,4096] users", "[1,2^21] users")
    cases = dict(zip(shapes, ((table, short[:4]), (users, mid),
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
            for var, (entries, _) in libs.items():
                def call(entry=entries[name]):
                    fn, pack = entry
                    _build.check_launch(fn(pack(*args)), var)

                times.append(f"{var} {cs.cuda_ms(call, iters=5):.3f}")
            print(f"pass 1 {shape} {impl} (segments {plan.segments}) ms: "
                  + ", ".join(times), flush=True)
    parts = fmod.fused_partials_reference(table, *short[:3], 64)
    reg = short[3]
    x = torch.empty((parts.shape[0], cs.RANK), device=dev)
    # the rows fill the card: one stage, no scratch
    rp = fmod.reduce_plan(parts.shape[0], 2, cs.RANK, fmod.sm_count(dev))
    assert rp.groups == 1
    times = []
    for var, (entries, _) in libs.items():
        def call(entry=entries["pio_fused_als_reduce"]):
            fn, pack = entry
            _build.check_launch(fn(pack(
                parts.data_ptr(), reg.data_ptr(), gram0.data_ptr(),
                x.data_ptr(), 0, parts.shape[0], cs.RANK, 2,
                rp.seg_per_group, parts.numel() * 4, 0, stream)), var)

        times.append(f"{var} {cs.cuda_ms(call, iters=5):.3f}")
    print(f"pass 2 {list(parts.shape)} ms: " + ", ".join(times), flush=True)


# ----------------------------------------------------------------- reduce --

# threads of pass 2's first-stage block in each variant (its plan is
# made for them: reduce_plan's threads)
REDUCE_SUM_THREADS = {"as_built": 64, "sum32": 32, "sum128": 128,
                      "unroll16": 64}


def reduce_variants(src: str) -> dict:
    def c(old, new):
        return cut(src, "fused_als.cu", old, new)

    sum_threads = "constexpr int kSumThreads = 64;"
    return {
        "as_built": src,
        **{f"sum{w}": c(sum_threads, f"constexpr int kSumThreads = {w};")
           for w in (32, 128)},
        "unroll16": c("constexpr int kUnroll = 8;",
                      "constexpr int kUnroll = 16;"),
    }


def run_reduce(torch, cs, libs) -> None:
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops import fused_als as fmod

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = fmod.sm_count(dev)
    R, P = cs.RANK, fmod.partial_floats(cs.RANK)
    g = torch.Generator(device=dev).manual_seed(6)
    # the ML-20M trainer's split buckets from 2048 slots (chip_smoke.py's
    # phase breakdown): the user half's against the item table, the item
    # half's against the user table; and phase fused's heavy row
    shapes = [(b, 2048 << j, cs.N_ITEMS)
              for j, b in enumerate((1046, 372, 124, 38, 10))]
    shapes += [(b, 2048 << j, cs.N_USERS) for j, b in enumerate(
        (1532, 728, 347, 162, 77, 34, 16, 2))]
    shapes.append((1, 1 << 21, cs.N_USERS))
    for name, (_, out) in libs.items():
        regs = {kern: re.search(kern + r".*?Used (\d+) registers", out, re.S)
                for kern in ("group_sum_kernelILi4E",
                             "reduce_kernelILi2ELi4E")}
        print(f"{name}: registers (ptxas) " + ", ".join(
            f"{k} {m.group(1) if m else '?'}" for k, m in regs.items()),
            flush=True)
    ti, tj = torch.tril_indices(R, R, device=dev)
    for b, k, m in shapes:
        s = fmod.fused_tile_plan(m, R, k, 4, "taa", b=b, sms=sms).segments
        v = torch.randn((b, s, 2, R), generator=g, device=dev) / 4
        gram = torch.einsum("bskr,bskt->bsrt", v, v)
        parts = torch.cat([gram[:, :, ti, tj], v.sum(2)], 2).contiguous()
        del v, gram
        reg = torch.ones(b, device=dev)
        want = fmod.fused_reduce_solve_reference(parts, reg)
        fns, plans = {}, {}
        cases = [(name, name) for name in libs]
        cases.append(("one stage", "as_built"))
        for case, var in cases:
            plan = fmod.reduce_plan(b, s, R, sms, REDUCE_SUM_THREADS[var])
            if case == "one stage":
                plan = plan._replace(groups=1, seg_per_group=s,
                                     scratch_bytes=0)
            plans[case] = plan
            scratch = torch.empty(max(plan.scratch_bytes // 4, 1),
                                  device=dev)
            x = torch.empty((b, R), device=dev)
            fn, pack = libs[var][0]["pio_fused_als_reduce"]
            block = pack(parts.data_ptr(), reg.data_ptr(), 0, x.data_ptr(),
                         scratch.data_ptr() if plan.scratch_bytes else 0,
                         b, R, s, plan.seg_per_group, parts.numel() * 4,
                         plan.scratch_bytes, stream)

            def call(fn=fn, block=block, case=case, x=x, scratch=scratch):
                _build.check_launch(fn(block), case)

            call()
            torch.cuda.synchronize()
            cs.max_err(x, want, 1e-4, f"variant {case} [{b},{s},{P}]")
            fns[case] = (call, 10)
        ms = cs.interleaved_ms(fns)
        print(f"pass 2 [{b},{s},{P}] ms: " + ", ".join(
            f"{case} (G={plans[case].groups}) {t:.4f}"
            for case, t in ms.items()), flush=True)
    # the floor at one row: one slice read and the one-block solve
    parts = torch.randn((1, 1, P), generator=g, device=dev).abs()
    parts[0, 0, :R * (R + 1) // 2] = 0.0
    reg = torch.ones(1, device=dev)
    x = torch.empty((1, R), device=dev)
    fn, pack = libs["as_built"][0]["pio_fused_als_reduce"]
    block = pack(parts.data_ptr(), reg.data_ptr(), 0, x.data_ptr(), 0, 1, R,
                 1, 1, P * 4, 0, stream)
    ms = cs.interleaved_ms({"solve": (
        lambda: _build.check_launch(fn(block), "solve"), 20)})
    print(f"pass 2 [1,1,{P}] (one slice, the one-block solve) ms: "
          f"{ms['solve']:.4f}", flush=True)


# --------------------------------------------------------------------- gj --

def gj_variants(src: str) -> dict:
    def c(old, new, text=src):
        return cut(text, "gj_solve.cu", old, new)

    return {
        "as_built": src,
        "no_solve": c(
            "  __syncthreads();\n\n  // this thread's symmetric rows",
            "  __syncthreads();\n  if (vec16 >= 0) {\n"
            "    if (live && l < R) __stcs(x + sys * R + l, smem[t] + bi[0]);"
            "\n    return;\n  }\n\n  // this thread's symmetric rows"),
        "no_load": c(
            "piece[k] = __ldcs(reinterpret_cast<const float4*>(src));",
            "piece[k] = make_float4(1.0f, 0.0f, 0.0f, 0.0f);"),
        "row_at_a_time": c(
            "constexpr int BATCH = PASSES < 8 ? PASSES : 8;",
            "constexpr int BATCH = 1;"),
        "branched": c(
            "    if (p < (h + 1) * TS - 1) {",
            "    if (p < (h + 1) * TS - 1 && c[h] != 0.0f) {"),
        "one_row": c("return RP == 128 ? 1 : 2;", "return 1;"),
        "unguarded": c("    if (p < R) {", "    if (true) {"),
        "early_next": c(
            "          next[RP + 2] = rq;\n        }\n      }\n",
            "          next[RP + 2] = rq;\n        }\n      }\n"
            "#pragma unroll\n"
            "      for (int k = (p + 1) / 4 + 1; k < RP / 4; ++k)\n"
            "        update_chunk<H, RP, TS>(a, c, col4[k], k, p);\n",
            c("      for (int k = (p + 1) / 4; k < RP / 4; ++k)\n"
              "        update_chunk<H, RP, TS>(a, c, col4[k], k, p);\n"
              "      if (p + 1 < R) {",
              "      if ((p + 1) / 4 < RP / 4)\n"
              "        update_chunk<H, RP, TS>(a, c, col4[(p + 1) / 4], "
              "(p + 1) / 4, p);\n"
              "      if (p + 1 < R) {")),
    }


def run_gj(torch, cs, libs) -> None:
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops.solve import (
        GjPlan, gj_plan, sm_count, spd_solve_reference,
    )

    R, B = 64, 65_536
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(1)
    G = torch.randn((B, R, R), generator=g, device=dev)
    A = (torch.bmm(G, G.mT) / R + 0.5 * torch.eye(R, device=dev)).contiguous()
    b = torch.randn((B, R), generator=g, device=dev)
    del G
    want = spd_solve_reference(A, b)
    plan = gj_plan(R, B, sm_count(dev))
    fns, notes = {}, {}
    for name, (entries, out) in libs.items():
        fn, pack = entries["pio_gj_solve"]
        regs = re.search(r"gj_solve_kernelILi64E.*?Used (\d+) registers",
                         out, re.S)
        regs = regs.group(1) if regs else "?"
        # one row a thread: a system of two warps has a block of its own
        p = GjPlan(R, R, 1, B, plan.smem_bytes // plan.systems) \
            if name == "one_row" else plan
        x = torch.empty_like(b)
        block = pack(A.data_ptr(), b.data_ptr(), x.data_ptr(), B, R, *p,
                     stream)

        def call(fn=fn, block=block, name=name, x=x):  # x outlives block
            _build.check_launch(fn(block), name)

        call()
        torch.cuda.synchronize()
        if name in ("no_solve", "no_load"):
            notes[name] = f"{regs} registers, cut"
        else:
            err = cs.max_err(x, want, 1e-4, f"variant {name}")
            notes[name] = f"{regs} registers, max_abs_err {err:.2e}"
        fns[name] = (call, 20)
    ms = cs.interleaved_ms(fns)
    for name in libs:
        print(f"A[{B},{R},{R}] {name}: {ms[name]:.4f} ms ({notes[name]})",
              flush=True)


# ------------------------------------------------------------------- taa1 --

def taa1_variants(src: str) -> dict:
    return {
        "as_built": src,
        "columns": cut(src, "gather_probe.cu", "      M > kTaa1Short &&",
                       "      false &&"),
    }


def run_taa1(torch, cs, libs) -> None:
    from predictionio_tpu_torch.ops import _build
    from predictionio_tpu_torch.ops.gather_probe import taa1_gather_reference

    R, M = 64, 1 << 20
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    g = torch.Generator(device=dev).manual_seed(4)
    flat_t = torch.randn(R * M + 1, generator=g, device=dev)
    flat_i = torch.randint(0, M, (R * M + 1,), generator=g, device=dev,
                           dtype=torch.int32)
    inputs = {"aligned": (flat_t[:-1].view(R, M), flat_i[:-1].view(R, M)),
              "unaligned": (flat_t[1:].view(R, M), flat_i[1:].view(R, M))}
    fns = {}
    for where, (table, idx) in inputs.items():
        want = taa1_gather_reference(table, idx)
        for name, (entries, _) in libs.items():
            fn, pack = entries["pio_taa1_gather"]
            out = torch.empty_like(table)
            block = pack(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                         R, M, 4, stream)

            def call(fn=fn, block=block, name=name, out=out):
                _build.check_launch(fn(block), name)

            call()
            if not torch.equal(out, want):
                raise AssertionError(f"variant {name} ({where}) differs "
                                     "from the plain version")
            fns[f"{name} {where}"] = (call, 20)
        idx64 = idx.long()
        fns[f"torch.gather {where}"] = (
            lambda t=table, i=idx64: torch.gather(t, 1, i), 20)
    ms = cs.interleaved_ms(fns)
    for name, t in ms.items():
        print(f"taa1 [{R},{M}] f32 {name}: {t:.4f} ms", flush=True)


KERNELS = {
    "fused": ("fused_als.cu", fused_variants, run_fused,
              ("pio_fused_als_f32", "pio_fused_als_dma_f32",
               "pio_fused_als_reduce")),
    "reduce": ("fused_als.cu", reduce_variants, run_reduce,
               ("pio_fused_als_reduce",)),
    "gj": ("gj_solve.cu", gj_variants, run_gj, ("pio_gj_solve",)),
    "taa1": ("gather_probe.cu", taa1_variants, run_taa1,
             ("pio_taa1_gather",)),
}


def main(argv: list[str]) -> int:
    if len(argv) != 1 or argv[0] not in KERNELS:
        print(f"usage: kernel_variants.py {'|'.join(KERNELS)}",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from predictionio_tpu_torch.ops import _build

    source, variants, run, entries = KERNELS[argv[0]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)
    libs = build(source, variants((_build.CSRC / source).read_text()),
                 entries)
    run(torch, cs, libs)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
