"""The port's torch engine (``analysis/torchlint.py``) against the
reference's jax engine (``analysis/jaxlint.py``).

For PIO101–104, PIO106 and PIO108, a torch transliteration of each
positive and negative fixture of ``tests/piolint_fixtures``, written
here line for line: the torch engine reports the rule on the line where
the jax engine reports it on the jax fixture, and nothing on the
negatives.  Then the torch-only forms: the metadata reads that strip
taint (``models/als.py``'s ``torch.is_tensor`` test among them), CUDA
graph captures, nested transforms, and the kernel wrappers and fences
of PIO108.
"""

from __future__ import annotations

from pathlib import Path

import pytest

from predictionio_tpu.analysis import SourceFile as RefSource
from predictionio_tpu.analysis.jaxlint import JaxEngine
from predictionio_tpu_torch.analysis import SourceFile
from predictionio_tpu_torch.analysis.torchlint import TorchEngine

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = Path(__file__).parent / "piolint_fixtures"

TORCH = {
    "pio101_pos": '''"""item() on a traced value inside torch.compile
-> PIO101."""
import torch


@torch.compile
def bad_sum(x):
    total = torch.sum(x)
    return total.item()  # EXPECT: PIO101
''',
    "pio101_neg": '''"""item() on host code (outside any trace) is fine."""
import torch


@torch.compile
def good_sum(x):
    return torch.sum(x)


def host_read(x):
    return good_sum(x).item()
''',
    "pio102_pos": '''"""float() forcing a traced value -> PIO102."""
import torch


@torch.compile
def bad_scale(x, factor):
    s = float(factor)  # EXPECT: PIO102
    return x * s
''',
    "pio102_neg": '''"""float() of an unbatched vmap argument is fine."""
import functools

import torch


@functools.partial(torch.vmap, in_dims=(0, None))
def good_scale(x, factor):
    s = float(factor)
    return x * s
''',
    "pio103_pos": '''"""np.asarray on a traced value -> PIO103."""
import numpy as np
import torch


@torch.compile
def bad_convert(x):
    host = np.asarray(x)  # EXPECT: PIO103
    return host
''',
    "pio103_neg": '''"""torch.as_tensor stays on device; host data is host."""
import numpy as np
import torch


@torch.compile
def good_convert(x):
    return torch.as_tensor(x, dtype=torch.float32) * 2.0


def host_prepare(rows):
    return good_convert(np.asarray(rows, np.float32))
''',
    "pio104_pos": '''"""Python branch on a traced value -> PIO104."""
import torch


@torch.compile
def bad_branch(x):
    if x > 0:  # EXPECT: PIO104
        return x
    return -x
''',
    "pio104_neg": '''"""`is None` checks and shape branches are static."""
import torch


@torch.compile
def good_branch(x, bias=None):
    if bias is None:
        bias = torch.zeros_like(x)
    if x.shape[0] > 2:
        x = x + bias
    return torch.where(x > 0, x, -x)
''',
    "pio106_pos": '''"""f-string interpolation of a traced value -> PIO106."""
import torch


@torch.compile
def bad_label(x):
    msg = f"value={x}"  # EXPECT: PIO106
    return x, msg
''',
    "pio106_neg": '''"""Formatting static metadata (shape/dtype) is fine."""
import torch


@torch.compile
def good_label(x):
    msg = f"shape={x.shape} dtype={x.dtype}"
    return x, msg
''',
    "pio108_pos": '''"""An unfenced device span -> PIO108."""
import time

import torch


def bench_matmul(a, b):
    t0 = time.perf_counter()
    out = torch.mm(a, b)
    dt = time.perf_counter() - t0  # EXPECT: PIO108
    return out, dt
''',
    "pio108_neg": '''"""torch.cuda.synchronize inside the span makes it honest."""
import time

import torch


def bench_matmul(a, b):
    t0 = time.perf_counter()
    out = torch.mm(a, b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, dt
''',
}


def _torch_findings(tmp_path: Path, text: str, name: str = "m.py"):
    p = tmp_path / name
    p.write_text(text)
    src = SourceFile.load(p, tmp_path)
    return {(f.rule, f.line) for f in TorchEngine(src, bench_scope=True)
            .run()}


@pytest.mark.parametrize("stem", sorted(TORCH))
def test_the_transliteration_finds_what_the_jax_engine_finds(stem, tmp_path):
    fixture = FIXTURES / f"{stem}.py"
    want = {(f.rule, f.line) for f in JaxEngine(
        RefSource.load(fixture, FIXTURES), bench_scope=True).run()}
    assert bool(want) == stem.endswith("_pos")
    assert _torch_findings(tmp_path, TORCH[stem]) == want
    # and the torch text marks the same lines as the jax fixture
    marked = {(line.split("# EXPECT: ")[1], i) for i, line in enumerate(
        TORCH[stem].splitlines(), start=1) if "# EXPECT: " in line}
    assert marked == want


def test_als_type_test_is_no_finding_but_a_value_branch_is(tmp_path):
    """``models/als.py``'s λ sweep runs ``_solve_buckets`` under
    ``torch.func.vmap``: its ``torch.is_tensor(lam)`` test reads the
    Python value's type, not the traced value, and is no finding; the
    same file with a branch on ``lam``'s value is one, on that line."""
    text = (ROOT / "predictionio_tpu_torch/models/als.py").read_text()
    assert _torch_findings(tmp_path, text) == set()
    guard = "lam.to(f32) if torch.is_tensor(lam)"
    line = text[:text.index(guard)].count("\n") + 1
    assert "torch.func.vmap(one)" in text
    got = _torch_findings(tmp_path, text.replace(guard,
                                                 "lam.to(f32) if lam > 0"))
    assert got == {("PIO104", line)}


def test_metadata_reads_strip_the_taint(tmp_path):
    src = '''import torch


@torch.compile
def f(x, lam):
    n = x.size(0) + x.dim() + x.numel()
    if n > 2 and x.is_cuda and x.ndim == 2 and x.device.type == "cuda":
        pass
    if torch.is_tensor(lam) and isinstance(lam, float) or x.is_complex():
        pass
    return int(n), f"{x.dtype}", str(x.shape)
'''
    assert _torch_findings(tmp_path, src) == set()


def test_the_host_copies_and_syncs_of_a_traced_value(tmp_path):
    src = '''import torch
from torch.func import grad, vmap


def loss(w, x):
    v = w.cpu()
    a = (w * x).numpy()
    b = w.tolist()
    if bool(w.sum()):
        pass
    assert w.max() < 3
    return "{}".format(w), repr(x)


per_row = vmap(grad(loss), in_dims=(None, 0))
'''
    # w is unbatched (in_dims None) but grad traces it: every use counts
    assert _torch_findings(tmp_path, src) == {
        ("PIO103", 6), ("PIO103", 7), ("PIO101", 8), ("PIO102", 9),
        ("PIO104", 11), ("PIO106", 12)}


def test_a_cuda_graph_capture_is_traced_code_around_it_is_not(tmp_path):
    src = '''import torch


def capture(static_in, n):
    warm = static_in.sum().item()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = torch.mm(static_in, static_in)
        total = out.sum()
        scale = total.item()
        if n > 1:
            out = out * 2
    return g, out, warm, scale, float(out.sum())


@torch.jit.script
def scripted(x):
    return x.tolist()


compiled = torch.compile(lambda x: x)
'''
    assert _torch_findings(tmp_path, src) == {
        ("PIO101", 10), ("PIO104", 11), ("PIO101", 18)}


def test_kernel_wrappers_are_device_work_and_fences_close_a_span(tmp_path):
    src = '''import time

import torch

from predictionio_tpu_torch import fence
from predictionio_tpu_torch.ops import _build
from predictionio_tpu_torch.ops.solve import spd_solve_batched


def unfenced(a, b, dev):
    t0 = time.perf_counter()
    x = spd_solve_batched(a, b)
    s = time.perf_counter() - t0
    t1 = time.perf_counter()
    _build.launch("pio_noop", "gj_solve", dev, a)
    u = time.perf_counter() - t1
    t2 = time.perf_counter()
    y = x @ x
    v = time.perf_counter() - t2
    return s, u, v, y


def fenced(a, b, dev, stop):
    t0 = time.perf_counter()
    x = spd_solve_batched(a, b)
    stop.synchronize()
    s = time.perf_counter() - t0
    t1 = time.perf_counter()
    y = x @ x
    fence(dev)
    u = time.perf_counter() - t1
    t2 = time.perf_counter()
    z = float(y.sum())
    v = time.perf_counter() - t2
    t3 = time.perf_counter()
    host = [k * 2 for k in range(9)]
    w = time.perf_counter() - t3
    return s, u, v, w, z, host
'''
    assert _torch_findings(tmp_path, src) == {
        ("PIO108", 13), ("PIO108", 16), ("PIO108", 19)}
    # PIO108 is measurement scope only
    p = tmp_path / "m.py"
    assert TorchEngine(SourceFile.load(p, tmp_path)).run() == []


@pytest.mark.parametrize("stem", ["pio105_pos", "pio107_pos"])
def test_static_arguments_and_donation_have_no_torch_counterpart(
        stem, tmp_path):
    """PIO105 and PIO107 keep their ids in the catalog; the torch engine
    reports neither, even on the jax fixtures that show them."""
    fixture = FIXTURES / f"{stem}.py"
    assert {f.rule for f in JaxEngine(RefSource.load(
        fixture, FIXTURES), bench_scope=True).run()} == {stem[:6].upper()}
    assert _torch_findings(tmp_path, fixture.read_text()) == set()
