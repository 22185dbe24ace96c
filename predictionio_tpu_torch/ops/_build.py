"""Builds the port's CUDA kernels and loads them through ctypes.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
an object of its own (all of them at once, one process each), and the
objects are linked into ``build/kernels/libpio_kernels.so`` at the root
of the checkout.  The sources expose a plain C interface: every entry
point takes one pointer to a block of its arguments (a struct of
``csrc/launch_args.cuh``: pointers, sizes, and the CUDA stream last),
which :func:`launch` packs with :mod:`struct` in the same native layout
(:data:`ARG_STRUCTS`), and returns the CUDA error code of its launch.

The build happens at first use, never at import, and is reused while
the sources are unchanged (a hash of them is kept beside the library).
A missing ``nvcc``, a failed compile or a failed load raises: there is
no fallback.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.  :func:`launch` is the
wrappers' one way in: it calls an entry point looked up once at load, on
the current stream of the tensors' device (entering that device only when
it is not already current), raises on a launch error and counts.

The launch path is kept near the host time of one PyTorch call: the
current device and its stream's raw handle are read straight from
PyTorch's C layer (``torch._C._cuda_getDevice``,
``torch._C._cuda_getCurrentRawStream``; ``torch.cuda.current_stream``
builds a ``Stream`` object each call), the arguments cross ctypes as one
packed block (ctypes converts each argument of a list on its own), and
:func:`check_tensor` reads each attribute once.  A call releases the GIL
as ctypes does by default: keeping it (``ctypes.PyDLL``) saves a tenth
of a microsecond a call but lengthens a profiled training iteration.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ..obs import xray

__all__ = [
    "ARG_STRUCTS",
    "BUILD_DIR",
    "ENTRY_ARGS",
    "LAUNCHES",
    "build",
    "check_launch",
    "check_tensor",
    "launch",
    "library",
    "nvcc_path",
    "reset_launches",
]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libpio_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# launches per kernel wrapper since the last reset_launches()
LAUNCHES: dict[str, int] = {
    "gj_solve": 0,
    "fused_als": 0,
    "fused_als_dma": 0,
    "fused_als_reduce": 0,
    "taa0_gather": 0,
    "taa1_gather": 0,
    "dma_row_gather": 0,
}

_lib: Optional[ctypes.CDLL] = None
# the first use loads the library once, whichever thread comes first
_load_lock = threading.Lock()
# wrappers launch from several threads at once (a parallel evaluation
# sweep): each count's read-modify-write takes this lock
_count_lock = threading.Lock()
# entry point name -> its ctypes function, filled when the library loads
_ENTRY: dict = {}
# torch._C's current-device and raw-stream readers, bound at load (a
# build of torch without CUDA has neither)
_get_device = None
_raw_stream = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's standard location; raises when none exists."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on the PATH): the "
        "port's CUDA kernels are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(CFLAGS).encode())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile and link the kernels unless an up-to-date build exists;
    returns the library's path.  The compilers' output (ptxas register
    and shared-memory reports included) goes to ``build.log``.

    Processes that build at once (test workers, a run beside a test
    session) take turns on an ``fcntl`` lock in the build directory: the
    first compiles, the others find its stamp and reuse the library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return _build_locked(force)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _build_locked(force: bool) -> Path:
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _source_hash()
    if (
        not force and lib_path.is_file() and stamp.is_file()
        and stamp.read_text() == digest
    ):
        return lib_path
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    procs = []
    for src in _sources():
        obj = BUILD_DIR / (src.stem + ".o")
        cmd = [nvcc, *CFLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    log, failed = [], []
    for src, _, p in procs:
        out, _ = p.communicate()
        log.append(f"== {src.name} (rc={p.returncode})\n{out}")
        if p.returncode != 0:
            failed.append(src.name)
    if not failed:
        tmp = BUILD_DIR / (LIB_NAME + ".tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in procs)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        log.append(f"== link (rc={p.returncode})\n{p.stdout}{p.stderr}")
        if p.returncode != 0:
            failed.append("link")
        else:
            os.replace(tmp, lib_path)
            stamp.write_text(digest)
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(
            f"CUDA kernel build failed ({', '.join(failed)}):\n"
            + "\n".join(log)
        )
    # a build that really ran: pio_jit_compiles_total / _seconds
    xray.note_build(time.perf_counter() - t0)
    return lib_path


# each argument block of csrc/launch_args.cuh as a struct format, field
# for field in the compiler's native layout ("@"): "P" a pointer, "i" an
# int, "q" a long long; the stream is the last field
ARG_STRUCTS = {
    "GjArgs": "@3P7iP",
    "FusedArgs": "@8P9iqiP",
    "ReduceArgs": "@5P4i2qP",
    "TaaArgs": "@3P3iP",
    "RowCopyArgs": "@3P8iP",
}
# every entry point's argument block (each returns a CUDA error code)
ENTRY_ARGS = {
    "pio_gj_solve": "GjArgs",
    "pio_fused_als_f32": "FusedArgs",
    "pio_fused_als_bf16": "FusedArgs",
    "pio_fused_als_dma_f32": "FusedArgs",
    "pio_fused_als_dma_bf16": "FusedArgs",
    "pio_fused_als_reduce": "ReduceArgs",
    "pio_taa0_gather": "TaaArgs",
    "pio_taa1_gather": "TaaArgs",
    "pio_dma_row_gather": "RowCopyArgs",
    "pio_noop": "TaaArgs",
}


def _declare(lib: ctypes.CDLL, names=None) -> dict:
    """Declare the entry points ``names`` (all of :data:`ENTRY_ARGS` when
    None): one argument, the packed block, and an int result.  Returns
    ``{name: (function, pack)}``, ``pack(*args, stream)`` giving the
    block's bytes."""
    entries = {}
    for name in ENTRY_ARGS if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_char_p]
        fn.restype = ctypes.c_int
        entries[name] = (fn, struct.Struct(ARG_STRUCTS[ENTRY_ARGS[name]]).pack)
    return entries


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call (one build and
    load however many threads call at once)."""
    global _lib, _get_device, _raw_stream
    with _load_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.pio_error_string.argtypes = [ctypes.c_int]
            lib.pio_error_string.restype = ctypes.c_char_p
            _ENTRY.update(_declare(lib))
            _get_device = torch._C._cuda_getDevice
            _raw_stream = torch._C._cuda_getCurrentRawStream
            _lib = lib
    return _lib


def launch(entry: str, key: str, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` (its argument
    block's fields but the stream; a pointer is an int, 0 for NULL) and
    the current stream of ``device`` (a CUDA ``torch.device``; without an
    index, the current device), raise on a launch error, and count the
    launch under ``key``."""
    if _lib is None:
        library()
    fn, pack = _ENTRY[entry]
    index = device.index
    current = _get_device()
    if index is None or index == current:
        rc = fn(pack(*args, _raw_stream(current)))
    else:
        with torch.cuda.device(index):
            rc = fn(pack(*args, _raw_stream(index)))
    if rc:
        check_launch(rc, key)
    with _count_lock:
        LAUNCHES[key] += 1


def check_launch(rc: int, kernel: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().pio_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (a tuple) on ``device``: a kernel is handed a bare pointer and trusts
    all four."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
