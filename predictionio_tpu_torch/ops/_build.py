"""Builds the port's CUDA kernels and loads them through ctypes.

Every ``ops/csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into
an object of its own (all of them at once, one process each), and the
objects are linked into ``build/kernels/libpio_kernels.so`` at the root
of the checkout.  The sources expose a plain C interface: pointers and
the CUDA stream travel as ``c_void_p``, sizes as ``c_int``, and every
entry point returns the CUDA error code of its launch.

The build happens at first use, never at import, and is reused while
the sources are unchanged (a hash of them is kept beside the library).
A missing ``nvcc``, a failed compile or a failed load raises: there is
no fallback.

Each kernel wrapper counts its launches in :data:`LAUNCHES`, so a run can
show that its main path went through the kernels.  :func:`launch` is the
wrappers' one way in: it calls an entry point looked up once at load, on
the current stream of the tensors' device (entering that device only when
it is not already current), raises on a launch error and counts.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

__all__ = [
    "BUILD_DIR",
    "LAUNCHES",
    "SIGNATURES",
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
# entry point name -> its ctypes function, filled when the library loads
_ENTRY: dict = {}


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
    return lib_path


_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FUSED = [_vp] * 8 + [_i] * 9 + [_ll]
# every entry point's argument types (each returns a CUDA error code)
SIGNATURES = {
    "pio_gj_solve": [_vp, _vp, _vp, _i, _i, _vp],
    "pio_fused_als_f32": _FUSED + [_vp],
    "pio_fused_als_bf16": _FUSED + [_vp],
    "pio_fused_als_dma_f32": _FUSED + [_i, _vp],
    "pio_fused_als_dma_bf16": _FUSED + [_i, _vp],
    "pio_fused_als_reduce": [_vp] * 4 + [_i] * 3 + [_ll, _vp],
    "pio_taa0_gather": [_vp] * 3 + [_i] * 3 + [_vp],
    "pio_taa1_gather": [_vp] * 3 + [_i] * 3 + [_vp],
    "pio_dma_row_gather": [_vp] * 3 + [_i] * 6 + [_vp],
}


def _declare(lib: ctypes.CDLL, names=None) -> dict:
    """Set the argument and result types of the entry points ``names``
    (all of :data:`SIGNATURES` when None); returns them by name."""
    entries = {}
    for name in SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes = SIGNATURES[name]
        fn.restype = _i
        entries[name] = fn
    return entries


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.pio_error_string.argtypes = [_i]
        lib.pio_error_string.restype = ctypes.c_char_p
        _ENTRY.update(_declare(lib))
        _lib = lib
    return _lib


def launch(entry: str, key: str, device, *args) -> None:
    """Call the C entry point ``entry`` with ``args`` and the current
    stream of ``device`` (a CUDA ``torch.device`` with an index), raise
    on a launch error, and count the launch under ``key``."""
    if _lib is None:
        library()
    fn = _ENTRY[entry]
    if device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    check_launch(rc, key)
    LAUNCHES[key] += 1


def check_launch(rc: int, kernel: str) -> None:
    """Raise when a kernel's C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().pio_error_string(rc).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: {msg} ({rc})")


def check_tensor(name: str, t, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device``: a kernel is handed a bare pointer and trusts all four."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
