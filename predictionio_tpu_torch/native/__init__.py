"""Native (C++) host runtime of the port, loaded through ctypes.

Port of ``predictionio_tpu/native/__init__.py``.  It builds the
repository's own C++ sources, ``native/bucketize.cpp`` (O(n) counting
sort of a rating COO by row), ``native/jsonl_scan.cpp`` (bulk scan of
JSON-lines events for the importer) and ``native/sqlite_scan.cpp``
(fused SQLite scan and id-dictionary encode for the training read),
with the system ``g++`` into ``build/native/libpio_native.so`` at the
root of the checkout.  The JAX package builds the same sources into
``$PIO_TPU_HOME/native/_native.so``; the port never loads that file.

The build happens at first use, never at import, and is reused while
the sources and flags are unchanged (a hash of them is kept beside the
library).  Processes that build at once take turns on an ``fcntl`` lock
in the build directory, and the library is compiled to a temporary name
and published with ``os.replace``, so no process ever loads a
half-written file.  A missing compiler or a failed compile or link
raises with the compiler's own words: unlike the reference, the port
neither rebuilds without the SQLite scan nor falls back to NumPy.  The
NumPy counting sort :func:`sort_coo_by_row_numpy` stays as the plain
version the tests hold the native one against.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from ..obs import xray

__all__ = [
    "BUILD_DIR",
    "NativeBuildError",
    "NativeScanError",
    "build",
    "native_available",
    "scan_events_jsonl",
    "scan_ratings_sqlite",
    "sort_coo_by_row",
    "sort_coo_by_row_numpy",
]


class NativeBuildError(RuntimeError):
    """The compiler is missing, or the compile or link failed."""


class NativeScanError(RuntimeError):
    """sqlite refused a ratings scan (a reason of the data: the caller
    may take its Python branch)."""


class _PioRatingsScan(ctypes.Structure):
    # mirrors PioRatingsScan in native/sqlite_scan.cpp
    _fields_ = [
        ("n", ctypes.c_int64),
        ("u_codes", ctypes.POINTER(ctypes.c_int32)),
        ("i_codes", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("times", ctypes.POINTER(ctypes.c_int64)),
        ("n_users", ctypes.c_int64),
        ("n_items", ctypes.c_int64),
        ("user_arena", ctypes.POINTER(ctypes.c_char)),
        ("user_offs", ctypes.POINTER(ctypes.c_int64)),
        ("item_arena", ctypes.POINTER(ctypes.c_char)),
        ("item_offs", ctypes.POINTER(ctypes.c_int64)),
        ("err", ctypes.c_char * 256),
    ]


_ROOT = Path(__file__).resolve().parents[2]
SRC_DIR = _ROOT / "native"
SOURCES = ("bucketize.cpp", "jsonl_scan.cpp", "sqlite_scan.cpp")
BUILD_DIR = _ROOT / "build" / "native"
LIB_NAME = "libpio_native.so"
CXX = "g++"
# -l:libsqlite3.so.0 links the runtime library by its soname: hosts ship
# it without the dev symlink or header (sqlite_scan.cpp declares the
# ABI-stable prototypes itself)
CXXFLAGS = ["-O3", "-shared", "-fPIC"]
LDLIBS = ["-l:libsqlite3.so.0"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    h.update(" ".join([CXX, *CXXFLAGS, *LDLIBS]).encode())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile and link the native library unless an up-to-date build
    exists; returns its path.  Raises :class:`NativeBuildError` with the
    tail of the compiler's output when the compiler is missing or
    fails."""
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
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [CXX, *CXXFLAGS, *(str(SRC_DIR / s) for s in SOURCES),
           "-o", str(tmp), *LDLIBS]
    try:
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(
                f"native build failed to run {CXX!r}: {e}"
            ) from e
        (BUILD_DIR / "build.log").write_text(
            f"$ {' '.join(cmd)}\n(rc={p.returncode})\n{p.stdout}{p.stderr}"
        )
        if p.returncode != 0:
            raise NativeBuildError(
                f"native build failed (rc={p.returncode}): "
                f"{(p.stdout + p.stderr)[-2000:]}"
            )
        os.replace(tmp, lib_path)
        stamp.write_text(digest)
    finally:
        tmp.unlink(missing_ok=True)
    # a build that really ran: pio_jit_compiles_total / _seconds
    xray.note_build(time.perf_counter() - t0)
    return lib_path


def _declare(lib: ctypes.CDLL) -> None:
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.pio_count_rows.argtypes = [i32p, ctypes.c_int64, i64p]
    lib.pio_count_rows.restype = None
    lib.pio_sort_coo.argtypes = [
        i32p, i32p, f32p, ctypes.c_int64, ctypes.c_int64,
        i64p, i64p, i32p, f32p,
    ]
    lib.pio_sort_coo.restype = None
    lib.pio_scan_ratings_sql.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
    ]
    lib.pio_scan_ratings_sql.restype = ctypes.POINTER(_PioRatingsScan)
    lib.pio_scan_ratings_free.argtypes = [ctypes.POINTER(_PioRatingsScan)]
    lib.pio_scan_ratings_free.restype = None
    lib.pio_scan_events_jsonl.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        i64p, i32p, i64p, i64p, i64p, i32p, i32p,
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.pio_scan_events_jsonl.restype = ctypes.c_int64


def _load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
        return _lib


def native_available() -> bool:
    """True once the library is built and loaded.  The port has no
    NumPy fallback, so a failed build raises here rather than answering
    False."""
    return _load() is not None


def _check_rows(row_ix: np.ndarray, n: int, n_rows: int) -> None:
    if n and (row_ix.min() < 0 or row_ix.max() >= n_rows):
        # the C++ path does unchecked ++counts[row[i]]
        raise ValueError(
            f"row ids must be in [0, {n_rows}); got "
            f"[{int(row_ix.min())}, {int(row_ix.max())}]"
        )


def sort_coo_by_row(
    row_ix: np.ndarray,
    col_ix: np.ndarray,
    val: np.ndarray,
    n_rows: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group a COO by row id with the native O(n) counting sort.

    Returns ``(c_sorted, v_sorted, counts, starts)`` where row ``r``'s
    ratings occupy ``[starts[r], starts[r+1])`` of the sorted arrays in
    their original order (stable)."""
    n = len(val)
    row_ix = np.ascontiguousarray(row_ix, dtype=np.int32)
    col_ix = np.ascontiguousarray(col_ix, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float32)
    _check_rows(row_ix, n, n_rows)
    lib = _load()
    counts = np.zeros(n_rows, dtype=np.int64)
    lib.pio_count_rows(row_ix, n, counts)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    cursor = np.empty(n_rows, dtype=np.int64)
    c_sorted = np.empty(n, dtype=np.int32)
    v_sorted = np.empty(n, dtype=np.float32)
    lib.pio_sort_coo(
        row_ix, col_ix, val, n, n_rows, starts, cursor, c_sorted, v_sorted
    )
    return c_sorted, v_sorted, counts, starts


def sort_coo_by_row_numpy(row_ix, col_ix, val, n_rows: int):
    """The plain version of :func:`sort_coo_by_row`: a stable NumPy
    argsort, with the same outputs bit for bit."""
    row_ix = np.ascontiguousarray(row_ix, dtype=np.int32)
    col_ix = np.ascontiguousarray(col_ix, dtype=np.int32)
    val = np.ascontiguousarray(val, dtype=np.float32)
    _check_rows(row_ix, len(val), n_rows)
    order = np.argsort(row_ix, kind="stable")
    c_sorted = np.ascontiguousarray(col_ix[order])
    v_sorted = np.ascontiguousarray(val[order])
    counts = np.bincount(row_ix, minlength=n_rows).astype(np.int64)
    starts = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return c_sorted, v_sorted, counts, starts


# number of per-event string-field slots emitted by pio_scan_events_jsonl
# (matches the Field enum in native/jsonl_scan.cpp)
_N_FIELDS = 8
(F_EVENT, F_ENTITY_TYPE, F_ENTITY_ID, F_TARGET_ENTITY_TYPE,
 F_TARGET_ENTITY_ID, F_PR_ID, F_EVENT_ID, F_PROPERTIES) = range(_N_FIELDS)


def scan_events_jsonl(data: bytes):
    """Native scan of a JSON-lines event buffer.

    Returns ``(n, field_off, field_len, event_ms, creation_ms, line_off,
    line_len, status)`` numpy arrays (sized n).  ``status[i] == 0`` means
    event ``i``'s storage-row fields were extracted natively; ``1`` means
    the caller must re-parse that line with the exact Python path
    (escapes, tags, validation failures, odd timestamps)."""
    lib = _load()
    # one slot per newline upper-bounds the event count
    max_events = data.count(b"\n") + 1
    field_off = np.empty(max_events * _N_FIELDS, dtype=np.int64)
    field_len = np.empty(max_events * _N_FIELDS, dtype=np.int32)
    event_ms = np.empty(max_events, dtype=np.int64)
    creation_ms = np.empty(max_events, dtype=np.int64)
    line_off = np.empty(max_events, dtype=np.int64)
    line_len = np.empty(max_events, dtype=np.int32)
    status = np.empty(max_events, dtype=np.int32)
    consumed = ctypes.c_int64(0)
    n = int(lib.pio_scan_events_jsonl(
        data, len(data), max_events,
        field_off, field_len, event_ms, creation_ms,
        line_off, line_len, status, ctypes.byref(consumed),
    ))
    return (
        n,
        field_off[: n * _N_FIELDS].reshape(n, _N_FIELDS),
        field_len[: n * _N_FIELDS].reshape(n, _N_FIELDS),
        event_ms[:n], creation_ms[:n], line_off[:n], line_len[:n],
        status[:n],
    )


def scan_ratings_sqlite(db_path: str, sql: str, binds, has_value_col: bool):
    """Fused scan + id-dictionary encode over one ratings SELECT.

    The caller builds ``sql`` (identifiers validated, every value a
    ``?N`` placeholder filled from ``binds``) with the column contract
    ``entity_id, target_entity_id, event_time[, value]``;
    ``has_value_col=False`` is implicit-feedback mode (each row counts
    1.0).  Returns ``(u_codes i32[n], i_codes i32[n], values f64[n],
    times i64[n], user_ids object[n_users], item_ids object[n_items])``
    with codes in first-seen dictionary order.  Raises
    :class:`NativeScanError` with sqlite's message when the scan fails (``json_extract`` on a
    NaN or Infinity token, for one), so the caller can take its Python
    branch."""
    lib = _load()
    binds = [b.encode() for b in binds]
    arr = (ctypes.c_char_p * len(binds))(*binds) if binds else None
    res = lib.pio_scan_ratings_sql(
        db_path.encode(), sql.encode(), arr, len(binds),
        1 if has_value_col else 0,
    )
    if not res:
        raise MemoryError("pio_scan_ratings allocation failed")
    try:
        rec = res.contents
        err = bytes(rec.err).split(b"\0", 1)[0]
        if err:
            raise NativeScanError(
                f"native ratings scan failed: {err.decode()}"
            )
        n = int(rec.n)

        def column(ptr, dtype):
            if not n:
                return np.empty(0, dtype)
            return np.ctypeslib.as_array(ptr, shape=(n,)).copy()

        def ids(arena_ptr, offs_ptr, count):
            count = int(count)
            if count == 0:
                return np.empty(0, dtype=object)
            offs = np.ctypeslib.as_array(offs_ptr, shape=(count + 1,))
            blob = ctypes.string_at(arena_ptr, int(offs[count]))
            out = np.empty(count, dtype=object)
            for k in range(count):
                out[k] = blob[offs[k]:offs[k + 1]].decode()
            return out

        u = column(rec.u_codes, np.int32)
        i = column(rec.i_codes, np.int32)
        v = column(rec.values, np.float64)
        t = column(rec.times, np.int64)
        user_ids = ids(rec.user_arena, rec.user_offs, rec.n_users)
        item_ids = ids(rec.item_arena, rec.item_offs, rec.n_items)
    finally:
        lib.pio_scan_ratings_free(res)
    return u, i, v, t, user_ids, item_ids
