"""The JSON-lines import of a sharded event store, one process a shard.

Building each event's storage row is Python work under the GIL, so an
import in one process is bound by one core.  Here the importer scans
the file natively, routes every line by the store's rule
(``crc32(entity type \\0 entity id) % shards``, over the scanned bytes
of every line at once; a line the scanner flags is parsed to be routed)
and streams each shard's lines, in file order, to a worker
process of its own (``python -m predictionio_tpu_torch.tools.
shard_import``).  The worker imports them into its shard file as the
one-process import does, inside one transaction, so a shard stores the
rows and rowids one writer would.

The commit is two-phase over the workers' pipes: once its lines end, a
worker writes a ``{"ready": ...}`` line with every row in its open
transaction and waits; when every worker is ready the importer sends
each ``commit``, and any failure (a worker's, or the importer's own,
such as a line no importer can read) closes the rest's input, which
rolls them back.  The shards then commit at once, each rebuilding its
secondary indexes on its own core.  A commit that fails after another
shard committed leaves that shard's rows, as the one-process scope's
shard-by-shard commit does.
"""

from __future__ import annotations

import json
import os
import struct
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from ..native import F_ENTITY_ID, F_ENTITY_TYPE, scan_events_jsonl
from ..storage.event import Event
from ..storage.sharded_events import _shard_ix

__all__ = ["import_by_shard", "shard_of_lines"]

# the package root, put on the workers' PYTHONPATH
_ROOT = Path(__file__).resolve().parents[2]
# a frame on a worker's input: its length, then its bytes; an empty
# frame ends the lines
_LEN = struct.Struct("<Q")


def _crc32_table() -> np.ndarray:
    """zlib's CRC-32 byte table (reflected polynomial 0xEDB88320)."""
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0xEDB88320), t >> 1)
    return t.astype(np.uint32)


_CRC32 = _crc32_table()


def shard_of_lines(data: bytes, scan, n_shards: int) -> np.ndarray:
    """The shard of every line of one scanned block: the store's rule
    over the scanned bytes of each natively scanned line (the scanner
    passes only unescaped UTF-8: the bytes the rule encodes), computed
    for all of them at once; a flagged line is parsed as the importer
    parses it, and its parse error raised."""
    n, foff, flen, _, _, loff, llen, status = scan
    buf = np.frombuffer(data, np.uint8)
    crc = np.full(n, 0xFFFFFFFF, np.uint32)
    for f in (F_ENTITY_TYPE, None, F_ENTITY_ID):
        if f is None:  # the separator byte, 0
            crc = _CRC32[crc & 0xFF] ^ (crc >> 8)
            continue
        off, ln = foff[:, f], flen[:, f]
        for j in range(int(ln.max(initial=0))):
            live = j < ln
            b = buf[np.where(live, off + j, 0)]
            crc = np.where(live, _CRC32[(crc ^ b) & 0xFF] ^ (crc >> 8), crc)
    out = ((crc ^ np.uint32(0xFFFFFFFF)) % n_shards).astype(np.int64)
    for k in np.flatnonzero(status):
        e = Event.from_json(json.loads(
            data[loff[k]: loff[k] + llen[k]].decode()))
        out[k] = _shard_ix(e.entity_type, e.entity_id, n_shards)
    return out


def _spawn(spec: dict, log) -> subprocess.Popen:
    env = {**os.environ,
           "PYTHONPATH": os.pathsep.join(
               [str(_ROOT), *filter(None, [os.environ.get("PYTHONPATH")])])}
    # the importer consults the fault plan for the shards; a worker that
    # armed it again would inject the same faults twice
    env.pop("PIO_FAULT_PLAN", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "predictionio_tpu_torch.tools.shard_import"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log, env=env)
    proc.stdin.write(json.dumps(spec).encode() + b"\n")
    return proc


def _send(proc: subprocess.Popen, payload: bytes) -> None:
    proc.stdin.write(_LEN.pack(len(payload)))
    proc.stdin.write(payload)


def _close(proc: subprocess.Popen) -> None:
    try:
        proc.stdin.close()
    except OSError:
        pass  # the worker is gone


def _failure(i: int, proc: subprocess.Popen, got: dict, log) -> str:
    proc.wait()
    log.seek(0)
    tail = log.read()[-4000:].strip()
    return (f"the import of shard {i} failed (exit {proc.returncode}): "
            f"{got.get('error') or tail}")


def _reply(i: int, proc: subprocess.Popen, key: str, log) -> dict:
    line = proc.stdout.readline()
    got = json.loads(line) if line.startswith(b"{") else {}
    if key not in got:
        raise RuntimeError(_failure(i, proc, got, log))
    return got


def import_by_shard(path, store, files: list, app_id: int, channel_id: int,
                    now_ms: int, tally: dict) -> int:
    """Import the JSON-lines file at ``path`` into the sharded ``store``
    whose shard files are ``files``, one worker process a file; returns
    the number of events.  ``tally`` gains the workers' native and
    Python counts, and the store books each shard's rows and seconds.
    A worker's failure raises ``RuntimeError`` naming its shard; the
    importer's own (a line no importer can read) raises as the
    one-process import does.  Either way every shard rolls back."""
    from .import_export import _line_blocks

    n = len(files)
    logs = [tempfile.TemporaryFile("w+") for _ in files]
    procs = []
    try:
        for i, f in enumerate(files):
            procs.append(_spawn({
                "shard_file": str(f), "app_id": app_id,
                "channel_id": channel_id, "now_ms": now_ms,
            }, logs[i]))
        with open(path, "rb") as fh:
            for data in _line_blocks(fh):
                scan = scan_events_jsonl(data)
                shard = shard_of_lines(data, scan, n)
                start = scan[5].tolist()
                end = (scan[5] + scan[6]).tolist()
                for i, proc in enumerate(procs):
                    lines = np.flatnonzero(shard == i).tolist()
                    if lines:
                        _send(proc, b"\n".join([
                            data[start[k]:end[k]] for k in lines]) + b"\n")
        for proc in procs:
            _send(proc, b"")
            proc.stdin.flush()
        ready = [_reply(i, p, "ready", logs[i])["ready"]
                 for i, p in enumerate(procs)]
        for proc in procs:
            _send(proc, b"commit")
            _close(proc)
        for i, proc in enumerate(procs):
            _reply(i, proc, "done", logs[i])
            if proc.wait() != 0:
                raise RuntimeError(_failure(i, proc, {}, logs[i]))
    except BrokenPipeError:
        # a worker died mid-stream: name it
        bad = next((i for i, p in enumerate(procs)
                    if p.poll() is not None), 0)
        raise RuntimeError(_failure(bad, procs[bad], {}, logs[bad])) \
            from None
    finally:
        for proc in procs:
            _close(proc)  # rolls back a worker not yet told to commit
        for proc in procs:
            proc.wait()
            proc.stdout.close()
        for log in logs:
            log.close()
    for i, r in enumerate(ready):
        store.book_import(i, r["rows"], r["seconds"])
        tally["native"] += r["native"]
        tally["python"] += r["python"]
    return sum(r["rows"] for r in ready)


def _frames(stream):
    """The payloads of ``stream``'s frames up to the empty one."""
    while True:
        head = stream.read(_LEN.size)
        if len(head) < _LEN.size:
            raise EOFError("the importer went away")
        (size,) = _LEN.unpack(head)
        if not size:
            return
        yield stream.read(size)


def _worker() -> int:
    """One shard's import: the spec line, the lines' frames and an
    empty frame on stdin, a ready line, then ``commit`` (anything else
    rolls back)."""
    from ..storage.sqlite_events import SQLiteEventStore
    from .import_export import insert_jsonl

    stdin = sys.stdin.buffer
    spec = json.loads(stdin.readline())
    store = SQLiteEventStore(spec["shard_file"])
    tally = {"native": 0, "python": 0}
    try:
        with store.bulk():
            t0 = time.perf_counter()
            rows = insert_jsonl(_frames(stdin), store, spec["app_id"],
                                spec["channel_id"], spec["now_ms"], tally)
            print(json.dumps({"ready": {
                "rows": rows, "seconds": time.perf_counter() - t0,
                **tally}}), flush=True)
            # the verdict: a commit frame; a closed input rolls back
            if next(_frames(stdin), b"") != b"commit":
                raise EOFError("rolled back")
    except EOFError:
        return 1
    except Exception as e:
        print(json.dumps({"error": f"{type(e).__name__}: {e}"}), flush=True)
        return 1
    finally:
        store.close()
    print(json.dumps({"done": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_worker())
