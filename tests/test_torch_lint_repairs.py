"""The faults the port's analyzer found in the port, each held by a test
that fails without its repair:

* ``obs/timeline.py`` (PIO211): a job on the profiler thread that asked
  for the profiler thread again ran inline while holding the thread's
  lock, so a second level of nesting deadlocked;
* ``storage/sqlite_events.py`` (PIO203): ``bulk`` took the writer lock
  and ran statements before its ``try``, so a failure there left the
  lock held for good;
* ``tenancy/online_eval.py`` (PIO202): ``close`` read the manifest
  without the refresh lock, so a close during the first refresh left
  the manifest that refresh made unfinalized.
"""

from __future__ import annotations

import threading

import pytest

from predictionio_tpu_torch.obs import runlog
from predictionio_tpu_torch.obs import timeline
from predictionio_tpu_torch.storage.sqlite_events import SQLiteEventStore
from predictionio_tpu_torch.tenancy.online_eval import OnlineEval


def test_nested_profiler_jobs_run_off_the_lock(monkeypatch):
    import atexit

    # this instance's thread is stopped here, not at interpreter exit
    monkeypatch.setattr(atexit, "register", lambda fn: fn)
    pt = timeline._ProfilerThread()
    out = {}

    def ask():
        out["locked"] = pt.call(lambda: pt.call(
            lambda: pt.call(pt._lock.locked)))

    asker = threading.Thread(target=ask, daemon=True)
    asker.start()
    asker.join(10)
    try:
        assert out == {"locked": False}
        # another thread's job still runs on the one profiler thread
        assert pt.call(threading.current_thread) is pt._thread
    finally:
        if not asker.is_alive():
            pt.stop()


def test_a_failed_bulk_scope_start_releases_the_writer_lock(tmp_path,
                                                            monkeypatch):
    es = SQLiteEventStore(tmp_path / "events.db")
    depth = SQLiteEventStore._bulk_depth
    reads = []

    def failing_second_read(self):
        reads.append(1)
        if len(reads) == 2:
            raise RuntimeError("injected between acquire and scope")
        return depth.fget(self)

    monkeypatch.setattr(SQLiteEventStore, "_bulk_depth",
                        property(failing_second_read))
    with pytest.raises(RuntimeError, match="injected"):
        with es.bulk():
            pass
    monkeypatch.undo()
    got = []

    def writer_takes_the_lock():
        got.append(es._lock.acquire(timeout=2))
        if got[-1]:
            es._lock.release()

    other = threading.Thread(target=writer_takes_the_lock)
    other.start()
    other.join(10)
    assert not other.is_alive() and got == [True]
    with es.bulk():
        pass
    es.close()


def test_close_during_the_first_refresh_finalizes_its_manifest(
        tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_RUNLOG_DIR", str(tmp_path))
    ev = OnlineEval(manifest_id="hive-race")
    entered, gate = threading.Event(), threading.Event()
    make = ev._ensure_manifest

    def slow_first_manifest():
        entered.set()
        gate.wait(10)
        return make()

    ev._ensure_manifest = slow_first_manifest
    refresher = threading.Thread(target=ev.refresh, args=(object(), {}))
    refresher.start()
    assert entered.wait(10)
    closer = threading.Thread(target=ev.close)
    closer.start()
    closer.join(0.3)
    gate.set()
    refresher.join(10)
    closer.join(10)
    assert not refresher.is_alive() and not closer.is_alive()
    view = runlog.read_manifest(tmp_path / "hive-race")
    assert view["final"] is not None
    assert view["final"]["status"] == "completed"
    assert view["final"]["refreshes"] == 1
