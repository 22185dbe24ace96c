"""The port's group-commit ingest WAL against the JAX package's, on the
CPU: acknowledged rows reach the store after ``barrier``; every group is
fsynced before its ``submit`` returns (the ack); rows logged
but never drained (``close(drain=False)``, the crash) replay into the
reference's rows from either package's ``replay_wal_dir``; a torn tail is
dropped; concurrent submitters all land; a broken log fails stop; a
store of more than one shard is routed by the reference's entity hash."""

import sys
import threading

import pytest

from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as JaxSQLiteEventStore,
)
from predictionio_tpu.storage.wal import (
    GroupCommitWAL as JaxGroupCommitWAL,
    replay_wal_dir as jax_replay_wal_dir,
)
from predictionio_tpu_torch.storage import (
    SQLiteEventStore,
    ShardUnavailableError,
)
from predictionio_tpu_torch.storage.wal import (
    GroupCommitWAL,
    read_records,
    replay_wal_dir,
)


def _row(k: int) -> tuple:
    return (f"ev{k:05d}", "rate", "user", f"u{k % 13}", "item",
            f"i{k % 29}", '{"rating":%d}' % (k % 5 + 1), 1_600_000_000_000 + k,
            "[]", None, 1_600_000_000_000)


def _rows(store) -> list:
    return sorted(store.iter_raw_rows(1))


def _store(cls, path):
    s = cls(path)
    s.init_channel(1)
    return s


def test_submit_barrier_rows_as_reference(tmp_path):
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    jes = _store(JaxSQLiteEventStore, tmp_path / "j.db")
    wal = GroupCommitWAL(es, tmp_path / "pwal")
    jwal = JaxGroupCommitWAL(jes, tmp_path / "jwal")
    try:
        for w in (wal, jwal):
            for s in range(0, 120, 40):
                w.submit(1, 0, [_row(k) for k in range(s, s + 40)])
            w.barrier()
        assert _rows(es) == _rows(jes) == [_row(k) for k in range(120)]
        assert wal.pending_rows() == 0
    finally:
        wal.close()
        jwal.close()


@pytest.mark.parametrize("replay", ["port", "reference"])
def test_undrained_rows_replay_into_the_references_rows(tmp_path, replay):
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    # a long accumulation window: the rows are logged, not yet drained
    wal = GroupCommitWAL(es, tmp_path / "wal", commit_interval_s=30.0)
    for s in range(0, 90, 30):
        wal.submit(1, 0, [_row(k) for k in range(s, s + 30)])
    wal.close(drain=False)
    records, _, torn = read_records(tmp_path / "wal" / "shard-0.wal")
    assert len(records) == 90 and not torn
    fresh = _store(SQLiteEventStore, tmp_path / "q.db")
    jes = _store(JaxSQLiteEventStore, tmp_path / "j.db")
    jax_replay_wal_dir(tmp_path / "wal", jes, truncate=False)
    fn = replay_wal_dir if replay == "port" else jax_replay_wal_dir
    report = fn(tmp_path / "wal", fresh)
    assert report["replayed"] == 90 and report["torn_shards"] == []
    assert _rows(fresh) == _rows(jes) == [_row(k) for k in range(90)]
    # replay truncated the log: a restart replays nothing twice
    assert read_records(tmp_path / "wal" / "shard-0.wal")[0] == []


def test_every_acknowledged_group_is_fsynced(tmp_path, monkeypatch):
    import predictionio_tpu_torch.storage.wal as wal_mod

    synced = []
    real_fsync = wal_mod.os.fsync
    monkeypatch.setattr(wal_mod.os, "fsync",
                        lambda fd: (synced.append(fd), real_fsync(fd)))
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    wal = GroupCommitWAL(es, tmp_path / "wal", commit_interval_s=30.0)
    try:
        for s in range(3):
            before = len(synced)
            wal.submit(1, 0, [_row(k) for k in range(10 * s, 10 * s + 10)])
            # the ack (submit returning) comes after the log's fsync
            assert len(synced) > before
    finally:
        wal.close(drain=False)
    assert len(read_records(tmp_path / "wal" / "shard-0.wal")[0]) == 30


def test_torn_tail_is_dropped_on_replay(tmp_path):
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    wal = GroupCommitWAL(es, tmp_path / "wal", commit_interval_s=30.0)
    wal.submit(1, 0, [_row(k) for k in range(10)])
    wal.close(drain=False)
    log = tmp_path / "wal" / "shard-0.wal"
    data = log.read_bytes()
    log.write_bytes(data + data[:37])         # a crash mid-append
    fresh = _store(SQLiteEventStore, tmp_path / "q.db")
    report = replay_wal_dir(tmp_path / "wal", fresh)
    assert report == {"replayed": 10, "torn_shards": [0], "shards": [0]}
    assert _rows(fresh) == [_row(k) for k in range(10)]


def test_concurrent_submitters_all_land(tmp_path):
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    wal = GroupCommitWAL(es, tmp_path / "wal")
    errors = []

    def post(t: int) -> None:
        try:
            for b in range(10):
                base = (t * 10 + b) * 5
                wal.submit(1, 0, [_row(k) for k in range(base, base + 5)])
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=post, args=(t,))
                   for t in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    wal.barrier()
    assert _rows(es) == [_row(k) for k in range(800)]
    wal.close()


def test_broken_log_fails_stop_and_multi_shard_needs_routing(tmp_path):
    es = _store(SQLiteEventStore, tmp_path / "p.db")
    wal = GroupCommitWAL(es, tmp_path / "wal")
    wal._wals[0].broken = "OSError: disk full"
    with pytest.raises(ShardUnavailableError, match="disk full"):
        wal.submit(1, 0, [_row(0)])
    wal.close()

    class TwoShards(SQLiteEventStore):
        n_shards = 2

    # a store of more than one shard is routed by the sharded store's
    # own entity hash, as in the reference
    from predictionio_tpu.storage.sharded_events import _shard_ix

    wal = GroupCommitWAL(TwoShards(tmp_path / "s.db"), tmp_path / "wal2")
    users = [f"u{k}" for k in range(20)]
    assert [wal.route("user", u) for u in users] == [
        _shard_ix("user", u, 2) for u in users]
    assert {wal.route("user", u) for u in users} == {0, 1}
    wal.close()
