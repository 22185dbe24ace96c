"""The port's sessions package and nextitem's scan against the reference.

The same seeded streams go through ``predictionio_tpu.sessions`` and
``predictionio_tpu_torch.sessions``: the sessionizer's transitions,
carry state and docs are equal; the transition store's weights, CSR
arrays and reference epoch are equal bit for bit (both add the same
float64 terms in the same order), through compaction and rebase; docs
load across the two packages; ``scan_transitions`` over one event file
(and one 4-shard store) gives both packages the same store, and a
replay from a saved cursor or a restored carry adds nothing.
Tolerance: none (bitwise), except where a test says otherwise.
"""

from __future__ import annotations

import datetime as dt
import json
import types

import numpy as np
import pytest

from predictionio_tpu import sessions as ref_sessions
from predictionio_tpu.storage import (
    ShardedSQLiteEventStore as RefShardedStore,
)
from predictionio_tpu.storage.sqlite_events import (
    SQLiteEventStore as RefSQLiteStore,
)
from predictionio_tpu.templates import nextitem as ref_nextitem
from predictionio_tpu_torch import sessions
from predictionio_tpu_torch.sessions import store as store_mod
from predictionio_tpu_torch.storage import (
    Event,
    ShardedSQLiteEventStore,
    SQLiteEventStore,
)
from predictionio_tpu_torch.templates import nextitem

UTC = dt.timezone.utc
BASE = dt.datetime(2026, 4, 1, tzinfo=UTC)


def _stream(seed: int, n: int = 400, users: int = 9, items: int = 14,
            gap: float = 30.0):
    """(user, item, ts) triples: steps of 0 to 2 gaps (so some land
    exactly on the gap), a few steps back in time, repeated items."""
    rng = np.random.default_rng(seed)
    t = 1_000.0
    out = []
    for _ in range(n):
        t += float(rng.choice([0.0, 1.0, gap, gap + 0.5, 2 * gap, -5.0]))
        out.append((f"u{int(rng.integers(0, users))}",
                    f"i{int(rng.integers(0, items))}", t))
    return out


def _transitions(seed: int, n: int = 500, items: int = 20,
                 span: float = 5_000.0):
    rng = np.random.default_rng(seed)
    return [(f"i{int(rng.integers(0, items))}",
             f"i{int(rng.integers(0, items))}",
             float(rng.uniform(0.0, span))) for _ in range(n)]


def _same_store(first, *others) -> None:
    """Stores (either package) equal bit for bit: their pending overlays,
    then their docs (``to_doc`` compacts)."""
    for o in others:
        assert o._pending == first._pending
    doc = json.dumps(first.to_doc())
    for o in others:
        assert json.dumps(o.to_doc()) == doc


def test_sessionizer_equals_the_references():
    s, r = sessions.Sessionizer(gap_s=30.0), ref_sessions.Sessionizer(
        gap_s=30.0)
    stream = _stream(0)
    got = [s.feed(*e) for e in stream]
    assert got == [r.feed(*e) for e in stream]
    assert sum(t is not None for t in got) > 50
    assert s.to_doc() == r.to_doc()
    assert len(s) == len(r)
    assert [s.last_item(f"u{k}") for k in range(10)] == [
        r.last_item(f"u{k}") for k in range(10)]
    with pytest.raises(ValueError):
        sessions.Sessionizer(gap_s=0.0)


def test_the_gap_is_exact_and_a_self_loop_adds_nothing():
    s = sessions.Sessionizer(gap_s=10.0)
    assert s.feed("u", "a", 100.0) is None
    assert s.feed("u", "b", 110.0) == ("a", "b")     # at the gap: continues
    assert s.feed("u", "b", 119.0) is None           # self-loop
    assert s.feed("u", "c", 129.0) == ("b", "c")     # its clock moved to 119
    assert s.feed("u", "d", 139.1) is None           # past the gap
    assert s.feed("u", "e", 130.0) == ("d", "e")     # back in time, in-gap
    assert s.feed("u", "f", 149.2) is None           # the clock held at 139.1


def test_sessionizer_docs_load_across_packages():
    stream = _stream(1)
    head, tail = stream[:250], stream[250:]
    s = sessions.Sessionizer(gap_s=30.0)
    r = ref_sessions.Sessionizer(gap_s=30.0)
    for e in head:
        s.feed(*e)
        r.feed(*e)
    s2 = sessions.Sessionizer.from_doc(json.loads(json.dumps(r.to_doc())))
    r2 = ref_sessions.Sessionizer.from_doc(json.loads(json.dumps(s.to_doc())))
    assert s2.gap_s == 30.0
    assert [s2.feed(*e) for e in tail] == [r2.feed(*e) for e in tail]
    assert s2.to_doc() == r2.to_doc()


def test_sessionize_equals_the_references():
    stream = _stream(2, n=300)
    got = sessions.sessionize(stream, gap_s=30.0)
    assert got == ref_sessions.sessionize(stream, gap_s=30.0)
    assert all(a != b for sess in got for a, b in zip(sess, sess[1:]))
    assert sessions.sessionize(
        [("u", "a", 0.0), ("u", "b", 5.0), ("u", "b", 6.0),
         ("u", "c", 100.0)], gap_s=10.0) == [["a", "b"], ["c"]]


@pytest.mark.parametrize("pending_limit", [4096, 7])
def test_transition_weights_equal_the_references_bitwise(pending_limit):
    """Many adds in a few calls; a small pending limit compacts between
    calls.  Weights and scores at a pinned ``now`` agree bit for bit."""
    trans = _transitions(3)
    st = sessions.TransitionStore(half_life_s=900.0, t0=2_000.0,
                                  pending_limit=pending_limit)
    rf = ref_sessions.TransitionStore(half_life_s=900.0, t0=2_000.0,
                                      pending_limit=pending_limit)
    for c in range(0, len(trans), 60):
        assert st.add_many(trans[c:c + 60]) == rf.add_many(trans[c:c + 60])
    assert st.compactions == rf.compactions
    assert (st.compactions > 0) == (pending_limit < 100)
    now = 6_000.0
    for src in ("i0", "i3", "i7", "i19", "missing"):
        assert st.top_successors(src, 5, now=now) == rf.top_successors(
            src, 5, now=now)
        assert st.top_successors(src, 8, blacklist={"i1", "i2"}, now=now) \
            == rf.top_successors(src, 8, blacklist={"i1", "i2"}, now=now)
        assert st.weight(src, "i5", now=now) == rf.weight(src, "i5", now=now)
    assert st.n_pairs == rf.n_pairs and st.n_items == rf.n_items
    _same_store(st, rf)


def test_rebase_equals_the_references_and_keeps_the_ranking():
    """A 1 s half-life and events 70 s after ``t0``: weights pass 2**60,
    the epoch rebases (by the weights, not the clock) in both."""
    trans = [("a", "b", 70.0), ("a", "b", 70.0), ("a", "c", 69.0),
             ("a", "d", 50.0), ("b", "a", 65.0)]
    st = sessions.TransitionStore(half_life_s=1.0, t0=0.0, pending_limit=2)
    rf = ref_sessions.TransitionStore(half_life_s=1.0, t0=0.0,
                                      pending_limit=2)
    st.add_many(trans)
    rf.add_many(trans)
    assert st.t0 == rf.t0 and st.t0 > 0.0
    assert st._max_w == rf._max_w and st._max_w <= 2.0 ** 61
    top = st.top_successors("a", 10, now=70.0)
    assert [i for i, _ in top] == ["b", "c", "d"]
    assert dict(top)["b"] == pytest.approx(2.0, rel=1e-9)
    assert top == rf.top_successors("a", 10, now=70.0)
    st.compact()
    rf.compact()
    _same_store(st, rf)
    assert [i for i, _ in st.top_successors("a", 10, now=70.0)] == [
        "b", "c", "d"]


def test_store_docs_load_across_packages_and_the_clock_is_pinned(
        monkeypatch):
    """No ``t0`` given: the store takes the clock, which the test pins in
    both packages' modules; ``top_successors`` with no ``now`` scales by
    the same pinned clock."""
    clock = types.SimpleNamespace(time=lambda: 5_000.0)
    monkeypatch.setattr(store_mod, "time", clock)
    monkeypatch.setattr(ref_sessions.store, "time", clock)
    st, rf = sessions.TransitionStore(half_life_s=600.0), \
        ref_sessions.TransitionStore(half_life_s=600.0)
    assert st.t0 == rf.t0 == 5_000.0
    trans = _transitions(4, n=120, span=5_000.0)
    st.add_many(trans)
    rf.add_many(trans)
    mine = ref_sessions.TransitionStore.from_doc(
        json.loads(json.dumps(st.to_doc())))
    theirs = sessions.TransitionStore.from_doc(
        json.loads(json.dumps(rf.to_doc())))
    for a, b in ((mine, rf), (theirs, st)):
        _same_store(a, b)
        assert a.transitions_folded == 120
        assert a.top_successors("i1", 4) == b.top_successors("i1", 4)
    with pytest.raises(ValueError):
        sessions.TransitionStore(half_life_s=0.0)


def _views(stream) -> list:
    return [Event(event="view", entity_type="user", entity_id=u,
                  target_entity_type="item", target_entity_id=i,
                  event_time=BASE + dt.timedelta(seconds=t))
            for u, i, t in stream]


def _scan_both(es, ref_es, cursor=0, page=50_000, carry=None):
    """``scan_transitions`` of each package on its own store object over
    the same files, from the same cursor and carry."""
    out = []
    for mod, pkg, store in ((nextitem, sessions, es),
                            (ref_nextitem, ref_sessions, ref_es)):
        sz = pkg.Sessionizer.from_doc(carry) if carry else \
            pkg.Sessionizer(gap_s=30.0)
        ts = pkg.TransitionStore(half_life_s=3_600.0,
                                 t0=BASE.timestamp())
        got = mod.scan_transitions(store, 1, 0, cursor, ("view",), sz, ts,
                                   page=page)
        out.append((got, sz, ts))
    return out


@pytest.mark.parametrize("page", [50_000, 37])
def test_scan_transitions_equals_the_references(tmp_path, page):
    es = SQLiteEventStore(tmp_path / "e.db")
    es.init_channel(1)
    es.insert_batch(_views(_stream(5, n=300)), app_id=1)
    (got, sz, ts), (want, rsz, rts) = _scan_both(
        es, RefSQLiteStore(tmp_path / "e.db"), page=page)
    assert got == want and got[1] == 300 and got[2] > 30
    assert sz.to_doc() == rsz.to_doc()
    _same_store(ts, rts)


def test_the_parallel_sharded_scan_equals_the_paged_scan_and_the_reference(
        tmp_path):
    es = ShardedSQLiteEventStore(tmp_path / "sh", n_shards=4)
    es.init_channel(1)
    es.insert_batch(_views(_stream(6, n=300)), app_id=1)
    assert es.supports_parallel_scan is True

    class Paged:
        """The sharded store without its parallel scan."""

        def find_rows_since(self, *a, **kw):
            kw.pop("parallel", None)
            return es.find_rows_since(*a, **kw)

    (par, sz, ts), (want, rsz, rts) = _scan_both(
        es, RefShardedStore(tmp_path / "sh", n_shards=4))
    (paged, psz, pts), _ = _scan_both(Paged(), RefShardedStore(
        tmp_path / "sh", n_shards=4), page=1_000)
    assert par == want == paged
    _same_store(ts, rts, pts)
    assert sz.to_doc() == rsz.to_doc() == psz.to_doc()


def test_a_replay_adds_nothing_and_a_session_spans_two_scans(tmp_path):
    """Rows past the saved cursor fold in exactly once, through the live
    carry and through a carry saved and loaded (in either package); a
    session whose first half was in the first scan gives its spanning
    transition in the second."""
    es = SQLiteEventStore(tmp_path / "e.db")
    es.init_channel(1)
    es.insert_batch(_views([("u0", "a", 0.0), ("u0", "b", 5.0),
                            ("u1", "a", 1.0)]), app_id=1)
    (got, sz, ts), (_, rsz, rts) = _scan_both(
        es, RefSQLiteStore(tmp_path / "e.db"))
    cursor = got[0]
    assert got[1:] == (3, 1)
    again = nextitem.scan_transitions(es, 1, 0, cursor, ("view",), sz, ts)
    assert again == (cursor, 0, 0) and ts.transitions_folded == 1
    es.insert_batch(_views([("u0", "c", 9.0), ("u1", "c", 4.0)]), app_id=1)
    carry = sz.to_doc()
    (tail, tsz, tts), (rtail, rtsz, rtts) = _scan_both(
        es, RefSQLiteStore(tmp_path / "e.db"), cursor=cursor,
        carry=rsz.to_doc())
    live = nextitem.scan_transitions(es, 1, 0, cursor, ("view",), sz, ts)
    assert tail == rtail == live and live[1:] == (2, 2)
    assert ts.weight("b", "c", now=BASE.timestamp()) == 2.0 ** (9.0 / 3_600)
    assert tts.weight("a", "c", now=BASE.timestamp()) == \
        rtts.weight("a", "c", now=BASE.timestamp())
    assert tsz.to_doc() == rtsz.to_doc() == sz.to_doc()
    assert carry != sz.to_doc()
