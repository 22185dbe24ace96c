"""The port's event store against the JAX package's, on the CPU.

The same seeded events go into both packages' SQLite stores; the
recommendation data sources then read the same ``Ratings`` (id lists and
COO arrays, bitwise).  The two packages share one on-disk layout: the
port reads a ``$PIO_TPU_HOME`` (``eventdata.db``, ``metadata.db``) that
the JAX package wrote, and the other way round.  Property folding
(``$set``/``$unset``/``$delete``), the scan filters and event validation
give the reference's results.
"""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.controller import (
    WorkflowContext as JaxContext,
    instantiate as jax_instantiate,
)
from predictionio_tpu.storage import (
    AccessKey as JaxAccessKey,
    Event as JaxEvent,
    EventValidationError as JaxValidationError,
    NO_TARGET as JAX_NO_TARGET,
    Storage as JaxStorage,
    validate_event as jax_validate,
)
from predictionio_tpu.templates.recommendation import (
    DataSourceParams as JaxDataSourceParams,
    RecommendationDataSource as JaxDataSource,
)
from predictionio_tpu_torch.controller import WorkflowContext, instantiate
from predictionio_tpu_torch.storage import (
    NO_TARGET,
    Event,
    EventValidationError,
    MemoryEventStore,
    Storage,
    validate_event,
)
from predictionio_tpu_torch.templates.recommendation import (
    DataSourceParams,
    RecommendationDataSource,
)

T0 = dt.datetime(2024, 3, 1, tzinfo=dt.timezone.utc)


def _event_specs(seed: int = 0, n: int = 400) -> list[dict]:
    """Seeded events as keyword dicts: rate events with repeated
    (user, item) pairs at later times, rates without a rating, rates of
    another entity type, view events, and item ``$set``/``$unset``/
    ``$delete`` events; every event has its own id and time."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        kind = rng.random()
        spec = dict(event_id=f"e{k:05d}",
                    event_time=T0 + dt.timedelta(milliseconds=int(7 * k)))
        if kind < 0.75:
            props = {"rating": float(rng.integers(1, 11) * 0.5)}
            if rng.random() < 0.03:
                props = {"note": "no rating"}
            spec.update(event="rate",
                        entity_type="admin" if rng.random() < 0.05 else "user",
                        entity_id=f"u{rng.integers(0, 30)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(0, 20)}",
                        properties=props)
        elif kind < 0.85:
            spec.update(event="view", entity_type="user",
                        entity_id=f"u{rng.integers(0, 30)}",
                        target_entity_type="item",
                        target_entity_id=f"i{rng.integers(0, 20)}")
        else:
            j = int(rng.integers(0, 12))
            op = ("$set", "$set", "$unset", "$delete")[int(rng.integers(0, 4))]
            props = {}
            if op == "$set":
                props = {"categories": [f"c{int(rng.integers(0, 3))}"],
                         "price": float(rng.integers(1, 100))}
            elif op == "$unset":
                props = {"price": None}
            spec.update(event=op, entity_type="item", entity_id=f"i{j}",
                        properties=props)
        out.append(spec)
    return out


def _fill(store, event_cls, specs, app_id=1, channel_id=0):
    store.init_channel(app_id, channel_id)
    with store.bulk():
        store.insert_batch([event_cls(**s) for s in specs], app_id,
                           channel_id)


def _storages(tmp_path):
    port = Storage({"PIO_TPU_HOME": str(tmp_path / "port")})
    jax = JaxStorage({"PIO_TPU_HOME": str(tmp_path / "jax")})
    return port, jax


def _same_ratings(a, b) -> None:
    assert list(a.users.ids) == list(b.users.ids)
    assert list(a.items.ids) == list(b.items.ids)
    for f in ("user_ix", "item_ix", "rating"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        assert x.tobytes() == y.tobytes(), f


def _read_both(port, jax, **params):
    pds = instantiate(RecommendationDataSource,
                      DataSourceParams(app_name="shop", **params))
    jds = jax_instantiate(JaxDataSource,
                          JaxDataSourceParams(app_name="shop", **params))
    got = pds.read_training(WorkflowContext(device="cpu", storage=port))
    want = jds.read_training(JaxContext(storage=jax))
    return got, want


@pytest.mark.parametrize("rating_property", ["rating", None])
def test_read_training_gives_the_references_ratings(tmp_path,
                                                    rating_property):
    """Explicit ratings (``dedup="last"``) and the implicit count mode
    (``rating_property=None``, ``dedup="sum"``); the item properties
    folded from the same events."""
    port, jax = _storages(tmp_path)
    specs = _event_specs()
    for st, ev in ((port, Event), (jax, JaxEvent)):
        app = st.get_metadata().app_insert("shop")
        _fill(st.get_event_store(), ev, specs, app.id)
    got, want = _read_both(port, jax, rating_property=rating_property)
    assert len(got.ratings) > 100
    _same_ratings(got.ratings, want.ratings)
    assert got.items == want.items


def test_port_reads_a_home_the_jax_package_wrote(tmp_path):
    home = tmp_path / "home"
    jax = JaxStorage({"PIO_TPU_HOME": str(home)})
    jmd = jax.get_metadata()
    app = jmd.app_insert("shop", "a shop")
    key = jmd.access_key_insert(JaxAccessKey("", app.id, ["rate", "view"]))
    chan = jmd.channel_insert("mobile", app.id)
    specs = _event_specs(seed=1)
    _fill(jax.get_event_store(), JaxEvent, specs, app.id)
    _fill(jax.get_event_store(), JaxEvent, specs[:40], app.id, chan.id)
    jax.close()

    port = Storage({"PIO_TPU_HOME": str(home)})
    md = port.get_metadata()
    assert md.app_get_by_name("shop").id == app.id
    assert md.access_key_get(key).events == ["rate", "view"]
    assert [c.name for c in md.channel_get_by_app(app.id)] == ["mobile"]
    es = port.get_event_store()
    jax = JaxStorage({"PIO_TPU_HOME": str(home)})
    jes = jax.get_event_store()
    for channel, n in ((0, len(specs)), (chan.id, 40)):
        got = [e.to_json() for e in es.find(app.id, channel)]
        want = [e.to_json() for e in jes.find(app.id, channel)]
        assert len(got) == n and got == want
    got, want = _read_both(port, jax)
    _same_ratings(got.ratings, want.ratings)
    assert got.items == want.items


def test_jax_package_reads_a_home_the_port_wrote(tmp_path):
    home = tmp_path / "home"
    port = Storage({"PIO_TPU_HOME": str(home)})
    app = port.get_metadata().app_insert("shop")
    specs = _event_specs(seed=2)
    _fill(port.get_event_store(), Event, specs, app.id)
    port.close()
    jax = JaxStorage({"PIO_TPU_HOME": str(home)})
    assert jax.get_metadata().app_get_by_name("shop").id == app.id
    got = [e.to_json() for e in jax.get_event_store().find(app.id)]
    assert [g["eventId"] for g in got] == [s["event_id"] for s in specs]
    port = Storage({"PIO_TPU_HOME": str(home)})
    got, want = _read_both(port, jax)
    _same_ratings(got.ratings, want.ratings)


def test_property_folding_matches_the_reference(tmp_path):
    """``aggregate_properties_of`` and the single-entity fold over the
    same ``$set``/``$unset``/``$delete`` history, in the SQLite and the
    memory stores, against the JAX package's SQLite store."""
    port, jax = _storages(tmp_path)
    specs = _event_specs(seed=3, n=600)
    stores = [port.get_event_store(), MemoryEventStore()]
    for s in stores:
        _fill(s, Event, specs)
    jes = jax.get_event_store()
    _fill(jes, JaxEvent, specs)

    def fold(pm):
        return (dict(pm.fields), pm.first_updated, pm.last_updated)

    want = {k: fold(v) for k, v in
            jes.aggregate_properties_of(1, "item").items()}
    assert 0 < len(want) < 12      # some items were deleted
    for s in stores:
        got = {k: fold(v) for k, v in
               s.aggregate_properties_of(1, "item").items()}
        assert got == want
        for j in range(12):
            a = s.aggregate_properties_single_entity(1, "item", f"i{j}")
            b = jes.aggregate_properties_single_entity(1, "item", f"i{j}")
            assert (a is None and b is None) or fold(a) == fold(b)
    got = port.get_event_store().aggregate_properties_of(
        1, "item", required=["price"])
    assert set(got) == set(jes.aggregate_properties_of(
        1, "item", required=["price"]))


def test_scan_filters_match_the_reference(tmp_path):
    port, jax = _storages(tmp_path)
    specs = _event_specs(seed=4)
    specs += [dict(event_id="x1", event="signup", entity_type="user",
                   entity_id="u1", event_time=T0 + dt.timedelta(days=1))]
    es, jes = port.get_event_store(), jax.get_event_store()
    _fill(es, Event, specs)
    _fill(jes, JaxEvent, specs)
    mem = MemoryEventStore()
    _fill(mem, Event, specs)
    cases = [
        {},
        dict(entity_type="user", entity_id="u3"),
        dict(event_names=["view", "signup"]),
        dict(target_entity_type=NO_TARGET),
        dict(target_entity_id="i4", limit=5),
        dict(start_time=T0 + dt.timedelta(milliseconds=700),
             until_time=T0 + dt.timedelta(milliseconds=1400)),
        dict(event_names=["rate"], reversed=True, limit=30),
    ]
    for kw in cases:
        jkw = {k: (JAX_NO_TARGET if v is NO_TARGET else v)
               for k, v in kw.items()}
        want = [e.event_id for e in jes.find(1, **jkw)]
        assert want, kw
        assert [e.event_id for e in es.find(1, **kw)] == want, kw
        assert [e.event_id for e in mem.find(1, **kw)] == want, kw
    frame = es.find_columnar(1, event_names=["rate"], float_property="rating")
    jframe = jes.find_columnar(1, event_names=["rate"],
                               float_property="rating")
    for f in ("event", "entity_id", "target_entity_id"):
        assert list(getattr(frame, f)) == list(getattr(jframe, f)), f
    np.testing.assert_array_equal(frame.value, jframe.value)
    np.testing.assert_array_equal(frame.event_time_ms, jframe.event_time_ms)


def test_validation_matches_the_reference():
    bad = [
        dict(event="$unset", entity_type="item", entity_id="i1"),
        dict(event="$set", entity_type="item", entity_id="i1",
             target_entity_type="user", target_entity_id="u1"),
        dict(event="rate", entity_type="user", entity_id="u1",
             target_entity_type="item"),
        dict(event="$bogus", entity_type="user", entity_id="u1"),
        dict(event="rate", entity_type="", entity_id="u1"),
        dict(event="rate", entity_type="pio_x", entity_id="u1"),
    ]
    for spec in bad:
        with pytest.raises(JaxValidationError) as want:
            jax_validate(JaxEvent(**spec))
        with pytest.raises(EventValidationError) as got:
            validate_event(Event(**spec))
        assert str(got.value) == str(want.value)
    ok = dict(event="rate", entity_type="user", entity_id="u1",
              target_entity_type="item", target_entity_id="i1",
              properties={"rating": 4.0}, event_time=T0, creation_time=T0)
    validate_event(Event(**ok))
    assert Event(**ok).to_json() == JaxEvent(**ok).to_json()
    assert Event.from_json(JaxEvent(**ok).to_json()).to_json() == \
        JaxEvent(**ok).to_json()


def test_memory_store_reads_the_same_ratings_as_sqlite(tmp_path):
    """The recommendation data source over the memory backend (its
    general columnar path) and over SQLite (``find_ratings``)."""
    specs = _event_specs(seed=5)
    sqlite = Storage({"PIO_TPU_HOME": str(tmp_path / "sqlite")})
    memory = Storage({
        "PIO_STORAGE_REPOSITORIES_EVENTDATA_SOURCE": "MEM",
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "MEM",
        "PIO_STORAGE_SOURCES_MEM_TYPE": "memory",
    })
    out = []
    for st in (sqlite, memory):
        app = st.get_metadata().app_insert("shop")
        _fill(st.get_event_store(), Event, specs, app.id)
        ds = instantiate(RecommendationDataSource,
                         DataSourceParams(app_name="shop"))
        out.append(ds.read_training(WorkflowContext(device="cpu", storage=st)))
    _same_ratings(out[0].ratings, out[1].ratings)
    assert out[0].items == out[1].items
