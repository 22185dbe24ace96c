"""The port's engine-facing store facades (``PEventStore``,
``LEventStore``, ``app_name_to_id``) and the deprecated batch views
against the JAX package's, on the CPU: the same seeded events in each
package's store give the same frames, property snapshots, entity scans,
view folds and errors."""

import datetime as dt

import numpy as np
import pytest

from predictionio_tpu.storage import (
    Event as JaxEvent,
    LEventStore as JaxLEventStore,
    PEventStore as JaxPEventStore,
    Storage as JaxStorage,
    app_name_to_id as jax_app_name_to_id,
)
from predictionio_tpu.storage.views import (
    BatchView as JaxBatchView,
    LBatchView as JaxLBatchView,
)
from predictionio_tpu_torch.storage import (
    Event,
    LEventStore,
    PEventStore,
    Storage,
    app_name_to_id,
)
from predictionio_tpu_torch.storage.views import BatchView, PBatchView

T0 = dt.datetime(2021, 6, 1, tzinfo=dt.timezone.utc)


def _specs(seed: int = 2, n: int = 300) -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        t = T0 + dt.timedelta(minutes=int(rng.integers(0, 5000)))
        r = rng.random()
        if r < 0.6:
            out.append(dict(
                event=("view", "buy", "rate")[k % 3], entity_type="user",
                entity_id=f"u{int(rng.integers(0, 8))}",
                target_entity_type="item",
                target_entity_id=f"i{int(rng.integers(0, 10))}",
                properties={"rating": float(k % 5)} if k % 3 == 2 else {},
                event_time=t, event_id=f"e{k}"))
        else:
            op = ("$set", "$set", "$unset", "$delete")[k % 4]
            props = {}
            if op == "$set":
                props = {"category": f"c{k % 3}", "price": k}
            elif op == "$unset":
                props = {"price": None}
            out.append(dict(event=op, entity_type="item",
                            entity_id=f"i{int(rng.integers(0, 10))}",
                            properties=props, event_time=t,
                            event_id=f"e{k}"))
    return out


@pytest.fixture()
def both(tmp_path):
    out = []
    for name, st_cls, ev_cls in (("port", Storage, Event),
                                 ("jax", JaxStorage, JaxEvent)):
        st = st_cls({"PIO_TPU_HOME": str(tmp_path / name)})
        md = st.get_metadata()
        app = md.app_insert("shop")
        ch = md.channel_insert("mobile", app.id)
        es = st.get_event_store()
        for cid in (0, ch.id):
            es.init_channel(app.id, cid)
            es.insert_batch([ev_cls(creation_time=T0, **s)
                             for s in _specs(seed=cid)], app.id, cid)
        out.append(st)
    return out


def _frames_equal(a, b) -> None:
    for f in ("event", "entity_type", "entity_id", "target_entity_type",
              "target_entity_id", "event_time_ms"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f


def _events(evs) -> list:
    return [e.to_json() for e in evs]


@pytest.mark.parametrize("kw", [
    dict(),
    dict(channel_name="mobile", entity_type="user", event_names=["buy"]),
    dict(start_time=T0 + dt.timedelta(days=1),
         until_time=T0 + dt.timedelta(days=3), target_entity_id="i3"),
])
def test_pevent_store_find(both, kw):
    port, jax = both
    got = PEventStore(port).find("shop", **kw)
    want = JaxPEventStore(jax).find("shop", **kw)
    assert len(got) > 0
    _frames_equal(got, want)


def test_pevent_store_aggregate_properties(both):
    port, jax = both
    for kw in (dict(), dict(required=["category"]),
               dict(channel_name="mobile")):
        got = PEventStore(port).aggregate_properties("shop", "item", **kw)
        want = JaxPEventStore(jax).aggregate_properties("shop", "item", **kw)
        assert {k: (v.to_json(), v.first_updated, v.last_updated)
                for k, v in got.items()} == {
            k: (v.to_json(), v.first_updated, v.last_updated)
            for k, v in want.items()}


def test_levent_store_find_by_entity(both):
    port, jax = both
    for kw in (dict(), dict(limit=3), dict(latest=False, event_names=["rate"]),
               dict(channel_name="mobile", target_entity_type="item")):
        got = LEventStore(port).find_by_entity("shop", "user", "u3", **kw)
        want = JaxLEventStore(jax).find_by_entity("shop", "user", "u3", **kw)
        assert _events(got) == _events(want)


def test_app_name_to_id_errors(both):
    port, jax = both
    assert app_name_to_id("shop", "mobile", port) == jax_app_name_to_id(
        "shop", "mobile", jax)
    for args in (("nope",), ("shop", "nochan")):
        with pytest.raises(ValueError) as got:
            app_name_to_id(*args, storage=port)
        with pytest.raises(ValueError) as want:
            jax_app_name_to_id(*args, storage=jax)
        assert str(got.value) == str(want.value)


def test_batch_view_folds(both):
    port, jax = both
    views = [cls(st.get_event_store(), 1, start_time="2021-06-02T00:00:00Z")
             for cls, st in ((BatchView, port), (JaxBatchView, jax))]
    got, want = views
    assert _events(got.events) == _events(want.events)
    assert got.aggregate_properties("item") == want.aggregate_properties(
        "item")

    def count(n, e):
        return n + 1

    assert got.aggregate_by_entity_ordered(0, count) == \
        want.aggregate_by_entity_ordered(0, count)
    sub = dict(event_name="buy", entity_type="user")
    assert _events(got.events.filter(**sub)) == _events(
        want.events.filter(**sub))
    assert got.events.group_by_entity_ordered(lambda e: e.event) == \
        want.events.group_by_entity_ordered(lambda e: e.event)


def test_deprecated_views_warn(both):
    port, jax = both
    with pytest.warns(DeprecationWarning, match="predictionio_tpu_torch"):
        PBatchView(port.get_event_store(), 1)
    with pytest.warns(DeprecationWarning):
        JaxLBatchView(jax.get_event_store(), 1)
