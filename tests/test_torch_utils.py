"""The port's ``utils/`` and ``EntityMap`` against the JAX package's.

``debug_string`` gives the reference's text for every value that is not
an array of a framework (numpy arrays, scalars, dataclasses, nested
containers, truncation); a tensor reads as the reference's numpy
summary with the tensor's type, dtype and device.  ``profile_trace`` is
a no-op unless ``PIO_TPU_PROFILE=1`` or ``enabled=True``, and then
writes a Chrome trace.  ``EntityIdIxMap``, ``EntityMap`` and
``extract_entity_map`` give the reference's maps on the same events.
"""

import dataclasses
import datetime as dt
import json

import numpy as np
import pytest
import torch

from predictionio_tpu.storage import MemoryEventStore as JaxMemoryEventStore
from predictionio_tpu.storage.bimap import (
    EntityIdIxMap as JaxEntityIdIxMap,
    EntityMap as JaxEntityMap,
)
from predictionio_tpu.storage.event import Event as JaxEvent
from predictionio_tpu.utils import debug_string as jax_debug_string
from predictionio_tpu_torch.storage import (
    EntityIdIxMap,
    EntityMap,
    Event,
    MemoryEventStore,
    Storage,
)
from predictionio_tpu_torch.utils import debug_string, profile_trace, profiled


@dataclasses.dataclass
class TD:
    id: int
    vals: list
    props: dict


CASES = [
    None, 3, 2.5, "s", b"b", True,
    np.arange(6.0).reshape(2, 3),
    np.zeros((0, 4), np.float32),
    np.int32(7),
    {"x": np.arange(30, dtype=np.int64), "y": [1, "a"], "z": (1.5,)},
    TD(id=3, vals=list(range(100)), props={f"k{i}": i for i in range(25)}),
    [[[[[[[["deep"]]]]]]]],
    {frozenset({1}), 2},
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_debug_string_is_the_references(case):
    assert debug_string(CASES[case]) == jax_debug_string(CASES[case])


def test_debug_string_summarises_tensors_with_device():
    x = np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 3, 4)
    want = jax_debug_string(x).replace("ndarray[2x3x4] float32",
                                       "Tensor[2x3x4] torch.float32 "
                                       "device=cpu")
    assert debug_string(torch.from_numpy(x)) == want
    nested = debug_string({"t": torch.from_numpy(x), "a": x})
    assert nested == "{'t': " + want + ", 'a': " + jax_debug_string(x) + "}"
    assert debug_string(torch.tensor(2, dtype=torch.int64)) == (
        "Tensor[scalar] torch.int64 device=cpu head=[2]")
    assert debug_string(torch.ones(3, dtype=torch.bfloat16)) == (
        "Tensor[3] torch.bfloat16 device=cpu head=[1.,1.,1.]")
    assert debug_string(torch.empty(0, 2)) == (
        "Tensor[0x2] torch.float32 device=cpu")


def test_profile_trace_is_a_noop_unless_enabled(tmp_path, monkeypatch):
    monkeypatch.setenv("PIO_TPU_HOME", str(tmp_path))
    monkeypatch.delenv("PIO_TPU_PROFILE", raising=False)
    with profile_trace("t") as out:
        assert out is None
    assert not (tmp_path / "profiles").exists()

    calls = []

    @profiled("deco")
    def work(a):
        calls.append(a)
        return (torch.ones(8, 8) @ torch.ones(8, 8)).sum()

    assert float(work(1)) == 512.0 and calls == [1]
    assert not (tmp_path / "profiles").exists()
    monkeypatch.setenv("PIO_TPU_PROFILE", "1")
    assert float(work(2)) == 512.0
    trace = tmp_path / "profiles" / "deco" / "trace.json"
    assert json.loads(trace.read_text())["traceEvents"]
    with profile_trace("unit", enabled=True) as out:
        (torch.ones(4, 4) @ torch.ones(4, 4)).sum()
    assert out == tmp_path / "profiles" / "unit"
    # the block's own ops, run on this thread, are in the trace
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    assert "aten::mm" in {e.get("name") for e in events}


def test_entity_maps_are_the_references():
    ids = ["b", "a", "c", "zz"]
    m, jm = EntityIdIxMap.from_ids(ids), JaxEntityIdIxMap.from_ids(ids)
    assert len(m) == len(jm) == 4
    assert [m(i) for i in ids] == [jm(i) for i in ids]
    assert [m.inverse(k) for k in range(4)] == [jm.inverse(k)
                                                 for k in range(4)]
    assert (m.get("nope"), "a" in m, "nope" in m) == (-1, True, False)
    data = {"u2": 20, "u1": 10, "u3": 30}
    em, jem = EntityMap(data), JaxEntityMap(data)
    assert [em.get_by_index(k) for k in range(3)] == [
        jem.get_by_index(k) for k in range(3)]
    assert em["u1"] == 10 and em.get("u9", -1) == -1 and "u3" in em
    assert len(em) == 3 and dict(em.items()) == data
    from predictionio_tpu_torch.storage.bimap import BiMap

    with pytest.raises(ValueError, match="contiguous"):
        EntityIdIxMap(BiMap({"a": 0, "b": 2}))
    assert EntityIdIxMap(BiMap({"a": 1, "b": 0})).inverse(0) == "b"


def _user_events(cls):
    t0 = dt.datetime(2024, 1, 1, tzinfo=dt.timezone.utc)
    out = []
    for k in range(6):
        props = {"age": 20 + k, "tier": "gold" if k % 2 else "basic"}
        if k == 4:
            del props["age"]
        out.append(cls(event="$set", entity_type="user", entity_id=f"u{k}",
                       properties=props,
                       event_time=t0 + dt.timedelta(minutes=k)))
    out.append(cls(event="$unset", entity_type="user", entity_id="u1",
                   properties={"tier": None},
                   event_time=t0 + dt.timedelta(hours=1)))
    out.append(cls(event="$delete", entity_type="user", entity_id="u5",
                   event_time=t0 + dt.timedelta(hours=2)))
    return out


@pytest.mark.parametrize("required", [None, ["age"], ["age", "tier"]])
def test_extract_entity_map_is_the_references(tmp_path, required):
    """The same events in each package's in-memory store, and in the
    port's SQLite store: the same typed map, in the same index order."""
    def extract(p):
        return (p.get_opt("age"), p.get_opt("tier"))

    ref = JaxMemoryEventStore()
    ref.insert_batch(_user_events(JaxEvent), 1)
    want = ref.extract_entity_map(extract, 1, "user", required=required)
    stores = [MemoryEventStore(),
              Storage({"PIO_TPU_HOME": str(tmp_path)}).get_event_store()]
    for es in stores:
        es.init_channel(1)
        es.insert_batch(_user_events(Event), 1)
        got = es.extract_entity_map(extract, 1, "user", required=required)
        assert dict(got.items()) == dict(want.items())
        assert [got.id_to_ix.inverse(k) for k in range(len(got))] == [
            want.id_to_ix.inverse(k) for k in range(len(want))]
        es.close()
