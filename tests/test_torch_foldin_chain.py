"""The fold-in delta chain and its apply against the JAX package's, on
the CPU.

Delta links (``workflow/model_io.py``) written by either package load in
the other; both chain loaders list, truncate a torn or gapped chain and
skip ``.tmp`` orphans alike, with the same error; ``apply_model_delta``
gives the reference's tables and ids and refuses an out-of-order link
with its ``ValueError``; the cached device tables of a served model are
patched to what a fresh upload of the patched tables gives; the
watermark files and the cursor algebra (``live/watermark.py``) are the
reference's.
"""

import json

import numpy as np
import pytest
import torch

from predictionio_tpu.live import apply as jax_apply
from predictionio_tpu.live import watermark as jax_wm
from predictionio_tpu.storage.bimap import StringIndex as JaxStringIndex
from predictionio_tpu.workflow import model_io as jax_io
from predictionio_tpu_torch.live import apply, watermark
from predictionio_tpu_torch.storage.bimap import StringIndex
from predictionio_tpu_torch.templates.recommendation import ALSModel
from predictionio_tpu_torch.workflow import model_io

KEY = "inst-0-als"
R = 6


def _delta(mod, seq: int, base_users: int, base_items: int, rng):
    """One link: two patched users, ``seq`` appended users, one appended
    item, in ``mod``'s ``ModelDelta``."""
    return mod.ModelDelta(
        seq=seq,
        meta={"instance": "inst", "key": KEY, "baseUsers": base_users,
              "baseItems": base_items,
              "watermark": {"appId": 1, "channelId": 0,
                            "rowid": json.dumps({"0": seq, "1": 2 * seq})},
              "events": 3},
        user_rows_ix=np.asarray([0, base_users - 1], np.int32),
        user_rows=rng.normal(size=(2, R)).astype(np.float32),
        new_user_ids=np.asarray([f"n{seq}-{k}" for k in range(seq)]),
        new_user_rows=rng.normal(size=(seq, R)).astype(np.float32),
        item_rows_ix=np.zeros(0, np.int32),
        item_rows=np.zeros((0, R), np.float32),
        new_item_ids=np.asarray([f"ni{seq}"]),
        new_item_rows=rng.normal(size=(1, R)).astype(np.float32),
    )


def _chain(mod, base_dir, n: int = 3, users: int = 10, items: int = 7):
    rng = np.random.default_rng(n)
    for seq in range(1, n + 1):
        mod.save_model_delta(base_dir, KEY, _delta(mod, seq, users, items,
                                                   rng))
        users += seq
        items += 1


def _same_delta(a, b) -> None:
    assert a.seq == b.seq and a.meta == b.meta
    for f in ("user_rows_ix", "user_rows", "new_user_ids", "new_user_rows",
              "item_rows_ix", "item_rows", "new_item_ids", "new_item_rows"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("writer,reader", [(model_io, jax_io),
                                           (jax_io, model_io)])
def test_delta_links_load_in_either_package(tmp_path, writer, reader):
    _chain(writer, tmp_path / "w")
    _chain(reader, tmp_path / "r")
    got, err = reader.load_model_delta_chain(tmp_path / "w", KEY)
    want, err_r = reader.load_model_delta_chain(tmp_path / "r", KEY)
    assert err is None and err_r is None and len(got) == 3
    for a, b in zip(got, want):
        _same_delta(a, b)
    assert model_io.DELTA_VERSION == jax_io.DELTA_VERSION
    assert model_io.delta_file_name(KEY, 7) == jax_io.delta_file_name(KEY, 7)


@pytest.mark.parametrize("fault", ["torn", "gap", "orphan"])
def test_a_broken_chain_truncates_like_the_references(tmp_path, fault):
    _chain(model_io, tmp_path, n=4)
    if fault == "torn":
        p = tmp_path / model_io.delta_file_name(KEY, 3)
        p.write_bytes(p.read_bytes()[:40])
    elif fault == "gap":
        (tmp_path / model_io.delta_file_name(KEY, 2)).unlink()
    else:
        (tmp_path / (model_io.delta_file_name(KEY, 5) + ".tmp")).write_bytes(
            b"half")
    got, err = model_io.load_model_delta_chain(tmp_path, KEY)
    want, err_r = jax_io.load_model_delta_chain(tmp_path, KEY)
    assert [d.seq for d in got] == [d.seq for d in want]
    assert err == err_r
    assert (err is None) == (fault == "orphan")
    assert model_io.list_model_deltas(tmp_path, KEY) == \
        jax_io.list_model_deltas(tmp_path, KEY)
    after, _ = model_io.load_model_delta_chain(tmp_path, KEY, after_seq=1)
    assert [d.seq for d in after] == [d.seq for d in jax_io.
                                      load_model_delta_chain(
                                          tmp_path, KEY, after_seq=1)[0]]


class _Model:
    """The fields a delta patches, as both packages' ALS models have."""

    def __init__(self, index_cls, users: int = 10, items: int = 7):
        rng = np.random.default_rng(0)
        self.user_factors = rng.normal(size=(users, R)).astype(np.float32)
        self.item_factors = rng.normal(size=(items, R)).astype(np.float32)
        self.users = index_cls([f"u{k}" for k in range(users)])
        self.items = index_cls([f"i{k}" for k in range(items)])


def test_apply_gives_the_references_tables_and_ids(tmp_path):
    _chain(model_io, tmp_path)
    chain, _ = model_io.load_model_delta_chain(tmp_path, KEY)
    port, jax = _Model(StringIndex), _Model(JaxStringIndex)
    assert apply.model_supports_deltas(port)
    assert jax_apply.model_supports_deltas(jax)
    assert not apply.model_supports_deltas(object())
    for d in chain:
        assert apply.apply_model_delta(port, d) == \
            jax_apply.apply_model_delta(jax, d)
    assert np.array_equal(port.user_factors, jax.user_factors)
    assert np.array_equal(port.item_factors, jax.item_factors)
    assert list(port.users.ids) == list(jax.users.ids)
    assert list(port.items.ids) == list(jax.items.ids)
    assert port.users.get("n3-2") == len(port.users) - 1


def test_an_out_of_order_link_raises_the_references_error(tmp_path):
    _chain(model_io, tmp_path)
    chain, _ = model_io.load_model_delta_chain(tmp_path, KEY)
    errs = []
    for mod, index in ((apply, StringIndex), (jax_apply, JaxStringIndex)):
        m = _Model(index)
        mod.apply_model_delta(m, chain[0])
        with pytest.raises(ValueError) as e:
            mod.apply_model_delta(m, chain[2])
        errs.append(str(e.value))
        with pytest.raises(ValueError):
            mod.apply_model_delta(m, chain[0])  # a double apply
    assert errs[0] == errs[1] and "out of order" in errs[0]


def test_cached_device_tables_are_patched_to_a_fresh_upload(tmp_path):
    _chain(model_io, tmp_path)
    chain, _ = model_io.load_model_delta_chain(tmp_path, KEY)
    base = _Model(StringIndex)
    model = ALSModel(user_factors=base.user_factors,
                     item_factors=base.item_factors, users=base.users,
                     items=base.items, item_props={},
                     device=torch.device("cpu"))
    for dtype in (None, "bfloat16"):
        model.device_item_factors(dtype)
        model.device_item_factors_t(dtype)
    before = model.device_item_factors()
    rows = np.asarray([[9.0] * R, [-9.0] * R], np.float32)
    model.patch_device_item_rows(np.asarray([1, 4]), rows)
    model.item_factors = model.item_factors.copy()
    model.item_factors[[1, 4]] = rows
    for d in chain:
        apply.apply_model_delta(model, d)
    fresh = ALSModel(user_factors=model.user_factors,
                     item_factors=model.item_factors, users=model.users,
                     items=model.items, item_props={},
                     device=torch.device("cpu"))
    for dtype in (None, "bfloat16"):
        for name in ("device_item_factors", "device_item_factors_t"):
            got = getattr(model, name)(dtype)
            want = getattr(fresh, name)(dtype)
            assert got.dtype == want.dtype and torch.equal(got, want)
            assert got.is_contiguous()
    assert before.shape[0] == 7 and torch.equal(
        before, torch.as_tensor(base.item_factors))  # not written in place


def test_watermark_files_and_cursor_algebra_equal_the_references(tmp_path):
    vec = json.dumps({"0": 3, "1": 5})
    later = json.dumps({"0": 4, "1": 5})
    for a, b in ((0, 7), (7, 3), (vec, later), (later, vec), (0, vec),
                 (vec, 0)):
        assert watermark.cursor_would_regress(a, b) == \
            jax_wm.cursor_would_regress(a, b)
        assert watermark.merge_cursors(a, b) == jax_wm.merge_cursors(a, b)
    for c in (0, "", 5, vec, json.dumps({"0": 0, "1": 0})):
        assert watermark.cursor_is_zero(c) == jax_wm.cursor_is_zero(c)
    with pytest.raises(ValueError, match="cursor kinds"):
        watermark.merge_cursors(5, vec)
    assert watermark.WATERMARK_FILE == jax_wm.WATERMARK_FILE
    path = tmp_path / watermark.WATERMARK_FILE
    watermark.WatermarkStore(path).advance(watermark.Watermark(1, 0, vec, 2))
    got = jax_wm.WatermarkStore(path).get(1, 0)
    assert (got.rowid, got.seq) == (vec, 2)
    jax_wm.WatermarkStore(path).advance(jax_wm.Watermark(1, 0, later, 3))
    got = watermark.WatermarkStore(path).get(1, 0)
    assert (got.rowid, got.seq) == (later, 3)
    with pytest.raises(ValueError, match="backwards"):
        watermark.WatermarkStore(path).advance(
            watermark.Watermark(1, 0, vec, 4))
    path.write_text("{torn")
    assert watermark.WatermarkStore(path).get(1, 0).rowid == 0
