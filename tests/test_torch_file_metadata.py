"""The port's ``jsonfs`` metadata store against the JAX package's.

The reference's DAO contract cases (``tests/test_metadata.py``, every
case that takes its ``md`` fixture) run unchanged on the port's
``FileMetadataStore``; the jsonfs-specific cases are mirrored; and a
document tree written by either package is read by the other, record
for record.
"""

import importlib
import logging
import threading
from dataclasses import asdict

import pytest

from predictionio_tpu.storage import FileMetadataStore as JaxFileMetadataStore
from predictionio_tpu.storage import Storage as JaxStorage
from predictionio_tpu_torch.storage import (
    AccessKey,
    EngineInstance,
    EngineManifest,
    EvaluationInstance,
    Model,
    Storage,
    StorageError,
)
from predictionio_tpu_torch.storage.file_metadata import FileMetadataStore

REF = importlib.import_module("test_metadata")
CONTRACT = ("test_apps_crud", "test_app_name_unique", "test_access_keys",
            "test_channels", "test_manifests",
            "test_engine_instances_latest_completed",
            "test_evaluation_instances", "test_models_blob",
            "test_duplicate_access_key_rejected",
            "test_app_rename_to_existing_name_rejected",
            "test_app_update_missing_id_is_noop", "test_hostile_keys_roundtrip")


@pytest.mark.parametrize("case", CONTRACT)
def test_the_reference_contract_cases_pass_on_jsonfs(tmp_path, case):
    md = FileMetadataStore(tmp_path / "meta-json")
    try:
        getattr(REF, case)(md)
    finally:
        md.close()


def _fill(md, ak, ei, ev, em, model):
    """One record of every kind, with the given package's classes."""
    app = md.app_insert("shop", "a shop")
    md.app_insert("other")
    key = md.access_key_insert(ak(key="", appid=app.id, events=["rate"]))
    ch = md.channel_insert("mobile", app.id)
    md.manifest_upsert(em(id="e/1", version="v@2", name="n",
                          engine_factory="f", files=["a.py"]))
    md.engine_instance_insert(ei(
        id="i1", status="COMPLETED", start_time="2020-01-02T00:00:00Z",
        end_time="2020-01-02T00:01:00Z", engine_id="eng",
        engine_version="1", engine_variant="engine.json",
        engine_factory="f", algorithms_params='[{"name": "als"}]'))
    md.evaluation_instance_insert(ev(
        id="x", status="EVALCOMPLETED", start_time="2020-01-01T00:00:00Z",
        end_time="", evaluation_class="E", engine_params_generator_class="G",
        evaluator_results="m=1"))
    md.model_insert(model(id="i1", models=b"\x00blob"))
    return app, key, ch


def _dump(md) -> dict:
    """Every record, as plain dicts, for comparing across packages."""
    return {
        "apps": [asdict(a) for a in md.app_get_all()],
        "keys": sorted((asdict(k) for k in md.access_key_get_all()),
                       key=lambda d: d["key"]),
        "channels": [asdict(c) for c in md.channel_get_by_app(1)],
        "manifests": [asdict(m) for m in md.manifest_get_all()],
        "instances": [asdict(e) for e in md.engine_instance_get_all()],
        "latest": asdict(md.engine_instance_get_latest_completed(
            "eng", "1", "engine.json")),
        "evals": [asdict(e) for e in md.evaluation_instance_get_completed()],
        "model": md.model_get("i1").models,
    }


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_a_tree_written_by_either_package_reads_in_the_other(tmp_path,
                                                             writer):
    from predictionio_tpu.storage import metadata as jmd

    root = tmp_path / "tree"
    if writer == "jax":
        w = JaxFileMetadataStore(root)
        _fill(w, jmd.AccessKey, jmd.EngineInstance, jmd.EvaluationInstance,
              jmd.EngineManifest, jmd.Model)
    else:
        w = FileMetadataStore(root)
        _fill(w, AccessKey, EngineInstance, EvaluationInstance,
              EngineManifest, Model)
    port, ref = FileMetadataStore(root), JaxFileMetadataStore(root)
    assert _dump(port) == _dump(ref)
    assert _dump(port)["apps"][0]["description"] == "a shop"
    # both go on bumping the same sequences
    assert port.app_insert("third").id == 3
    assert ref.app_insert("fourth").id == 4


def test_torn_documents_read_as_absent_loudly(tmp_path, caplog):
    m = FileMetadataStore(tmp_path / "meta-json")
    good = m.app_insert("good")
    (tmp_path / "meta-json" / "apps" / "999.json").write_text("{trunc")
    with caplog.at_level(logging.WARNING):
        assert m.app_get(999) is None
        assert [a.name for a in m.app_get_all()] == ["good"]
        assert m.app_get_by_name("good").id == good.id
        m.app_insert("another")
    assert any("undecodable" in r.message for r in caplog.records)


def test_persists_across_reopen_and_ids_stay_monotonic(tmp_path):
    root = tmp_path / "meta-json"
    a = FileMetadataStore(root)
    app = a.app_insert("survivor", "desc")
    a.model_insert(Model(id="m", models=b"blob"))
    a.close()
    b = FileMetadataStore(root)
    assert b.app_get(app.id).name == "survivor"
    assert b.model_get("m").models == b"blob"
    b.app_delete(app.id)
    assert FileMetadataStore(root).app_insert("next").id == app.id + 1


def test_documents_stay_inside_the_root(tmp_path):
    root = tmp_path / "meta-json"
    m = FileMetadataStore(root)
    m.manifest_upsert(EngineManifest(id="../../escape", version="v",
                                     name="n", engine_factory="f"))
    m.engine_instance_insert(EngineInstance(
        id="../outside", status="INIT", start_time="t", end_time="t",
        engine_id="e", engine_version="1", engine_variant="v",
        engine_factory="f"))
    inside = {p.resolve() for p in root.rglob("*") if p.is_file()}
    assert not [p for p in inside if root.resolve() not in p.parents]
    assert not (tmp_path / "escape@v.json").exists()


def test_registry_wiring_jsonfs_and_a_dotted_type(tmp_path):
    """TYPE=jsonfs resolves through the registry (no longer refused);
    the same tree loads as a dotted-path backend with the conf dict, as
    in the reference; a bad dotted path is loud."""
    env = {
        "PIO_TPU_HOME": str(tmp_path / "home"),
        "PIO_STORAGE_REPOSITORIES_METADATA_SOURCE": "FSM",
        "PIO_STORAGE_SOURCES_FSM_TYPE": "jsonfs",
        "PIO_STORAGE_SOURCES_FSM_PATH": str(tmp_path / "tree"),
    }
    s = Storage(env)
    md = s.get_metadata()
    assert isinstance(md, FileMetadataStore)
    app = md.app_insert("via-env")
    s.close()
    dotted = dict(env, PIO_STORAGE_SOURCES_FSM_TYPE=(
        "predictionio_tpu_torch.storage.file_metadata.FileMetadataStore"))
    s2 = Storage(dotted)
    assert s2.get_metadata().app_get_by_name("via-env").id == app.id
    s2.close()
    # the reference's registry reads the tree the port's wrote
    s3 = JaxStorage(env)
    assert s3.get_metadata().app_get_by_name("via-env").id == app.id
    s3.close()
    bad = dict(env, PIO_STORAGE_SOURCES_FSM_TYPE="no.such.Backend")
    with pytest.raises(StorageError, match="cannot load"):
        Storage(bad).get_metadata()
    nopath = dict(dotted)
    del nopath["PIO_STORAGE_SOURCES_FSM_PATH"]
    with pytest.raises(StorageError, match="failed to initialize"):
        Storage(nopath).get_metadata()


def test_concurrent_inserts_get_unique_ids(tmp_path):
    m = FileMetadataStore(tmp_path / "meta-json")
    ids, errs = [], []

    def work(k):
        try:
            for j in range(5):
                ids.append(m.app_insert(f"app-{k}-{j}").id)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert len(ids) == 20 and len(set(ids)) == 20
    assert len(m.app_get_all()) == 20
