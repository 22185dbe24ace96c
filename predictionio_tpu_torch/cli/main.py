"""`pio`-equivalent CLI console of the port.

Port of ``predictionio_tpu/cli/main.py``, a re-expression of reference
`tools/console/Console.scala:128-737` + `console/App.scala` +
`console/AccessKey.scala` on argparse, with the reference's arguments,
messages and exit codes.  Subcommands:

  app new|list|show|delete|data-delete|trim|compact|channel-new|channel-delete
  accesskey new|list|delete
  engines list|describe
  template list|get
  train | deploy | foldin | eval | undeploy | eventserver
  build | unregister | run | import | export | status | upgrade | version

``eventserver --workers N`` runs the ingest router in front of N
shard-owner ``eventserver`` processes over the sharded store, and
``deploy --replicas N`` the serving router in front of N ``deploy``
processes.  ``foldin`` folds the events past the watermark into the
deployed model as a delta link (``--watch`` keeps polling), which
``deploy --foldin-poll SEC`` applies in place and ``deploy --replicas N
--push-foldin SEC`` pushes to every replica in turn.  ``deploy --multi
TENANTS_JSON`` hosts every tenant of a manifest in one server (tenant 0
the anchor; ``--memory-budget BYTES`` overrides its budget,
``--autopilot on|JSON`` runs the SPRT autopilot; with ``--replicas N``
every replica hosts them all).  ``adminserver`` and ``dashboard``, and
the options of multi-process training, are refused before any work with
``Error: ... is not ported to predictionio_tpu_torch yet (ROADMAP Queue 1
item N)`` and exit code 1 (:data:`_REFUSED`).  ``train --coordinator
HOST:PORT --num-processes N --process-id K`` joins a multi-process train
(``parallel.mesh.distributed_init``) before the train and leaves it
after.  The
observability options (``--telemetry-dir``, ``--no-metrics``,
``--xray-sample-s``, ``--no-profiler``, ``--flight-capacity``,
``--slo-ms``) work as the reference's (:func:`_apply_obs_flags`).

``main(argv, storage, device)`` runs on the card unless the caller asks
for ``device="cpu"`` (the tests do); ``train``, ``deploy``, ``foldin``
and ``eval`` raise without one.  ``python -m predictionio_tpu_torch`` always takes the card.

There is no sbt: ``build`` validates the engine variant and registers an
EngineManifest (RegisterEngine analogue), and engine factories are
Python callables resolved by dotted path (`WorkflowUtils.getEngine`
reflection analogue, `workflow/WorkflowUtils.scala:60-77`).
"""

from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import subprocess
import sys
from pathlib import Path
from typing import Any, Optional

from .. import __version__
from ..device import DeviceLike
from ..storage.metadata import AccessKey
from ..storage.registry import Storage, get_storage

__all__ = ["main", "resolve_attr", "load_engine_from_variant"]

logger = logging.getLogger(__name__)


def resolve_attr(path: str) -> Any:
    """'package.module.attr' -> attr (the reflection-loader analogue)."""
    mod_name, _, attr = path.rpartition(".")
    if not mod_name:
        raise ValueError(f"invalid dotted path: {path!r}")
    mod = importlib.import_module(mod_name)
    try:
        return getattr(mod, attr)
    except AttributeError as e:
        raise ValueError(f"{attr!r} not found in module {mod_name}") from e


def _engine_dir_on_path(variant_path: str | Path, factory_path: str) -> None:
    """Make a scaffolded engine dir importable: its ``engine.py`` is the
    factory module when engineFactory is ``engine.<attr>`` (the
    `template get` layout).  Evicts a stale ``engine`` module loaded from
    a different engine dir, and puts this dir first on ``sys.path``: with
    several engine dirs loaded in one process, the import must find this
    dir's ``engine.py``, not the one of a dir inserted later."""
    engine_dir = str(Path(variant_path).resolve().parent)
    top = factory_path.split(".", 1)[0]
    candidate = Path(engine_dir) / f"{top}.py"
    if not candidate.exists():
        return
    if engine_dir in sys.path:
        sys.path.remove(engine_dir)
    sys.path.insert(0, engine_dir)
    mod = sys.modules.get(top)
    if mod is not None and getattr(mod, "__file__", None) != str(candidate):
        del sys.modules[top]


def load_engine_from_variant(
    variant_path: str | Path,
    engine_factory: Optional[str] = None,
    return_factory: bool = False,
):
    """engine.json -> (engine, engine_params, variant dict).

    Two dispatch forms: ``engineFactory`` (a dotted path) or ``engine``
    (a registry name: the spec's default params fill what the file does
    not say).  ``return_factory=True`` appends the factory object (an
    EngineFactory instance, or the bare callable)."""
    variant = json.loads(Path(variant_path).read_text())
    factory_path = engine_factory or variant.get("engineFactory")
    if not factory_path:
        name = variant.get("engine")
        if name:
            from .. import engines

            try:
                spec = engines.get_engine_spec(name)
            except KeyError:
                # an engine.json inside a not-yet-discovered engine dir:
                # load THAT dir (works without PIO_TPU_ENGINE_PATH)
                engines.discovery.load_engine_dir(
                    Path(variant_path).resolve().parent
                )
                spec = engines.get_engine_spec(name)
            merged = spec.default_variant()
            merged.update(variant)
            engine = spec.build()
            out = (engine, engine.params_from_variant(merged), merged)
            return (*out, spec.factory) if return_factory else out
        raise ValueError(
            "engine.json must declare 'engineFactory' or 'engine' "
            "(or pass --engine-factory)"
        )
    _engine_dir_on_path(variant_path, factory_path)
    factory = resolve_attr(factory_path)
    obj = factory() if isinstance(factory, type) else factory
    if not hasattr(obj, "apply") and callable(obj):
        obj = obj()  # plain function factory -> Engine (or EngineFactory)
    if hasattr(obj, "apply"):  # EngineFactory object
        engine = obj.apply()
        factory_obj = obj
    else:
        engine = obj
        factory_obj = factory
    out = (engine, engine.params_from_variant(variant), variant)
    return (*out, factory_obj) if return_factory else out


def _out(msg: str) -> None:
    print(msg)


def _apply_obs_flags(args) -> None:
    """Wire the pio-obs/pio-xray knobs shared by the server/workflow
    commands: ``--telemetry-dir`` (span JSONL journal location),
    ``--no-metrics`` (404 the /metrics + /debug/xray mounts),
    ``--xray-sample-s`` (device sampler cadence) and
    ``--flight-capacity`` (slow-query flight recorder depth)."""
    from ..obs import configure, get_flight_recorder, xray

    configure(
        journal_dir=getattr(args, "telemetry_dir", None),
        metrics=(False if getattr(args, "no_metrics", False) else None),
    )
    sample_s = getattr(args, "xray_sample_s", None)
    if sample_s is not None:
        xray.set_sample_period(sample_s)
    flight_n = getattr(args, "flight_capacity", None)
    if flight_n is not None:
        get_flight_recorder().set_capacity(flight_n)
    if getattr(args, "no_profiler", False):
        # pio-scope opt-out: the servers' ensure_started() becomes a
        # no-op; the TimedLock contention lens keeps booking (its cost
        # is per-contended-acquire, not per-sample)
        from ..obs import scope

        scope.set_enabled(False)


def _add_obs_args(p) -> None:
    p.add_argument("--telemetry-dir", metavar="DIR",
                   help="journal pio-obs spans as JSON lines to "
                   "DIR/spans-<pid>.jsonl (size-capped rotated "
                   "segments; default: in-memory ring only; "
                   "PIO_TPU_TELEMETRY=1 journals under "
                   "$PIO_TPU_HOME/telemetry)")
    p.add_argument("--no-metrics", action="store_true",
                   help="disable the GET /metrics Prometheus "
                   "exposition and GET /debug/xray (recording still "
                   "happens; only the endpoints answer 404)")
    p.add_argument("--xray-sample-s", type=float, default=None,
                   metavar="SEC",
                   help="pio-xray device-memory sampler period "
                   "(default: $PIO_TPU_XRAY_SAMPLE_S or 10; <= 0 "
                   "disables the sampler)")
    p.add_argument("--no-profiler", action="store_true",
                   help="disable the pio-scope always-on sampling "
                   "profiler (GET /debug/pprof then answers an empty "
                   "profile; the lock-contention lens stays on; "
                   "PIO_TPU_SCOPE=0 is the env equivalent)")


# --------------------------------------------------------------------------
# what the port refuses, before any work
# --------------------------------------------------------------------------

def _is_set(v) -> bool:
    return v is not None and v is not False


# (command, argument, refused when, what, ROADMAP Queue 1 item); an
# argument of None refuses the command itself
_REFUSED = (
    ("adminserver", None, None, "adminserver", 9),
    ("dashboard", None, None, "dashboard", 9),
)


def _refusal(args) -> Optional[str]:
    """The message refusing what ``args`` asks for, or None."""
    for cmd, dest, when, what, item in _REFUSED:
        if args.command != cmd:
            continue
        if dest is None or (hasattr(args, dest) and when(getattr(args, dest))):
            return (f"{what} is not ported to predictionio_tpu_torch yet "
                    f"(ROADMAP Queue 1 item {item})")
    if args.command == "eventserver" and args.no_wal_fsync:
        return ("eventserver --no-wal-fsync is not offered by "
                "predictionio_tpu_torch: its WAL fsyncs every group "
                "before the ack")
    return None


# --------------------------------------------------------------------------
# app / accesskey ops (console/App.scala:34-498, console/AccessKey.scala)
# --------------------------------------------------------------------------


def _resolve_channel(md, app_id: int, name: str):
    """Channel name -> Channel for an app, or None if absent."""
    for c in md.channel_get_by_app(app_id):
        if c.name == name:
            return c
    return None


def cmd_app(args, storage: Storage) -> int:
    md = storage.get_metadata()
    es = storage.get_event_store()
    if args.app_command == "new":
        if md.app_get_by_name(args.name):
            _out(f"Error: app '{args.name}' already exists.")
            return 1
        app = md.app_insert(args.name, args.description)
        es.init_channel(app.id)
        key = md.access_key_insert(
            AccessKey(key=args.access_key or "", appid=app.id)
        )
        _out(f"Created app '{app.name}' (id {app.id}).")
        _out(f"Access key: {key}")
        return 0
    if args.app_command == "list":
        for app in md.app_get_all():
            keys = md.access_key_get_by_app(app.id)
            _out(f"{app.id:>6}  {app.name}  keys={len(keys)}")
        return 0
    if args.app_command == "compact":
        es.compact()
        _out("Compacted the event store (space reclaimed).")
        return 0
    app = md.app_get_by_name(args.name)
    if app is None:
        _out(f"Error: app '{args.name}' not found.")
        return 1
    if args.app_command == "show":
        _out(f"App: {app.name} (id {app.id})")
        _out(f"Description: {app.description or ''}")
        for k in md.access_key_get_by_app(app.id):
            events = ",".join(k.events) if k.events else "(all)"
            _out(f"Access key: {k.key} events={events}")
        for c in md.channel_get_by_app(app.id):
            _out(f"Channel: {c.name} (id {c.id})")
        return 0
    if args.app_command == "delete":
        for c in md.channel_get_by_app(app.id):
            es.remove_channel(app.id, c.id)
            md.channel_delete(c.id)
        es.remove_channel(app.id)
        for k in md.access_key_get_by_app(app.id):
            md.access_key_delete(k.key)
        md.app_delete(app.id)
        _out(f"Deleted app '{args.name}'.")
        return 0
    if args.app_command == "channel-new":
        try:
            c = md.channel_insert(args.channel, app.id)
        except ValueError as e:
            _out(f"Error: {e}")
            return 1
        es.init_channel(app.id, c.id)
        _out(f"Created channel '{c.name}' (id {c.id}).")
        return 0
    # data-delete, trim and channel-delete name an existing channel
    chan = None
    if args.channel:
        chan = _resolve_channel(md, app.id, args.channel)
        if chan is None:
            _out(f"Error: channel '{args.channel}' not found.")
            return 1
    if args.app_command == "data-delete":
        if chan is not None:
            es.remove_channel(app.id, chan.id)
            es.init_channel(app.id, chan.id)
        else:
            es.remove_channel(app.id)
            es.init_channel(app.id)
        _out(f"Deleted event data of app '{args.name}'.")
        return 0
    if args.app_command == "trim":
        from ..storage.event import parse_time
        from ..tools.trim import trim_events

        try:
            before = parse_time(args.before) if args.before else None
        except ValueError as e:
            _out(f"Error: invalid --before time: {e}")
            return 1
        try:
            n = trim_events(
                es, app.id, chan.id if chan is not None else 0,
                before=before,
                event_names=args.event or None,
                keep_special=not args.all,
            )
        except ValueError as e:
            _out(f"Error: {e}")
            return 1
        _out(f"Trimmed {n} events from app '{args.name}'.")
        if args.compact:
            es.compact()
            _out("Compacted the event store (space reclaimed).")
        return 0
    if args.app_command == "channel-delete":
        es.remove_channel(app.id, chan.id)
        md.channel_delete(chan.id)
        _out(f"Deleted channel '{args.channel}'.")
        return 0
    raise AssertionError(args.app_command)


def cmd_accesskey(args, storage: Storage) -> int:
    md = storage.get_metadata()
    if args.ak_command == "new":
        app = md.app_get_by_name(args.app_name)
        if app is None:
            _out(f"Error: app '{args.app_name}' not found.")
            return 1
        key = md.access_key_insert(
            AccessKey(key="", appid=app.id, events=args.events or [])
        )
        _out(f"Access key: {key}")
        return 0
    if args.ak_command == "list":
        keys = md.access_key_get_all()
        if args.app_name:
            app = md.app_get_by_name(args.app_name)
            if app is None:
                _out(f"Error: app '{args.app_name}' not found.")
                return 1
            keys = [k for k in keys if k.appid == app.id]
        for k in keys:
            events = ",".join(k.events) if k.events else "(all)"
            _out(f"{k.key}  appid={k.appid}  events={events}")
        return 0
    if args.ak_command == "delete":
        md.access_key_delete(args.key)
        _out(f"Deleted access key {args.key}.")
        return 0
    raise AssertionError(args.ak_command)


# --------------------------------------------------------------------------
# engines / train / deploy / servers
# --------------------------------------------------------------------------


def _load_engine_for_args(args, return_factory: bool = False):
    """One resolution path for the workflow commands: ``--engine NAME``
    (registry dispatch, no engine.json needed) or ``--engine-json
    PATH``.  Returns ``(engine, ep, variant, variant_key[, factory])``
    where ``variant_key`` is the engine-variant string instances are
    registered and looked up under."""
    from ..tools.template_gallery import verify_template_min_version

    name = getattr(args, "engine", None)
    if name:
        from .. import engines

        spec = engines.get_engine_spec(name)
        engine, ep, variant = engines.resolve(name)
        out = (engine, ep, variant, spec.instance_variant_key())
        return (*out, spec.factory) if return_factory else out
    verify_template_min_version(Path(args.engine_json).parent)
    loaded = load_engine_from_variant(
        args.engine_json, args.engine_factory, return_factory=return_factory
    )
    out = (*loaded[:3], str(args.engine_json))
    return (*out, loaded[3]) if return_factory else out


def _resolve_instance_id(md, engine_id: str, variant_key: str,
                         explicit: Optional[str]):
    """An explicit instance id is verified, else the latest COMPLETED
    instance for (engine_id, variant_key) wins.  Returns ``(iid,
    error_message)``."""
    if explicit:
        if md.engine_instance_get(explicit) is None:
            return None, f"engine instance '{explicit}' not found."
        return explicit, None
    latest = md.engine_instance_get_latest_completed(
        engine_id, "1", variant_key
    )
    if latest is None:
        return None, ("no completed engine instance found; "
                      "run train first.")
    return latest.id, None


def _write_port_file(path: str, port: int) -> None:
    pf = Path(path)
    pf.parent.mkdir(parents=True, exist_ok=True)
    pf.write_text(f"{port}\n")


def cmd_engines(args, storage: Storage) -> int:
    """The registry view: every engine one registration away from
    ``train/deploy --engine NAME`` (built-ins plus anything on
    PIO_TPU_ENGINE_PATH)."""
    from .. import engines

    if args.engines_command == "list":
        specs = engines.list_engine_specs()
        for spec in specs:
            src = "" if spec.source == "builtin" else f"  [{spec.source}]"
            _out(f"{spec.name:<26} {spec.description}{src}")
        _out(f"({len(specs)} engines registered)")
        return 0
    if args.engines_command == "describe":
        try:
            spec = engines.get_engine_spec(args.name)
        except KeyError as e:
            _out(f"Error: {e.args[0]}")
            return 1
        _out(json.dumps(spec.describe(), indent=2))
        return 0
    raise AssertionError(args.engines_command)


def cmd_train(args, storage: Storage, device: DeviceLike) -> int:
    if args.scan_cache:
        os.environ["PIO_TPU_SCAN_CACHE"] = "1"
    if args.coordinator or args.num_processes is not None:
        # a multi-process train: every process runs the same command
        # with its own --process-id; the collectives then span them
        from ..parallel.mesh import distributed_init, distributed_shutdown

        backend = distributed_init(
            coordinator_address=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=device,
        )
        _out(f"Process {args.process_id} of {args.num_processes} joined "
             f"the run over {backend}.")
        try:
            return _train(args, storage, device)
        finally:
            distributed_shutdown()
    return _train(args, storage, device)


def _train(args, storage: Storage, device: DeviceLike) -> int:
    from ..controller.base import WorkflowContext
    from ..workflow.params import WorkflowParams
    from ..workflow.train import run_train

    engine, ep, variant, variant_key, factory = _load_engine_for_args(
        args, return_factory=True
    )
    if args.engine_params_key:
        # programmatic params override: EngineFactory.engine_params(key)
        # (reference CreateWorkflow --engine-params-key)
        if not hasattr(factory, "engine_params"):
            _out("Error: --engine-params-key needs an EngineFactory with "
                 "engine_params(key).")
            return 1
        try:
            ep = factory.engine_params(args.engine_params_key)
        except KeyError as e:
            _out(f"Error: unknown engine params key: {e}")
            return 1
    ctx = WorkflowContext(device=device, storage=storage, mode="Training",
                          batch=args.batch)
    wp = WorkflowParams(
        batch=args.batch,
        skip_sanity_check=args.skip_sanity_check,
        stop_after_read=args.stop_after_read,
        stop_after_prepare=args.stop_after_prepare,
    )
    iid = run_train(
        engine, ep, ctx=ctx, workflow_params=wp,
        engine_id=variant.get("id", "default"),
        engine_variant=variant_key,
        engine_factory=args.engine_factory or variant.get("engineFactory", ""),
    )
    _out(f"Training completed. Engine instance id: {iid}")
    return 0


def cmd_deploy(args, storage: Storage, device: DeviceLike) -> int:
    import time
    import urllib.error
    import urllib.request

    from ..controller.base import WorkflowContext
    from ..server.serving import EngineServer, ServerConfig

    if args.replicas > 1:
        # N replica processes and one router in this one
        return _deploy_fleet(args, device)
    if args.scan_cache:
        os.environ["PIO_TPU_SCAN_CACHE"] = "1"
    # `deploy --multi tenants.json`: ONE server hosts every tenant of
    # the manifest.  Tenant 0 is the anchor (loaded now as the server's
    # own components, pinned); the rest load on their first query under
    # the registry's memory budget
    tenants = None
    if args.multi:
        tenants = _build_tenant_registry(args, storage)
        anchor = tenants.spec(tenants.anchor_key)
        if anchor.engine_name:
            args.engine = anchor.engine_name
        else:
            args.engine_json = anchor.engine_json
        if anchor.instance_id and not args.engine_instance_id:
            args.engine_instance_id = anchor.instance_id
    engine, ep, variant, variant_key = _load_engine_for_args(args)
    md = storage.get_metadata()
    engine_id = variant.get("id", "default")
    iid, err = _resolve_instance_id(
        md, engine_id, variant_key, args.engine_instance_id
    )
    if err:
        _out(f"Error: {err}")
        return 1
    ctx = WorkflowContext(device=device, storage=storage, mode="Serving")
    server = EngineServer(
        engine, ep, iid, ctx=ctx,
        config=ServerConfig(
            host=args.ip, port=args.port,
            microbatch=args.microbatch,
            shared_batcher=(args.shared_batcher != "off"),
            query_timeout_s=args.query_timeout,
            edge=args.edge,
            max_connections=args.max_connections,
            feedback=args.feedback,
            event_server_url=args.event_server_url,
            access_key=args.accesskey,
            log_url=args.log_url,
            log_prefix=args.log_prefix,
            feedback_capacity=args.feedback_capacity,
            breaker_failures=args.breaker_failures,
            breaker_reset_s=args.breaker_reset,
            foldin_poll_s=args.foldin_poll,
            slo_ms=args.slo_ms,
        ),
        engine_id=engine_id,
        engine_variant=variant_key,
        tenants=tenants,
    )
    # undeploy a stale server holding the port (CreateServer.scala:266-288)
    stale_host = "127.0.0.1" if args.ip == "0.0.0.0" else args.ip
    try:
        with urllib.request.urlopen(
            urllib.request.Request(
                f"http://{stale_host}:{args.port}/stop", method="POST"
            ),
            timeout=2,
        ):
            _out(f"Undeployed stale engine server on port {args.port}.")
            time.sleep(0.5)
    except (urllib.error.URLError, OSError):
        pass
    if args.port_file:
        # bind now so the announced port is real (--port 0 = ephemeral)
        server._bind()
        _write_port_file(args.port_file, server.port)
    _out(f"Deploying engine instance {iid} on {args.ip}:{server.port}")
    try:
        server.serve_forever()
    finally:
        # a POST /stop ends the loop from another thread: finish the
        # teardown (the batcher's dispatcher, the aux pool) before the
        # process exits
        server.stop()
    return 0


def _build_tenant_registry(args, storage: Storage):
    """``--multi`` tenants.json as a ``TenantRegistry``, each tenant's
    app id and access key resolved from the metadata (the feedback's
    attribution and accessKey routing need them; a tenant whose app is
    missing loses both, with a warning).  ``--memory-budget`` overrides
    the manifest's budget, ``--autopilot`` its ``"autopilot"`` block
    (``on`` for the defaults, else a JSON object of knobs)."""
    from ..tenancy import TenantRegistry, load_tenant_manifest

    specs, opts = load_tenant_manifest(args.multi)
    for spec in specs:
        if spec.engine_json is None and spec.engine_name is None:
            _out(f"Error: tenant {spec.key_str} has no engineJson or "
                 "engine name.")
            raise SystemExit(1)
    if args.memory_budget is not None:
        opts["memory_budget_bytes"] = args.memory_budget
    if args.autopilot:
        if args.autopilot.strip().lower() in ("1", "on", "true"):
            opts["autopilot"] = {}
        else:
            try:
                opts["autopilot"] = json.loads(args.autopilot)
            except json.JSONDecodeError as e:
                _out(f"Error: --autopilot is neither 'on' nor valid "
                     f"JSON: {e}")
                raise SystemExit(1)
    md = storage.get_metadata()
    for spec in specs:
        app = md.app_get_by_name(spec.app)
        if app is None:
            _out(f"Warning: tenant app '{spec.app}' not found in "
                 "metadata; accessKey routing and online-eval "
                 "conversion scanning are off for it.")
            continue
        spec.app_id = app.id
        if spec.access_key is None:
            keys = md.access_key_get_by_app(app.id)
            if keys:
                spec.access_key = keys[0].key
    return TenantRegistry(specs, **opts)


def _deploy_fleet(args, device: DeviceLike) -> int:
    """``deploy --replicas N``: spawn N single-replica ``deploy``
    processes on ephemeral ports (on the card, or on the host when the
    caller asked for the CPU), wait for each port file, supervise them
    (unless ``--no-respawn``), then run the router in THIS process on
    the requested port until ``POST /stop``, SIGTERM or SIGINT; the
    replicas are stopped on the way out.  Every replica gets the deploy
    options, the feedback, remote-log and ``--foldin-poll`` ones
    included; ``--push-foldin SEC`` runs the router's rolling fold-in
    push every SEC seconds, and ``--multi``, ``--memory-budget`` and
    ``--autopilot`` give every replica the same tenants.  The fleet's
    directory (port files and replica logs) is removed after a clean
    stop; after a failure it stays, and its path is in the replica
    lines."""
    import shutil
    import signal
    import tempfile
    import threading

    import torch

    from ..server.router import (
        Replica,
        ReplicaSupervisor,
        RouterConfig,
        RouterServer,
        spawn_replica,
        wait_for_port_file,
    )

    on_cpu = torch.device(device).type == "cpu"
    coord_dir = Path(tempfile.mkdtemp(prefix="pio-serve-fleet-"))
    engine_args = (["--engine", args.engine] if args.engine
                   else ["--engine-json", str(args.engine_json)])
    extra = []
    for flag, val in (
        ("--engine-factory", args.engine_factory),
        ("--engine-instance-id", args.engine_instance_id),
        ("--microbatch", args.microbatch),
        ("--shared-batcher", args.shared_batcher),
        ("--edge", args.edge),
        ("--event-server-url", args.event_server_url),
        ("--accesskey", args.accesskey),
        ("--log-url", args.log_url),
        ("--log-prefix", args.log_prefix),
        # every replica hosts the same tenants
        ("--multi", args.multi),
        ("--autopilot", args.autopilot),
    ):
        if val:
            # one argument: a value may itself begin with a dash
            extra.append(f"{flag}={val}")
    for flag, val in (
        ("--query-timeout", args.query_timeout),
        ("--max-connections", args.max_connections),
        ("--feedback-capacity", args.feedback_capacity),
        ("--breaker-failures", args.breaker_failures),
        ("--breaker-reset", args.breaker_reset),
        ("--foldin-poll", args.foldin_poll),
        ("--memory-budget", args.memory_budget),
        # every replica arms its own burn-rate gauges too: the router's
        # merged /metrics shows them per replica
        ("--slo-ms", args.slo_ms),
    ):
        if val is not None:
            extra += [flag, str(val)]
    for flag, on in (("--feedback", args.feedback),
                     ("--scan-cache", args.scan_cache),
                     ("--no-profiler", args.no_profiler)):
        if on:
            extra.append(flag)

    def spawner(i):
        return spawn_replica(engine_args, i, coord_dir, extra_args=extra,
                             on_cpu=on_cpu)

    spawned = [spawner(i) for i in range(args.replicas)]
    supervisor = None if args.no_respawn else ReplicaSupervisor(spawner)

    def reap():
        # respawns replace boot-time processes: reap what the supervisor
        # tracks now, and the boot list (dead originals reap as no-ops)
        procs = [s["proc"] for s in spawned]
        if supervisor is not None:
            procs += supervisor.live_procs()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        # a SIGTERM to the router must stop its replicas too: leave
        # through the finally below instead of dying where it stands
        prev_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    clean = False
    router = None
    try:
        replicas = []
        for s in spawned:
            port = wait_for_port_file(s)
            _out(f"Replica {s['index']} (pid {s['proc'].pid}) up on "
                 f"127.0.0.1:{port} (log: {s['log_path']})")
            replica = Replica(f"replica-{s['index']}", "127.0.0.1", port)
            if supervisor is not None:
                supervisor.attach(replica, s)
            replicas.append(replica)
        router = RouterServer(replicas, RouterConfig(
            host=args.ip, port=args.port,
            health_interval_s=args.health_interval,
            max_connections=args.max_connections,
            push_foldin_s=args.push_foldin,
            slo_ms=args.slo_ms,
        ), supervisor=supervisor)
        router._bind()
        _out(f"Router fronting {len(replicas)} replicas on "
             f"{args.ip}:{router.port}")
        # whoever reads the port file may read these lines next
        sys.stdout.flush()
        if args.port_file:
            _write_port_file(args.port_file, router.port)
        router.serve_forever()
        clean = True
    except SystemExit as e:
        clean = e.code in (0, None)
        raise
    finally:
        if router is not None:
            router.stop()
        reap()
        if on_main:
            signal.signal(signal.SIGTERM, prev_term)
        if clean:
            shutil.rmtree(coord_dir, ignore_errors=True)
    return 0


def cmd_foldin(args, storage: Storage, device: DeviceLike) -> int:
    """pio-live: incremental ALS fold-in (one cycle, or ``--watch``).

    Scans the event store past the per-(app, channel) watermark, solves
    the touched and new factor rows against the frozen opposite table
    on ``device``, and publishes delta links that a deployed engine
    server (``deploy --foldin-poll``, ``POST /foldin/apply``) patches in
    live: fresh events become fresh predictions without ``train`` or
    ``/reload``."""
    from ..controller.base import WorkflowContext
    from ..live import FoldInRunner

    engine, ep, variant, variant_key = _load_engine_for_args(args)
    md = storage.get_metadata()
    engine_id = variant.get("id", "default")
    iid, err = _resolve_instance_id(
        md, engine_id, variant_key, args.engine_instance_id
    )
    if err:
        _out(f"Error: {err}")
        return 1
    ctx = WorkflowContext(device=device, storage=storage, mode="Serving")
    try:
        runner = FoldInRunner(
            storage, engine, ep, iid, channel_id=args.channel, ctx=ctx,
            from_now=args.from_now,
        )
    except ValueError as e:
        _out(f"Error: {e}")
        return 1
    _out(f"Fold-in on instance {iid} (app {runner.app_id}, "
         f"watermark rowid {runner.cursor}, chain seq {runner.seq})")
    if args.watch:
        _out(f"Watching for events every {args.interval}s "
             "(Ctrl-C to stop)...")
        try:
            runner.watch(
                interval_s=args.interval,
                max_cycles=args.max_cycles,
                on_cycle=lambda st: _out(json.dumps(st)),
            )
        except KeyboardInterrupt:
            _out("Stopped.")
        return 0
    stats = runner.cycle()
    if stats is None:
        _out(f"No new events past watermark rowid {runner.cursor}; "
             "nothing to fold in.")
    else:
        _out(json.dumps(stats))
    return 0


def cmd_eval(args, storage: Storage, device: DeviceLike) -> int:
    from ..controller.base import WorkflowContext
    from ..workflow.evaluate import NO_CANDIDATES, run_evaluation

    if args.scan_cache:
        os.environ["PIO_TPU_SCAN_CACHE"] = "1"
    generator_path = args.engine_params_generator
    if args.engine:
        # `eval --engine NAME` dispatches the spec's declared evaluation
        # — no dotted path to remember
        from .. import engines

        spec = engines.get_engine_spec(args.engine)
        if spec.evaluation is None:
            _out(f"Error: engine '{spec.name}' declares no evaluation; "
                 "pass a dotted evaluation path instead.")
            return 1
        evaluation = spec.evaluation
        eval_class = spec.evaluation_path
        # with --engine the one positional names the generator (argparse
        # fills the first positional slot, the evaluation's)
        if args.evaluation and not generator_path:
            generator_path = args.evaluation
    elif args.evaluation:
        evaluation = resolve_attr(args.evaluation)
        eval_class = args.evaluation
    else:
        _out("Error: pass an evaluation dotted path or --engine NAME.")
        return 1
    if callable(evaluation) and not hasattr(evaluation, "engine"):
        evaluation = evaluation()
    params_list = None
    if generator_path:
        gen = resolve_attr(generator_path)
        if callable(gen) and not hasattr(gen, "engine_params_list"):
            gen = gen()
        params_list = list(gen.engine_params_list)
    elif getattr(evaluation, "engine_params_list", None) is None:
        _out(f"Error: {NO_CANDIDATES}")
        return 1
    ctx = WorkflowContext(device=device, storage=storage, mode="Evaluation",
                          batch=args.batch)
    eval_id, result = run_evaluation(
        evaluation, params_list, ctx=ctx,
        evaluation_class=eval_class,
        engine_params_generator_class=generator_path or "",
        parallelism=args.parallelism,
    )
    _out(result.to_one_liner())
    _out(f"Evaluation completed. Instance id: {eval_id}")
    return 0


def cmd_eventserver(args, storage: Storage) -> int:
    if args.workers > 1:
        return _eventserver_fleet(args, storage)
    from ..server.event_server import EventServer, EventServerConfig

    owned = None
    if args.owned_shards:
        owned = [int(s) for s in args.owned_shards.split(",") if s != ""]
    elif args.worker_index is not None:
        # shard-owner worker: stripe ownership by index
        from ..server.ingest_router import shards_for_worker

        owned = shards_for_worker(
            args.worker_index, args.worker_count,
            getattr(storage.get_event_store(), "n_shards", 1),
        )
    server = EventServer(
        storage, EventServerConfig(
            host=args.ip, port=args.port,
            stats=args.stats,
            write_retries=args.write_retries,
            write_backoff_s=args.write_backoff,
            max_connections=args.max_connections,
            wal_dir=args.wal_dir,
            owned_shards=owned,
            ttl_s=args.ttl,
            compact_interval_s=args.compact_interval,
            slo_ms=args.slo_ms,
        )
    )
    if args.port_file:
        # bind first so the announced port is real (--port 0 =
        # ephemeral); the fleet spawner reads this file.  The WAL has
        # replayed by now: a respawned worker announces only after its
        # acknowledged backlog is back in sqlite
        server._bind()
        _write_port_file(args.port_file, server.port)
    role = f" (shard owner: {owned})" if owned is not None else ""
    _out(f"Event server running on {args.ip}:{server.port}{role}")
    server.serve_forever()
    return 0


def _eventserver_fleet(args, storage: Storage) -> int:
    """``eventserver --workers N``: spawn N shard-owner worker processes
    (each owning ``shard % N == index`` of the sharded store, each with
    its own ingest WAL under ``--wal-dir``) and run the ingest router in
    THIS process on the requested port, until ``POST /stop``, SIGTERM
    or SIGINT; the workers are stopped on the way out.  The fleet's
    directory (port files, worker logs and, without ``--wal-dir``, the
    WALs) is removed after a clean stop with ``--wal-dir``; otherwise it
    stays, and its path is in the worker lines."""
    import shutil
    import signal
    import tempfile
    import threading

    from ..server.ingest_router import IngestRouterConfig, boot_ingest_fleet

    n_shards = getattr(storage.get_event_store(), "n_shards", 1)
    if args.workers > n_shards:
        _out(f"error: --workers {args.workers} exceeds the store's "
             f"{n_shards} shards; extra workers would own nothing")
        return 1
    coord_dir = Path(tempfile.mkdtemp(prefix="pio-ingest-fleet-"))
    extra = []
    for flag, val in (
        ("--write-retries", args.write_retries),
        ("--write-backoff", args.write_backoff),
        ("--max-connections", args.max_connections),
        ("--ttl", args.ttl),
        ("--compact-interval", args.compact_interval),
        # each worker arms its own write-SLO burn gauges; the router's
        # merged /metrics shows them per worker
        ("--slo-ms", args.slo_ms),
    ):
        if val is not None:
            extra += [flag, str(val)]
    if args.no_profiler:
        extra.append("--no-profiler")
    router, spawned = boot_ingest_fleet(
        args.workers, n_shards, coord_dir,
        config=IngestRouterConfig(
            host=args.ip, port=args.port,
            max_connections=args.max_connections,
        ),
        wal_root=args.wal_dir, extra_args=extra,
        respawn=not args.no_respawn,
    )

    def reap():
        procs = [s["proc"] for s in spawned]
        if router.supervisor is not None:
            procs += router.supervisor.live_procs()
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    on_main = threading.current_thread() is threading.main_thread()
    if on_main:
        # a SIGTERM to the router must stop its workers too: leave
        # through the finally below instead of dying where it stands
        prev_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    clean = False
    try:
        for w, s in zip(router.workers, spawned):
            _out(f"Ingest worker {w.index} (pid {s['proc'].pid}) up on "
                 f"127.0.0.1:{w.port} owning shards {w.shards} in "
                 f"{s['boot_s']:.2f} s (log: {s['log_path']})")
        router._bind()
        _out(f"Ingest router fronting {args.workers} shard-owner workers "
             f"({n_shards} shards) on {args.ip}:{router.port}")
        # whoever reads the port file may read these lines next
        sys.stdout.flush()
        if args.port_file:
            _write_port_file(args.port_file, router.port)
        router.serve_forever()
        clean = True
    except SystemExit as e:
        clean = e.code in (0, None)
        raise
    finally:
        router.stop()
        reap()
        if on_main and prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        if clean and args.wal_dir:
            shutil.rmtree(coord_dir, ignore_errors=True)
    return 0


def cmd_import(args, storage: Storage) -> int:
    from ..tools.import_export import import_events

    es = storage.get_event_store()
    es.init_channel(args.appid, args.channel)
    # import_events infers the format (extension or content magic) and
    # routes to the JSON-lines, columnar or Parquet reader itself
    counts: dict = {}
    n = import_events(args.input, es, args.appid, args.channel,
                      counts=counts)
    if counts:
        logger.info("import of %s: %d events by the native scanner, %d "
                    "parsed in Python", args.input, counts["native"],
                    counts["python"])
    _out(f"Imported {n} events.")
    return 0


def cmd_export(args, storage: Storage) -> int:
    from ..tools.import_export import (
        columnar_path,
        export_events,
        infer_format,
    )

    es = storage.get_event_store()
    es.init_channel(args.appid, args.channel)
    n = export_events(args.output, es, args.appid, args.channel,
                      fmt=args.format)
    fmt = args.format or infer_format(args.output)
    written = columnar_path(args.output) if fmt == "columnar" else args.output
    _out(f"Exported {n} events to {written}.")
    return 0


def cmd_template(args, storage: Storage) -> int:
    """Template gallery (`console/Template.scala:130-427` analogue)."""
    import http.client
    import urllib.error

    from ..tools.template_gallery import (
        TemplateVersionError, fetch_index, list_templates, scaffold,
        scaffold_from_archive, scaffold_from_index, scaffold_from_url,
    )

    if args.template_command == "list":
        if args.index_url:
            try:
                entries = fetch_index(args.index_url)
            except (ValueError, urllib.error.URLError, OSError,
                    http.client.HTTPException) as e:
                _out(f"Error: {e}")
                return 1
            for e in entries:
                _out(f"{e['name']:<26} {e.get('description', '')}")
            return 0
        for t in list_templates():
            _out(f"{t.name:<26} {t.description}")
        return 0
    if args.template_command == "get":
        target_dir = args.directory or args.name
        try:
            if args.from_archive:
                target = scaffold_from_archive(args.from_archive, target_dir)
            elif args.from_url:
                target = scaffold_from_url(args.from_url, target_dir)
            elif args.index_url:
                target = scaffold_from_index(args.name, target_dir,
                                             args.index_url)
            else:
                target = scaffold(args.name, target_dir)
        except (KeyError, FileExistsError, FileNotFoundError, ValueError,
                TemplateVersionError, urllib.error.URLError, OSError,
                http.client.HTTPException) as e:
            # HTTPException covers truncated/garbage responses
            # (IncompleteRead, BadStatusLine) that are not OSErrors
            _out(f"Error: {e}")
            return 1
        _out(f"Engine template '{args.name}' created at {target}/")
        return 0
    raise AssertionError(args.template_command)


def _engine_id_of(engine_json: str, variant: dict) -> str:
    return variant.get("id", Path(engine_json).resolve().parent.name)


def cmd_build(args, storage: Storage) -> int:
    """Validate the engine variant and register its manifest.

    The reference `build` runs sbt then `RegisterEngine` (Console.scala:
    772-802); with Python engines the build step reduces to import-checking
    the factory and upserting the `EngineManifest`.
    """
    from ..storage.metadata import EngineManifest
    from ..tools.template_gallery import verify_template_min_version

    verify_template_min_version(Path(args.engine_json).parent)
    try:
        engine, ep, variant = load_engine_from_variant(
            args.engine_json, args.engine_factory
        )
    except Exception as e:  # any failure to load is the user's to see
        _out(f"Error: engine variant failed to load: {e}")
        return 1
    engine_id = _engine_id_of(args.engine_json, variant)
    storage.get_metadata().manifest_upsert(
        EngineManifest(
            id=engine_id,
            version=args.engine_version,
            name=engine_id,
            description=variant.get("description"),
            files=[str(Path(args.engine_json).resolve())],
            engine_factory=args.engine_factory
            or variant.get("engineFactory", ""),
        )
    )
    _out(f"Engine '{engine_id}' built and registered "
         f"(version {args.engine_version}).")
    return 0


def cmd_unregister(args, storage: Storage) -> int:
    variant = json.loads(Path(args.engine_json).read_text())
    engine_id = _engine_id_of(args.engine_json, variant)
    storage.get_metadata().manifest_delete(engine_id, args.engine_version)
    _out(f"Engine '{engine_id}' unregistered.")
    return 0


def cmd_run(args, storage: Storage) -> int:
    """Run an arbitrary dotted-path main under the framework env
    (Console `run` analogue — there it spark-submits a user class)."""
    fn = resolve_attr(args.main_class)
    if not callable(fn):
        _out(f"Error: {args.main_class} resolved to a non-callable "
             f"{type(fn).__name__}.")
        return 1
    rv = fn(*args.args)
    return int(rv) if isinstance(rv, int) else 0


def cmd_undeploy(args, storage: Storage) -> int:
    """POST /stop to a deployed engine server (Console.scala undeploy)."""
    import urllib.error
    import urllib.request

    url = f"http://{args.ip}:{args.port}/stop"
    try:
        with urllib.request.urlopen(
            urllib.request.Request(url, method="POST"), timeout=5
        ) as r:
            r.read()
    except (urllib.error.URLError, OSError) as e:
        _out(f"Error: cannot undeploy {args.ip}:{args.port}: {e}")
        return 1
    _out(f"Undeployed engine server at {args.ip}:{args.port}.")
    return 0


def cmd_upgrade(args, storage: Storage) -> int:
    """The reference phones home for new versions (WorkflowUtils.scala:
    220-225); this build is offline, so report the installed version."""
    _out(f"pio-tpu {__version__} — no network egress; upgrade checks "
         "are disabled in this environment.")
    return 0


# probe of the card, run in a bounded subprocess: CUDA initialisation
# can hang on a broken GPU stack, and `status` is the command an operator
# runs to diagnose that
_DEVICE_PROBE = (
    "import torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "print('DEVICES=' + repr([torch.cuda.get_device_name(i) "
    "for i in range(n)]))\n"
)


def _build_state(build_dir: Path, lib_name: str, digest: str,
                 compiler: str) -> str:
    lib, stamp = build_dir / lib_name, build_dir / "sources.sha256"
    if not lib.is_file():
        return f"{lib}: not built ({compiler} builds it at first use)"
    if not stamp.is_file() or stamp.read_text() != digest:
        return f"{lib}: stale ({compiler} rebuilds it at first use)"
    return f"{lib}: built, up to date"


def cmd_status(args, storage: Storage) -> int:
    """Sanity-check env + storage (console/Console.scala:1028-1085)."""
    import torch

    from .. import native
    from ..ops import _build

    _out(f"predictionio_tpu_torch {__version__}")
    _out(f"torch {torch.__version__} (CUDA {torch.version.cuda})")
    if args.probe_timeout <= 0:
        _out("CUDA devices: probe skipped (--probe-timeout 0)")
    else:
        try:
            proc = subprocess.run(
                [sys.executable, "-c", _DEVICE_PROBE], capture_output=True,
                text=True, timeout=args.probe_timeout,
            )
            found = [ln[len("DEVICES="):] for ln in proc.stdout.splitlines()
                     if ln.startswith("DEVICES=")]
            if not found:
                lines = proc.stderr.strip().splitlines()
                _out("Warning: the CUDA probe failed: "
                     f"{(lines or ['no output'])[-1]}")
            elif found[0] == "[]":
                _out("Warning: no CUDA device is available (train and "
                     "deploy need one; the other commands run anywhere)")
            else:
                _out(f"CUDA devices: {found[0]}")
        except subprocess.TimeoutExpired:
            _out(f"Warning: CUDA initialisation did not answer within "
                 f"{args.probe_timeout}s; commands that touch no device "
                 "are unaffected")
    try:
        storage.verify_all_data_objects()
        _out("Storage: OK (metadata, event store, model data verified)")
    except Exception as e:  # status reports the failure, it never raises
        _out(f"Error: storage verification failed: {e}")
        return 1
    _out("CUDA kernels: " + _build_state(
        _build.BUILD_DIR, _build.LIB_NAME, _build._source_hash(), "nvcc"))
    _out("Native host runtime: " + _build_state(
        native.BUILD_DIR, native.LIB_NAME, native._source_hash(), "g++"))
    _out("Ready.")
    return 0


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pio-tpu",
        description="predictionio_tpu_torch console "
        "(the `pio` command, on PyTorch and CUDA)",
    )
    p.add_argument("--version", action="version",
                   version=f"pio-tpu {__version__}")
    p.add_argument("--verbose", action="store_true",
                   help="chatty logging (WorkflowUtils.modifyLogging)")
    p.add_argument("--debug", action="store_true",
                   help="debug logging")
    sub = p.add_subparsers(dest="command", required=True)

    ap = sub.add_parser("app", help="manage apps")
    aps = ap.add_subparsers(dest="app_command", required=True)
    x = aps.add_parser("new")
    x.add_argument("name")
    x.add_argument("--description")
    x.add_argument("--access-key")
    aps.add_parser("list")
    x = aps.add_parser("show")
    x.add_argument("name")
    x = aps.add_parser("delete")
    x.add_argument("name")
    x = aps.add_parser("data-delete")
    x.add_argument("name")
    x.add_argument("--channel")
    x = aps.add_parser("trim", help="delete old events")
    x.add_argument("name")
    x.add_argument("--before", help="delete events before this ISO8601 time")
    x.add_argument("--event", action="append",
                   help="restrict to these event names (repeatable)")
    x.add_argument("--channel")
    x.add_argument("--all", action="store_true",
                   help="also delete $set/$unset/$delete property events")
    x.add_argument("--compact", action="store_true",
                   help="reclaim freed space afterwards (sqlite VACUUM)")
    aps.add_parser("compact",
                   help="reclaim space freed by trims/deletes")
    x = aps.add_parser("channel-new")
    x.add_argument("name")
    x.add_argument("channel")
    x = aps.add_parser("channel-delete")
    x.add_argument("name")
    x.add_argument("channel")

    ak = sub.add_parser("accesskey", help="manage access keys")
    aks = ak.add_subparsers(dest="ak_command", required=True)
    x = aks.add_parser("new")
    x.add_argument("app_name")
    x.add_argument("events", nargs="*")
    x = aks.add_parser("list")
    x.add_argument("app_name", nargs="?")
    x = aks.add_parser("delete")
    x.add_argument("key")

    en = sub.add_parser("engines",
                        help="engine registry (built-in templates + "
                        "PIO_TPU_ENGINE_PATH dirs)")
    ens = en.add_subparsers(dest="engines_command", required=True)
    ens.add_parser("list", help="list every registered engine")
    x = ens.add_parser("describe",
                       help="JSON spec of one registered engine")
    x.add_argument("name")

    t = sub.add_parser("train", help="train an engine")
    _add_obs_args(t)
    t.add_argument("--engine-json", default="engine.json")
    t.add_argument("--engine", metavar="NAME",
                   help="train a REGISTERED engine by name (no engine.json "
                   "needed; see `engines list`)")
    t.add_argument("--engine-factory")
    t.add_argument("--batch", default="")
    t.add_argument("--skip-sanity-check", action="store_true")
    t.add_argument("--stop-after-read", action="store_true")
    t.add_argument("--stop-after-prepare", action="store_true")
    t.add_argument("--engine-params-key",
                   help="use EngineFactory.engine_params(<key>) instead of "
                   "the engine.json params")
    t.add_argument("--coordinator",
                   help="multi-process: coordinator address host:port "
                   "(process 0 serves it)")
    t.add_argument("--num-processes", type=int,
                   help="multi-process: the number of processes")
    t.add_argument("--process-id", type=int,
                   help="multi-process: this process's id, 0 .. N-1")
    t.add_argument("--scan-cache", action="store_true",
                   help="snapshot columnar event scans to npz keyed by a "
                   "table write-version (storage/scan_cache.py); repeat "
                   "trains on an unchanged table skip the sqlite scan")

    d = sub.add_parser("deploy", help="deploy an engine server")
    _add_obs_args(d)
    d.add_argument("--scan-cache", action="store_true",
                   help="snapshot columnar event scans to npz keyed by a "
                   "table write-version (storage/scan_cache.py)")
    d.add_argument("--engine-json", default="engine.json")
    d.add_argument("--engine", metavar="NAME",
                   help="deploy a REGISTERED engine by name (serves the "
                   "latest instance trained with `train --engine NAME`)")
    d.add_argument("--engine-factory")
    d.add_argument("--engine-instance-id")
    d.add_argument("--ip", default="0.0.0.0")
    d.add_argument("--port", type=int, default=8000)
    d.add_argument("--feedback", action="store_true",
                   help="post every answered query back to the event "
                   "server as a pio_pr event (needs --event-server-url "
                   "and --accesskey); the reply carries its prId")
    d.add_argument("--event-server-url")
    d.add_argument("--accesskey")
    d.add_argument("--log-url",
                   help="ship serving errors to this URL via POST "
                   "(reference CreateServer remoteLog)")
    d.add_argument("--log-prefix", default="",
                   help="string prepended to each shipped log payload")
    d.add_argument("--microbatch", choices=("auto", "on", "off"),
                   default="auto",
                   help="coalesce concurrent queries into one batched "
                   "device call (auto: when the algorithm batch-"
                   "predicts; off restores bitwise per-request "
                   "determinism)")
    d.add_argument("--shared-batcher", choices=("on", "off"),
                   default="on",
                   help="ONE shared continuous batcher per server, "
                   "claimed by weighted deficit round-robin across "
                   "tenants (off: a private batcher)")
    d.add_argument("--query-timeout", type=float, default=None,
                   metavar="SEC",
                   help="per-request time budget: expiry answers a "
                   "structured 503 + Retry-After instead of queueing "
                   "device work behind a client that gave up "
                   "(per-request override: /queries.json?timeout=SEC)")
    d.add_argument("--feedback-capacity", type=int, default=1024,
                   help="bounded feedback/remote-log delivery queue "
                   "size; overflow drops the OLDEST entry and counts "
                   "it in the status JSON")
    d.add_argument("--breaker-failures", type=int, default=5,
                   help="consecutive delivery failures that open the "
                   "circuit breaker for a dead event server / log "
                   "collector")
    d.add_argument("--breaker-reset", type=float, default=10.0,
                   metavar="SEC",
                   help="seconds an open delivery breaker waits before "
                   "letting one probe through")
    d.add_argument("--flight-capacity", type=int, default=None,
                   metavar="N",
                   help="slow-query flight recorder keeps the N "
                   "slowest requests' full span trees (default: "
                   "$PIO_TPU_XRAY_FLIGHT_N or 16; see /debug/xray)")
    d.add_argument("--foldin-poll", type=float, default=None,
                   metavar="SEC",
                   help="pio-live: poll the model dir every SEC seconds "
                   "for fold-in delta links and patch them into the "
                   "serving model in place (no reload); pair with a "
                   "`foldin --watch` daemon")
    d.add_argument("--edge", choices=("eventloop", "threads"),
                   default="eventloop",
                   help="serving front end: eventloop = one selector "
                   "loop, no thread per connection (default); threads = "
                   "the stdlib ThreadingHTTPServer edge")
    d.add_argument("--max-connections", type=int, default=512,
                   help="concurrent-connection cap; connection "
                   "attempts past it get a structured 503 and are "
                   "closed (slow-loris guard)")
    d.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                   help="latency SLO in milliseconds: arms the "
                   "pio_slo_burn_rate{window} error-budget gauges on "
                   "this server's latency histogram")
    d.add_argument("--replicas", type=int, default=0, metavar="N",
                   help="fleet mode: spawn N replica processes on "
                   "ephemeral ports and run a router on --port fanning "
                   "out over them with health checks and failover")
    d.add_argument("--health-interval", type=float, default=1.0,
                   metavar="SEC",
                   help="fleet mode: router health-check period")
    d.add_argument("--push-foldin", type=float, default=None,
                   metavar="SEC",
                   help="fleet mode: every SEC seconds the router walks "
                   "the replicas one at a time, POSTing /foldin/apply "
                   "so each applies the pending fold-in delta links "
                   "(POST /admin/push-foldin does it on demand)")
    d.add_argument("--port-file", metavar="PATH",
                   help="announce the BOUND port (after --port 0 "
                   "resolution) by writing it to PATH")
    d.add_argument("--no-respawn", action="store_true",
                   help="fleet mode: disable the replica-respawn "
                   "supervisor (default: a dead replica process is "
                   "respawned with capped exponential backoff and "
                   "booked in pio_replica_respawns_total)")
    d.add_argument("--multi", metavar="TENANTS_JSON",
                   help="host EVERY tenant of this manifest in one "
                   "process (or one fleet with --replicas): lazy load "
                   "and LRU eviction under a memory budget, per-tenant "
                   "breakers, quotas and metrics, and weighted sticky "
                   "A/B variant routing; tenant 0 is the pinned anchor")
    d.add_argument("--memory-budget", type=float, default=None,
                   metavar="BYTES",
                   help="override the manifest's memoryBudgetBytes "
                   "(0 = unbounded): resident tenant models are "
                   "LRU-evicted to stay under it; pinned and in-flight "
                   "tenants are never evicted")
    d.add_argument("--autopilot", metavar="ON|JSON",
                   help="run the SPRT auto-weight controller on the "
                   "registry's experiments ('on' for the defaults, or "
                   "a JSON object of knobs: alpha/beta/minLift/"
                   "minSamples/maxStep/minWeight/burnThreshold; needs "
                   "--multi); every decision lands in a run manifest "
                   "and at GET /debug/experiments")

    fi = sub.add_parser(
        "foldin",
        help="pio-live: fold new events into the deployed model "
        "incrementally (no full retrain)",
    )
    _add_obs_args(fi)
    fi.add_argument("--engine-json", default="engine.json")
    fi.add_argument("--engine", metavar="NAME",
                    help="fold into a REGISTERED engine by name")
    fi.add_argument("--engine-factory")
    fi.add_argument("--engine-instance-id",
                    help="fold into this instance (default: latest "
                    "completed)")
    fi.add_argument("--channel", type=int, default=0)
    fi.add_argument("--watch", action="store_true",
                    help="keep running: poll the event-store watermark "
                    "and fold in whenever it advances")
    fi.add_argument("--interval", type=float, default=5.0,
                    metavar="SEC",
                    help="watch-mode poll period (default 5s)")
    fi.add_argument("--max-cycles", type=int, default=None,
                    help="stop --watch after N non-empty fold-in "
                    "cycles (smoke/bench harnesses)")
    fi.add_argument("--from-now", action="store_true",
                    help="on the FIRST run (no watermark, no chain): "
                    "start the cursor at the store's current high-water "
                    "mark instead of re-folding the history the full "
                    "train already saw")

    e = sub.add_parser("eval", help="run an evaluation sweep")
    _add_obs_args(e)
    e.add_argument("evaluation", nargs="?",
                   help="dotted path to an Evaluation (or factory); "
                   "with --engine NAME, the one positional is the "
                   "generator")
    e.add_argument("--engine", metavar="NAME",
                   help="run the evaluation a REGISTERED engine "
                   "declares in its spec")
    e.add_argument("engine_params_generator", nargs="?",
                   help="dotted path to an EngineParamsGenerator")
    e.add_argument("--batch", default="")
    e.add_argument("--parallelism", type=int, default=1,
                   help="candidates scored concurrently (>1 disables "
                   "FastEval prefix caching)")
    e.add_argument("--scan-cache", action="store_true",
                   help="snapshot columnar event scans to npz keyed by a "
                   "table write-version (storage/scan_cache.py)")

    ev = sub.add_parser("eventserver", help="run the event server")
    _add_obs_args(ev)
    ev.add_argument("--ip", default="0.0.0.0")
    ev.add_argument("--port", type=int, default=7070)
    ev.add_argument("--stats", action="store_true", default=True)
    ev.add_argument("--write-retries", type=int, default=3,
                    help="attempts (first try included) for a transient "
                    "storage failure before the route answers 503 + "
                    "Retry-After")
    ev.add_argument("--write-backoff", type=float, default=0.05,
                    metavar="SEC",
                    help="base backoff between storage retries "
                    "(decorrelated jitter grows it toward a 10x cap)")
    ev.add_argument("--max-connections", type=int, default=512,
                    help="concurrent-connection cap; attempts past it "
                    "get a structured 503 and are closed")
    ev.add_argument("--workers", type=int, default=0, metavar="N",
                    help="boot N shard-owner worker processes (each "
                    "owning shard %% N == index of the sharded store, "
                    "each with its own ingest WAL) behind an ingest "
                    "router in this process; 0/1 = single process")
    ev.add_argument("--wal-dir", metavar="DIR",
                    help="group-commit ingest WAL root: events are "
                    "fsynced here before the 2xx and drained to sqlite "
                    "in the background; a crash replays the tail on "
                    "next boot (off by default: ack = sqlite commit)")
    ev.add_argument("--no-wal-fsync", action="store_true",
                    help="skip the per-group fsync (refused: the port's "
                    "WAL always fsyncs before the ack)")
    ev.add_argument("--ttl", type=float, metavar="SEC",
                    help="purge events older than SEC on a maintenance "
                    "timer (bounded live window)")
    ev.add_argument("--compact-interval", type=float, metavar="SEC",
                    help="VACUUM owned shard files every SEC (reclaims "
                    "TTL-purged space; off by default)")
    ev.add_argument("--owned-shards", metavar="CSV",
                    help="restrict writes to these shard indexes "
                    "(shard-owner worker mode; e.g. 0,2,4)")
    ev.add_argument("--worker-index", type=int, metavar="I",
                    help="this worker's index in a --workers fleet "
                    "(stripes ownership: shard %% count == I)")
    ev.add_argument("--worker-count", type=int, default=1, metavar="N",
                    help="fleet size for --worker-index striping")
    ev.add_argument("--port-file", metavar="PATH",
                    help="write the bound port here after bind "
                    "(--port 0 = ephemeral; the fleet spawner reads it)")
    ev.add_argument("--no-respawn", action="store_true",
                    help="with --workers: do not respawn dead workers")
    ev.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                    help="event-write latency SLO: arms the multi-"
                    "window pio_slo_burn_rate gauges over the event-"
                    "write histogram (with --workers, each shard owner "
                    "arms its own)")

    ad = sub.add_parser("adminserver", help="run the admin API server "
                        "(not ported: refused)")
    _add_obs_args(ad)
    ad.add_argument("--ip", default="127.0.0.1")
    ad.add_argument("--port", type=int, default=7071)

    db = sub.add_parser("dashboard", help="run the evaluation dashboard "
                        "(not ported: refused)")
    _add_obs_args(db)
    db.add_argument("--ip", default="127.0.0.1")
    db.add_argument("--port", type=int, default=9000)

    im = sub.add_parser("import",
                        help="import events (JSON lines, .npz columnar or "
                        ".parquet, by extension or content)")
    im.add_argument("--appid", type=int, required=True)
    im.add_argument("--channel", type=int, default=0)
    im.add_argument("--input", required=True)

    ex = sub.add_parser("export", help="export events to a file")
    ex.add_argument("--appid", type=int, required=True)
    ex.add_argument("--channel", type=int, default=0)
    ex.add_argument("--output", required=True)
    ex.add_argument("--format", choices=["json", "columnar", "parquet"],
                    help="default: json, or columnar/parquet for an "
                    ".npz/.parquet output")

    tp = sub.add_parser("template", help="engine template gallery")
    tps = tp.add_subparsers(dest="template_command", required=True)
    tl = tps.add_parser("list")
    tl.add_argument("--index-url", metavar="URL",
                    help="browse a REMOTE JSON template index instead "
                    "of the built-in gallery")
    x = tps.add_parser("get")
    x.add_argument("name")
    x.add_argument("directory", nargs="?")
    x.add_argument("--from-archive", metavar="PATH",
                   help="scaffold from a local zip/tar engine archive "
                   "instead of the built-in gallery")
    x.add_argument("--from-url", metavar="URL",
                   help="download a zip/tar engine archive over "
                   "http(s) and scaffold from it")
    x.add_argument("--index-url", metavar="URL",
                   help="look NAME up in a remote JSON template index "
                   "and download its archive")

    b = sub.add_parser("build", help="validate + register an engine")
    b.add_argument("--engine-json", default="engine.json")
    b.add_argument("--engine-factory")
    b.add_argument("--engine-version", default="1")

    ur = sub.add_parser("unregister", help="remove an engine manifest")
    ur.add_argument("--engine-json", default="engine.json")
    ur.add_argument("--engine-version", default="1")

    rn = sub.add_parser("run", help="run a dotted-path main under the env")
    rn.add_argument("main_class")
    rn.add_argument("args", nargs="*")

    ud = sub.add_parser("undeploy", help="stop a deployed engine server")
    ud.add_argument("--ip", default="127.0.0.1")
    ud.add_argument("--port", type=int, default=8000)

    sub.add_parser("upgrade", help="check for framework upgrades")
    stp = sub.add_parser("status", help="check environment and storage")
    stp.add_argument("--probe-timeout", type=float, default=30.0,
                     help="seconds to wait for CUDA initialisation before "
                     "reporting the card unreachable (status never hangs "
                     "on a broken GPU stack)")
    sub.add_parser("version")
    sub.add_parser("help", help="show this help")
    return p


_DISPATCH = {
    "app": cmd_app,
    "accesskey": cmd_accesskey,
    "engines": cmd_engines,
    "eventserver": cmd_eventserver,
    "import": cmd_import,
    "export": cmd_export,
    "template": cmd_template,
    "build": cmd_build,
    "unregister": cmd_unregister,
    "run": cmd_run,
    "undeploy": cmd_undeploy,
    "upgrade": cmd_upgrade,
    "status": cmd_status,
}
# the commands that run on a device
_DEVICE_DISPATCH = {
    "train": cmd_train,
    "deploy": cmd_deploy,
    "foldin": cmd_foldin,
    "eval": cmd_eval,
}


def main(argv: Optional[list[str]] = None,
         storage: Optional[Storage] = None,
         device: DeviceLike = "cuda") -> int:
    args = build_parser().parse_args(argv)
    from ..tools.template_gallery import TemplateVersionError
    from ..utils.logging import setup_logging

    setup_logging(verbose=args.verbose, debug=args.debug)
    if args.command == "version":
        _out(f"pio-tpu {__version__}")
        return 0
    if args.command == "help":
        build_parser().print_help()
        return 0
    refused = _refusal(args)
    if refused is not None:
        _out(f"Error: {refused}")
        return 1
    _apply_obs_flags(args)
    storage = storage or get_storage()
    try:
        if args.command in _DEVICE_DISPATCH:
            return _DEVICE_DISPATCH[args.command](args, storage, device)
        return _DISPATCH[args.command](args, storage)
    except (TemplateVersionError, NotImplementedError) as e:
        # NotImplementedError: a library call refused what the port does
        # not have yet (an import format, an engine.json option)
        _out(f"Error: {e}")
        return 1


if __name__ == "__main__":
    sys.exit(main())
