"""Evaluation dashboard (port 9000).

Port of ``predictionio_tpu/server/dashboard.py``: every page the
reference serves, read from the port's ``obs/``, ``tenancy/autopilot.py``
and ``obs/runlog.py``.  Re-expression of reference
`tools/dashboard/Dashboard.scala:30-141`: an HTML
index of completed evaluation instances with drill-down to
``evaluator_results.{txt,html,json}`` per instance, plus CORS headers
(`dashboard/CorsSupport.scala`), plus the pio-obs **live metrics** page
(``/metrics.html``: current registry samples + recent spans — the
operator view next to the evaluation index; machines scrape
``/metrics``).
"""

from __future__ import annotations

import html as _html
import json
import logging
import urllib.parse

from ..obs import get_registry, get_tracer, telemetry_home
from ..storage.registry import Storage
from .http_base import HTTPServerBase, JsonRequestHandler

logger = logging.getLogger(__name__)

__all__ = ["DashboardServer"]


class DashboardServer(HTTPServerBase):
    server_name = "dashboard"

    def __init__(self, storage: Storage, host: str = "127.0.0.1",
                 port: int = 9000):
        self.storage = storage
        self.host = host
        self.port = port

    def index_html(self) -> str:
        md = self.storage.get_metadata()
        rows = []
        for ev in md.evaluation_instance_get_completed():
            rows.append(
                "<tr><td>{id}</td><td>{cls}</td><td>{start}</td>"
                "<td>{end}</td><td>{res}</td>"
                "<td><a href='/engine_instances/{id}/evaluator_results.txt'>txt</a> "
                "<a href='/engine_instances/{id}/evaluator_results.html'>html</a> "
                "<a href='/engine_instances/{id}/evaluator_results.json'>json</a>"
                "</td></tr>".format(
                    id=_html.escape(ev.id),
                    cls=_html.escape(ev.evaluation_class),
                    start=_html.escape(ev.start_time),
                    end=_html.escape(ev.end_time),
                    res=_html.escape(ev.evaluator_results),
                )
            )
        # pio-live row: one recent-events link per app (rowid-cursor
        # backed — see events_html), next to the evaluations table
        app_links = " &middot; ".join(
            f"<a href='/events.html?app={a.id}'>{_html.escape(a.name)}"
            f" (id {a.id})</a>"
            for a in md.app_get_all()
        ) or "(no apps)"
        return (
            "<html><head><title>predictionio_tpu_torch dashboard</title>"
            "</head>"
            "<body><h1>Completed evaluations</h1>"
            "<table border='1'><tr><th>id</th><th>evaluation</th>"
            "<th>start</th><th>end</th><th>result</th><th>details</th></tr>"
            + "\n".join(rows)
            + "</table>"
            "<p>Recent events (pio-live): " + app_links + "</p>"
            "<p><a href='/metrics.html'>live metrics</a> &middot; "
            "<a href='/xray.html'>x-ray</a> &middot; "
            "<a href='/pulse.html'>pulse</a> &middot; "
            "<a href='/train.html'>training console</a> &middot; "
            "<a href='/tenants.html'>tenants</a> &middot; "
            "<a href='/experiments.html'>experiments</a> &middot; "
            "<a href='/fleet.html'>fleet</a> &middot; "
            "<a href='/prof.html'>flamegraph</a> &middot; "
            "<a href='/metrics'>prometheus exposition</a></p>"
            "</body></html>"
        )

    def events_html(self, app_id: int, channel_id: int = 0,
                    limit: int = 50) -> str:
        """Newest events of an (app, channel), via the event store's
        indexed rowid cursor (`SQLiteEventStore.find_rows_since`
        ``newest_first`` — one B-tree range read) instead of a
        full-table scan + time sort.  Stores without the cursor API
        (memory backend) fall back to the reversed time-ordered
        ``find``."""
        es = self.storage.get_event_store()
        rows = []
        if hasattr(es, "find_since"):
            pairs, _ = es.find_since(
                app_id, channel_id, cursor=0, limit=limit,
                newest_first=True,
            )
        else:
            pairs = [
                (0, e)
                for e in es.find(
                    app_id, channel_id, limit=limit, reversed=True
                )
            ]
        for rowid, e in pairs:
            rows.append(
                "<tr><td>{rid}</td><td>{ev}</td><td>{ent}</td>"
                "<td>{tgt}</td><td>{t}</td></tr>".format(
                    rid=rowid or "-",
                    ev=_html.escape(e.event),
                    ent=_html.escape(
                        f"{e.entity_type}/{e.entity_id}"
                    ),
                    tgt=_html.escape(
                        f"{e.target_entity_type}/{e.target_entity_id}"
                        if e.target_entity_id else "-"
                    ),
                    t=_html.escape(str(e.event_time)),
                )
            )
        return (
            "<html><head><title>recent events</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            f"<body><h1>Recent events — app {app_id}"
            f"{f' channel {channel_id}' if channel_id else ''}</h1>"
            "<table border='1'><tr><th>rowid</th><th>event</th>"
            "<th>entity</th><th>target</th><th>time</th></tr>"
            + "\n".join(rows) + "</table>"
            "<p><a href='/'>back</a></p></body></html>"
        )

    def metrics_html(self) -> str:
        """Operator view of the process-wide registry + recent spans."""
        reg = get_registry()
        rows = []
        for name, label_items, value in reg.collect():
            lbl = ", ".join(f"{k}={v}" for k, v in label_items)
            rows.append(
                "<tr><td>{n}</td><td>{l}</td><td>{v}</td></tr>".format(
                    n=_html.escape(name), l=_html.escape(lbl),
                    v=_html.escape(f"{value:g}"),
                )
            )
        spans = get_tracer().spans(limit=50)
        span_rows = [
            "<tr><td>{n}</td><td>{t}</td><td>{d:.3f}</td></tr>".format(
                n=_html.escape(s.name),
                t=_html.escape(s.trace_id or "-"),
                d=s.duration_s * 1e3,
            )
            for s in reversed(spans)
        ]
        return (
            "<html><head><title>live metrics</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            "<body><h1>Live metrics</h1>"
            "<p>Prometheus exposition at <a href='/metrics'>/metrics"
            "</a> &middot; compiler/device view at "
            "<a href='/xray.html'>/xray.html</a>.</p>"
            "<table border='1'><tr><th>metric</th><th>labels</th>"
            "<th>value</th></tr>" + "\n".join(rows) + "</table>"
            "<h2>Recent spans (newest first)</h2>"
            "<table border='1'><tr><th>span</th><th>trace</th>"
            "<th>ms</th></tr>" + "\n".join(span_rows) + "</table>"
            "</body></html>"
        )

    def xray_html(self) -> str:
        """Operator view of the pio-xray payload: jit entry points,
        the recompile ring (with signature deltas), device memory, and
        the slow-query flight recorder.  Machines read /debug/xray."""
        from ..obs.xray import xray_payload

        p = xray_payload()

        def esc(v) -> str:
            return _html.escape(str(v))

        jit_rows = [
            "<tr><td>{f}</td><td>{c}</td><td>{s}</td><td>{bc}</td>"
            "<td>{t}</td></tr>".format(
                f=esc(fn), c=st["calls"], s=st["signatures"],
                bc=st["backendCompiles"],
                t=f"{st['compileSecondsTotal']:.3f}",
            )
            for fn, st in sorted(p["jit"].items())
        ]
        rec_rows = []
        for e in reversed(p["recompiles"]):
            delta = e.get("delta") or {}
            changed = "; ".join(
                f"{c['arg']}: {c['from']} -> {c['to']}"
                for c in delta.get("changed", [])
            ) or "(first signature)"
            rec_rows.append(
                "<tr><td>{f}</td><td>{k}</td><td>{t}</td>"
                "<td>{d}</td></tr>".format(
                    f=esc(e["fn"]), k=esc(e["kind"]),
                    t=esc(e.get("traceId") or "-"), d=esc(changed),
                )
            )
        dev_rows = [
            "<tr><td>{d}</td><td>{s}</td><td>{v}</td></tr>".format(
                d=esc(s["device"]), s=esc(stat), v=f"{v:,}",
            )
            for s in p["devices"]["samples"]
            for stat, v in sorted(s["stats"].items())
        ]
        flight_rows = [
            "<tr><td>{t}</td><td>{ms:.2f}</td><td>{n}</td></tr>".format(
                t=esc(w["traceId"]), ms=w["durationSec"] * 1e3,
                n=w["spanCount"],
            )
            for w in p["flight"]["worst"]
        ]
        cache = p["compileCache"]
        return (
            "<html><head><title>x-ray</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            "<body><h1>X-ray: compiler &amp; device</h1>"
            "<p>JSON at <a href='/debug/xray'>/debug/xray</a>. "
            "Compilation cache: "
            f"<code>{esc(cache['dir'] or 'disabled')}</code> "
            f"{esc(cache['events'] or '')}</p>"
            "<h2>Instrumented jit entry points</h2>"
            "<table border='1'><tr><th>fn</th><th>calls</th>"
            "<th>signatures</th><th>backend compiles</th>"
            "<th>compile s total</th></tr>"
            + "\n".join(jit_rows) + "</table>"
            "<h2>Recompile ring (newest first)</h2>"
            "<table border='1'><tr><th>fn</th><th>kind</th>"
            "<th>trace</th><th>signature delta</th></tr>"
            + "\n".join(rec_rows) + "</table>"
            "<h2>Device memory</h2>"
            "<table border='1'><tr><th>device</th><th>stat</th>"
            "<th>bytes</th></tr>" + "\n".join(dev_rows) + "</table>"
            "<h2>Flight recorder (slowest requests)</h2>"
            "<table border='1'><tr><th>trace</th><th>ms</th>"
            "<th>spans</th></tr>" + "\n".join(flight_rows) + "</table>"
            "</body></html>"
        )

    def tenants_html(self) -> str:
        """Operator view of the pio-hive layer: per-(app, variant)
        serving outcomes and latency, residency/eviction counters, and
        the online A/B table (impressions / conversions / rate) — the
        same registry families ``/metrics`` exposes, rendered per
        tenant.  (Full registry detail lives on the engine server's
        ``GET /debug/tenants``.)"""
        from ..obs import (
            TENANT_LOADS_TOTAL,
            TENANT_MEMORY_BUDGET,
            TENANT_QUERIES_TOTAL,
            TENANT_QUERY_LATENCY,
            TENANT_RESIDENT_BYTES,
            TENANTS_RESIDENT,
            VARIANT_FEEDBACK_TOTAL,
            VARIANT_RATE,
            VARIANT_REQUESTS_TOTAL,
        )

        def esc(v) -> str:
            return _html.escape(str(v))

        def by_tenant(family, value_of):
            out: dict[tuple, dict] = {}
            for key, child in family.children():
                k = dict(key)
                tenant = (k.get("app", "?"), k.get("variant", "?"))
                out.setdefault(tenant, {}).update(value_of(k, child))
            return out

        tenants: dict[tuple, dict] = {}
        for (app, variant), d in by_tenant(
            TENANT_QUERIES_TOTAL,
            lambda k, c: {f"q_{k.get('status', '?')}": c.value()},
        ).items():
            tenants.setdefault((app, variant), {}).update(d)
        for (app, variant), d in by_tenant(
            TENANT_RESIDENT_BYTES,
            lambda k, c: {"resident": c.value()},
        ).items():
            tenants.setdefault((app, variant), {}).update(d)
        for key, child in TENANT_QUERY_LATENCY.children():
            k = dict(key)
            snap = child.snapshot()
            if snap["count"]:
                tenants.setdefault(
                    (k.get("app", "?"), k.get("variant", "?")), {}
                ).update({
                    "p50_ms": child.percentile(50, snap) * 1e3,
                    "p95_ms": child.percentile(95, snap) * 1e3,
                })
        rows = []
        for (app, variant) in sorted(tenants):
            d = tenants[(app, variant)]
            rows.append(
                "<tr><td>{a}/{v}</td><td>{r}</td><td>{ok:g}</td>"
                "<td>{err:g}</td><td>{shed:g}</td><td>{q:g}</td>"
                "<td>{p50:.2f} / {p95:.2f}</td></tr>".format(
                    a=esc(app), v=esc(variant),
                    r=("%.1f KB" % (d["resident"] / 1e3)
                       if d.get("resident") else "—"),
                    ok=d.get("q_ok", 0.0), err=d.get("q_error", 0.0),
                    shed=d.get("q_shed", 0.0) + d.get("q_rejected", 0.0),
                    q=d.get("q_quota", 0.0),
                    p50=d.get("p50_ms", 0.0), p95=d.get("p95_ms", 0.0),
                )
            )
        ab: dict[tuple, dict] = {}
        for fam, field in ((VARIANT_REQUESTS_TOTAL, "impressions"),
                           (VARIANT_FEEDBACK_TOTAL, "conversions"),
                           (VARIANT_RATE, "rate")):
            for key, child in fam.children():
                k = dict(key)
                ab.setdefault(
                    (k.get("app", "?"), k.get("variant", "?")), {}
                )[field] = child.value()
        ab_rows = [
            "<tr><td>{a}/{v}</td><td>{i:g}</td><td>{c:g}</td>"
            "<td>{r:.4f}</td></tr>".format(
                a=esc(app), v=esc(variant),
                i=d.get("impressions", 0.0),
                c=d.get("conversions", 0.0),
                r=d.get("rate", 0.0),
            )
            for (app, variant), d in sorted(ab.items())
        ]
        loads = {"load": 0.0, "evict": 0.0, "overcommit": 0.0}
        for key, child in TENANT_LOADS_TOTAL.children():
            kind = dict(key).get("kind", "?")
            loads[kind] = loads.get(kind, 0.0) + child.value()
        budget = TENANT_MEMORY_BUDGET.child().value()
        head = (
            "<p>resident tenants: <b>{:g}</b> &middot; memory budget: "
            "<b>{}</b> &middot; loads {:g} / evictions {:g} / "
            "overcommits {:g}</p>".format(
                TENANTS_RESIDENT.child().value(),
                ("%.1f MB" % (budget / 1e6)) if budget else "unbounded",
                loads["load"], loads["evict"], loads["overcommit"],
            )
        )
        return (
            "<!DOCTYPE html><html><head><title>pio-hive tenants</title>"
            "<meta http-equiv='refresh' content='5'>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td,th{padding:3px 8px;font-family:monospace}</style>"
            "</head><body><h1>Tenants (pio-hive)</h1>" + head +
            "<h2>Per-tenant serving</h2>"
            "<table border='1'><tr><th>tenant</th><th>resident</th>"
            "<th>ok</th><th>errors</th><th>shed</th><th>quota 429s</th>"
            "<th>p50 / p95 ms</th></tr>" + "".join(rows) + "</table>"
            "<h2>Online A/B (per variant)</h2>"
            "<table border='1'><tr><th>variant</th><th>impressions</th>"
            "<th>conversions</th><th>rate</th></tr>" +
            "".join(ab_rows) + "</table>"
            "<p><a href='/'>index</a></p></body></html>"
        )

    def experiments_html(self, server_url: str = "") -> str:
        """pio-pilot experiment console: per-app SPRT state (LLR walk
        vs its thresholds), live weights, guardrail vetoes, and the
        ramp-decision tail.  Renders the in-process autopilot when one
        exists, else fetches ``?server=http://host:port``'s
        ``/debug/experiments``, else falls back to the newest
        ``pilot-*`` tower manifest on disk (cross-process view)."""
        from ..tenancy.autopilot import autopilot_payload

        def esc(v) -> str:
            return _html.escape(str(v))

        p = autopilot_payload()
        source = "in-process autopilot"
        if p is None and server_url:
            import urllib.request
            try:
                with urllib.request.urlopen(
                    server_url.rstrip("/") + "/debug/experiments",
                    timeout=5,
                ) as r:
                    p = json.loads(r.read().decode())
                source = esc(server_url)
            except Exception as e:
                return (
                    "<html><body><h1>Experiments</h1><p>could not "
                    f"reach {esc(server_url)}/debug/experiments: "
                    f"{esc(e)}</p></body></html>"
                )
        if p is None:
            p = self._experiments_from_manifest()
            source = "tower manifest"
        if p is None:
            return (
                "<html><body><h1>Experiments</h1><p>No autopilot in "
                "this process and no pilot manifest on disk. Point me "
                "at a serving edge with <code>/experiments.html?"
                "server=http://host:port</code> or curl its "
                "<code>/debug/experiments</code>.</p></body></html>"
            )
        app_rows = []
        for app, cell in sorted((p.get("apps") or {}).items()):
            last = cell.get("last") or {}
            llr = last.get("llr")
            walk = (
                f"{llr:.3f} in [{last.get('lower', 0):.3f}, "
                f"{last.get('upper', 0):.3f}]"
                if llr is not None else "-"
            )
            weights = ", ".join(
                f"{v}={w:.3f}" for v, w in sorted(
                    (p.get("weights", {}).get(app) or
                     last.get("weights") or {}).items()
                )
            )
            vetoes = ", ".join(
                f"{v}:{r}" for v, r in
                sorted((last.get("vetoes") or {}).items())
            ) or "-"
            app_rows.append(
                "<tr><td>{a}</td><td>{st}</td><td>{d}</td>"
                "<td>{lead}</td><td>{walk}</td><td>{w}</td>"
                "<td>{veto}</td></tr>".format(
                    a=esc(app), st=esc(cell.get("stateName", "?")),
                    d=esc(last.get("decision", "-")),
                    lead=esc(last.get("leader") or
                             last.get("target") or "-"),
                    walk=esc(walk), w=esc(weights), veto=esc(vetoes),
                )
            )
        dec_rows = []
        for app, cell in sorted((p.get("apps") or {}).items()):
            for d in reversed(cell.get("decisions") or []):
                dec_rows.append(
                    "<tr><td>{a}</td><td>{dec}</td><td>{r}</td>"
                    "<td>{llr}</td><td>{w}</td></tr>".format(
                        a=esc(app), dec=esc(d.get("decision")),
                        r=esc(d.get("reason") or "-"),
                        llr=(f"{d['llr']:.3f}"
                             if d.get("llr") is not None else "-"),
                        w=esc(", ".join(
                            f"{v}={w:.3f}" for v, w in
                            sorted((d.get("weights") or {}).items())
                        )),
                    )
                )
        cfg = p.get("config") or {}
        cfg_html = " &middot; ".join(
            f"{k}={cfg[k]}" for k in sorted(cfg)
        )
        return (
            "<!DOCTYPE html><html><head><title>experiments</title>"
            "<meta http-equiv='refresh' content='5'>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td,th{padding:3px 8px;font-family:monospace}</style>"
            "</head><body><h1>Experiments (pio-pilot)</h1>"
            f"<p>source: {source} &middot; manifest "
            f"<code>{esc(p.get('manifestId', '?'))}</code> &middot; "
            f"ticks {p.get('ticks', '?')}</p>"
            f"<p>{cfg_html}</p>"
            "<h2>Per-app SPRT state</h2>"
            "<table border='1'><tr><th>app</th><th>state</th>"
            "<th>last decision</th><th>leader</th>"
            "<th>LLR walk</th><th>weights</th><th>vetoes</th></tr>"
            + "\n".join(app_rows) + "</table>"
            "<h2>Decision tail (newest first)</h2>"
            "<table border='1'><tr><th>app</th><th>decision</th>"
            "<th>reason</th><th>LLR</th><th>weights</th></tr>"
            + "\n".join(dec_rows) + "</table>"
            "<p>JSON at the serving edge's "
            "<code>/debug/experiments</code>; every decision is a "
            "pio-tower manifest event (<code>tools/runlog.py</code>)."
            "</p><p><a href='/'>index</a></p></body></html>"
        )

    def _experiments_from_manifest(self):
        """Newest ``pilot-*`` run manifest rebuilt into (a subset of)
        the autopilot payload shape — the cross-process fallback."""
        from ..obs.runlog import read_manifest, runs_root

        try:
            dirs = sorted(
                (d for d in runs_root().iterdir()
                 if d.name.startswith("pilot-")),
                key=lambda d: d.stat().st_mtime, reverse=True,
            )
        except OSError:
            return None
        for d in dirs:
            doc = read_manifest(d)
            if doc is None:
                continue
            apps: dict[str, dict] = {}
            for ev in doc.get("events", ()):
                if ev.get("event") != "decision":
                    continue
                app = ev.get("app", "?")
                cell = apps.setdefault(
                    app, {"stateName": "?", "decisions": []}
                )
                cell["last"] = ev
                cell["decisions"].append(ev)
                del cell["decisions"][:-10]
                state = ev.get("state")
                cell["stateName"] = {
                    0.0: "collecting", 1.0: "ramping",
                    2.0: "concluded", 3.0: "frozen",
                }.get(state, "?")
            header = doc.get("header") or {}
            return {
                "enabled": True,
                "manifestId": header.get("instanceId", d.name),
                "ticks": len(doc.get("events", ())),
                "config": {
                    k: header[k]
                    for k in ("alpha", "beta", "minLift", "minSamples",
                              "maxStep", "minWeight")
                    if k in header
                },
                "weights": {},
                "apps": apps,
            }
        return None

    def pulse_html(self) -> str:
        """Operator view of the pio-pulse request-lifecycle layer: the
        per-segment decomposition of serving and ingest latency, the
        micro-batcher's concurrency saturation counters, and the
        latest closed-loop sweep (``bench_serving.py --sweep`` writes
        ``telemetry/sweeps/latest.json``)."""
        from ..obs.timeline import (
            EVENT_SEGMENTS,
            EVENTS_SEGMENT_SECONDS,
            MICROBATCH_BATCH_SIZE,
            MICROBATCH_QUEUE_DEPTH,
            MICROBATCH_ROLE_TOTAL,
            SERVE_INFLIGHT,
            SERVE_SEGMENTS,
            SERVE_SEGMENT_SECONDS,
        )

        def esc(v) -> str:
            return _html.escape(str(v))

        def seg_rows(family, segments):
            rows = []
            for s in segments:
                child = family.labels(segment=s)
                snap = child.snapshot()
                n = snap["count"]
                mean = (snap["sum"] / n * 1e3) if n else 0.0
                p95 = child.percentile(95, snap) * 1e3 if n else 0.0
                rows.append(
                    "<tr><td>{s}</td><td>{n}</td><td>{m:.3f}</td>"
                    "<td>{p:.3f}</td></tr>".format(
                        s=esc(s), n=n, m=mean, p=p95,
                    )
                )
            return rows

        seg_table = (
            "<table border='1'><tr><th>segment</th><th>count</th>"
            "<th>mean ms</th><th>p95 ms</th></tr>"
        )
        bs = MICROBATCH_BATCH_SIZE.child()
        bs_snap = bs.snapshot()
        roles = {
            dict(key).get("role", "?"): child.value()
            for key, child in MICROBATCH_ROLE_TOTAL.children()
        }
        sat_rows = [
            "<tr><td>inflight</td><td>{:g}</td></tr>".format(
                SERVE_INFLIGHT.child().value()),
            "<tr><td>batcher queue depth</td><td>{:g}</td></tr>".format(
                MICROBATCH_QUEUE_DEPTH.child().value()),
            "<tr><td>batches dispatched</td><td>{}</td></tr>".format(
                bs_snap["count"]),
            "<tr><td>mean batch size</td><td>{:.2f}</td></tr>".format(
                bs_snap["sum"] / bs_snap["count"]
                if bs_snap["count"] else 0.0),
            "<tr><td>leader / follower requests</td>"
            "<td>{:g} / {:g}</td></tr>".format(
                roles.get("leader", 0.0), roles.get("follower", 0.0)),
        ]
        sweep_html = "<p>(no sweep recorded yet — run "
        sweep_html += "<code>bench_serving.py --sweep 1,4,16</code>)</p>"
        sweep_path = telemetry_home() / "sweeps" / "latest.json"
        try:
            sweep = json.loads(sweep_path.read_text())
        except (OSError, json.JSONDecodeError):
            sweep = None
        if sweep:
            rows = []
            for p in sweep.get("points", ()):
                segs = "; ".join(
                    f"{k} {v:.2f}" for k, v in
                    sorted(p.get("segments_ms", {}).items(),
                           key=lambda kv: -kv[1])[:4]
                )
                rows.append(
                    "<tr><td>{c}</td><td>{q:.1f}</td><td>{p50:.2f}</td>"
                    "<td>{p99:.2f}</td><td>{e}</td><td>{s}</td>"
                    "</tr>".format(
                        c=p.get("concurrency"), q=p.get("qps", 0.0),
                        p50=p.get("p50_ms", 0.0),
                        p99=p.get("p99_ms", 0.0),
                        e=p.get("errors", 0), s=esc(segs),
                    )
                )
            slo = sweep.get("slo_ms")
            qps = sweep.get("qps_at_slo")
            sweep_html = (
                "<p>recorded {at} on {plat}; QPS@SLO(p99 &le; "
                "{slo} ms) = <b>{qps}</b></p>"
                "<table border='1'><tr><th>concurrency</th><th>qps</th>"
                "<th>p50 ms</th><th>p99 ms</th><th>errors</th>"
                "<th>top segments (mean ms)</th></tr>".format(
                    at=esc(sweep.get("recorded_at", "?")),
                    plat=esc(sweep.get("platform", "?")),
                    slo=esc(slo), qps=esc(qps if qps is not None
                                          else "(no point met SLO)"),
                ) + "\n".join(rows) + "</table>"
            )
        return (
            "<html><head><title>pulse</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            "<body><h1>Pulse: request lifecycle &amp; saturation</h1>"
            "<p>Segment histograms at <a href='/metrics'>/metrics</a> "
            "(pio_serve_segment_seconds / pio_events_segment_seconds); "
            "on-demand profiler at <code>/debug/profile?seconds=S</code> "
            "on any server.</p>"
            "<h2>Serving segments</h2>"
            + seg_table
            + "\n".join(seg_rows(SERVE_SEGMENT_SECONDS, SERVE_SEGMENTS))
            + "</table>"
            "<h2>Event-ingest segments</h2>"
            + seg_table
            + "\n".join(seg_rows(EVENTS_SEGMENT_SECONDS, EVENT_SEGMENTS))
            + "</table>"
            "<h2>Concurrency saturation</h2>"
            "<table border='1'><tr><th>gauge</th><th>value</th></tr>"
            + "\n".join(sat_rows) + "</table>"
            "<h2>Latest closed-loop sweep</h2>" + sweep_html +
            "</body></html>"
        )

    def prof_html(self, target_url: str = "", seconds: float = 60.0,
                  state: str = "", baseline_url: str = "") -> str:
        """pio-scope flamegraph console: render any hive process's
        rolling CPU profile as a zoomable flamegraph — no external
        assets, no tooling on the operator's box.  ``?target=http://
        host:port`` fetches that server's ``/debug/pprof`` (router,
        replica, eventserver, ingest router — the mount is universal);
        no target renders THIS dashboard process's own ring.
        ``&baseline=URL`` overlays a second profile as share deltas
        (the profcat A/B diff, served live)."""
        from ..obs import scope

        def fetch(url: str) -> str:
            import urllib.request
            qs = f"/debug/pprof?seconds={seconds:g}"
            if state:
                qs += f"&state={urllib.parse.quote(state)}"
            with urllib.request.urlopen(
                url.rstrip("/") + qs, timeout=5
            ) as r:
                return r.read().decode()

        try:
            if target_url:
                folded = fetch(target_url)
                title = f"pio-scope: {target_url} (last {seconds:g}s)"
            else:
                folded = scope.get_profiler().collapsed(
                    seconds, state=state or None
                )
                title = f"pio-scope: dashboard process (last {seconds:g}s)"
            baseline = fetch(baseline_url) if baseline_url else None
        except Exception as e:
            esc = _html.escape
            return (
                "<html><body><h1>Profile</h1><p>could not fetch "
                f"profile: {esc(str(e))}</p><p>Usage: <code>"
                "/prof.html?target=http://host:port&amp;seconds=60"
                "&amp;state=running&amp;baseline=http://other:port"
                "</code></p></body></html>"
            )
        return scope.flamegraph_html(folded, title=title,
                                     baseline=baseline)

    def fleet_html(self, router_url: str = "") -> str:
        """pio-lens fleet console: the per-replica tail table (p50/p99
        off each replica's scraped latency histogram, breaker/respawn/
        scrape state) and the router flight recorder's worst-N with
        per-replica attribution.  Renders the in-process router's
        payload when one exists (``deploy --replicas`` runs the router
        in this process in fleet mode tests), else fetches
        ``?router=http://host:port``'s ``/debug/fleet``.  Machines
        read ``/debug/fleet`` on the router."""
        from ..obs import fleet

        def esc(v) -> str:
            return _html.escape(str(v))

        p = fleet.fleet_payload()
        source = "in-process router"
        if p is None and router_url:
            import urllib.request
            try:
                with urllib.request.urlopen(
                    router_url.rstrip("/") + "/debug/fleet", timeout=5
                ) as r:
                    p = json.loads(r.read().decode())
                source = esc(router_url)
            except Exception as e:
                return (
                    "<html><body><h1>Fleet</h1><p>could not reach "
                    f"{esc(router_url)}/debug/fleet: {esc(e)}</p>"
                    "</body></html>"
                )
        if p is None:
            return (
                "<html><body><h1>Fleet</h1><p>No router in this "
                "process. Point me at one with "
                "<code>/fleet.html?router=http://host:port</code> or "
                "curl the router's <code>/debug/fleet</code>.</p>"
                "</body></html>"
            )
        rows = []
        for r in p.get("replicas", ()):
            rows.append(
                "<tr><td>{n}</td><td>{h}</td><td>{b}</td>"
                "<td>{p50}</td><td>{p99}</td><td>{q:g}</td>"
                "<td>{f}</td><td>{rsp:g}</td><td>{se}</td></tr>".format(
                    n=esc(r.get("name")),
                    h="up" if r.get("healthy") else "<b>DOWN</b>",
                    b=esc(r.get("breaker", "?")),
                    p50=r.get("p50Ms", "-"), p99=r.get("p99Ms", "-"),
                    q=r.get("queriesTotal", 0.0),
                    f=r.get("failovers", 0),
                    rsp=r.get("respawns", 0.0),
                    se=r.get("scrapeErrors", 0),
                )
            )
        worst_rows = []
        for w in p.get("worst", ()):
            attrs = w.get("attrs") or {}
            segs = "; ".join(
                f"{k} {v}" for k, v in sorted(
                    (attrs.get("segmentsMs") or {}).items(),
                    key=lambda kv: -kv[1])[:4]
            )
            rsegs = "; ".join(
                f"{k} {v}" for k, v in sorted(
                    (attrs.get("replicaSegmentsMs") or {}).items(),
                    key=lambda kv: -kv[1])[:4]
            ) or "-"
            worst_rows.append(
                "<tr><td>{t}</td><td>{ms:.1f}</td><td>{r}</td>"
                "<td>{est}</td><td>{segs}</td><td>{rsegs}</td>"
                "</tr>".format(
                    t=esc(w.get("traceId")),
                    ms=w.get("durationSec", 0.0) * 1e3,
                    r=esc(attrs.get("replica", "?")),
                    est=attrs.get("ewmaAtAdmissionSec", "-"),
                    segs=esc(segs) or "-", rsegs=esc(rsegs),
                )
            )
        burn = p.get("burnRate") or {}
        burn_html = ""
        if burn:
            burn_html = (
                "<p>SLO {slo} ms — burn rate "
                + " &middot; ".join(
                    f"{w}: <b>{burn[w]}</b>" for w in sorted(burn)
                ) + "</p>"
            ).format(slo=esc(p.get("sloMs")))
        return (
            "<html><head><title>fleet</title>"
            "<meta http-equiv='refresh' content='5'>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            "<body><h1>Fleet (pio-lens)</h1>"
            f"<p>source: {source} &middot; healthy "
            f"{p.get('healthyReplicas')}/{len(p.get('replicas', ()))} "
            "&middot; EWMA forward "
            f"{p.get('ewmaForwardSec', 0.0) * 1e3:.2f} ms &middot; "
            f"unroutable {p.get('unroutable', 0)} &middot; "
            f"scrape errors {p.get('scrapeErrors', 0)}</p>"
            + burn_html +
            "<h2>Per-replica tail</h2>"
            "<table border='1'><tr><th>replica</th><th>health</th>"
            "<th>breaker</th><th>p50 ms</th><th>p99 ms</th>"
            "<th>queries</th><th>failovers</th><th>respawns</th>"
            "<th>scrape errs</th></tr>" + "\n".join(rows) + "</table>"
            "<h2>Worst requests (router flight recorder)</h2>"
            "<table border='1'><tr><th>trace</th><th>ms</th>"
            "<th>replica</th><th>EWMA@admit s</th>"
            "<th>router segments ms</th><th>replica segments ms</th>"
            "</tr>" + "\n".join(worst_rows) + "</table>"
            "<p>Stitch one trace across processes: "
            "<code>python tools/tracecat.py &lt;trace-id&gt;</code>. "
            "JSON at the router's <code>/debug/fleet</code>; merged "
            "exposition at its <code>/metrics</code>.</p>"
            "<p><a href='/'>index</a></p></body></html>"
        )

    def train_html(self) -> str:
        """pio-tower training console: the live run (if any — this
        process, or another process's manifest still growing on disk)
        plus manifest history with phase totals and loss trajectory
        endpoints.  Machines read ``/debug/train``; ``tools/runlog.py
        diff`` answers "why did sweep 7 take 3x" from the same files."""
        from ..obs.tower import train_payload

        def esc(v) -> str:
            return _html.escape(str(v))

        p = train_payload()
        active = p["active"]
        if active:
            last = active.get("lastSweep") or {}
            seg = "; ".join(
                f"{k} {v * 1e3:.1f}ms"
                for k, v in sorted((last.get("phases") or {}).items())
            )
            planned = active.get("sweepsPlanned")
            eta = active.get("etaSeconds")
            active_html = (
                "<p><b>live:</b> {iid} ({kind}) — sweep {i}{of}, "
                "last {ls:.3f}s [{seg}], ETA {eta}</p>".format(
                    iid=esc(active["instanceId"]),
                    kind=esc(active["runKind"]),
                    i=active["sweep"],
                    of=f"/{planned}" if planned else "",
                    ls=(last.get("seconds") or 0.0),
                    seg=esc(seg),
                    eta=f"{eta:.0f}s" if eta is not None else "?",
                )
            )
        else:
            active_html = "<p>(no run live in this process)</p>"
        rows = []
        for r in p["runs"]:
            phases = "; ".join(
                f"{k} {v:.2f}s" for k, v in sorted(
                    (r.get("phaseTotals") or {}).items(),
                    key=lambda kv: -kv[1],
                )[:4]
            )
            loss = (
                f"{r['firstLoss']:.4g} &rarr; {r['lastLoss']:.4g}"
                if r.get("firstLoss") is not None
                and r.get("lastLoss") is not None else "-"
            )
            status = r.get("status", "?")
            if r.get("live"):
                status = "<b>live</b>"
            elif r.get("reason"):
                status += f" ({esc(r['reason'])})"
            rows.append(
                "<tr><td>{iid}</td><td>{kind}</td><td>{st}</td>"
                "<td>{n}{of}</td><td>{mean}</td><td>{ph}</td>"
                "<td>{loss}</td><td>{ev}</td></tr>".format(
                    iid=esc(r.get("instanceId")),
                    kind=esc(r.get("runKind")),
                    st=status,
                    n=r.get("sweeps"),
                    of=(
                        f"/{r['sweepsPlanned']}"
                        if r.get("sweepsPlanned") else ""
                    ),
                    mean=(
                        f"{r['sweepSecondsMean']:.3f}s"
                        if r.get("sweepSecondsMean") is not None else "-"
                    ),
                    ph=esc(phases) or "-",
                    loss=loss,
                    ev=r.get("events", 0),
                )
            )
        return (
            "<html><head><title>training console</title>"
            "<style>body{font-family:sans-serif;margin:2em}"
            "td{font-family:monospace;padding:2px 8px}</style></head>"
            "<body><h1>Tower: training console</h1>"
            "<p>JSON at <a href='/debug/train'>/debug/train</a>; "
            "compare two runs with <code>python tools/runlog.py diff "
            "A B</code>.</p>"
            + active_html +
            "<h2>Run manifests (newest first)</h2>"
            "<table border='1'><tr><th>instance</th><th>kind</th>"
            "<th>status</th><th>sweeps</th><th>mean sweep</th>"
            "<th>top phases (total)</th><th>loss first&rarr;last</th>"
            "<th>events</th></tr>" + "\n".join(rows) + "</table>"
            "</body></html>"
        )

    def _make_handler(server: "DashboardServer"):
        class Handler(JsonRequestHandler):
            server_logger = logger
            # CORS (reference CorsSupport.scala)
            extra_headers = (("Access-Control-Allow-Origin", "*"),)

            def do_GET(self):
                if self._serve_metrics():
                    return
                path = urllib.parse.urlparse(self.path).path
                if path == "/":
                    self._reply(200, server.index_html().encode(), "text/html")
                    return
                if path == "/metrics.html":
                    self._reply(200, server.metrics_html().encode(),
                                "text/html")
                    return
                if path == "/events.html":
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    try:
                        app_id = int(q.get("app", ["-1"])[0])
                        channel = int(q.get("channel", ["0"])[0])
                        limit = min(int(q.get("n", ["50"])[0]), 500)
                    except ValueError:
                        self._reply(400, b"bad query", "text/plain")
                        return
                    self._reply(
                        200,
                        server.events_html(app_id, channel, limit).encode(),
                        "text/html",
                    )
                    return
                if path == "/xray.html":
                    self._reply(200, server.xray_html().encode(),
                                "text/html")
                    return
                if path == "/pulse.html":
                    self._reply(200, server.pulse_html().encode(),
                                "text/html")
                    return
                if path == "/train.html":
                    self._reply(200, server.train_html().encode(),
                                "text/html")
                    return
                if path == "/tenants.html":
                    self._reply(200, server.tenants_html().encode(),
                                "text/html")
                    return
                if path == "/experiments.html":
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    self._reply(
                        200,
                        server.experiments_html(
                            q.get("server", [""])[0]
                        ).encode(),
                        "text/html",
                    )
                    return
                if path == "/fleet.html":
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    self._reply(
                        200,
                        server.fleet_html(
                            q.get("router", [""])[0]
                        ).encode(),
                        "text/html",
                    )
                    return
                if path == "/prof.html":
                    q = urllib.parse.parse_qs(
                        urllib.parse.urlparse(self.path).query
                    )
                    try:
                        seconds = float(q.get("seconds", ["60"])[0])
                    except ValueError:
                        seconds = 60.0
                    self._reply(
                        200,
                        server.prof_html(
                            q.get("target", [""])[0],
                            seconds=seconds,
                            state=q.get("state", [""])[0],
                            baseline_url=q.get("baseline", [""])[0],
                        ).encode(),
                        "text/html",
                    )
                    return
                parts = [x for x in path.split("/") if x]
                if len(parts) == 2 and parts[0] == "engine_instances":
                    # also accept bare ids -> json
                    parts = [parts[0], parts[1], "evaluator_results.json"]
                if len(parts) == 3 and parts[0] == "engine_instances":
                    ev = server.storage.get_metadata().evaluation_instance_get(
                        parts[1]
                    )
                    if ev is None:
                        self._reply(404, b"not found", "text/plain")
                        return
                    which = parts[2]
                    if which == "evaluator_results.txt":
                        self._reply(200, ev.evaluator_results.encode(),
                                    "text/plain")
                    elif which == "evaluator_results.html":
                        self._reply(200, ev.evaluator_results_html.encode(),
                                    "text/html")
                    elif which == "evaluator_results.json":
                        self._reply(200, ev.evaluator_results_json.encode(),
                                    "application/json")
                    else:
                        self._reply(404, b"not found", "text/plain")
                else:
                    self._reply(404, b"not found", "text/plain")

        return Handler
