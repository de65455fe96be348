# ported from tidb_tpu/server/status.py @ 02e96d8
# (/resource from the same file @ f4efee1)
"""HTTP status/admin API.

Reference analog: pkg/server http_handler.go + handler/ — /status,
/schema, /stats, /settings endpoints on the status port, plus a
Prometheus-text /metrics endpoint (pkg/metrics scrape surface).

The port answers the routes whose subsystems it has: ``/status``,
``/schema[/<db>[/<table>]]``, ``/stats``, ``/metrics``, ``/settings``,
``/regions/meta``, ``/mvcc/key/<db>/<table>/<handle>``, ``/ddl/history``,
``/schema_version``, ``/sched`` (the device scheduler's and the
client's counters, ``CopClient.sched_stats``), and the observability
plane: ``/trace`` (the flight recorder's index) and ``/trace/<id>``
(one statement's span tree; ``?fmt=chrome`` the Chrome trace-event
JSON for ui.perfetto.dev), ``/hbm`` (the memory ledgers reconciled with
the card, the roofline tables, the calibration's memory counters) and
``/profile?ms=N`` (a ``torch.profiler`` capture, gated by
``tidb_tpu_profile``), ``/pd`` (the coordination plane: this
Domain's membership, every attached coordinator and a bounded dump of
the shared store) and ``/resource`` (the resource groups' RU balances,
debt and debits, the scheduler's per-group and per-digest device time,
and the runaway ring).  The JAX package's ``/locksan`` reads the lock
sanitizer, which the port has not yet: it answers HTTP 501 naming its
ROADMAP.md item.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .. import CONTROL, unported
from ..session.session import Domain

# routes over subsystems of later slices, by the ROADMAP.md item that
# ports them
_UNPORTED_ROUTES = {"/locksan": CONTROL}


class StatusServer:
    def __init__(self, domain: Domain, host: str = "127.0.0.1", port: int = 0):
        self.domain = domain
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                try:
                    body, ctype = outer._route_retry(self.path)
                except KeyError:
                    self.send_error(404)
                    return
                except NotImplementedError as e:
                    self.send_error(501, str(e))
                    return
                except Exception as e:
                    self.send_error(500, str(e))
                    return
                data = body.encode()
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> int:
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="status-http", daemon=True)
        self._thread.start()
        return self.port

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()

    # -------------------------------------------------------------- #

    def _route_retry(self, path: str) -> tuple[str, str]:
        """Retry on 'dict changed size during iteration': routes read
        shared Domain state concurrently mutated by connection threads."""
        for _ in range(4):
            try:
                return self._route(path)
            except RuntimeError:
                continue
        return self._route(path)

    def _route(self, path: str) -> tuple[str, str]:
        path, _, qs = path.partition("?")
        query = dict(p.split("=", 1) for p in qs.split("&") if "=" in p)
        path = path.rstrip("/") or "/status"
        if path == "/status":
            from .mysql_server import SERVER_VERSION
            return json.dumps({
                "version": SERVER_VERSION,
                "connections": len(self.domain.sessions()),
            }), "application/json"
        if path == "/schema":
            out = {db: sorted(tables)
                   for db, tables in self.domain.catalog.databases.items()}
            return json.dumps(out), "application/json"
        if path.startswith("/schema/"):
            parts = path.split("/")[2:]
            db = parts[0]
            tables = self.domain.catalog.databases.get(db)
            if tables is None:
                raise KeyError(db)
            if len(parts) == 1:
                return json.dumps(sorted(tables)), "application/json"
            tbl = tables.get(parts[1])
            if tbl is None:
                raise KeyError(parts[1])
            return json.dumps({
                "name": tbl.name, "table_id": tbl.table_id,
                "columns": [{"name": n, "type": str(t)}
                            for n, t in zip(tbl.col_names, tbl.col_types)],
                "indexes": [{"name": ix.name, "columns": ix.columns,
                             "unique": ix.unique, "state": ix.state}
                            for ix in tbl.indexes],
            }), "application/json"
        if path == "/stats":
            rows = []
            for db, tables in self.domain.catalog.databases.items():
                for name, tbl in tables.items():
                    ts = self.domain.stats.get(tbl)
                    if ts is not None:
                        rows.append({"db": db, "table": name,
                                     "rows": ts.realtime_count,
                                     "modify_count": ts.modify_count})
            return json.dumps(rows), "application/json"
        if path == "/metrics":
            from ..utils.metrics import global_registry
            return global_registry().prometheus_text(), "text/plain"
        if path == "/sched":
            # the device admission scheduler: queue depth, per-group
            # fair share and RU accounting, coalesce/batch/fusion launch
            # counters, the window's state, HBM-budget admission, launch
            # supervision (retries, bisections, breaker states), wait
            # p50/p99, the program cache, and the shared client's
            # counters
            return json.dumps(self.domain.client.sched_stats(),
                              default=str), "application/json"
        if path == "/resource":
            # resource control plane (rc/): per-group RU budget state
            # (balance/debt/debited), drain-side enforcement counters
            # (throttled skips, deadline failures, priced debits),
            # measured per-group + per-program-digest device-time
            # attribution, and the bounded runaway-record ring
            mgr = self.domain.resource_groups
            groups = mgr.resource_stats()
            sched = self.domain.client.sched_stats()
            for name, gstats in (sched.get("groups") or {}).items():
                ent = groups.setdefault(name, {})
                ent.update({
                    "tasks": gstats.get("tasks", 0),
                    "queued": gstats.get("queued", 0),
                    "rus": gstats.get("rus", 0.0),
                    "throttled": gstats.get("throttled", 0),
                    "device_ms": gstats.get("device_ms", 0.0),
                })
            return json.dumps({
                "rc_enable": sched.get("rc_enable", True),
                "rc_overdraft_ru": sched.get("rc_overdraft_ru"),
                "rc_throttled": sched.get("rc_throttled", 0),
                "rc_exhausted": sched.get("rc_exhausted", 0),
                "rc_debited_ru": sched.get("rc_debited_ru", 0.0),
                "digest_device_ms": sched.get("digest_device_ms", {}),
                # copmeter (analysis/calibrate): closed-loop cost
                # calibration state + OOM recovery / early shedding
                "calibration": sched.get("calibration"),
                "oom_faults": sched.get("oom_faults", 0),
                "shed_rejects": sched.get("shed_rejects", 0),
                "backlog_ms": sched.get("backlog_ms", 0.0),
                "groups": groups,
                "runaway": {
                    "total": mgr.runaway_ring.total,
                    "records": mgr.runaway_ring.records(),
                },
            }, default=str), "application/json"
        if path == "/pd":
            # coplace (pd/): coordination-plane status — this Domain's
            # membership (lease epoch, degraded state, quota shares,
            # registry gossip counters) plus the cross-coordinator view
            # and a bounded dump of the shared store (leases, key
            # census per family, versions)
            from ..pd import pd_status
            out = {"status": pd_status()}
            coord = getattr(self.domain, "pd", None)
            if coord is None:
                out["this_domain"] = {"enabled": False}
            else:
                out["this_domain"] = coord.stats()
            return json.dumps(out), "application/json"
        if path in _UNPORTED_ROUTES:
            raise unported(f"the status route {path}",
                           _UNPORTED_ROUTES[path])
        if path == "/hbm":
            # copgauge (obs/hbm + obs/roofline): the device-memory and
            # utilization plane — live ledger balances (in-flight launch
            # bytes), measured watermarks, bounded reconciliation with
            # the card's allocator, per-digest memory prediction error
            # (mem_factor calibration state), and the roofline tables
            # (top-N digests by residency and by gap, memory-/compute-/
            # launch-bound)
            from ..analysis.calibrate import correction_store
            from ..obs.hbm import all_ledgers, hbm_status, profiler_gate
            from ..obs.roofline import roofline_status
            sched = self.domain.client.sched_stats()
            for led in all_ledgers():
                led.reconcile(self.domain.client.devices)
            cal = correction_store().stats()
            return json.dumps({
                "enabled": (sched.get("hbm") or {}).get("enabled", True),
                "budget_bytes": sched.get("hbm_budget", 0),
                "last_launch_bytes": sched.get("last_launch_bytes", 0),
                "budget_admitted": sched.get("budget_admitted", 0),
                "budget_rejects": sched.get("budget_rejects", 0),
                **hbm_status(),
                "calibration": {
                    "mem_observed": cal.get("mem_observed", 0),
                    "mean_mem_err_pct": cal.get("mean_mem_err_pct"),
                    "oom_events": cal.get("oom_events", 0),
                },
                "roofline": roofline_status(),
                "profiler": profiler_gate().stats(),
            }, default=str), "application/json"
        if path == "/profile":
            # on-demand torch.profiler capture (?ms=N): gated by the
            # tidb_tpu_profile sysvar, refused while one is active —
            # the Chrome trace lands in the capture directory for
            # ui.perfetto.dev; the card's activity rides with the CPU's
            from ..obs.hbm import profiler_gate
            enabled = bool(int(
                self.domain.sysvars.get("tidb_tpu_profile", 0) or 0))
            if not enabled:
                return json.dumps({
                    "refused": "profiling disabled; "
                               "SET GLOBAL tidb_tpu_profile = 1"}), \
                    "application/json"
            ms = int(query.get("ms", "1000"))
            cuda = self.domain.client.devices[0].type == "cuda"
            return json.dumps(profiler_gate().start(ms, cuda=cuda)), \
                "application/json"
        if path == "/trace":
            # copscope flight recorder (obs/): newest-first index of
            # retained statement traces (failed/degraded/quarantined/
            # retried/slow always kept, the rest sampled) + ring stats
            fr = self.domain.flight_recorder
            return json.dumps({"stats": fr.stats(),
                               "traces": fr.index()}), "application/json"
        if path.startswith("/trace/"):
            # one statement's full span tree; ?fmt=chrome exports the
            # Chrome trace-event / Perfetto JSON (load in ui.perfetto.dev
            # or chrome://tracing)
            trace_id = path.split("/")[2]
            tree = self.domain.flight_recorder.get(trace_id)
            if tree is None:
                raise KeyError(trace_id)
            if query.get("fmt") == "chrome":
                return json.dumps(tree.chrome_trace()), "application/json"
            return json.dumps(tree.to_dict()), "application/json"
        if path == "/settings":
            # handler/settings analog: live global sysvars
            return json.dumps(dict(sorted(
                self.domain.sysvars.items()))), "application/json"
        if path == "/regions/meta":
            # region/shard topology introspection
            # (handler/tikv_handler.go RegionsMeta analog)
            out = []
            for db, tables in self.domain.catalog.databases.items():
                for name, tbl in tables.items():
                    snap = tbl.snapshot()
                    s, cap, counts = snap.shard_layout()
                    ent = {"db": db, "table": name,
                           "table_id": tbl.table_id,
                           "rows": snap.num_rows, "shards": s,
                           "shard_capacity": cap}
                    if snap.placement is not None:
                        ent["placement"] = [
                            {"shard": i, "store": sh.store,
                             "range": [sh.lo, sh.hi]}
                            for i, sh in enumerate(snap.placement.shards)]
                    out.append(ent)
            return json.dumps(out), "application/json"
        if path.startswith("/mvcc/key/"):
            # MVCC version history of one row key
            # (handler/tikv_handler.go MvccTxnHandler analog)
            parts = path.split("/")[3:]
            if len(parts) != 3:
                raise KeyError(path)
            db, table, handle = parts[0], parts[1], int(parts[2])
            tbl = self.domain.catalog.get_table(db, table)
            return json.dumps(self._mvcc_versions(tbl, handle)), \
                "application/json"
        if path == "/ddl/history":
            # handler/ddl history analog: persisted job records
            jobs = []
            try:
                for j in self.domain.ddl.storage.history():
                    jobs.append({"job_id": j.job_id, "type": j.job_type,
                                 "state": j.state, "table": j.table,
                                 "error": j.error})
            except Exception:
                pass
            return json.dumps(jobs), "application/json"
        if path == "/schema_version":
            ver = getattr(self.domain, "schema_version", None)
            if callable(ver):
                ver = ver()
            return json.dumps({"schema_version": ver}), "application/json"
        raise KeyError(path)

    def _mvcc_versions(self, tbl, handle: int, max_versions: int = 8):
        """Version history of a record key, read straight off the native
        store's MVCC chains (kv_versions; reference pkg/server/handler
        mvcc handlers) — exact, newest-first, O(versions) instead of a
        per-ts probe walk."""
        from ..store.codec import decode_row, record_key
        kv = tbl.kv
        if kv is None:
            return {"error": "table has no KV store (bulk mode)"}
        key = record_key(tbl.table_id, handle)
        try:
            history, truncated = kv.versions(key, max_versions)
        except AttributeError:
            return {"error": "store does not expose version history"}
        out = []
        for ts, val in history:
            ent = {"commit_ts": ts}
            if val is None:
                ent["deleted"] = True
            else:
                try:
                    ent["row"] = [str(v) for v in
                                  decode_row(val, tbl.col_types)]
                except Exception:
                    ent["value_len"] = len(val)
            out.append(ent)
        res = {"key": key.hex(), "versions": out}
        if truncated:
            res["truncated"] = True
        return res


__all__ = ["StatusServer"]
