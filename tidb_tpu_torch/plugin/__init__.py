# ported from tidb_tpu/plugin/__init__.py @ 6233200
"""Plugin framework: audit / authentication / schema / daemon kinds.

Reference analog: pkg/plugin — the four plugin kinds (Audit, Authentication,
Schema, Daemon; plugin/spi.go AuditManifest/AuthenticationManifest/
SchemaManifest/DaemonManifest) and pkg/extension.  A plugin is any object
exposing a subset of the hook methods; hooks fire synchronously, and a
misbehaving plugin is isolated (its exceptions are recorded, not
propagated) — the reference's plugin sandboxing contract.

Hooks by kind:

    Audit           on_connection(event, conn_id, user)
                    on_stmt_begin(sess, sql)
                    on_stmt_end(sess, sql, error, elapsed_sec, rows)
    Authentication  authenticate(user, host) -> True | False | None
                    (None = no opinion; False vetoes a login the builtin
                    check accepted — plugin/spi.go OnUserAuthenticated)
    Schema          on_ddl(event, db, sql)    (OnSchemaChange analog)
    Daemon          start(domain) / stop()    (background service
                    lifecycle owned by the server, DaemonManifest)

    from tidb_tpu_torch.plugin import registry
    registry.register(MyPlugin())
"""

from __future__ import annotations

import threading
from typing import Any, Optional


class PluginRegistry:
    def __init__(self):
        from collections import deque
        self._plugins: list[Any] = []
        self._mu = threading.Lock()
        # serializes the whole daemon start/stop transition: refcount
        # check AND the start()/stop() loop, so a concurrent last-close
        # can never stop daemons a first-open just started
        self._daemon_mu = threading.Lock()
        self._daemon_refs = 0
        # bounded: a misfiring plugin on a busy server must not leak
        self.errors: Any = deque(maxlen=256)       # (plugin, error)

    def register(self, plugin: Any) -> None:
        if not getattr(plugin, "name", ""):
            raise ValueError("plugin needs a .name")
        with self._mu:
            self._plugins.append(plugin)

    def unregister(self, name: str) -> bool:
        with self._mu:
            before = len(self._plugins)
            self._plugins = [p for p in self._plugins if p.name != name]
            return len(self._plugins) != before

    def plugins(self) -> list:
        with self._mu:
            return list(self._plugins)

    def fire(self, hook: str, *args, **kw) -> None:
        """Invoke `hook` on every plugin that implements it; plugin
        failures are isolated and recorded."""
        for p in self.plugins():
            fn = getattr(p, hook, None)
            if fn is None:
                continue
            try:
                fn(*args, **kw)
            except Exception as e:       # noqa: BLE001 - isolation
                with self._mu:
                    self.errors.append((p.name, f"{hook}: {e}"))

    # -- authentication kind (veto semantics) ----------------------- #

    def check_auth(self, user: str, host: str = "%"):
        """Consult authentication plugins; the first non-None answer
        wins.  False vetoes the login even when the builtin credential
        check passed; a plugin failure abstains (fail-open like the
        builtin-path isolation, recorded in .errors)."""
        for p in self.plugins():
            fn = getattr(p, "authenticate", None)
            if fn is None:
                continue
            try:
                out = fn(user, host)
            except Exception as e:       # noqa: BLE001 - isolation
                with self._mu:
                    self.errors.append((p.name, f"authenticate: {e}"))
                continue
            if out is not None:
                return bool(out)
        return None

    # -- daemon kind (lifecycle owned by the server) ---------------- #
    #
    # The registry is process-global, so daemon start/stop is
    # REFCOUNTED: the first server start()s them, the last close()
    # stop()s them — two servers in one process share one daemon set.

    def start_daemons(self, domain) -> None:
        with self._daemon_mu:
            self._daemon_refs += 1
            if self._daemon_refs > 1:
                return
            for p in self.plugins():
                if hasattr(p, "start"):
                    try:
                        p.start(domain)
                    except Exception as e:   # noqa: BLE001
                        with self._mu:
                            self.errors.append((p.name, f"start: {e}"))

    def stop_daemons(self) -> None:
        with self._daemon_mu:
            if self._daemon_refs == 0:
                return
            self._daemon_refs -= 1
            if self._daemon_refs > 0:
                return
            for p in self.plugins():
                if hasattr(p, "stop"):
                    try:
                        p.stop()
                    except Exception as e:   # noqa: BLE001
                        with self._mu:
                            self.errors.append((p.name, f"stop: {e}"))


registry = PluginRegistry()


class AuditLogPlugin:
    """Sample audit plugin (the reference ships audit as its flagship
    plugin): appends one line per statement to a log list or file."""

    name = "audit-log"

    def __init__(self, path: Optional[str] = None, max_lines: int = 10_000):
        from collections import deque
        self.path = path
        self.lines: Any = deque(maxlen=max_lines)  # in-memory ring

    def on_stmt_end(self, sess, sql: str, error: Optional[str],
                    elapsed_sec: float, rows: int) -> None:
        line = (f"user={sess.user} db={sess.db} rows={rows} "
                f"ms={elapsed_sec * 1e3:.1f} "
                f"err={error or '-'} sql={sql[:200]}")
        self.lines.append(line)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


__all__ = ["PluginRegistry", "registry", "AuditLogPlugin"]
