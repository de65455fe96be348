# ported from tidb_tpu/privilege/manager.py @ 6233200
"""MySQL GRANT-system privilege manager.

Reference analog: pkg/privilege + pkg/privilege/privileges (Handle, the
MySQLPrivilege cache of mysql.user/mysql.db/mysql.tables_priv) — but held
as an in-memory authoritative store on the Domain instead of system-table
rows reloaded on FLUSH: one process owns the catalog here, so the cache
IS the store.  Host matching is exact-or-'%' (no netmasks).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional

from ..utils import auth as P

# statement-level privileges recognised (mysql.user columns analog)
KNOWN_PRIVS = {"SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP",
               "ALTER", "INDEX", "CREATE USER", "PROCESS", "SUPER"}


class PrivilegeError(PermissionError):
    """ER_TABLEACCESS_DENIED / ER_SPECIFIC_ACCESS_DENIED analog."""


@dataclass
class UserRecord:
    user: str
    host: str
    auth_hash: bytes                       # SHA1(SHA1(password))
    global_privs: set = field(default_factory=set)
    db_privs: dict = field(default_factory=dict)      # db -> set
    table_privs: dict = field(default_factory=dict)   # (db, table) -> set

    def key(self):
        return (self.user, self.host)


class PrivilegeManager:
    def __init__(self):
        self._mu = threading.RLock()
        self.users: dict[tuple, UserRecord] = {}
        # bootstrap root@% with ALL, empty password (session/bootstrap.go
        # doDMLWorks analog)
        root = UserRecord("root", "%", P.native_password_hash(""))
        root.global_privs = set(KNOWN_PRIVS) | {"ALL"}
        self.users[root.key()] = root

    # ---------------- snapshot (watch-plane persistence) ------------- #

    def snapshot(self) -> str:
        """JSON of every user record — the mysql.user/db/tables_priv dump
        the watch plane persists and remote domains reload."""
        with self._mu:
            out = []
            for rec in self.users.values():
                out.append({
                    "user": rec.user, "host": rec.host,
                    "auth": rec.auth_hash.hex(),
                    "auth_plugin": getattr(rec, "auth_plugin", ""),
                    "global": sorted(rec.global_privs),
                    "db": {db: sorted(v)
                           for db, v in rec.db_privs.items()},
                    "table": {f"{db}\x00{tb}": sorted(v)
                              for (db, tb), v in rec.table_privs.items()},
                })
        import json
        return json.dumps(out)

    def load_snapshot(self, blob: str) -> None:
        import json
        recs = json.loads(blob)
        with self._mu:
            self.users.clear()
            for r in recs:
                rec = UserRecord(r["user"], r["host"],
                                 bytes.fromhex(r["auth"]))
                if r.get("auth_plugin"):
                    rec.auth_plugin = r["auth_plugin"]
                rec.global_privs = set(r["global"])
                rec.db_privs = {db: set(v) for db, v in r["db"].items()}
                rec.table_privs = {tuple(k.split("\x00", 1)): set(v)
                                   for k, v in r["table"].items()}
                self.users[rec.key()] = rec

    # ---------------- account management ---------------- #

    def create_user(self, user: str, host: str, password: Optional[str],
                    if_not_exists: bool = False):
        with self._mu:
            if (user, host) in self.users:
                if if_not_exists:
                    return
                raise PrivilegeError(
                    f"Operation CREATE USER failed for '{user}'@'{host}'")
            self.users[(user, host)] = UserRecord(
                user, host, P.native_password_hash(password or ""))

    def alter_user(self, user: str, host: str, password: Optional[str]):
        with self._mu:
            rec = self._must_get(user, host)
            rec.auth_hash = P.native_password_hash(password or "")

    def drop_user(self, user: str, host: str, if_exists: bool = False):
        with self._mu:
            if (user, host) not in self.users:
                if if_exists:
                    return
                raise PrivilegeError(
                    f"Operation DROP USER failed for '{user}'@'{host}'")
            del self.users[(user, host)]

    def _must_get(self, user: str, host: str) -> UserRecord:
        rec = self.users.get((user, host))
        if rec is None:
            raise PrivilegeError(f"unknown user '{user}'@'{host}'")
        return rec

    def _match(self, user: str) -> Optional[UserRecord]:
        """Resolve a connecting user by name.  Connections carry no client
        host here (all are local), so: '%' record first, else the record
        with the lexically-smallest host (deterministic)."""
        rec = self.users.get((user, "%"))
        if rec is not None:
            return rec
        cands = [r for (u, _), r in sorted(self.users.items()) if u == user]
        return cands[0] if cands else None

    # ---------------- grants ---------------- #

    def grant(self, privs: list[str], db: str, table: str,
              user: str, host: str):
        with self._mu:
            rec = self._must_get(user, host)
            pset = {p.upper() for p in privs}
            for p in pset - KNOWN_PRIVS - {"ALL"}:
                raise PrivilegeError(f"unknown privilege {p}")
            if db == "*":
                rec.global_privs |= pset
            elif table == "*":
                rec.db_privs.setdefault(db, set()).update(pset)
            else:
                rec.table_privs.setdefault((db, table), set()).update(pset)

    def revoke(self, privs: list[str], db: str, table: str,
               user: str, host: str):
        with self._mu:
            rec = self._must_get(user, host)
            pset = {p.upper() for p in privs}
            def strip(s: set):
                if "ALL" in pset:
                    s.clear()
                else:
                    s -= pset
            if db == "*":
                strip(rec.global_privs)
            elif table == "*":
                strip(rec.db_privs.setdefault(db, set()))
            else:
                strip(rec.table_privs.setdefault((db, table), set()))

    # ---------------- checks ---------------- #

    def check(self, user: str, priv: str, db: str = "",
              table: str = "") -> bool:
        """RequestVerification analog: global > db > table grant levels."""
        rec = self._match(user)
        if rec is None:
            return False
        priv = priv.upper()
        def has(s):
            return "ALL" in s or priv in s
        if has(rec.global_privs):
            return True
        if db and has(rec.db_privs.get(db, ())):
            return True
        if db and table and has(rec.table_privs.get((db, table), ())):
            return True
        return False

    def has_db_access(self, user: str, db: str) -> bool:
        """USE/COM_INIT_DB check: any privilege at global, db, or
        any-table-in-db level grants visibility (mysql checkGrantDB)."""
        rec = self._match(user)
        if rec is None:
            return False
        if rec.global_privs:
            return True
        if rec.db_privs.get(db):
            return True
        return any(d == db and privs
                   for (d, _t), privs in rec.table_privs.items())

    def require(self, user: str, priv: str, db: str = "", table: str = ""):
        if not self.check(user, priv, db, table):
            target = f"table '{db}.{table}'" if table else (
                f"database '{db}'" if db else "this operation")
            raise PrivilegeError(
                f"{priv} command denied to user '{user}' for {target}")

    # ---------------- introspection / auth ---------------- #

    def show_grants(self, user: str, host: str = "%") -> list[str]:
        rec = self.users.get((user, host)) or self._match(user)
        if rec is None:
            raise PrivilegeError(f"unknown user '{user}'@'{host}'")
        ident = f"'{rec.user}'@'{rec.host}'"
        out = []
        gp = sorted(rec.global_privs)
        if "ALL" in rec.global_privs:
            out.append(f"GRANT ALL PRIVILEGES ON *.* TO {ident}")
        elif gp:
            out.append(f"GRANT {', '.join(gp)} ON *.* TO {ident}")
        else:
            out.append(f"GRANT USAGE ON *.* TO {ident}")
        for db in sorted(rec.db_privs):
            ps = sorted(rec.db_privs[db])
            if ps:
                out.append(f"GRANT {', '.join(ps)} ON {db}.* TO {ident}")
        for (db, tbl) in sorted(rec.table_privs):
            ps = sorted(rec.table_privs[(db, tbl)])
            if ps:
                out.append(f"GRANT {', '.join(ps)} ON {db}.{tbl} TO {ident}")
        return out

    def authenticate(self, user: str, auth: bytes, salt: bytes):
        """Wire-auth verify; returns (ok, error_message)."""
        rec = self._match(user)
        if rec is None:
            return False, f"Access denied for user '{user}'"
        if not P.check_scramble(auth, salt, rec.auth_hash):
            return False, f"Access denied for user '{user}' (using password: " \
                          f"{'YES' if auth else 'NO'})"
        return True, None

    def authenticate_cleartext(self, user: str, password: str):
        """caching_sha2_password FULL-auth verify (TLS-protected
        cleartext checks against the stored SHA1(SHA1(pw)))."""
        from ..utils.auth import native_password_hash
        rec = self._match(user)
        if rec is None:
            return False, f"Access denied for user '{user}'"
        if native_password_hash(password) != rec.auth_hash:
            return False, f"Access denied for user '{user}'"
        return True, None


__all__ = ["PrivilegeManager", "PrivilegeError", "UserRecord", "KNOWN_PRIVS"]
