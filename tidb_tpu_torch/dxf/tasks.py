# ported from tidb_tpu/dxf/tasks.py @ 9be2bf6
"""Built-in DXF task types bound to a Domain.

Reference analog: the disttask users — ADD INDEX backfill and IMPORT
INTO run as distributed tasks (pkg/disttask/importinto,
pkg/ddl/backfilling_dist_*).  Here: ANALYZE fan-out (one subtask per
table) and CSV import (one subtask per file chunk), each planned into
independent subtasks the worker pool executes.
"""

from __future__ import annotations

from . import TaskManager, TaskTypeRegistry


def build_registry(domain) -> TaskTypeRegistry:
    reg = TaskTypeRegistry()

    # -- analyze: one subtask per table ------------------------------- #

    def plan_analyze(meta: dict) -> list[dict]:
        db = meta.get("db", "test")
        names = meta.get("tables") or sorted(
            domain.catalog.databases.get(db, {}))
        return [{"db": db, "table": n} for n in names]

    def run_analyze(meta: dict):
        tbl = domain.catalog.get_table(meta["db"], meta["table"])
        domain.stats.analyze_table(tbl)
        return tbl.num_rows

    reg.register("analyze", plan_analyze, run_analyze)

    # -- import-csv: one subtask per chunk of lines ------------------- #

    def plan_import(meta: dict) -> list[dict]:
        """One planning pass records each chunk's BYTE offset, so
        subtasks seek straight to their slice instead of rescanning the
        file from line 0 (O(file) total, not O(chunks x file))."""
        chunk = int(meta.get("chunk_rows", 4096))
        offsets = [0]
        rows_in_chunk = 0
        with open(meta["path"], "rb") as f:
            for line in f:
                rows_in_chunk += 1
                if rows_in_chunk == chunk:
                    offsets.append(f.tell())
                    rows_in_chunk = 0
        if rows_in_chunk == 0 and len(offsets) > 1:
            offsets.pop()            # file ended exactly on a boundary
        return [{"db": meta.get("db", "test"), "table": meta["table"],
                 "path": meta["path"], "offset": off,
                 "rows": chunk, "sep": meta.get("sep", ",")}
                for off in offsets]

    def run_import(meta: dict):
        tbl = domain.catalog.get_table(meta["db"], meta["table"])
        rows = []
        with open(meta["path"]) as f:
            f.seek(meta["offset"])
            for _ in range(meta["rows"]):
                line = f.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                vals = [None if v == "\\N" else v
                        for v in line.rstrip("\n").split(meta["sep"])]
                rows.append(tuple(vals))
        return tbl.insert_rows(rows)

    reg.register("import-csv", plan_import, run_import)
    return reg


def manager_for(domain) -> TaskManager:
    return TaskManager(kv=domain.kv, registry=build_registry(domain))


__all__ = ["build_registry", "manager_for"]
