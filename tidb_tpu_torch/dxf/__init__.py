# ported from tidb_tpu/dxf/__init__.py @ 9be2bf6
"""DXF-lite: the distributed task framework.

Reference analog: pkg/disttask/framework (scheduler + taskexecutor):
a TASK of a registered type is planned into SUBTASKS, which a worker
pool executes with per-subtask state persisted to the KV meta keyspace —
so a restarted owner resumes unfinished subtasks instead of starting
over.  The reference distributes subtasks across nodes over gRPC; here
the pool is in-process threads (the single-host analog), but the state
machine, persistence, cancel, and resume semantics match:

    pending -> running -> succeed | failed | cancelled
    subtask: pending -> running -> succeed | failed

Task types register a planner (task meta -> list of subtask metas) and
an executor (subtask meta -> result).  ADD INDEX backfill and bulk
import are the reference's flagship DXF users; here the framework is
exercised by the analyze/import paths and directly by tests.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Optional

META_TASK = b"m_dxf_task_"


@dataclass
class Subtask:
    idx: int
    meta: dict
    state: str = "pending"      # pending | running | succeed | failed
    result: Any = None
    error: str = ""


@dataclass
class DistTask:
    task_id: int
    task_type: str
    meta: dict
    state: str = "pending"  # pending|running|succeed|failed|cancelled
    subtasks: list = field(default_factory=list)
    error: str = ""
    start_time: float = 0.0
    finish_time: float = 0.0

    def to_json(self) -> bytes:
        # built by hand, NOT asdict(): results are never persisted and
        # must not be deep-copied either (they may be large or hold
        # non-copyable objects)
        d = {"task_id": self.task_id, "task_type": self.task_type,
             "meta": self.meta, "state": self.state, "error": self.error,
             "start_time": self.start_time,
             "finish_time": self.finish_time,
             "subtasks": [{"idx": s.idx, "meta": s.meta,
                           "state": s.state, "result": None,
                           "error": s.error} for s in self.subtasks]}
        return json.dumps(d).encode()

    @classmethod
    def from_json(cls, b: bytes) -> "DistTask":
        d = json.loads(b.decode())
        subs = [Subtask(**s) for s in d.pop("subtasks")]
        t = cls(**d)
        t.subtasks = subs
        return t


class TaskTypeRegistry:
    def __init__(self):
        self._types: dict[str, tuple[Callable, Callable]] = {}

    def register(self, task_type: str, planner: Callable,
                 executor: Callable) -> None:
        """planner(meta) -> [subtask metas]; executor(meta) -> result."""
        self._types[task_type] = (planner, executor)

    def get(self, task_type: str):
        if task_type not in self._types:
            raise KeyError(f"unregistered task type {task_type!r}")
        return self._types[task_type]


REGISTRY = TaskTypeRegistry()


class TaskManager:
    """Owner-side scheduler (disttask scheduler + taskexecutor pool)."""

    def __init__(self, kv=None, workers: int = 4,
                 registry: TaskTypeRegistry = REGISTRY):
        self.kv = kv
        self.workers = workers
        self.registry = registry
        self._next_id = 0
        self._tasks: dict[int, DistTask] = {}
        self._cancel: set[int] = set()
        self._mu = threading.Lock()
        if kv is not None:
            self._recover()

    # -- persistence -------------------------------------------------- #

    def _persist(self, t: DistTask) -> None:
        if self.kv is None:
            return
        from ..store.codec import encode_int_key
        txn = self.kv.begin()
        txn.put(META_TASK + encode_int_key(t.task_id), t.to_json())
        txn.commit()

    def _recover(self) -> None:
        from ..store.codec import encode_int_key
        ts = self.kv.alloc_ts()
        end = META_TASK[:-1] + bytes([META_TASK[-1] + 1])
        for _, v in self.kv.scan(META_TASK, end, ts):
            t = DistTask.from_json(v)
            self._tasks[t.task_id] = t
            self._next_id = max(self._next_id, t.task_id)
            # a task that was mid-flight when the owner died resumes
            if t.state == "running":
                for s in t.subtasks:
                    if s.state == "running":
                        s.state = "pending"     # re-run unfinished work

    # -- API ----------------------------------------------------------- #

    def submit(self, task_type: str, meta: dict) -> int:
        planner, _ = self.registry.get(task_type)
        # plan BEFORE publishing: a planner failure must not leave a
        # ghost pending task in the registry
        subtasks = [Subtask(i, m) for i, m in enumerate(planner(meta))]
        with self._mu:
            self._next_id += 1
            t = DistTask(self._next_id, task_type, meta)
            t.subtasks = subtasks
            self._tasks[t.task_id] = t
        self._persist(t)
        return t.task_id

    def run(self, task_id: int) -> DistTask:
        """Execute pending subtasks on the worker pool until done (the
        scheduler loop, synchronous form)."""
        t = self._tasks[task_id]
        _, executor = self.registry.get(t.task_type)
        t.state = "running"
        t.start_time = t.start_time or time.time()
        self._persist(t)

        def run_one(s: Subtask):
            if task_id in self._cancel:
                return
            s.state = "running"
            try:
                s.result = executor(s.meta)
                s.state = "succeed"
            except Exception as e:       # noqa: BLE001 - task isolation
                s.state = "failed"
                s.error = str(e)
            # persist EVERY subtask completion: crash-resume must skip
            # finished subtasks (their side effects committed), not
            # re-execute them (_mu serializes concurrent pool persists).
            # O(K) state rows per persist — results are excluded, so each
            # write is small.  A persist failure must not escape subtask
            # isolation (the task would be stuck 'running' forever).
            try:
                with self._mu:
                    self._persist(t)
            except Exception as e:       # noqa: BLE001
                s.error = (s.error + "; " if s.error else "") + \
                    f"persist: {e}"

        pending = [s for s in t.subtasks if s.state != "succeed"]
        with ThreadPoolExecutor(max_workers=self.workers) as pool:
            list(pool.map(run_one, pending))
        if task_id in self._cancel:
            t.state = "cancelled"
            self._cancel.discard(task_id)
        elif any(s.state == "failed" for s in t.subtasks):
            t.state = "failed"
            t.error = "; ".join(s.error for s in t.subtasks
                                if s.state == "failed")[:512]
        else:
            t.state = "succeed"
            t.error = ""           # a re-run that succeeds clears failures
        t.finish_time = time.time()
        self._persist(t)
        return t

    def cancel(self, task_id: int) -> None:
        with self._mu:
            self._cancel.add(task_id)

    def get(self, task_id: int) -> Optional[DistTask]:
        return self._tasks.get(task_id)

    def tasks(self) -> list[DistTask]:
        return sorted(self._tasks.values(), key=lambda t: t.task_id)


__all__ = ["TaskManager", "TaskTypeRegistry", "DistTask", "Subtask",
           "REGISTRY"]
