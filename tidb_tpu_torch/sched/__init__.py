# ported from tidb_tpu/sched/__init__.py @ 02e96d8
"""Device admission scheduler: continuous micro-batching of concurrent
cop tasks (tikv unified-read-pool + inference continuous-batching
analog).  See scheduler.py for the design."""

from .scheduler import (DEFAULT_MAX_COALESCE, DEFAULT_QUEUE_DEPTH,
                        DeviceScheduler, scheduler_for, shutdown_all)
from .task import (SCHED_GROUP, CopTask, ServerBusyError,
                   TaskCancelledError, current_group, mesh_fingerprint)

__all__ = ["DeviceScheduler", "scheduler_for", "shutdown_all", "CopTask",
           "ServerBusyError", "TaskCancelledError", "SCHED_GROUP",
           "current_group",
           "DEFAULT_QUEUE_DEPTH", "DEFAULT_MAX_COALESCE",
           "mesh_fingerprint"]
