# ported from tidb_tpu/ddl/jobs.py @ 3951242
"""DDL job model + KV-persisted job queue/history.

Reference analog: pkg/ddl job handling — jobs enqueued to the DDL job
table (mysql.tidb_ddl_job), processed by the owner, archived to
tidb_ddl_history; reorg progress checkpointed in tidb_ddl_reorg
(ddl/reorg.go) so backfill resumes after failover.  Here jobs persist as
JSON under the meta prefix of the native KV store ('m' keyspace,
pkg/meta/meta.go:78 analog).
"""

from __future__ import annotations

import json
import time
from dataclasses import asdict, dataclass, field
from typing import Optional

from ..store.codec import encode_int_key

META_JOB = b"m_ddl_job_"        # + int key: queued/running jobs
META_HIST = b"m_ddl_hist_"      # + int key: finished jobs


@dataclass
class DDLJob:
    job_id: int = 0
    job_type: str = ""          # 'add index' | 'drop index' | ...
    db: str = ""
    table: str = ""
    args: dict = field(default_factory=dict)
    state: str = "queueing"     # queueing | running | done | failed
    schema_state: str = "none"  # F1 states (ddl/index.go:880-888)
    error: str = ""
    reorg_handle: int = 0       # backfill checkpoint (tidb_ddl_reorg)
    rows_backfilled: int = 0
    start_time: float = 0.0
    finish_time: float = 0.0

    def to_json(self) -> bytes:
        return json.dumps(asdict(self)).encode()

    @classmethod
    def from_json(cls, b: bytes) -> "DDLJob":
        return cls(**json.loads(b.decode()))


class JobStorage:
    """Persist jobs/history in the KV meta keyspace."""

    def __init__(self, kv):
        self.kv = kv

    def _put(self, prefix: bytes, job: DDLJob):
        t = self.kv.begin()
        t.put(prefix + encode_int_key(job.job_id), job.to_json())
        t.commit()

    def save(self, job: DDLJob):
        self._put(META_JOB, job)

    def archive(self, job: DDLJob):
        t = self.kv.begin()
        t.delete(META_JOB + encode_int_key(job.job_id))
        t.put(META_HIST + encode_int_key(job.job_id), job.to_json())
        t.commit()

    def _scan(self, prefix: bytes) -> list[DDLJob]:
        ts = self.kv.alloc_ts()
        end = prefix[:-1] + bytes([prefix[-1] + 1])
        return [DDLJob.from_json(v)
                for _, v in self.kv.scan(prefix, end, ts)]

    def pending(self) -> list[DDLJob]:
        return self._scan(META_JOB)

    def history(self) -> list[DDLJob]:
        return self._scan(META_HIST)

    def all_jobs(self) -> list[DDLJob]:
        return sorted(self.pending() + self.history(),
                      key=lambda j: j.job_id)


__all__ = ["DDLJob", "JobStorage", "META_JOB", "META_HIST"]
