# ported from tidb_tpu/utils/rwlock.py @ 9d319cb
"""Small reader-writer lock.

Used as the in-process analog of the F1 schema-lease wait (pkg/ddl
syncer): DML statements hold the read side for their duration; a DDL
state transition takes the write side, which drains in-flight writers
before the next schema state becomes visible (SURVEY.md §3.4: "after
EACH transition: wait all nodes ack").
"""

from __future__ import annotations

import threading
from contextlib import contextmanager


class RWLock:
    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    @contextmanager
    def read(self):
        with self._cond:
            # writer preference: new readers also yield to WAITING writers,
            # else a steady DML stream starves DDL transitions forever
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                if self._readers == 0:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


__all__ = ["RWLock"]
