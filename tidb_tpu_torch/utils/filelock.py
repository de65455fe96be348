# ported from tidb_tpu/utils/filelock.py @ 02e96d8
"""Advisory file locking for one-host multi-process coordination.

Reference analog: PD's etcd gives the reference cluster a linearizable
store; on one host the portable poor-man's equivalent is an fcntl
advisory lock around read-modify-write plus atomic temp-file rename
for the write itself.  Two subsystems share this seam:

- ``pd/store.py`` FileBackend — every transaction on the coordination
  store runs under the lock, so CAS semantics hold across processes.
- ``compilecache/manifest.py`` — concurrent manifest saves from two
  processes sharing one ``tidb_tpu_compile_cache_dir`` merge instead
  of clobbering.

Platforms without ``fcntl`` (a defensive gate only — tier-1 runs on
Linux) degrade to the atomic-rename-only discipline: last writer wins,
never a torn file.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

try:
    import fcntl
except ImportError:          # pragma: no cover - non-POSIX fallback
    fcntl = None


@contextmanager
def locked_file(path: str):
    """Hold an exclusive advisory lock on ``path`` (created empty if
    missing) for the dynamic extent.  OSError propagates — callers own
    the unavailability semantics (pd maps it to PdUnavailable, the
    manifest swallows it: persistence is an optimization there)."""
    fd = os.open(path, os.O_CREAT | os.O_RDWR, 0o644)
    try:
        if fcntl is not None:
            fcntl.flock(fd, fcntl.LOCK_EX)
        yield fd
    finally:
        try:
            if fcntl is not None:
                fcntl.flock(fd, fcntl.LOCK_UN)
        finally:
            os.close(fd)


__all__ = ["locked_file"]
