# ported from tidb_tpu/dxf/balancer.py @ 9be2bf6
"""DXF node pool: subtask balancing across store processes.

Reference analog: the disttask framework's scheduler + balancer
(pkg/disttask/framework/doc.go:15-80, scheduler/balancer.go) — subtasks
of one task spread across taskexecutor NODES; when a node dies its
unfinished subtasks rebalance onto survivors and the task still
completes.  Here nodes are the store RPC processes (store/server.py),
and the pool runs one puller thread per node over a shared queue — a
work-stealing balancer: a fast node naturally takes more subtasks, a
dead one's in-flight subtask is requeued for the survivors.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Sequence


class DXFNodeError(RuntimeError):
    """Every node died with subtasks outstanding."""


class DXFNodePool:
    """Balance subtask execution over remote executor nodes."""

    def __init__(self, stores: Sequence[Any]):
        # `stores` are RemoteStore-shaped: .request(msg) raising on a
        # dead peer, .store_id
        self.stores = list(stores)
        self.dead: set[int] = set()
        # observability (the reference's subtask table columns)
        self.per_node: dict[int, int] = {s.store_id: 0 for s in self.stores}
        self.rebalanced = 0
        self._mu = threading.Lock()

    def live_nodes(self):
        return [s for s in self.stores if s.store_id not in self.dead]

    def run_subtasks(self, subtasks: Sequence[Any],
                     make_msg: Callable[[Any], Any],
                     handle_resp: Callable[[Any, Any], None]) -> None:
        """Execute every subtask exactly once on some live node.

        make_msg(subtask) -> RPC message; handle_resp(subtask, resp) runs
        on the puller thread that got the response (callers serialize
        their own state).  A node failure marks it dead, requeues the
        in-flight subtask, and lets the surviving pullers drain the
        queue; DXFNodeError only if ALL nodes die first."""
        q: queue.Queue = queue.Queue()
        for st in subtasks:
            q.put(st)
        n_left = [len(subtasks)]
        errors: list = []
        done = threading.Event()

        def puller(store):
            while not done.is_set():
                try:
                    # block briefly instead of exiting on empty: a dying
                    # node may requeue its in-flight subtask at any time
                    st = q.get(timeout=0.05)
                except queue.Empty:
                    if n_left[0] == 0:
                        return
                    continue
                try:
                    resp = store.request(make_msg(st))
                except Exception:
                    # node loss: requeue for survivors, retire this puller
                    with self._mu:
                        self.dead.add(store.store_id)
                        self.rebalanced += 1
                    q.put(st)
                    return
                try:
                    handle_resp(st, resp)
                except Exception as e:      # executor-side failure
                    errors.append(e)
                    done.set()
                    return
                with self._mu:
                    self.per_node[store.store_id] += 1
                    n_left[0] -= 1
                    if n_left[0] == 0:
                        done.set()

        threads = [threading.Thread(target=puller, args=(s,), daemon=True)
                   for s in self.live_nodes()]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if n_left[0] > 0:
            raise DXFNodeError(
                f"{n_left[0]} subtasks unassigned: all DXF nodes died")


__all__ = ["DXFNodePool", "DXFNodeError"]
