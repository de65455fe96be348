# ported from tidb_tpu/rc/__init__.py @ 02e96d8
"""Resource control plane (pkg/resourcegroup + tikv resource_control
analog): RU pricing of device launches from their static LaunchCost
(rc/pricing), per-group token buckets with bounded overdraft
(rc/bucket), admission-time enforcement wired into the scheduler drain
plus statement accounting (rc/controller), and the runaway watch with
KILL / COOLDOWN / SWITCH_GROUP actions (rc/runaway).  Host-only copies:
the port's device scheduler (sched/) prices and debits at its drain,
and the session's resource-group statements make and alter the groups
(``session.Session._charge_resource_group`` charges each statement).
"""

from .bucket import TokenBucket
from .controller import (DEFAULT_MAX_QUEUE_S, DEFAULT_OVERDRAFT_RU,
                         PRIORITY_WEIGHTS, ResourceExhaustedError,
                         ResourceGroup, ResourceGroupManager,
                         charge_statement)
from .pricing import cost_rus, plan_rus, statement_rus, task_rus
from .runaway import RunawayError, RunawayRecord, RunawayRing

__all__ = ["TokenBucket", "ResourceGroup", "ResourceGroupManager",
           "ResourceExhaustedError", "RunawayError", "RunawayRecord",
           "RunawayRing", "charge_statement", "cost_rus", "task_rus",
           "plan_rus", "statement_rus", "PRIORITY_WEIGHTS",
           "DEFAULT_OVERDRAFT_RU", "DEFAULT_MAX_QUEUE_S"]
