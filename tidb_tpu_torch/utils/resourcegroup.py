# ported from tidb_tpu/utils/resourcegroup.py @ f4efee1
"""Back-compat shim: resource control lives in the ``rc`` package
(LaunchCost-priced RU admission, group isolation, runaway enforcement
at the device drain).  Import from ``tidb_tpu_torch.rc`` in new code;
this module re-exports the stable surface so existing importers
(session, infoschema, tests) keep working."""

from __future__ import annotations

from ..rc.controller import (PRIORITY_WEIGHTS, ResourceExhaustedError,
                             ResourceGroup, ResourceGroupManager,
                             charge_statement)
from ..rc.runaway import RunawayError

__all__ = ["ResourceGroup", "ResourceGroupManager", "RunawayError",
           "ResourceExhaustedError", "charge_statement",
           "PRIORITY_WEIGHTS"]
