# ported from tidb_tpu/utils/telemetry.py @ df101aa
"""Telemetry: opt-in local usage reporting.

Reference analog: pkg/telemetry (feature-usage collection reported on an
interval; excised of any network egress here — reports are written as
local JSON only, and collection is OFF unless tidb_enable_telemetry is
set).  The collected shape mirrors the reference's report: instance
info, uptime, feature-usage flags, statement counts.

The JAX package reads its devices through ``jax``; the port reads the
domain's client's device: on the card ``torch.cuda`` (the card's name,
count and compute capability, the torch and CUDA versions), else the CPU.
"""

from __future__ import annotations

import json
import time
from typing import Optional


def _hardware(domain) -> dict:
    """The device half of a report, read off the domain's client."""
    import torch
    dev = domain.client.devices[0]
    hw = {"platform": dev.type, "torch": torch.__version__}
    if dev.type != "cuda":
        hw["device_count"] = 1
        return hw
    hw.update({
        "device_count": torch.cuda.device_count(),
        "device_name": torch.cuda.get_device_name(dev),
        "capability": ".".join(
            map(str, torch.cuda.get_device_capability(dev))),
        "cuda": torch.version.cuda,
    })
    return hw


def collect(domain) -> dict:
    """Assemble one telemetry report from live Domain state."""
    tables = sum(len(t) for t in domain.catalog.databases.values())
    indexes = sum(len(getattr(t, "indexes", []))
                  for ts in domain.catalog.databases.values()
                  for t in ts.values())
    stmt_rows = domain.stmt_summary.summary_rows()
    features = {
        "bindings": bool(domain.bindings.rows()),
        "resource_groups": len(domain.resource_groups.rows()) > 1,
        "ddl_jobs": domain._ddl is not None,
        "durable_store": domain.meta is not None,
    }
    return {
        "report_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "version": "0.2.0",
        "hardware": _hardware(domain),
        "schema": {"tables": tables, "indexes": indexes},
        "workload": {
            "distinct_digests": len(stmt_rows),
            "total_execs": sum(r[1] for r in stmt_rows),
        },
        "features": features,
    }


def report(domain, path: Optional[str] = None) -> Optional[str]:
    """Write one report to `path` (JSON) if telemetry is enabled.
    Returns the path written, or None when disabled."""
    from .memory import sysvar_bool
    if not sysvar_bool(domain.sysvars.get("tidb_enable_telemetry"), False):
        return None
    out = path or "telemetry-report.json"
    with open(out, "w") as f:
        json.dump(collect(domain), f, indent=2)
    return out


__all__ = ["collect", "report"]
