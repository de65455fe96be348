# ported from tidb_tpu/faults/__init__.py @ ba365f2
"""faultline: deterministic fault injection + launch supervision
primitives (seeded FaultPlan seams, per-digest circuit breaker).  The
scheduler drain and CopClient consult these; see plan.py / breaker.py
for the design."""

from .breaker import (CLOSED, HALF_OPEN, OPEN, CircuitBreaker,
                      LaunchQuarantinedError, digest_hex)
from .plan import (SEAMS, FaultPlan, FaultRule, InjectedFault,
                   MemoryFault, PoisonFault, TransientFault, active,
                   check, clear, install, install_spec, is_oom_error,
                   stats)

__all__ = ["FaultPlan", "FaultRule", "InjectedFault", "TransientFault",
           "PoisonFault", "MemoryFault", "is_oom_error", "SEAMS",
           "install", "install_spec", "clear", "active", "check",
           "stats", "CircuitBreaker", "LaunchQuarantinedError",
           "digest_hex", "CLOSED", "OPEN", "HALF_OPEN"]
