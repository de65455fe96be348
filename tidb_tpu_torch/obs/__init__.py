# ported from tidb_tpu/obs/__init__.py @ df101aa
"""copscope: end-to-end observability for the async serving
stack.

- ``trace``: cross-thread trace propagation (``TraceCtx`` stamped onto
  CopTask at submit) + lock-protected per-statement span trees with
  explicit parent ids — the scheduler drain, copforge resolve, and
  client transfer/merge seams record real spans from their own threads.
- ``recorder``: bounded flight-recorder ring of completed query traces
  (failed/degraded/quarantined/retried/slow always kept, the rest
  sampled), served at ``/trace`` + ``/trace/<id>`` with Chrome
  trace-event export (``?fmt=chrome``).

Latency histograms ride ``utils/metrics`` (label-aware prometheus-text
histograms) — ``tidb_tpu_sched_{wait,launch,compile}_ms`` and the
per-strategy agg launch histogram are wired at the scheduler drain.

copgauge adds the memory/throughput axis:

- ``hbm``: the live per-device HBM ledger (launch-scoped bytes at
  admission/finish), measured launch watermarks, bounded device
  ``memory_stats`` reconciliation, and the on-demand ``/profile``
  capture gate (``torch.profiler``).
- ``roofline``: per-program-digest achieved-vs-peak bytes/s and
  FLOPs/s attribution (memory-/compute-/launch-bound) against a
  declared per-backend peak table (NVIDIA's datasheet for the cards it
  names, a device microbench for another card, the CPU: boot-time
  microbench), over the launch's device time from CUDA events on the
  card.
"""

from .hbm import (HbmLedger, all_ledgers, device_memory_stats,
                  hbm_status, ledger_for, profiler_gate)
from .recorder import FlightRecorder
from .roofline import (backend_peaks, peaks_for_mesh, roofline_status,
                       roofline_store)
from .trace import (TRACE_CTX, Span, SpanTree, TraceCtx, annotate,
                    current, flag, new_trace_id, span)

__all__ = ["Span", "SpanTree", "TraceCtx", "TRACE_CTX", "current",
           "span", "flag", "annotate", "new_trace_id", "FlightRecorder",
           "HbmLedger", "ledger_for", "all_ledgers", "hbm_status",
           "device_memory_stats", "profiler_gate", "roofline_store",
           "roofline_status", "backend_peaks", "peaks_for_mesh"]
