# ported from tidb_tpu/obs/__init__.py @ 02e96d8
"""Observability: of the JAX package's ``obs/`` the port holds the
device-memory ledger the scheduler's drain reads (``hbm.ledger_for``).
The spans, the flight recorder and the roofline store come with
ROADMAP.md, Queue 1 entry 12."""
