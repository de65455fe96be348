# ported from tidb_tpu/analysis/lint.py @ 1fb41ee
"""The analysis gate's finding record.

The port holds the ``Finding`` the gate passes report
(``shardflow.shard_findings``, ``valueflow.value_findings``,
``lifetime.donation_findings``).  The AST linter itself, its rules and
its baseline come with ROADMAP.md, Queue 1 entry 11b.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Finding:
    rule: str
    path: str        # tidb_tpu_torch-relative, /-separated
    line: int
    symbol: str      # enclosing Class.function qualname ('' = module)
    message: str

    def key(self) -> str:
        """Baseline identity: rule + file + enclosing symbol.  Line
        numbers are deliberately excluded so accepted findings survive
        unrelated edits to the same file."""
        return f"{self.rule} {self.path}::{self.symbol}"

    def __str__(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym} {self.message}"


__all__ = ["Finding"]
