# ported from tidb_tpu/config.py @ 6233200
"""Server configuration file (pkg/config analog, TOML).

Layout mirrors the reference's config.toml.example at the level this
engine honors:

    host = "127.0.0.1"
    port = 4000
    status-port = 10080
    data-dir = "/var/lib/tidb-tpu"
    sync-wal = false

    [variables]              # global sysvar overrides, validated
    tidb_mem_quota_query = 1073741824

    [log]
    slow-threshold-ms = 300

Unknown top-level keys are rejected (typo protection, like the
reference's config check); unknown [variables] entries fail sysvar
validation.
"""

from __future__ import annotations

try:
    import tomllib                 # py >= 3.11
except ImportError:                # py 3.10: the identical-API backport
    import tomli as tomllib
from dataclasses import dataclass, field
from typing import Any, Optional


class ConfigError(ValueError):
    pass


@dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 4000
    status_port: int = 10080
    data_dir: Optional[str] = None
    sync_wal: bool = False
    slow_threshold_ms: float = 300.0
    variables: dict[str, Any] = field(default_factory=dict)


_TOP_KEYS = {"host", "port", "status-port", "data-dir", "sync-wal",
             "variables", "log"}


def load_config(path: Optional[str] = None) -> Config:
    cfg = Config()
    if path is None:
        return cfg
    try:
        with open(path, "rb") as f:
            raw = tomllib.load(f)
    except OSError as e:
        raise ConfigError(f"cannot read config {path!r}: {e}")
    except tomllib.TOMLDecodeError as e:
        raise ConfigError(f"bad TOML in {path!r}: {e}")
    unknown = set(raw) - _TOP_KEYS
    if unknown:
        raise ConfigError(
            f"unknown config keys: {', '.join(sorted(unknown))}")
    try:
        cfg.host = str(raw.get("host", cfg.host))
        cfg.port = int(raw.get("port", cfg.port))
        cfg.status_port = int(raw.get("status-port", cfg.status_port))
        cfg.data_dir = raw.get("data-dir", cfg.data_dir) or None
        cfg.sync_wal = bool(raw.get("sync-wal", cfg.sync_wal))
        log = raw.get("log", {})
        if not isinstance(log, dict):
            raise ConfigError("[log] must be a table")
        cfg.slow_threshold_ms = float(
            log.get("slow-threshold-ms", cfg.slow_threshold_ms))
        variables = raw.get("variables", {})
        if not isinstance(variables, dict):
            raise ConfigError("[variables] must be a table")
        cfg.variables = dict(variables)
    except ConfigError:
        raise
    except (TypeError, ValueError) as e:
        raise ConfigError(f"bad config value in {path!r}: {e}")
    return cfg


def apply_to_domain(cfg: Config, domain) -> None:
    """Validated global sysvar overrides + observability knobs."""
    from .session.sysvars import SysVarError, validate_set
    for name, value in cfg.variables.items():
        try:
            domain.sysvars[name.lower()] = validate_set(name.lower(), value)
        except SysVarError as e:
            raise ConfigError(str(e))
    # (the JAX package also sets its statement summary's slow-log
    # threshold here; the port records no statements yet: ROADMAP.md,
    # Queue 1 entry 7)


__all__ = ["Config", "ConfigError", "load_config", "apply_to_domain"]
