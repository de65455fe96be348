# ported from tidb_tpu/privilege/__init__.py @ 6233200
from .manager import PrivilegeError, PrivilegeManager

__all__ = ["PrivilegeManager", "PrivilegeError"]
