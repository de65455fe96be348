# ported from tidb_tpu/server/__init__.py @ 6233200
from .mysql_server import MySQLServer
from .status import StatusServer

__all__ = ["MySQLServer", "StatusServer"]
