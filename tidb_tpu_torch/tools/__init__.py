# ported from tidb_tpu/tools/__init__.py @ f12d972
from .br import backup, restore
from .dump import dump_database
from .lightning import import_csv

__all__ = ["backup", "restore", "dump_database", "import_csv"]
