from .jobs import DDLJob, JobStorage
from .owner import DDLExecutor, DDLError

__all__ = ["DDLJob", "JobStorage", "DDLExecutor", "DDLError"]
