from .physical import ExecContext, ResultChunk, PhysOp
from .plan import to_physical
