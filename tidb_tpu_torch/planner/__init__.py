from .build import build_select, BuiltSelect, ExprBuilder, PlanError
from .optimize import optimize_plan
from .logical import explain_logical
