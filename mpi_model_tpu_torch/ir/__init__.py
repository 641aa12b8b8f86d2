"""Flow IR (counterpart of ``mpi_model_tpu/ir``): a declarative term
language for nonlinear, coupled physics, lowered by one registered lowering
to every step engine. ``ir.terms`` is the grammar, ``ir.lower`` the
lowering and its engine contexts, ``ir.model`` ``FlowIRModel`` (budgets,
conservation reconciliation), ``ir.library`` the built-in models behind
``--model``."""

from .expr import (Chan, Const, Expr, abs_, exp, maximum,  # noqa: F401
                   minimum)
from .library import MODELS, build_model  # noqa: F401
from .model import FlowIRModel  # noqa: F401
from .terms import (BUDGET_PREFIX, Clock, Sink, Source, Term,  # noqa: F401
                    Transfer, Transport)
