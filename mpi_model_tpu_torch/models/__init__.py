"""L4 orchestration: Model, SerialExecutor, Report, ModelRectangular."""

from .model import (
    ConservationError,
    Model,
    Report,
    SerialExecutor,
    default_conservation_rtol,
)
from .model_rectangular import ModelRectangular

__all__ = ["ConservationError", "Model", "ModelRectangular", "Report",
           "SerialExecutor", "default_conservation_rtol"]
