"""L4 orchestration: Model, SerialExecutor, Report."""

from .model import (
    ConservationError,
    Model,
    Report,
    SerialExecutor,
    default_conservation_rtol,
)

__all__ = ["ConservationError", "Model", "Report", "SerialExecutor",
           "default_conservation_rtol"]
