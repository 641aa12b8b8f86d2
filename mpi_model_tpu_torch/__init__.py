"""mpi_model_tpu_torch — the PyTorch/CUDA port of ``mpi_model_tpu``.

The same cellular-space framework (CellularSpace / Cell / Attribute / Flow /
Model) in PyTorch for one NVIDIA H100, with the fused stencil kernel written
by hand in CUDA C++ (``csrc/fused_stencil.cu``). It imports torch and numpy,
never jax and nothing of ``mpi_model_tpu``. Entry points run on the card
unless the caller asks for the CPU (``device="cpu"``).

Layer map (as in the JAX package):
  L0 ``abstraction``  — dtype seam (DataType → torch dtypes)
  L2 ``core``         — Attribute/Cell/CellularSpace
  L3 ``ops``          — flows, plain-torch stencil, fused kernel K1
  L4 ``models``       — Model/SerialExecutor/Report
  —  ``oracle``, ``interop``, ``cli``
"""

from .abstraction import DataType, UnsupportedDataTypeError, \
    get_abstraction_data_type
from .core import Attribute, Cell, CellularSpace, Partition
from .ops import Coupled, Diffusion, Exponencial, Flow, PointFlow
from .models import ConservationError, Model, Report, SerialExecutor

__version__ = "0.1.0"

__all__ = [
    "DataType",
    "UnsupportedDataTypeError",
    "get_abstraction_data_type",
    "Attribute",
    "Cell",
    "CellularSpace",
    "Partition",
    "Flow",
    "PointFlow",
    "Exponencial",
    "Diffusion",
    "Coupled",
    "ConservationError",
    "Model",
    "Report",
    "SerialExecutor",
]
