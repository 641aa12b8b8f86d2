"""mpi_model_tpu_torch — the PyTorch/CUDA port of ``mpi_model_tpu``.

The same cellular-space framework (CellularSpace / Cell / Attribute / Flow /
Model) in PyTorch for one NVIDIA H100, with the kernels written by hand in
CUDA C++ (``csrc/``): the fused stencil K1, the composed k-step filter K3, the
fused multi-channel field step K4 (pointwise flows lowered to programs), the
pipelined-window stencil K5 over a batch of scenarios and the fused
active-tile pass K6/K7. It imports torch and numpy,
never jax and nothing of ``mpi_model_tpu``. Entry points run on the card
unless the caller asks for the CPU (``device="cpu"``).

Layer map (as in the JAX package):
  L0 ``abstraction``  — dtype seam (DataType → torch dtypes)
  L2 ``core``         — Attribute/Cell/CellularSpace
  L3 ``ops``          — flows, plain-torch stencil, active-tile engine,
                         flow lowering, kernels K1, K3, K4, K6/K7
  L4 ``models``       — Model/SerialExecutor/Report
  L5 ``ensemble``     — batched scenarios (EnsembleExecutor, K5), the
                         bucketed scheduler, the synchronous service
  —  ``utils`` (serving counters), ``resilience`` (FailureEvent),
     ``oracle``, ``interop``, ``cli``
"""

from .abstraction import DataType, UnsupportedDataTypeError, \
    get_abstraction_data_type
from .core import Attribute, Cell, CellularSpace, Partition
from .ops import Coupled, Diffusion, Exponencial, Flow, PointFlow, \
    cell_coords
from .models import ConservationError, Model, Report, SerialExecutor
from .ensemble import (EnsembleConservationError, EnsembleExecutor,
                       EnsembleScheduler, EnsembleService, EnsembleSpace,
                       buckets_for, run_ensemble)

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
    "cell_coords",
    "ConservationError",
    "Model",
    "Report",
    "SerialExecutor",
    "EnsembleConservationError",
    "EnsembleExecutor",
    "EnsembleScheduler",
    "EnsembleService",
    "EnsembleSpace",
    "buckets_for",
    "run_ensemble",
]
