"""mpi_model_tpu_torch — the PyTorch/CUDA port of ``mpi_model_tpu``.

The same cellular-space framework (CellularSpace / Cell / Attribute / Flow /
Model) in PyTorch for one NVIDIA H100, with the kernels written by hand in
CUDA C++ (``csrc/``): the fused stencil K1, the composed k-step filter K3, the
fused multi-channel field step K4 (pointwise flows lowered to programs), the
pipelined-window stencil K5 over a batch of scenarios, the fused
active-tile pass K6/K7, and the halo modes K2, K3-halo and K4-halo that
step the shards of a sharded grid. It imports torch and numpy,
never jax and nothing of ``mpi_model_tpu``. Entry points run on the card
unless the caller asks for the CPU (``device="cpu"``).

Layer map (as in the JAX package):
  L0 ``abstraction``  — dtype seam (DataType → torch dtypes)
  L1 ``io``           — the output dumps; ``parallel`` — mesh, ghost-ring
                         exchange, collectives, ShardMapExecutor,
                         AutoShardedExecutor
  L2 ``core``         — Attribute/Cell/CellularSpace
  L3 ``ops``          — flows, plain-torch stencil, active-tile engine,
                         flow lowering, kernels K1, K3, K4, K6/K7
  L4 ``models``       — Model/SerialExecutor/Report/ModelRectangular
  L5 ``ensemble``     — batched scenarios (EnsembleExecutor, K5), the
                         bucketed scheduler, the synchronous service, the
                         always-on async service and ``run_soak``
  —  ``ir``           — the Flow IR: terms, the one registered lowering,
                         FlowIRModel and its library (``--model``)
  —  ``examples``     — the four front-door scripts (``python -m
                         mpi_model_tpu_torch.examples.<name>``)
  —  ``utils`` (timing helpers, serving counters, tracing, the roofline
     read from the card, the kernel build cache), ``obs`` (the flight
     recorder, the telemetry snapshot, the status endpoint), ``resilience``
     (FailureEvent, the fault plans of ``inject``, the supervisor),
     ``native`` (the C++ engine of ``native/``), ``oracle``, ``interop``,
     ``cli``
"""

from .abstraction import DataType, UnsupportedDataTypeError, \
    get_abstraction_data_type
from .core import Attribute, Cell, CellularSpace, Partition
from .ops import Coupled, Diffusion, Exponencial, Flow, PointFlow, \
    cell_coords
from .models import ConservationError, Model, ModelRectangular, Report, \
    SerialExecutor
from .resilience import (FailureEvent, SimulationFailure, check_health,
                         supervised_run)
from .parallel import (AutoShardedExecutor, ShardMapExecutor, make_mesh,
                       make_mesh_2d, shard_space)
from .ensemble import (AsyncEnsembleService, EnsembleConservationError,
                       EnsembleExecutor, EnsembleScheduler, EnsembleService,
                       EnsembleSpace, ServiceOverloaded, TicketExpired,
                       buckets_for, run_ensemble, run_soak)
from .ir import (Chan, Clock, FlowIRModel, Sink, Source, Transfer, Transport,
                 build_model)

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
    "ModelRectangular",
    "Report",
    "SerialExecutor",
    "FailureEvent",
    "SimulationFailure",
    "check_health",
    "supervised_run",
    "AsyncEnsembleService",
    "EnsembleConservationError",
    "EnsembleExecutor",
    "EnsembleScheduler",
    "EnsembleService",
    "EnsembleSpace",
    "ServiceOverloaded",
    "TicketExpired",
    "buckets_for",
    "run_ensemble",
    "run_soak",
    "AutoShardedExecutor",
    "ShardMapExecutor",
    "make_mesh",
    "make_mesh_2d",
    "shard_space",
    "Chan",
    "Clock",
    "FlowIRModel",
    "Sink",
    "Source",
    "Transfer",
    "Transport",
    "build_model",
    "__version__",
]
