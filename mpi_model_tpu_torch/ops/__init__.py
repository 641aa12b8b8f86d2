"""L3 ops: flows, plain-torch stencil transport, the active-tile engine, the
flow lowering and the kernels K1 (fused stencil), K3 (composed filter), K4
(fused field step), K5 (pipelined window over a batch), K6/K7 (fused active
pass)."""

from .flow import Coupled, Diffusion, Exponencial, Flow, PointFlow, \
    build_outflow, cell_coords
from .active import ActiveDiffusionStep, build_active_runner, plan_for
from .composed_stencil import ComposedDiffusionStep, composed_dense_step, \
    composed_taps
from .field_lower import FieldProgram, eval_program, lower_flows
from .field_stencil import PallasFieldStep, field_step_plain, \
    pallas_field_step
from .fused_active import FusedActiveStep, build_fused_runner, \
    fused_active_pass
from .fused_stencil import PallasDiffusionStep, check_offsets, \
    dense_step_plain, pallas_dense_step
from .pipeline_stencil import pipeline_dense_step, pipeline_step_plain
from .stencil import flow_step, gather_neighbors, neighbor_counts, \
    point_flow_step, shift2d, transport

__all__ = [
    "Flow", "PointFlow", "Exponencial", "Diffusion", "Coupled",
    "build_outflow", "cell_coords", "PallasDiffusionStep", "check_offsets",
    "dense_step_plain", "pallas_dense_step", "flow_step",
    "gather_neighbors", "neighbor_counts", "point_flow_step", "shift2d",
    "transport", "ActiveDiffusionStep", "build_active_runner", "plan_for",
    "ComposedDiffusionStep", "composed_dense_step", "composed_taps",
    "FusedActiveStep", "build_fused_runner", "fused_active_pass",
    "FieldProgram", "eval_program", "lower_flows", "PallasFieldStep",
    "field_step_plain", "pallas_field_step", "pipeline_dense_step",
    "pipeline_step_plain",
]
