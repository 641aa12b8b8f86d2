"""L3 ops: flows, plain-torch stencil transport and the fused kernel K1."""

from .flow import Coupled, Diffusion, Exponencial, Flow, PointFlow, \
    build_outflow
from .fused_stencil import PallasDiffusionStep, check_offsets, \
    dense_step_plain, pallas_dense_step
from .stencil import flow_step, gather_neighbors, neighbor_counts, \
    point_flow_step, shift2d, transport

__all__ = [
    "Flow", "PointFlow", "Exponencial", "Diffusion", "Coupled",
    "build_outflow", "PallasDiffusionStep", "check_offsets",
    "dense_step_plain", "pallas_dense_step", "flow_step",
    "gather_neighbors", "neighbor_counts", "point_flow_step", "shift2d",
    "transport",
]
