"""L2 data model: Attribute, Cell, CellularSpace, Partition."""

from .attribute import Attribute
from .cell import MOORE_OFFSETS, VON_NEUMANN_OFFSETS, Cell, moore_neighbors, \
    neighbor_count_grid
from .cellular_space import (
    DEFAULT_ATTR,
    CellularSpace,
    Partition,
    block_partitions,
    first_float_dtype,
    resolve_device,
    row_partitions,
)

__all__ = [
    "Attribute", "Cell", "CellularSpace", "Partition", "DEFAULT_ATTR",
    "MOORE_OFFSETS", "VON_NEUMANN_OFFSETS", "moore_neighbors",
    "neighbor_count_grid", "block_partitions", "row_partitions",
    "first_float_dtype", "resolve_device",
]
