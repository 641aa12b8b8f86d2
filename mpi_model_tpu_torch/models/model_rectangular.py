"""ModelRectangular: the 2-D block-decomposed model (counterpart of
``mpi_model_tpu/models/model_rectangular.py``).

The reference's ``ModelRectangular`` (``/root/reference/src/
ModelRectangular.hpp:13-273``) assigns ``PROC_DIMX_REC × PROC_DIMY_REC``
blocks over a ``LINES_REC × COLUMNS_REC`` process grid (``:69-80``) but
leaves its halo, reduction and merge stages commented out and computes the
owner of a cell wrongly (``:85``). Here, as in the JAX package, the 2-D case
is finished: the step is ``Model``'s, and the 2-D-ness is the executor's
mesh. ``default_executor(devices=)`` builds a ``ShardMapExecutor`` over a
lines × columns mesh (the visible cards round-robin over the positions by
default, so on one card every block is a shard on it), giving the block
decomposition with a full 8-neighbour (edge + corner) ghost exchange. The
executed mesh is the source of truth of the block map that ``owner_of``,
``partitions`` and ``write_output`` describe.
"""

from __future__ import annotations

from typing import Optional, Sequence

from ..core.cellular_space import CellularSpace, Partition, block_partitions
from .model import Model


class ModelRectangular(Model):
    """``Model`` whose default executor is a ``ShardMapExecutor`` over a 2-D
    mesh, and whose partition geometry (owner lookup, per-block output) is
    that mesh's block map."""

    def __init__(self, flow, time: float = 1.0, time_step: float = 1.0, *,
                 lines: Optional[int] = None, columns: Optional[int] = None,
                 offsets=None, step_impl: str = "xla", halo_depth: int = 1,
                 compute_dtype=None):
        super().__init__(flow, time, time_step, offsets=offsets)
        self.lines = lines
        self.columns = columns
        #: passed to the default ShardMapExecutor: the per-shard step, the
        #: ring depth and the kernels' interior-math dtype
        self.step_impl = step_impl
        self.halo_depth = halo_depth
        self.compute_dtype = compute_dtype

    @classmethod
    def reference_scenario(cls, dtype="float64", device=None, **kw):
        """(space, model) of the reference's disabled rectangular demo
        (``/root/reference/src/Main.cpp:37-47`` + ``DefinesRectangular.hpp``):
        a 20×60 grid over a 2×3 process grid (10×20 blocks), an Exponencial
        source at (18, 19) with value 2.2 and rate 0.1, time 10.0, step 0.2.
        The source sits one cell off block (1, 0)'s south-east corner, so
        its Moore shares cross both block axes. ``device=None`` is the
        card."""
        from ..core.attribute import Attribute
        from ..core.cell import Cell
        from ..ops.flow import Exponencial

        space = CellularSpace.create(20, 60, 1.0, dtype=dtype, device=device)
        model = cls(Exponencial(Cell(18, 19, Attribute(99, 2.2)), 0.1),
                    10.0, 0.2, lines=2, columns=3, **kw)
        return space, model

    def _grid_shape(self, devices=None) -> tuple[int, int]:
        # the EXECUTED mesh is the source of truth once a default executor
        # exists: a run over an explicit device list must yield the block
        # map it actually sharded over
        ex = self._default_executor
        if devices is None and ex is not None and hasattr(ex, "mesh"):
            return ex.mesh.grid_shape
        from ..parallel.mesh import _devices, resolve_grid2d

        if (devices is None and self.lines is not None
                and self.columns is not None):
            return self.lines, self.columns
        return resolve_grid2d(self.lines, self.columns,
                              len(_devices(devices)))

    def partitions(self, space: CellularSpace,
                   devices=None) -> list[Partition]:
        """The lines × columns block map of ``space``
        (``ModelRectangular.hpp:69-80``, remainder-safe)."""
        lines, columns = self._grid_shape(devices)
        return block_partitions(space.dim_x, space.dim_y, lines, columns)

    def owner_of(self, x: int, y: int, space: CellularSpace,
                 devices=None) -> int:
        """Rank owning global cell (x, y): the block containing it. (The
        reference's ``(x + y) / height + 1``, ``ModelRectangular.hpp:85``,
        is wrong for 2-D blocks: cells (0, 59) and (18, 1) collide.)"""
        for p in self.partitions(space, devices):
            if p.contains(x, y):
                return p.rank
        raise IndexError(f"({x}, {y}) outside the {space.shape} grid")

    def write_output(self, directory: str, space: CellularSpace,
                     devices=None, **kw) -> str:
        """Per-block ``comm_rank{r}.txt`` dumps in rank-major order and the
        merged file: the output stage the reference's 2-D variant left
        commented out (``ModelRectangular.hpp:235-270``)."""
        from ..io.output import write_output

        return write_output(directory, space,
                            partitions=self.partitions(space, devices), **kw)

    def default_executor(self, devices: Optional[Sequence] = None):
        """A ``ShardMapExecutor`` on a lines × columns mesh over ``devices``
        (default: the visible cards round-robin over the positions). It
        becomes the model's default, so ``owner_of``/``partitions``/
        ``write_output`` follow its mesh."""
        from ..parallel.executors import ShardMapExecutor
        from ..parallel.mesh import make_mesh_2d

        mesh = make_mesh_2d(self.lines, self.columns, devices=devices)
        self._default_executor = ShardMapExecutor(
            mesh, step_impl=self.step_impl, halo_depth=self.halo_depth,
            compute_dtype=self.compute_dtype)
        return self._default_executor

    def execute(self, space, executor=None, **kw):
        if executor is None:
            if self._default_executor is None:
                self._default_executor = self.default_executor()
            executor = self._default_executor
        elif getattr(executor, "mesh", None) is not None:
            # an explicitly passed mesh executor becomes the geometry's
            # source of truth too
            self._default_executor = executor
        return super().execute(space, executor, **kw)
