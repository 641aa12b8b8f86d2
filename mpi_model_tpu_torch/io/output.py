"""Output: per-partition state dumps and the master merge (counterpart of
``mpi_model_tpu/io/output.py``).

The reference's workers each write their partition as ``x<TAB>y<TAB>value``
lines to ``comm_rank{r}.txt`` (``/root/reference/src/Model.hpp:246-260``)
and the master concatenates them rank by rank into ``output
<timestamp>.txt`` (``Model.hpp:100-131``). Coordinates are global, and the
merged file covers every cell once, in rank-major then row-major order; the
files are byte for byte the JAX package's for the same space and
partitions. One process writes them all: it is the master, so the JAX
package's multi-host ``master_only``/``broadcast_str`` have no work here.
"""

from __future__ import annotations

import datetime as _dt
import os
import shutil
from typing import Iterable, Optional

from ..core.cellular_space import (DEFAULT_ATTR, CellularSpace, Partition,
                                   row_partitions)


def partition_dump_lines(space: CellularSpace, attr: str = DEFAULT_ATTR,
                         fmt: str = "{:.6g}") -> Iterable[str]:
    """Row-major ``x<TAB>y<TAB>value`` lines with global coordinates (the
    reference's per-cell dump loop, ``Model.hpp:252-256``)."""
    vals = space.to_numpy()[attr]
    for lx in range(space.dim_x):
        x = space.x_init + lx
        row = vals[lx]
        for ly in range(space.dim_y):
            yield f"{x}\t{space.y_init + ly}\t{fmt.format(float(row[ly]))}"


def write_partition_dump(directory: str, space: CellularSpace, rank: int,
                         attr: str = DEFAULT_ATTR,
                         fmt: str = "{:.6g}") -> str:
    """One worker's ``comm_rank{r}.txt`` (``Model.hpp:249-257``)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"comm_rank{rank}.txt")
    with open(path, "w") as f:
        for line in partition_dump_lines(space, attr, fmt):
            f.write(line + "\n")
    return path


def merge_dumps(out_path: str, dump_paths: Iterable[str]) -> str:
    """Master merge: concatenate worker dumps in rank order into one file
    (``Model.hpp:110-131``)."""
    d = os.path.dirname(os.path.abspath(out_path)) or "."
    os.makedirs(d, exist_ok=True)
    with open(out_path, "wb") as out:
        for p in dump_paths:
            with open(p, "rb") as f:
                shutil.copyfileobj(f, out)
    return out_path


def output_filename(timestamp: Optional[str] = None) -> str:
    """``output <timestamp>.txt``: the reference stamps the merge with
    ``__TIMESTAMP__`` (``Model.hpp:104``); here the wall time."""
    ts = timestamp or _dt.datetime.now().strftime("%a %b %d %H:%M:%S %Y")
    return f"output {ts}.txt"


def write_output(directory: str, space: CellularSpace,
                 partitions: Optional[list[Partition]] = None,
                 comm_size: int = 1, attr: str = DEFAULT_ATTR,
                 fmt: str = "{:.6g}",
                 timestamp: Optional[str] = None) -> str:
    """Per-partition dumps and the merged master file; returns the merged
    file's path. ``partitions`` defaults to the reference's 1-D row
    striping over ``comm_size`` ranks (``Model.hpp:62-76``)."""
    if partitions is None:
        partitions = row_partitions(space.dim_x, space.dim_y, comm_size)
    host = space.with_values({k: v.cpu() for k, v in space.values.items()})
    dumps = [write_partition_dump(directory, host.slice_partition(p),
                                  p.rank, attr, fmt) for p in partitions]
    return merge_dumps(os.path.join(directory, output_filename(timestamp)),
                       dumps)
