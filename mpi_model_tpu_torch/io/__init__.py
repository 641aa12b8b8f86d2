"""L1 I/O: the end-of-run output dumps (``output``)."""

from .output import (merge_dumps, output_filename, partition_dump_lines,
                     write_output, write_partition_dump)

__all__ = ["partition_dump_lines", "write_partition_dump", "merge_dumps",
           "output_filename", "write_output"]
