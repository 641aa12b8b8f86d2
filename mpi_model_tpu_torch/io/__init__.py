"""L1 I/O: checkpoints (``checkpoint``: the dense layout, the manager,
``run_checkpointed``), the delta chain and the live-migration stream
(``delta``), and the end-of-run output dumps (``output``). The sharded
layout (``io/sharded.py``) is not ported (ROADMAP.md)."""

from .checkpoint import (Checkpoint, CheckpointCorruptionError,
                         CheckpointManager, load_checkpoint,
                         run_checkpointed, save_checkpoint)
from .delta import (DeltaChain, MigrationError, MigrationResult,
                    migrate_scenario, transfer_space)
from .output import (merge_dumps, output_filename, partition_dump_lines,
                     write_output, write_partition_dump)

__all__ = [
    "Checkpoint",
    "CheckpointCorruptionError",
    "CheckpointManager",
    "save_checkpoint",
    "load_checkpoint",
    "run_checkpointed",
    "DeltaChain",
    "MigrationError",
    "MigrationResult",
    "migrate_scenario",
    "transfer_space",
    "partition_dump_lines",
    "write_partition_dump",
    "merge_dumps",
    "output_filename",
    "write_output",
]
