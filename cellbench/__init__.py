"""The benchmark of the PyTorch and CUDA port (``mpi_model_tpu_torch``).

One command runs one cell::

    python3 -m cellbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, cell, traffic kind, per-layer
metric or flow kind is a file of its own, found by name (``registry``);
``README.md`` says how to add one. Importing this package imports nothing
else: ``run.py`` sets the cache directories before torch is loaded.
"""
