"""The port's front door: four example programs, each the counterpart of a
script of the JAX package's ``examples/``.

    python -m mpi_model_tpu_torch.examples.reference_run       # the card
    python -m mpi_model_tpu_torch.examples.scaling --device=cpu

- ``reference_run``: the reference's exact scenario, serial, on 5 row
  stripes and on its 2×3 rectangular block grid.
- ``scaling``: the fused kernel K1 (``SerialExecutor("auto",
  substeps=4)``), depth-4 halos on a 2×4 mesh, a supervised run that
  survives an injected fault with the per-shard checkpoint layout, and the
  point-subsystem path over 50,000 steps.
- ``masked_lake``: a bool mask channel stored, sharded and checkpointed
  beside the float channel it modulates.
- ``reaction_diffusion``: Gray-Scott through the Flow IR, serial, on 4
  stripes and as a feed-rate sweep in one batched run.

Each module has ``main(device=None, **sizes) -> dict``, which prints what
its JAX script prints and returns it as numbers and tensors. It runs on the
card unless ``device="cpu"`` is given, and raises without a card. Where the
JAX script needs several devices, the port places that many mesh positions
on the one device, so no section is skipped.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch


def expect(cond: bool, what: str) -> None:
    """An example's own check: raises ``AssertionError`` when it fails
    (also under ``python -O``)."""
    if not cond:
        raise AssertionError(what)


def device_name(dev: torch.device) -> str:
    """The name of the device an example runs on, printed beside its
    times."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return str(dev)


def synchronize(dev: torch.device) -> None:
    """Wait for the device's queued work (``jax.block_until_ready``'s
    place)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(main: Callable[..., dict], argv=None) -> int:
    """The ``python -m`` entry: ``--device`` (default: the card) passed to
    ``main``."""
    ap = argparse.ArgumentParser(description=main.__module__)
    ap.add_argument("--device", default=None,
                    help="torch device to run on (default: the card)")
    args = ap.parse_args(argv)
    main(device=args.device)
    return 0
