"""Scaling the simulation: fused kernels, deep halos, checkpointed runs
(the JAX package's ``examples/scaling.py``).

A tour of the performance and resilience surface on one device (the card,
or the CPU when asked):

1. dense Diffusion through the fused multi-step kernel K1
   (``SerialExecutor("auto", substeps=4)``: 4 flow steps per launch, 16
   launches for 64 steps; on the CPU the kernel's plain version runs);
2. a 2-D sharded run with deep halos (one depth-4 ghost exchange per 4
   steps) on a 2x4 mesh whose 8 positions sit on the one device;
3. a supervised, checkpointed run that survives an injected fault, with
   the per-shard checkpoint layout;
4. the point-subsystem path: a 50,000-step point-flow run (only the ~9
   involved cells ride the loop, so a step's cost does not depend on the
   grid).

Sizes follow the JAX script's two branches: a 2048² bfloat16 grid on the
card, 256² float32 on the CPU; ``main(side=..., dtype=...)`` overrides
both. §1's time includes building K1 when no built copy is cached yet.

Run: python -m mpi_model_tpu_torch.examples.scaling [--device=cpu]
"""

from __future__ import annotations

import tempfile
import time

import torch

from .. import (Attribute, Cell, CellularSpace, Diffusion, Exponencial,
                Model, SerialExecutor, supervised_run)
from ..core.cellular_space import resolve_device
from ..io import CheckpointManager
from ..parallel import ShardMapExecutor, make_mesh_2d
from . import device_name, expect, run, synchronize

POINT_STEPS = 50_000


class Flaky:
    """An executor that raises on its third call (a simulated preemption)
    and otherwise runs ``SerialExecutor()``."""

    comm_size = 1

    def __init__(self):
        self.calls = 0
        self.inner = SerialExecutor()

    def run_model(self, m, s, k):
        self.calls += 1
        if self.calls == 3:
            raise RuntimeError("simulated preemption")
        return self.inner.run_model(m, s, k)


def point_run(g: int, steps: int, device=None) -> dict:
    """§4: the reference's point source on a g x g float32 grid, ``steps``
    steps through the point subsystem, after one warm-up step; returns the
    grid, the seconds of the timed run and the path taken."""
    dev = resolve_device(device)
    s4 = CellularSpace.create(g, g, 1.0, dtype="float32", device=dev)
    m4 = Model(Exponencial(Cell(19, 3, Attribute(99, 2.2)), 1e-5), 1.0, 1.0)
    ex4 = SerialExecutor()
    ex4.run_model(m4, s4, 1)  # warm: the plans and step vectors built
    synchronize(dev)
    t0 = time.perf_counter()
    out4 = ex4.run_model(m4, s4, steps)
    synchronize(dev)
    dt = time.perf_counter() - t0
    return {"values": out4["value"], "seconds": dt, "steps": steps,
            "impl": ex4.last_impl}


def main(device=None, side=None, dtype=None,
         point_steps: int = POINT_STEPS) -> dict:
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    g = side if side is not None else (2048 if on_card else 256)
    dtype = dtype if dtype is not None else (
        "bfloat16" if on_card else "float32")
    print(f"device: {device_name(dev)}")

    # 1. fused multi-step kernel (serial / one device)
    space = CellularSpace.create(g, g, 1.0, dtype=dtype, device=dev)
    model = Model(Diffusion(0.1), 64.0, 1.0)
    ex1 = SerialExecutor("auto", substeps=4)
    t0 = time.perf_counter()
    out, rep = model.execute(space, ex1)
    s1 = time.perf_counter() - t0
    launches = (rep.backend_report or {}).get("launches")
    print(f"1. {g}x{g} {dtype}, 64 steps, fused x4 ({rep.impl}, "
          f"{launches} launches): {s1:.2f}s, "
          f"|drift|={rep.conservation_error():.2e}")

    # 2. 2-D sharded with deep halos
    mesh = make_mesh_2d(2, 4, devices=[dev] * 8)
    s2 = CellularSpace.create(256, 256, 1.0, dtype="float32", device=dev)
    out2, rep2 = Model(Diffusion(0.1), 16.0, 1.0).execute(
        s2, ShardMapExecutor(mesh, halo_depth=4))
    print(f"2. 256x256 over a 2x4 mesh, depth-4 halos "
          f"(4 steps per exchange): ranks={rep2.comm_size}, "
          f"|drift|={rep2.conservation_error():.2e}")

    # 3. supervised + checkpointed, with an injected transient fault
    s3 = CellularSpace.create(64, 64, 1.0, dtype="float64", device=dev)
    m3 = Model(Diffusion(0.05), 20.0, 1.0)
    with tempfile.TemporaryDirectory() as d:
        res = supervised_run(m3, s3,
                             CheckpointManager(d, layout="sharded",
                                               device=dev),
                             steps=20, every=5, executor=Flaky())
    want, _ = m3.execute(s3, steps=20)
    same = torch.equal(res.space.values["value"], want.values["value"])
    expect(same, "the supervised run is not the uninterrupted one")
    print(f"3. supervised run (sharded ckpt layout): "
          f"{res.recovered_failures} failure recovered "
          f"({res.events[0].detail}), final state bit-identical to an "
          "uninterrupted run")

    # 4. point-subsystem fast path: the reference's live workload at
    # absurd step counts; per-step cost is independent of the grid
    p4 = point_run(g, point_steps, dev)
    us = p4["seconds"] / point_steps * 1e6
    print(f"4. {g}x{g} point flow, {point_steps:,} steps in "
          f"{p4['seconds'] * 1e3:.0f} ms ({us:.2f} µs/step — only the 9 "
          "involved cells ride the loop)")
    return {"device": str(dev), "side": g, "dtype": dtype,
            "s1": {"values": out.values["value"], "seconds": s1,
                   "impl": rep.impl, "launches": launches,
                   "drift": rep.conservation_error()},
            "s2": {"values": out2.values["value"],
                   "comm_size": rep2.comm_size,
                   "drift": rep2.conservation_error()},
            "s3": {"values": res.space.values["value"],
                   "uninterrupted": want.values["value"],
                   "bitwise": same,
                   "recovered": res.recovered_failures,
                   "detail": res.events[0].detail},
            "s4": {**p4, "us_per_step": us}}


if __name__ == "__main__":
    raise SystemExit(run(main))
