"""The reference's exact scenario, end to end (the JAX package's
``examples/reference_run.py``).

Reproduces ``mpirun -np 6 ./exec`` of the reference
(the reference's ``src/Main.cpp:17-52``): a 100x100 grid of 1.0, an
``Exponencial`` flow at cell (19,3) with snapshot value 2.2 and rate 0.1,
one live step (its time loop is disabled), sum conserved at 10000 +- 1e-3;
then the same run on 5 row stripes, with the source deliberately on a
stripe edge, exactly like the reference's cross-rank halo default; then the
rectangular 2x3 demo the reference left commented out. float64 throughout.
Every mesh position sits on the one device.

Run: python -m mpi_model_tpu_torch.examples.reference_run [--device=cpu]
"""

from __future__ import annotations

import torch

from .. import (Attribute, Cell, CellularSpace, Exponencial, Model,
                ModelRectangular)
from ..core.cellular_space import resolve_device
from ..parallel import ShardMapExecutor, make_mesh
from . import device_name, expect, run


def main(device=None) -> dict:
    dev = resolve_device(device)
    print(f"device: {device_name(dev)}")
    space = CellularSpace.create(100, 100, 1.0, dtype="float64", device=dev)
    model = Model(Exponencial(Cell(19, 3, Attribute(99, 2.2)), 0.1),
                  10.0, 0.2)

    out, report = model.execute(space, steps=1)  # the reference's one step
    value = out.values["value"]
    v = value.cpu().numpy()
    print(f"serial: total={report.final_total['value']:.6f} "
          f"source cell (19,3)={v[19, 3]:.6f} "
          f"neighbor (18,3)={v[18, 3]:.6f} "
          f"|drift|={report.conservation_error():.2e}")
    expect(abs(v[19, 3] - 0.78) < 1e-12, "source cell != 1 - 0.22")
    expect(abs(v[18, 3] - (1 + 0.22 / 8)) < 1e-12,
           "neighbor != 1 + 0.22/8")

    # sharded: 5 row stripes of 20 rows, the reference's NWORKERS=5
    # decomposition (Defines.hpp:7-8), where cell (19,3) sits on stripe
    # 0's LAST row, so its share crosses a stripe boundary through the
    # ghost ring: the reference's deliberate cross-rank default
    # (Main.cpp:33)
    out2, rep2 = model.execute(
        space, ShardMapExecutor(make_mesh(5, devices=[dev] * 5)), steps=1)
    sharded = out2.values["value"]
    err = float((sharded - value).abs().max())
    expect(err <= 1e-12, f"sharded run differs from serial by {err:.3e}")
    print(f"sharded x{rep2.comm_size}: identical to serial, "
          f"|drift|={rep2.conservation_error():.2e}")

    # the rectangular demo the reference left COMMENTED OUT
    # (Main.cpp:37-47): 20x60 over a 2x3 block grid, source (18,19)
    # crossing both block axes; here it just runs
    rspace, rmodel = ModelRectangular.reference_scenario(device=dev)
    rout, rrep = rmodel.execute(
        rspace, rmodel.default_executor(devices=[dev] * 6))
    owner = rmodel.owner_of(18, 19, rspace)
    print(f"rectangular 2x3 blocks (the reference's disabled demo): "
          f"total={rrep.final_total['value']:.6f} "
          f"|drift|={rrep.conservation_error():.2e}, "
          f"owner of (18,19) = rank {owner}")
    return {"device": str(dev), "serial": value,
            "serial_total": report.final_total["value"],
            "serial_drift": report.conservation_error(),
            "sharded": sharded, "sharded_comm_size": rep2.comm_size,
            "sharded_drift": rep2.conservation_error(),
            "rect": rout.values["value"],
            "rect_comm_size": rrep.comm_size,
            "rect_total": rrep.final_total["value"],
            "rect_drift": rrep.conservation_error(), "owner": owner}


if __name__ == "__main__":
    raise SystemExit(run(main))
