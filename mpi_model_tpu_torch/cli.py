"""Command line of the PyTorch/CUDA port (serial path).

    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \\
        --dimy=16384 --impl=pallas --substeps=8 --json

Runs on the card unless ``--device=cpu`` is given. Prints one row: the impl
that actually ran, the kernel launch count, the totals, whether mass was
conserved and the wall time. Exit status 1 when conservation fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional

from . import (Attribute, Cell, CellularSpace, Diffusion, Exponencial, Model,
               SerialExecutor)


def cmd_run(args) -> int:
    if args.flow == "exponencial":
        # the reference's live scenario: 0.1 * 2.2 out of (19, 3) per step
        flow = Exponencial(Cell(19, 3, Attribute(99, 2.2)), 0.1)
    else:
        flow = Diffusion(0.1)
    space = CellularSpace.create(args.dimx, args.dimy, args.init,
                                 dtype=args.dtype, device=args.device)
    model = Model(flow)
    executor = SerialExecutor(step_impl=args.impl, substeps=args.substeps)
    t0 = time.perf_counter()
    out, report = model.execute(space, executor, steps=args.steps,
                                check_conservation=False)
    wall = time.perf_counter() - t0
    err = report.conservation_error()
    thresh = model.conservation_threshold(
        space, initial_totals=report.initial_total)
    row = {
        "backend": "serial",
        "device": str(space.device),
        "impl": report.impl,
        "substeps": args.substeps,
        "kernel_launches": (report.backend_report or {}).get("launches", 0),
        "steps": report.steps,
        "initial": report.initial_total,
        "final": report.final_total,
        "conservation_error": err,
        "conserved": bool(err <= thresh),
        "wall_s": wall,
    }
    if args.json:
        print(json.dumps(row, allow_nan=False))
    else:
        status = "CONSERVED" if row["conserved"] else "VIOLATED"
        print(f"impl={row['impl']} launches={row['kernel_launches']} "
              f"steps={row['steps']} initial={row['initial']} "
              f"final={row['final']} |delta|={err:.3e} {status} "
              f"({wall:.3f}s on {row['device']})")
    return 0 if row["conserved"] else 1


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpi_model_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a simulation (reference scenario "
                         "by default)")
    run.add_argument("--flow", default="exponencial",
                     choices=("exponencial", "diffusion"))
    run.add_argument("--dimx", type=int, default=100)
    run.add_argument("--dimy", type=int, default=100)
    run.add_argument("--init", type=float, default=1.0)
    run.add_argument("--steps", type=int, default=1)
    run.add_argument("--dtype", default="float32",
                     choices=("float32", "float64", "bfloat16"))
    run.add_argument("--impl", default="auto",
                     choices=("xla", "pallas", "auto"),
                     help="xla: plain torch ops; pallas: the fused CUDA "
                     "kernel; auto: pallas where eligible")
    run.add_argument("--substeps", type=int, default=1)
    run.add_argument("--device", default="cuda",
                     help="torch device (default: the card)")
    run.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
