"""Command line of the PyTorch/CUDA port (serial path).

    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \\
        --dimy=16384 --impl=pallas --substeps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \\
        --dimy=16384 --impl=active_fused --substeps=8 --blob=0.05 --json
    python -m mpi_model_tpu_torch.cli run --flow=coupled --channels=2 \\
        --dimx=8192 --dimy=8192 --impl=pallas --substeps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=4096 \\
        --dimy=4096 --ensemble=8 --ensemble-impl=pipeline --substeps=8 \\
        --steps=8 --json

Runs on the card unless ``--device=cpu`` is given. Prints one row: the impl
that actually ran, the kernel launch count, the totals, whether mass was
conserved, the wall time and the executor's ``backend_report`` (the
composed k, the active engine's fallback steps, mean active fraction and
per-kernel launches). ``--blob=FRAC`` starts from zeros with a centred
square of ``U(0.5, 2.0)`` values (numpy seed 0) covering FRAC of the grid
(the active engine's sparse workload) instead of ``--init`` everywhere.
``--flow=coupled --channels=N`` is the JAX package's chain: N channels
``c0..c{N-1}``, a ``Diffusion(0.1)`` on each, and ``Coupled(0.05)`` from
each channel but the last, modulated by the next; at N=2 the BASELINE
config-4 flow set's shape, which runs on the field kernel K4.
``--ensemble=B`` runs B copies of the scenario through the serving stack
(``EnsembleService`` → bucketed scheduler → batched engine) and prints the
ensemble row (scenarios/s, batch occupancy, runner-cache hits, dispatches);
``--ensemble-impl`` picks its engine (``pipeline`` is the kernel K5). Exit
status 1 when conservation fails.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import (Attribute, Cell, CellularSpace, Coupled, Diffusion, Exponencial,
               Model, SerialExecutor)

RATE = 0.1  # the JAX package's --rate default


def build_flows(args):
    """The run's flows and the space's initial values (``--init`` per
    channel), as the JAX package's CLI builds them."""
    if args.flow == "exponencial":
        # the reference's live scenario: 0.1 * 2.2 out of (19, 3) per step
        return Exponencial(Cell(19, 3, Attribute(99, 2.2)), RATE), args.init
    if args.flow == "diffusion":
        return Diffusion(RATE), args.init
    # N diffusing channels chained by coupled flows: channel i sheds mass
    # modulated by channel i+1
    names = [f"c{i}" for i in range(args.channels)]
    flows = [Diffusion(RATE, attr=nm) for nm in names]
    flows += [Coupled(flow_rate=RATE / 2, attr=names[i],
                      modulator=names[i + 1])
              for i in range(len(names) - 1)]
    return flows, {nm: args.init for nm in names}


def check_ensemble_flags(args) -> None:
    """The JAX package's checks of the ensemble flags, for the flags the
    port has."""
    if args.ensemble is not None:
        if args.ensemble < 1:
            raise SystemExit(f"--ensemble={args.ensemble} needs B >= 1")
        if args.impl != "auto":
            raise SystemExit(
                "--impl selects the single-run kernel; ensemble runs "
                "use --ensemble-impl=xla|pipeline|active|active_fused")
    elif args.ensemble_impl != "xla":
        raise SystemExit("--ensemble-impl applies to ensemble runs; add "
                         "--ensemble=B")


def run_ensemble_cli(args, space, model) -> int:
    """``--ensemble B``: B copies of the configured scenario through the
    serving stack, conservation judged here (status and exit code), not
    raised mid-flight."""
    from .ensemble import EnsembleService, buckets_for
    from .models.model import kernel_launches

    B = args.ensemble
    steps = args.steps
    svc = EnsembleService(
        model, steps=steps, impl=args.ensemble_impl,
        substeps=args.substeps, buckets=buckets_for(B),
        check_conservation=False)
    before = kernel_launches()
    t0 = time.perf_counter()
    try:
        tickets = [svc.submit(space) for _ in range(B)]
        svc.flush()
        outs = [svc.result(t) for t in tickets]
    except (TypeError, ValueError) as e:
        # an ineligible engine (e.g. pipeline on a point flow or a grid that
        # does not cut into strips) is misuse of the flags, not a crash
        raise SystemExit(f"ensemble run failed: {e}")
    wall = time.perf_counter() - t0
    launched = sum(v - before[k] for k, v in kernel_launches().items())
    st = svc.stats()
    thresh = model.conservation_threshold(space)
    err = max(rep.conservation_error() for _, rep in outs)
    conserved = bool(err <= thresh)
    initial = {k: sum(rep.initial_total[k] for _, rep in outs)
               for k in outs[0][1].initial_total}
    final = {k: sum(rep.final_total[k] for _, rep in outs)
             for k in outs[0][1].final_total}
    row = {
        "backend": "ensemble",
        "device": str(space.device),
        "ranks": 1,
        "ensemble": B,
        "steps": steps,
        "initial": initial,
        "final": final,
        "conservation_error": err,
        "conserved": conserved,
        "wall_s": wall,
        "impl": args.ensemble_impl,
        "substeps": args.substeps,
        "kernel_launches": launched,
        "mesh": st["mesh"],
        "scenarios_per_s": st["scenarios_per_s"],
        "batch_occupancy": st["batch_occupancy"],
        "compile_cache_hits": st["compile_cache_hits"],
        "dispatches": st["dispatches"],
        "recovered_failures": st["recovered_failures"],
        "quarantined": st["quarantined"],
        "solo_retries": st["solo_retries"],
    }
    if args.json:
        print(json.dumps(row, allow_nan=False))
    else:
        status = "CONSERVED" if conserved else "VIOLATED"
        sps = st["scenarios_per_s"]
        rate = f"{sps:.1f} scenarios/s, " if sps else ""
        print(f"backend=ensemble impl={args.ensemble_impl} B={B} "
              f"steps={steps} max|delta|={err:.3e} {status} "
              f"({wall:.2f}s on {row['device']}, {rate}"
              f"occupancy={st['batch_occupancy']:.2f}, "
              f"{st['dispatches']} dispatches, {launched} kernel launches)")
    return 0 if conserved else 1


def cmd_run(args) -> int:
    check_ensemble_flags(args)
    if args.flow == "coupled" and args.channels < 2:
        raise SystemExit("--flow=coupled needs --channels >= 2 (one channel "
                         "has nothing to modulate — use --flow=diffusion)")
    if args.channels != 2 and args.flow != "coupled":
        raise SystemExit("--channels applies to --flow=coupled")
    if args.blob is not None and args.flow == "coupled":
        raise SystemExit("--blob fills the single channel of "
                         "--flow=diffusion|exponencial")
    flow, init = build_flows(args)
    space = CellularSpace.create(args.dimx, args.dimy, init,
                                 dtype=args.dtype, device=args.device)
    if args.blob is not None:
        v = blob_grid(args.dimx, args.dimy, args.blob)
        space = space.with_values({"value": torch.from_numpy(v).to(
            device=space.device, dtype=space.dtype)})
    model = Model(flow)
    if args.ensemble is not None:
        return run_ensemble_cli(args, space, model)
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
        "backend_report": report.backend_report,
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


def blob_grid(h: int, w: int, frac: float, seed: int = 0) -> np.ndarray:
    """Zeros with a centred square of side ``round(h * sqrt(frac))`` holding
    ``U(0.5, 2.0)`` values from ``seed`` (f32): the state a point source's
    front reaches after sweeping ``frac`` of the grid."""
    side = max(1, min(h, w, int(round(h * math.sqrt(frac)))))
    v = np.zeros((h, w), np.float32)
    r0, c0 = (h - side) // 2, (w - side) // 2
    v[r0:r0 + side, c0:c0 + side] = np.random.default_rng(seed).uniform(
        0.5, 2.0, (side, side)).astype(np.float32)
    return v


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpi_model_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a simulation (reference scenario "
                         "by default)")
    run.add_argument("--flow", default="exponencial",
                     choices=("exponencial", "diffusion", "coupled"))
    run.add_argument("--channels", type=int, default=2,
                     help="channel count for --flow=coupled (a chain of N "
                     "diffusing channels, each but the last shedding "
                     "modulated by the next)")
    run.add_argument("--dimx", type=int, default=100)
    run.add_argument("--dimy", type=int, default=100)
    run.add_argument("--init", type=float, default=1.0)
    run.add_argument("--steps", type=int, default=1)
    run.add_argument("--dtype", default="float32",
                     choices=("float32", "float64", "bfloat16"))
    run.add_argument("--impl", default="auto",
                     choices=("xla", "pallas", "auto", "composed", "active",
                              "active_fused"),
                     help="xla: plain torch ops; pallas: the fused CUDA "
                     "kernel K1 (Diffusion) or the fused field kernel K4 "
                     "(other pointwise flows); composed: the composed "
                     "k-step filter K3; "
                     "active: the plain active-tile engine; active_fused: "
                     "the fused active kernels K6 + K7; auto: pallas where "
                     "eligible")
    run.add_argument("--blob", type=float, default=None,
                     help="start from a centred square of random values "
                     "(seed 0) covering this fraction of the grid, zeros "
                     "elsewhere")
    run.add_argument("--substeps", type=int, default=1)
    run.add_argument("--ensemble", type=int, default=None, metavar="B",
                     help="run B copies of the scenario together through "
                     "the ensemble serving stack (EnsembleService)")
    run.add_argument("--ensemble-impl", default="xla",
                     choices=("xla", "pipeline", "active", "active_fused"),
                     help="ensemble engine: 'xla' (the batched plain-op "
                     "step, per-lane rates), 'pipeline' (the pipelined-"
                     "window kernel K5, one launch for all lanes), 'active'/"
                     "'active_fused' (the active-tile engine per lane)")
    run.add_argument("--device", default="cuda",
                     help="torch device (default: the card)")
    run.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
