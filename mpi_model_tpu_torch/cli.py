"""Command line of the PyTorch/CUDA port.

    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \\
        --dimy=16384 --impl=pallas --substeps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \\
        --dimy=16384 --impl=active_fused --substeps=8 --blob=0.05 --json
    python -m mpi_model_tpu_torch.cli run --flow=coupled --channels=2 \\
        --dimx=8192 --dimy=8192 --impl=pallas --substeps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=4096 \\
        --dimy=4096 --ensemble=8 --ensemble-impl=pipeline --substeps=8 \\
        --steps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \
        --dimy=16384 --mesh=2x2 --impl=pallas --halo-depth=8 --json
    python -m mpi_model_tpu_torch.cli run --rectangular=2x3 --dimx=20 \
        --dimy=60 --owner-of=18,19 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \
        --dimy=16384 --mesh=2x2 --impl=active_fused --blob=0.05 --json
    python -m mpi_model_tpu_torch.cli run --flow=exponencial --source=19,3 \
        --value=2.2 --rate=0.1 --steps=-1 --dtype=float64 --output=DIR
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=4096 \
        --dimy=4096 --serve --serve-scenarios=16 --ensemble-impl=pipeline \
        --substeps=8 --steps=8 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \
        --dimy=16384 --steps=64 --checkpoint-dir=DIR --checkpoint-every=16 \
        --chaos=exc:1 --json
    python -m mpi_model_tpu_torch.cli run --model=gray_scott --dimx=8192 \
        --dimy=8192 --steps=16 --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=16384 \
        --dimy=16384 --impl=pallas --substeps=8 --steps=64 \
        --trace=trace.json --compile-cache=DIR --json
    python -m mpi_model_tpu_torch.cli run --flow=diffusion --dimx=4096 \
        --dimy=4096 --serve --ensemble-impl=pipeline --substeps=8 \
        --steps=8 --status=snap.json --status-interval-s=1 --json
    python -m mpi_model_tpu_torch.cli info --json

Runs on the card unless ``--device=cpu`` is given. The scenario flags are
the JAX package's: ``--source=X,Y``, ``--value`` (the point source's frozen
value) and ``--rate`` for ``--flow=exponencial`` (``--rate`` also sets every
diffusion rate), ``--time`` and ``--time-step`` for the model's horizon
(``--steps=-1`` runs ``time/time_step`` steps), and ``--output=DIR``, which
writes the per-rank dumps ``comm_rank{r}.txt`` and the merged ``output
<timestamp>.txt`` (row stripes over the run's ranks; ``--rectangular``: the
block map). Prints one row: the impl
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
``--ensemble-impl`` picks its engine (``pipeline`` is the kernel K5).
``--mesh=LxC`` (or ``N``: N row stripes) runs the sharded executor
(``ShardMapExecutor``) over an L×C mesh, ``--rectangular=LxC`` runs
``ModelRectangular`` over one, and ``--halo-depth=d`` exchanges a depth-d
ghost ring once per d steps (the halo kernels fuse d steps per launch). On
the card every mesh position is a card, round-robin over the visible cards
(all on one card when there is one); with ``--device=cpu`` all on the CPU.
The sharded row carries ``comm_size``, ``mesh`` (lines, columns and the
number of distinct devices), ``impl``, ``backend_report`` and
``kernel_launches``; ``--owner-of=X,Y`` adds the block owner of a cell.
``--mesh=LxC --impl=active|active_fused`` runs the shard-local active
engines; their ``backend_report`` carries the fallback steps, the mean
active fraction, ``flags_fused`` and the host reads.
``--mesh=LxC --executor=gspmd`` runs ``AutoShardedExecutor``: the global
step's values for any flow (a user flow with an undeclared footprint too),
its row's ``impl`` ``"point"`` for an all-point-flow model, else ``"xla"``;
it refuses ``--rectangular``, ``--impl=pallas|composed``, ``--halo-depth``
and ``--compute-dtype`` with the JAX CLI's words, and composes with the
checkpoint flags, ``--chaos`` and ``--output``.
``--serve`` drives the always-on loop (``AsyncEnsembleService`` through
``run_soak``): ``--serve-scenarios`` copies of the scenario arrive
open-loop at ``--arrival-rate`` per second (unset or 0: as fast as
admission allows) against a ``--max-queue``-bounded admission queue, with
an optional per-ticket ``--deadline-s``; the row carries the served/
failed/expired/shed ledger (exit status 1 if it is not complete),
sustained scenarios/s, p50/p99 queue latency and occupancy.
``--serve-services=N`` above 1, or ``--serve-transport=process|tcp``,
serves the same stream through an N-member ``FleetSupervisor`` (in-process
members, or children over unix sockets or authenticated TCP on
127.0.0.1, each environment overlaid with the repeatable
``--serve-member-env=KEY=VAL``, e.g. a ``CUDA_VISIBLE_DEVICES`` pin); the
row adds ``member_faults``, ``readmitted``, the per-member ``members``
attribution and, for process members, the wire's ledger.
``--residency-budget=BYTES`` with ``--hibernate-dir=DIR`` (both or
neither) turns on scenario tiering: scenarios beyond the budget hibernate
to the vault and wake as capacity frees, and the row adds the paging
ledger (hibernations, wakes, wake-latency p50/p99, the residency cut).
``--ensemble-mesh=B|BxS`` places every ensemble dispatch of ``--ensemble``
or ``--serve`` over a ``(batch, space)`` mesh (``ensemble.mesh``; impl
``xla`` only): on the card the visible cards round-robin over the
positions, with ``--device=cpu`` the CPU at every position, and a process
or TCP member builds it over its own devices. The ensemble row's ``mesh``
names its extents.
``--status=PATH``
writes the telemetry snapshot (``obs``) of a ``--serve`` soak to PATH every
``--status-interval-s`` seconds and at its end, and installs a flight
recorder dumping under ``PATH.flight.d/``; ``--status-port=PORT`` serves
``GET /metrics`` and ``GET /`` on ``127.0.0.1:PORT`` for the soak (0: an
ephemeral port).
``--trace=FILE`` writes the process tracer's spans (``utils.tracing``) as a
Chrome trace after the run, on every path; the row names it.
``--compile-cache=DIR`` points the kernel build directory at DIR (a
library built there by an earlier process is loaded, not built again),
``--compile-cache=off`` at a private directory removed at exit; unset, the
package's ``_build/``. ``info`` prints the version, torch and CUDA, the
devices, the card's kind and ``chip_peaks()`` (read from the card) and the
native engine's library.
``--checkpoint-dir=DIR`` runs the scenario under the supervisor
(``supervised_run``), checkpointing every ``--checkpoint-every`` steps in
``--checkpoint-layout=full|sharded|delta`` (``--keyframe-every`` for the
chain; ``--async-checkpoints`` writes the sharded layout's files on a
thread of their own, overlapping the next chunk) and resuming from the
newest checkpoint that verifies; ``--chaos=KIND[:N]``
(``exc|nan|halo|torn|torn-keyframe|torn-delta|torn-chain``, seeded by
``--chaos-seed``) arms a fault plan against it, with or without a
checkpoint directory, and ``--max-failures`` bounds the consecutive
recoveries. The row adds ``recovered_failures``, ``injected_faults`` and
the event ledger.
``--compute-dtype=bfloat16`` is the kernels' bf16 interior math (the TPU
kernels' ``compute_dtype``: K1/K2 above one step, K3, K4 and K5 on the
tiles off the edge; refused with ``--impl=xla`` and ``--executor=gspmd``,
as the JAX CLI refuses it).
``--model={diffusion,gray_scott,sir,predator_prey}`` runs a registered
Flow IR model (``ir.library``: its seeded space, its term rates; ``--time``
and ``--time-step`` set its horizon) in place of ``--flow``, through
``--impl``, ``--substeps``, ``--ensemble``, ``--serve``, ``--mesh`` and
``--checkpoint-*``; the ``conserved`` verdict is judged on the model's
conservation view (declared sources and sinks reconciled against their
budget channels). As in the JAX package's CLI, it refuses ``--flow``,
``--rectangular``, ``--rate``/``--source``/``--value``, and for the
nonlinear models ``--impl=pallas|active_fused`` and
``--ensemble-impl=pipeline|active|active_fused``; ``--impl=composed`` with
``--substeps`` above 1 runs k = 1 (a note says so). ``--blob`` fills the
flow scenarios' channel and is refused with ``--model``.
Exit status 1 when conservation fails (``--serve``: when the ledger is
not complete; a supervised run: also when it fails).
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import (Attribute, Cell, CellularSpace, Coupled, Diffusion, Exponencial,
               Model, ModelRectangular, SerialExecutor)


def build_flows(args):
    """The run's flows and the space's initial values (``--init`` per
    channel), as the JAX package's CLI builds them."""
    if args.flow == "exponencial":
        # the reference's live scenario by default: 0.1 * 2.2 out of
        # (19, 3) per step
        try:
            sx, sy = (int(v) for v in args.source.split(","))
        except ValueError:
            raise SystemExit(f"--source={args.source!r} is not X,Y")
        return (Exponencial(Cell(sx, sy, Attribute(99, args.value)),
                            args.rate), args.init)
    if args.flow == "diffusion":
        return Diffusion(args.rate), args.init
    # N diffusing channels chained by coupled flows: channel i sheds mass
    # modulated by channel i+1
    names = [f"c{i}" for i in range(args.channels)]
    flows = [Diffusion(args.rate, attr=nm) for nm in names]
    flows += [Coupled(flow_rate=args.rate / 2, attr=names[i],
                      modulator=names[i + 1])
              for i in range(len(names) - 1)]
    return flows, {nm: args.init for nm in names}


def check_model_flags(args, sharded: bool) -> None:
    """The JAX package's checks of ``--model`` against the other flags;
    then the flow scenario's default (``--flow=exponencial``)."""
    if args.model is not None:
        if args.flow is not None:
            raise SystemExit(
                "--model runs a registered Flow IR model; --flow builds "
                "a hand-wired scenario — pick one")
        if args.rectangular is not None:
            raise SystemExit(
                "--model runs the standard Model orchestration; "
                "--rectangular drives the flow-based ModelRectangular "
                "demo — use --mesh=LxC for sharded IR runs")
        if (args.rate != 0.1 or args.source != "19,3"
                or args.value != 2.2):
            raise SystemExit(
                "--rate/--source/--value configure hand-built flows; a "
                "registry model's coefficients are its term rates "
                "(registry defaults) — drop them or use --flow")
        if args.blob is not None:
            raise SystemExit(
                "--blob fills the flow scenarios' channel; a registry "
                "model starts from its own seeded space")
        nonlinear = args.model != "diffusion"
        if nonlinear and args.impl in ("pallas", "active_fused"):
            raise SystemExit(
                f"--impl={args.impl} is a linear-stencil kernel; "
                f"--model={args.model} has nonlinear/coupled terms. "
                "Eligible: --impl=xla/auto (dense lowering), composed "
                "(k forced to 1, warns), active (term-derived activity "
                "predicate)")
        if nonlinear and args.ensemble_impl in ("pipeline", "active",
                                                "active_fused"):
            raise SystemExit(
                f"--ensemble-impl={args.ensemble_impl} batches "
                "all-Diffusion lanes; nonlinear IR models run the "
                "batched general lowering — use --ensemble-impl=xla")
        if nonlinear and sharded and args.impl not in ("xla", "auto"):
            raise SystemExit(
                f"--impl={args.impl} is a linear-stencil engine on a "
                f"mesh; --model={args.model}'s nonlinear terms run the "
                "sharded general lowering — use --impl=xla/auto")
        if args.impl == "composed" and args.substeps > 1 and nonlinear:
            # allowed (the warning is the contract), but said up front
            print("note: nonlinear terms do not compose; "
                  "--impl=composed will run k=1 iterated passes",
                  file=sys.stderr)
    elif args.flow is None:
        args.flow = "exponencial"


def _cache_spec(args, default):
    """``--compile-cache`` → the ``compile_cache`` knob, by the JAX
    package's rules: unset → ``default``, ``off``/``none`` → None
    (disabled), a directory → that directory; an empty value is an
    error."""
    v = args.compile_cache
    if v is None:
        return default
    if v.strip().lower() in ("off", "none"):
        return None
    if not v.strip():
        raise SystemExit(
            "--compile-cache needs a directory (or 'off' to disable the "
            "build cache explicitly)")
    return v


def export_trace(args) -> None:
    """``--trace=FILE``: the process tracer's spans as a Chrome trace."""
    if args.trace:
        from .utils.tracing import get_tracer

        get_tracer().export_chrome(args.trace)
        print(f"trace written to {args.trace}", file=sys.stderr)


def parse_ensemble_mesh(spec):
    """``--ensemble-mesh B`` or ``BxS`` → the scheduler's mesh spec (a batch
    extent, or a ``(batch, space)`` pair), as the JAX package's CLI parses
    it. The mesh itself resolves against the devices of the process that
    serves: this one, or a member child."""
    if spec is None:
        return None
    s = str(spec).lower().replace("×", "x")
    try:
        if "x" in s:
            b, sp = s.split("x", 1)
            b, sp = int(b), int(sp)
            if b < 1 or sp < 1:
                raise ValueError
            return (b, sp)
        b = int(s)
        if b < 1:
            raise ValueError
        return b
    except ValueError:
        raise SystemExit(
            f"--ensemble-mesh expects a batch extent B or BxS "
            f"(batch x space devices), got {spec!r}")


def check_serve_flags(args, sharded: bool) -> None:
    """The JAX package's checks of the serving flags."""
    if args.serve:
        if args.ensemble is not None:
            raise SystemExit(
                "--serve runs the always-on async loop over an arrival "
                "process; --ensemble runs one synchronous batch — pick "
                "one")
        if sharded:
            raise SystemExit(
                "--serve batches whole scenarios through the ensemble "
                "engine (the batch axis replaces the mesh axes); drop "
                "--mesh/--rectangular")
        if args.chaos is not None:
            raise SystemExit(
                "--chaos drives the single-run supervised path; serve-"
                "mode chaos is driven from the API (resilience.inject "
                "armed around run_soak)")
        if args.checkpoint_dir is not None or args.output is not None:
            raise SystemExit(
                "--serve does not compose with --checkpoint-dir/"
                "--output (supervised/dump runs are single-scenario)")
        if args.impl != "auto":
            raise SystemExit(
                "--impl selects the single-run kernel; serve mode uses "
                "--ensemble-impl=xla|pipeline|active|active_fused")
        if args.serve_scenarios < 1:
            raise SystemExit(
                f"--serve-scenarios={args.serve_scenarios} needs >= 1")
        if args.serve_services < 1:
            raise SystemExit(
                f"--serve-services={args.serve_services} needs >= 1")
        if args.max_queue < 1:
            raise SystemExit(f"--max-queue={args.max_queue} needs >= 1")
        if args.arrival_rate is not None and args.arrival_rate < 0:
            raise SystemExit(
                f"--arrival-rate={args.arrival_rate} must be >= 0 "
                "(0 = open throttle)")
        if args.deadline_s is not None and args.deadline_s <= 0:
            raise SystemExit(
                f"--deadline-s={args.deadline_s} must be positive")
        if (args.residency_budget is None) != (args.hibernate_dir is None):
            raise SystemExit(
                "scenario tiering needs BOTH --residency-budget and "
                "--hibernate-dir (or neither)")
        if args.serve_member_env and args.serve_transport not in (
                "process", "tcp"):
            raise SystemExit(
                "--serve-member-env pins a spawned CHILD's environment "
                "(device visibility); it needs "
                "--serve-transport=process or =tcp")
        if args.residency_budget is not None \
                and args.residency_budget < 1:
            raise SystemExit(
                f"--residency-budget={args.residency_budget} needs >= 1 "
                "byte")
        if args.status_interval_s <= 0:
            raise SystemExit(
                f"--status-interval-s={args.status_interval_s} must be "
                "positive")
        return
    for flag, val, default in (
            ("--arrival-rate", args.arrival_rate, None),
            ("--deadline-s", args.deadline_s, None),
            ("--max-queue", args.max_queue, 64),
            ("--serve-scenarios", args.serve_scenarios, 64),
            ("--serve-services", args.serve_services, 1),
            ("--serve-transport", args.serve_transport, "inproc"),
            ("--serve-member-env", args.serve_member_env or None, None),
            ("--residency-budget", args.residency_budget, None),
            ("--hibernate-dir", args.hibernate_dir, None),
            ("--status", args.status, None),
            ("--status-interval-s", args.status_interval_s, 5.0),
            ("--status-port", args.status_port, None)):
        if val != default:
            raise SystemExit(
                f"{flag} configures the always-on serving loop; add "
                "--serve")


def check_ensemble_flags(args) -> None:
    """The JAX package's checks of the ensemble flags, for the flags the
    port has."""
    if args.ensemble_mesh is not None:
        if args.ensemble is None and not args.serve:
            raise SystemExit(
                "--ensemble-mesh shards the ensemble batch axis over "
                "devices; add --ensemble=B or --serve (for the spatial "
                "mesh of a single run use --mesh=LxC)")
        if args.ensemble_impl != "xla":
            raise SystemExit(
                "--ensemble-mesh requires --ensemble-impl=xla (the "
                "other engines carry per-lane state the batch-axis "
                "sharding contract does not cover)")
        parse_ensemble_mesh(args.ensemble_mesh)
    if args.ensemble is not None:
        if args.ensemble < 1:
            raise SystemExit(f"--ensemble={args.ensemble} needs B >= 1")
        if args.chaos is not None:
            raise SystemExit(
                "--chaos drives the single-run supervised path; it does "
                "not compose with --ensemble (drive ensemble chaos from "
                "the API: resilience.inject + EnsembleScheduler("
                "retry='solo'))")
        if args.checkpoint_dir is not None:
            raise SystemExit(
                "--ensemble does not compose with --checkpoint-dir "
                "(supervised/checkpointed runs are single-scenario)")
        if args.output is not None:
            raise SystemExit(
                "--output writes one scenario's dump; it does not "
                "compose with --ensemble")
        if args.impl != "auto":
            raise SystemExit(
                "--impl selects the single-run kernel; ensemble runs "
                "use --ensemble-impl=xla|pipeline|active|active_fused")
    elif args.ensemble_impl != "xla" and not args.serve:
        raise SystemExit("--ensemble-impl applies to ensemble/serve runs; "
                         "add --ensemble=B or --serve")


def parse_chaos(args):
    """``--chaos=KIND[:N]`` → a seeded ``FaultPlan``, or None, as the JAX
    package's CLI builds it. Kinds: ``exc`` (an executor exception on chunk
    N), ``nan`` (NaN written into the state after chunk N), ``halo`` (the
    ghost rings perturbed during chunk N; sharded runs only), ``torn`` (the
    checkpoint written at step N torn on disk; needs --checkpoint-dir; with
    the delta layout it tears whichever record step N wrote), and the delta
    chain's ``torn-keyframe``/``torn-delta``/``torn-chain`` (that record
    kind, or the chain manifest; need --checkpoint-layout=delta)."""
    if args.chaos is None:
        return None
    from .resilience.inject import Fault, FaultPlan

    spec = args.chaos
    kind, _, at_s = spec.partition(":")
    known = ("exc", "nan", "halo", "torn", "torn-keyframe", "torn-delta",
             "torn-chain")
    if kind not in known:
        raise SystemExit(
            f"--chaos={spec!r}: unknown kind {kind!r} (expected "
            "exc|nan|halo|torn|torn-keyframe|torn-delta|torn-chain, "
            "optionally ':N' for the chunk/step to fire at)")
    try:
        at = int(at_s) if at_s else None
    except ValueError:
        raise SystemExit(f"--chaos={spec!r}: {at_s!r} is not an integer")
    sharded = args.mesh is not None or args.rectangular is not None
    if kind == "halo" and not sharded:
        raise SystemExit(
            "--chaos=halo perturbs the ghost-ring exchange; add "
            "--mesh=LxC (serial runs have no halos)")
    if kind.startswith("torn"):
        if args.checkpoint_dir is None:
            raise SystemExit(
                f"--chaos={kind} tears a written checkpoint; add "
                "--checkpoint-dir=DIR")
        part = kind.partition("-")[2] or None
        if part is not None and args.checkpoint_layout != "delta":
            raise SystemExit(
                f"--chaos={kind} targets a delta-chain "
                f"{'manifest' if part == 'chain' else part + ' record'}, "
                f"which --checkpoint-layout={args.checkpoint_layout} "
                "never writes; use --checkpoint-layout=delta (or plain "
                "--chaos=torn for this layout's files)")
        # the manifest is json: corrupt it (truncation at a byte offset is
        # the data records' tear)
        tear = (Fault("torn", at=at, channel="chain", tear="corrupt",
                      offset=2)
                if part == "chain"
                else Fault("torn", at=at, channel=part, tear="truncate",
                           offset=64))
        return FaultPlan((tear,), seed=args.chaos_seed)
    return FaultPlan((Fault(kind, at=at),), seed=args.chaos_seed)


def check_checkpoint_flags(args) -> None:
    """The JAX package's checks of the checkpoint flags."""
    if args.async_checkpoints and args.checkpoint_layout != "sharded":
        raise SystemExit(
            "--async-checkpoints requires --checkpoint-layout=sharded")
    if args.checkpoint_dir is None and (args.async_checkpoints
                                        or args.checkpoint_layout != "full"):
        raise SystemExit(
            "--checkpoint-layout/--async-checkpoints configure "
            "checkpointing; add --checkpoint-dir=DIR")
    if args.keyframe_every is not None:
        if args.checkpoint_layout != "delta":
            raise SystemExit(
                "--keyframe-every sets the delta chain's keyframe "
                "cadence; it does nothing for "
                f"--checkpoint-layout={args.checkpoint_layout} (use "
                "--checkpoint-layout=delta)")
        if args.keyframe_every < 1:
            raise SystemExit(
                f"--keyframe-every={args.keyframe_every} must be >= 1 "
                "(1 = every save is a keyframe)")
    if args.checkpoint_every < 1:
        raise SystemExit(
            f"--checkpoint-every={args.checkpoint_every} must be >= 1")


def parse_grid2(text: str, flag: str) -> tuple[int, int]:
    """'N' or 'LxC' → (lines, columns), positive."""
    try:
        parts = [int(v) for v in text.lower().split("x")]
        if len(parts) == 1:  # "N" = 1-D row stripes (Model.hpp:62-76)
            parts.append(1)
        lines, columns = parts
        if lines < 1 or columns < 1:
            raise ValueError
    except ValueError:
        raise SystemExit(
            f"{flag}={text!r} is not N or LxC with positive extents "
            f"(e.g. {flag}=4, {flag}=2x4)")
    return lines, columns


def check_sharded_flags(args) -> bool:
    """The JAX package's checks of the sharded flags; True for a sharded
    run."""
    sharded = args.mesh is not None or args.rectangular is not None
    if not sharded and args.halo_depth != 1:
        raise SystemExit(
            "--halo-depth applies to sharded execution; add --mesh=LxC "
            "or --rectangular=LxC")
    if sharded and args.substeps != 1:
        raise SystemExit(
            "--substeps applies to the serial executor; for sharded runs "
            "use --halo-depth for the analogous fusion")
    if args.rectangular is not None and args.mesh is not None:
        raise SystemExit(
            "--rectangular IS the mesh (a lines x columns block "
            "decomposition); drop --mesh")
    if args.executor == "gspmd":
        if args.rectangular is not None:
            raise SystemExit(
                "--rectangular always runs the explicit block-halo "
                "ShardMapExecutor (its owner map IS that mesh); for the "
                "GSPMD path use --mesh=LxC --executor=gspmd")
        if args.mesh is None:
            raise SystemExit("--executor=gspmd is a sharded path; add "
                             "--mesh=LxC")
        if args.impl in ("pallas", "composed"):
            raise SystemExit(
                "--executor=gspmd runs the global XLA step (XLA inserts "
                "the collectives); the Pallas/composed kernels need "
                "--executor=shardmap")
        if args.halo_depth != 1 or args.compute_dtype is not None:
            raise SystemExit(
                "--halo-depth/--compute-dtype tune the explicit "
                "ShardMapExecutor; --executor=gspmd delegates both to XLA")
    if args.executor == "shardmap" and not sharded:
        raise SystemExit("--executor=shardmap needs --mesh=LxC")
    if args.executor == "serial" and sharded:
        raise SystemExit("--executor=serial contradicts "
                         "--mesh/--rectangular")
    if sharded and args.ensemble is not None:
        raise SystemExit(
            "--ensemble batches whole scenarios through the ensemble "
            "engine (the batch axis replaces the mesh axes); drop "
            "--mesh/--rectangular")
    if args.owner_of is not None and args.rectangular is None:
        raise SystemExit(
            "--owner-of reports the 2-D block owner map; add "
            "--rectangular=LxC")
    return sharded


def mesh_devices(args, n: int):
    """The mesh's devices: on the card, None (the visible cards placed
    round-robin over the positions); otherwise ``--device`` at every
    position."""
    dev = torch.device(args.device)
    return None if dev.type == "cuda" else [dev] * n


def build_sharded_executor(args, model):
    from .parallel import (AutoShardedExecutor, ShardMapExecutor, make_mesh,
                           make_mesh_2d)

    if args.rectangular is not None:
        lines, columns = parse_grid2(args.rectangular, "--rectangular")
        return model.default_executor(
            devices=mesh_devices(args, lines * columns))
    lines, columns = parse_grid2(args.mesh, "--mesh")
    n = lines * columns
    if lines == 1 or columns == 1:
        mesh = make_mesh(n, devices=mesh_devices(args, n))
    else:
        mesh = make_mesh_2d(lines, columns, devices=mesh_devices(args, n))
    if args.executor == "gspmd":
        # the GSPMD path's contract: the global step's values for any flow
        # (an undeclared footprint too), on the routes the executor picks
        return AutoShardedExecutor(mesh)
    return ShardMapExecutor(mesh, step_impl=args.impl,
                            halo_depth=args.halo_depth,
                            compute_dtype=args.compute_dtype)


def run_ensemble_cli(args, space, model) -> int:
    """``--ensemble B``: B copies of the configured scenario through the
    serving stack, conservation judged here (status and exit code), not
    raised mid-flight."""
    from .ensemble import (EnsembleService, buckets_for,
                           resolve_ensemble_mesh)
    from .models.model import kernel_launches

    B = args.ensemble
    steps = args.steps if args.steps is not None else model.num_steps
    svc = EnsembleService(
        model, steps=steps, impl=args.ensemble_impl,
        substeps=args.substeps, buckets=buckets_for(B),
        compute_dtype=args.compute_dtype, check_conservation=False,
        compile_cache=_cache_spec(args, "auto"),
        mesh=resolve_ensemble_mesh(parse_ensemble_mesh(args.ensemble_mesh),
                                   device=space.device))
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
    export_trace(args)
    st = svc.stats()
    thresh = model.conservation_threshold(space)
    # IR models are judged on their budget-reconciled view
    err = max(model.report_conservation_error(rep) for _, rep in outs)
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
        "trace": args.trace,
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


def _parse_member_env(pairs):
    """The repeatable ``--serve-member-env KEY=VAL`` as the environment laid
    over every spawned member (per-slot pins are the API's:
    ``FleetSupervisor(member_env=[{...}, {...}])``)."""
    if not pairs:
        return None
    env = {}
    for p in pairs:
        if "=" not in p:
            raise SystemExit(
                f"--serve-member-env expects KEY=VAL, got {p!r}")
        k, v = p.split("=", 1)
        if not k:
            raise SystemExit(
                f"--serve-member-env expects a non-empty KEY, got {p!r}")
        env[k] = v
    return env


def run_serve_cli(args, space, model) -> int:
    """``--serve``: the always-on loop, or with ``--serve-services`` above 1
    or ``--serve-transport=process|tcp`` a ``FleetSupervisor`` over it,
    under an open-loop arrival process (``run_soak``), with the JAX
    package's report keys (a fleet's row adds the per-member attribution,
    a tiered one the paging ledger); exit status 1 when the ledger is not
    complete."""
    from .ensemble import (AsyncEnsembleService, FleetSupervisor,
                           buckets_for, resolve_ensemble_mesh, run_soak)
    from .models.model import kernel_launches

    steps = args.steps if args.steps is not None else model.num_steps
    n = args.serve_scenarios
    before = kernel_launches()
    if args.status:
        # flight dumps land beside the snapshot, so a post-mortem finds
        # them even if this process died with its in-memory dumps
        from .obs.flight import FlightRecorder, set_recorder

        set_recorder(FlightRecorder(dump_dir=args.status + ".flight.d"))
    svc_kw = dict(
        steps=steps, impl=args.ensemble_impl, substeps=args.substeps,
        buckets=buckets_for(8), max_queue=args.max_queue,
        compute_dtype=args.compute_dtype, deadline_s=args.deadline_s,
        retry="solo", compile_cache=_cache_spec(args, "auto"),
        # scenario tiering: overload hibernates instead of shedding
        residency_budget=args.residency_budget,
        hibernate_dir=args.hibernate_dir)
    # process members always run under the supervisor: something must
    # heartbeat, fence and respawn the children
    fleet_mode = (args.serve_services > 1
                  or args.serve_transport != "inproc")
    # the mesh as a spec: a fleet resolves it for its in-process members
    # and a member child over its own devices
    mesh = parse_ensemble_mesh(args.ensemble_mesh)
    svc_kw["mesh"] = (mesh if fleet_mode
                      else resolve_ensemble_mesh(mesh, device=space.device))
    try:
        if fleet_mode:
            svc = FleetSupervisor(
                model, services=args.serve_services,
                member_transport=args.serve_transport,
                member_env=_parse_member_env(args.serve_member_env),
                device=space.device, **svc_kw)
        else:
            svc = AsyncEnsembleService(model, **svc_kw)
    except (TypeError, ValueError) as e:
        raise SystemExit(f"serve run failed: {e}")
    rate = args.arrival_rate if args.arrival_rate else 1e9
    with svc:
        rep = run_soak(svc, [(space, None, None)] * n, arrival_rate_hz=rate,
                       snapshot_path=args.status,
                       snapshot_interval_s=args.status_interval_s,
                       status_port=args.status_port)
    launched = sum(v - before[k] for k, v in kernel_launches().items())
    export_trace(args)
    result = {
        "backend": "serve",
        "device": str(space.device),
        "impl": args.ensemble_impl,
        "steps": steps,
        "max_queue": args.max_queue,
        "deadline_s": args.deadline_s,
        "services": args.serve_services,
        "transport": args.serve_transport,
        "telemetry_snapshot": args.status,
        "trace": args.trace,
        "kernel_launches": launched,
        **{k: rep[k] for k in (
            "offered", "served", "failed", "expired", "shed",
            "ledger_complete", "wall_s", "sustained_scenarios_per_s",
            "occupancy", "latency_p50_s", "latency_p99_s",
            "batch_occupancy", "dispatches", "solo_retries",
            "recovered_failures", "quarantined", "loop_faults")},
    }
    # the stopped service's cut: a fleet's final tick heartbeat every
    # process member, so the per-member counts are the members' last
    st = svc.stats()
    if args.residency_budget is not None:
        # the paging ledger and the residency cut
        for k in ("hibernations", "rehibernations", "wakes",
                  "wake_faults", "wake_latency_p50_s",
                  "wake_latency_p99_s", "resident_scenarios",
                  "resident_bytes", "residency_budget",
                  "hibernated_scenarios", "hibernated_bytes"):
            result[k] = st.get(k)
        if fleet_mode:
            result["wakes_by_member"] = st.get("wakes_by_member")
    if fleet_mode:
        result["member_faults"] = rep["member_faults"]
        result["readmitted"] = rep["readmitted"]
        # per-member attribution: which member served what
        result["members"] = [
            {k: s[k] for k in ("service_id", "scenarios", "dispatches",
                               "pending", "gen")}
            for s in st["services"]]
        if args.serve_transport in ("process", "tcp"):
            for k in ("respawns", "heartbeats", "heartbeat_misses",
                      "wire_errors", "wire_bytes_in", "wire_bytes_out"):
                result[k] = st[k]
    if args.json:
        print(json.dumps(result, allow_nan=False))
    else:
        sps = rep["sustained_scenarios_per_s"]
        p99 = rep["latency_p99_s"]
        p99_s = "n/a" if p99 is None else f"{p99:.4f}s"
        occ = rep["occupancy"]
        fleet_note = (f" services={args.serve_services}"
                      if args.serve_services > 1 else "")
        print(f"backend=serve impl={args.ensemble_impl}{fleet_note} "
              f"served={rep['served']}/{rep['offered']} "
              f"shed={rep['shed']} expired={rep['expired']} "
              f"failed={rep['failed']} "
              f"({0.0 if sps is None else sps:.1f} scenarios/s sustained, "
              f"p99={p99_s}, occupancy="
              f"{0.0 if occ is None else occ:.2f}, {launched} kernel "
              f"launches on {result['device']})")
    return 0 if rep["ledger_complete"] else 1


def build_scenario(args):
    """The run's space and model: a registered IR model with its seeded
    space (``--model``), or the flow scenario's (``--flow``)."""
    if args.model is not None:
        from .ir import build_model

        model, space = build_model(
            args.model, args.dimx, args.dimy, dtype=args.dtype,
            device=args.device, time=args.time, time_step=args.time_step)
        return space, model
    flow, init = build_flows(args)
    space = CellularSpace.create(args.dimx, args.dimy, init,
                                 dtype=args.dtype, device=args.device)
    if args.blob is not None:
        v = blob_grid(args.dimx, args.dimy, args.blob)
        space = space.with_values({"value": torch.from_numpy(v).to(
            device=space.device, dtype=space.dtype)})
    if args.rectangular is not None:
        lines, columns = parse_grid2(args.rectangular, "--rectangular")
        model = ModelRectangular(flow, args.time, args.time_step,
                                 lines=lines, columns=columns,
                                 step_impl=args.impl,
                                 halo_depth=args.halo_depth,
                                 compute_dtype=args.compute_dtype)
    else:
        model = Model(flow, args.time, args.time_step)
    return space, model


def cmd_run(args) -> int:
    from .utils.compile_cache import (configure_compile_cache,
                                      resolve_compile_cache)

    # the build directory is set before anything builds; unset, it stays
    # the package's _build/
    spec = _cache_spec(args, "auto")
    try:
        configure_compile_cache(resolve_compile_cache(spec))
    except (OSError, ValueError) as e:
        raise SystemExit(f"--compile-cache={args.compile_cache}: {e}")
    check_ensemble_flags(args)
    sharded = check_sharded_flags(args)
    check_serve_flags(args, sharded)
    check_checkpoint_flags(args)
    check_model_flags(args, sharded)
    chaos_plan = parse_chaos(args)
    if args.flow == "coupled" and args.channels < 2:
        raise SystemExit("--flow=coupled needs --channels >= 2 (one channel "
                         "has nothing to modulate — use --flow=diffusion)")
    if args.channels != 2 and args.flow != "coupled":
        raise SystemExit("--channels applies to --flow=coupled")
    if args.blob is not None and args.flow == "coupled":
        raise SystemExit("--blob fills the single channel of "
                         "--flow=diffusion|exponencial")
    if args.compute_dtype is not None and args.impl == "xla":
        raise SystemExit(
            "--compute-dtype tunes the Pallas kernels' interior math; "
            "--impl=xla never runs them (use --impl=pallas or auto)")
    space, model = build_scenario(args)
    if args.serve:
        return run_serve_cli(args, space, model)
    if args.ensemble is not None:
        return run_ensemble_cli(args, space, model)
    if sharded:
        executor = build_sharded_executor(args, model)
    else:
        executor = SerialExecutor(step_impl=args.impl,
                                  substeps=args.substeps,
                                  compute_dtype=args.compute_dtype)
    from .models.model import _launches_since, kernel_launches

    if args.checkpoint_dir is not None or chaos_plan is not None:
        return run_supervised_cli(args, space, model, executor, sharded,
                                  chaos_plan)
    before = kernel_launches()
    t0 = time.perf_counter()
    out, report = model.execute(space, executor, steps=args.steps,
                                check_conservation=False)
    wall = time.perf_counter() - t0
    launched = sum(_launches_since(before).values())
    export_trace(args)
    err = model.report_conservation_error(report)
    thresh = model.conservation_threshold(
        space, initial_totals=report.initial_total)
    write_dumps(args, model, out, report.comm_size)
    row = {
        "backend": "sharded" if sharded else "serial",
        "device": str(space.device),
        "impl": report.impl,
        "comm_size": report.comm_size,
        "substeps": args.substeps if not sharded else None,
        "halo_depth": args.halo_depth if sharded else None,
        "kernel_launches": launched,
        "backend_report": report.backend_report,
        "steps": report.steps,
        "initial": report.initial_total,
        "final": report.final_total,
        "conservation_error": err,
        "conserved": bool(err <= thresh),
        "wall_s": wall,
        "trace": args.trace,
    }
    if sharded:
        lines, columns = executor.mesh.grid_shape
        row["mesh"] = {"lines": lines, "columns": columns,
                       "devices": len(executor.mesh.distinct_devices())}
        row["rectangular"] = args.rectangular
    add_owner_of(args, model, out, row)
    if args.json:
        print(json.dumps(row, allow_nan=False))
    else:
        status = "CONSERVED" if row["conserved"] else "VIOLATED"
        print(f"backend={row['backend']} ranks={row['comm_size']} "
              f"impl={row['impl']} launches={row['kernel_launches']} "
              f"steps={row['steps']} initial={row['initial']} "
              f"final={row['final']} |delta|={err:.3e} {status} "
              f"({wall:.3f}s on {row['device']})")
    return 0 if row["conserved"] else 1


def write_dumps(args, model, out, comm_size: int) -> None:
    """``--output=DIR``: the per-rank dumps and the merged file (per block
    of the executed mesh under ``--rectangular``)."""
    if not args.output:
        return
    if args.rectangular is not None:
        merged = model.write_output(args.output, out)
    else:
        from .io import write_output

        merged = write_output(args.output, out, comm_size=max(comm_size, 1))
    print(f"output written to {merged}", file=sys.stderr)


def add_owner_of(args, model, out, row: dict) -> None:
    """``--owner-of=X,Y``: the block owner of a cell and the partitions."""
    if args.owner_of is None:
        return
    try:
        x, y = (int(v) for v in args.owner_of.split(","))
    except ValueError:
        raise SystemExit(f"--owner-of={args.owner_of!r} is not X,Y")
    row["owner_of"] = {
        "cell": [x, y], "owner": model.owner_of(x, y, out),
        "partitions": [p.describe() for p in model.partitions(out)]}


def run_supervised_cli(args, space, model, executor, sharded: bool,
                       chaos_plan) -> int:
    """``--checkpoint-dir`` or ``--chaos``: the run under
    ``supervised_run`` (a manager adds durability and resume; without one
    the rollback is in memory), the fault plan armed around it. The row
    carries the JAX package's keys (``recovered_failures``,
    ``injected_faults``; ``error`` when the run failed) and the event
    ledger; conservation is judged against the run-global totals."""
    import contextlib

    from .io import CheckpointManager
    from .models.model import _launches_since, kernel_launches
    from .resilience import SimulationFailure, inject, supervised_run

    steps = args.steps if args.steps is not None else model.num_steps
    initial = {k: float(space.total(k)) for k in space.values}
    manager = (CheckpointManager(args.checkpoint_dir,
                                 layout=args.checkpoint_layout,
                                 async_writes=args.async_checkpoints,
                                 keyframe_every=args.keyframe_every or 8,
                                 device=space.device)
               if args.checkpoint_dir else None)
    arm = (inject.armed(chaos_plan) if chaos_plan is not None
           else contextlib.nullcontext())
    events: list = []
    failure = out = None
    armed = None
    before = kernel_launches()
    t0 = time.perf_counter()
    try:
        with arm as armed:
            res = supervised_run(model, space, manager, steps=steps,
                                 every=args.checkpoint_every,
                                 max_failures=args.max_failures,
                                 executor=executor, on_event=events.append)
    except SimulationFailure as e:
        failure = str(e)
        events = e.events
    else:
        out = res.space
        # the run-global baseline survives a resume inside the checkpoint
        initial = res.initial_totals or initial
    wall = time.perf_counter() - t0
    launched = sum(_launches_since(before).values())
    export_trace(args)
    # the fired faults are reported even when the run failed
    injected = len(armed.fired) if armed is not None else 0
    row = {
        "backend": "sharded" if sharded else "serial",
        "device": str(space.device),
        "impl": getattr(executor, "last_impl", None),
        "comm_size": getattr(executor, "comm_size", 1),
        "substeps": args.substeps if not sharded else None,
        "halo_depth": args.halo_depth if sharded else None,
        "steps": steps,
        "kernel_launches": launched,
        "checkpoint_dir": args.checkpoint_dir,
        "checkpoint_layout": (args.checkpoint_layout
                              if args.checkpoint_dir else None),
        "checkpoint_steps": manager.steps() if manager else None,
        "recovered_failures": len(events),
        "injected_faults": injected,
        "events": [{"kind": e.kind, "step": e.step,
                    "rolled_back_to": e.rolled_back_to,
                    "attempt": e.attempt,
                    "classification": e.classification} for e in events],
        "wall_s": wall,
        "trace": args.trace,
    }
    if failure is not None:
        row.update(conserved=False, error=failure)
        print(json.dumps(row) if args.json
              else f"FAILED after {len(events)} failure(s): {failure}")
        return 1
    final = {k: float(out.total(k)) for k in out.values}
    err = model.conservation_error(initial, final)
    thresh = model.conservation_threshold(space, initial_totals=initial)
    row.update(initial=initial, final=final, conservation_error=err,
               conserved=bool(err <= thresh))
    write_dumps(args, model, out, row["comm_size"])
    add_owner_of(args, model, out, row)
    if args.json:
        print(json.dumps(row, allow_nan=False))
    else:
        status = "CONSERVED" if row["conserved"] else "VIOLATED"
        print(f"backend={row['backend']} impl={row['impl']} "
              f"ranks={row['comm_size']} steps={steps} "
              f"initial={initial} final={final} |delta|={err:.3e} {status} "
              f"({wall:.2f}s, {len(events)} recovered failures, "
              f"{launched} kernel launches on {row['device']})")
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


def cmd_info(args) -> int:
    """``info``: the version, torch and CUDA, the devices, the card's kind,
    ``chip_peaks()`` read from it (None without a card) and the native
    engine's library (built if needed)."""
    from . import __version__
    from .utils import chip_peaks

    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 0
    info = {
        "version": __version__,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "devices": [f"cuda:{i}" for i in range(n)] or ["cpu"],
        "device_kind": torch.cuda.get_device_name(0) if cuda else None,
        "chip_peaks": chip_peaks(),
        "cpu_threads": torch.get_num_threads(),
    }
    try:
        from .native import build_native

        info["native_library"] = build_native()
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        # no compiler, or a failed build: no native library here
        info["native_library"] = f"unavailable: {e}"
    print(json.dumps(info, indent=None if args.json else 2))
    return 0


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mpi_model_tpu_torch.cli",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run a simulation (reference scenario "
                         "by default)")
    run.add_argument("--flow", default=None,
                     choices=("exponencial", "diffusion", "coupled"),
                     help="hand-built flow scenario (default: the "
                     "reference's exponencial run); mutually exclusive "
                     "with --model")
    run.add_argument("--model", default=None,
                     choices=("diffusion", "gray_scott", "sir",
                              "predator_prey"),
                     help="run a registered Flow IR model: declarative "
                     "terms lowered once for every engine ('gray_scott' "
                     "reaction-diffusion, 'sir' contagion, "
                     "'predator_prey' Lotka-Volterra, or the linear "
                     "'diffusion', bit for bit --flow=diffusion's "
                     "physics)")
    run.add_argument("--channels", type=int, default=2,
                     help="channel count for --flow=coupled (a chain of N "
                     "diffusing channels, each but the last shedding "
                     "modulated by the next)")
    run.add_argument("--dimx", type=int, default=100)
    run.add_argument("--dimy", type=int, default=100)
    run.add_argument("--init", type=float, default=1.0)
    run.add_argument("--source", default="19,3",
                     help="point-flow source cell x,y")
    run.add_argument("--rate", type=float, default=0.1)
    run.add_argument("--value", type=float, default=2.2,
                     help="frozen snapshot value of the point source")
    run.add_argument("--time", type=float, default=10.0)
    run.add_argument("--time-step", type=float, default=0.2)
    run.add_argument("--steps", type=int, default=1,
                     help="step count (default 1 = the reference's live "
                     "behavior; pass --steps=-1 for time/time_step)")
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
    run.add_argument("--compute-dtype", default=None,
                     choices=("float32", "bfloat16"),
                     help="the kernels' interior-tile math (bfloat16: the "
                          "TPU kernels' bf16 interior; default float32)")
    run.add_argument("--ensemble", type=int, default=None, metavar="B",
                     help="run B copies of the scenario together through "
                     "the ensemble serving stack (EnsembleService)")
    run.add_argument("--ensemble-impl", default="xla",
                     choices=("xla", "pipeline", "active", "active_fused"),
                     help="ensemble engine: 'xla' (the batched plain-op "
                     "step, per-lane rates), 'pipeline' (the pipelined-"
                     "window kernel K5, one launch for all lanes), 'active'/"
                     "'active_fused' (the active-tile engine per lane)")
    run.add_argument("--serve", action="store_true",
                     help="drive the always-on async serving loop: "
                     "--serve-scenarios copies of the scenario arrive "
                     "open-loop at --arrival-rate/s against a bounded "
                     "admission queue; reports sustained scenarios/s, "
                     "p50/p99 queue latency, occupancy and the "
                     "served/shed/expired/failed ledger")
    run.add_argument("--serve-scenarios", type=int, default=64,
                     metavar="N",
                     help="scenarios offered to the serving loop "
                     "(default 64)")
    run.add_argument("--serve-services", type=int, default=1, metavar="N",
                     help="with --serve: shard the arrival stream over an "
                     "N-member FleetSupervisor (structure-affine routing, "
                     "member fencing and respawn, per-member attribution "
                     "in the row)")
    run.add_argument("--serve-transport", default="inproc",
                     choices=("inproc", "process", "tcp"),
                     help="fleet member transport: 'inproc' (in-process "
                     "services), 'process' (a child each over a unix "
                     "socket, heartbeat-fenced) or 'tcp' (a child each over "
                     "an authenticated TCP socket on 127.0.0.1: a fresh "
                     "secret in its environment, the HMAC handshake before "
                     "the first frame)")
    run.add_argument("--serve-member-env", action="append", default=None,
                     metavar="KEY=VAL",
                     help="with --serve-transport=process or tcp: an "
                     "environment variable laid over every member child "
                     "(repeatable; e.g. CUDA_VISIBLE_DEVICES=0 pins the "
                     "card)")
    run.add_argument("--ensemble-mesh", default=None, metavar="B[xS]",
                     help="place every ensemble dispatch over a (batch x "
                     "space) device mesh: B lanes groups, S row blocks "
                     "(impl xla; with --ensemble or --serve)")
    run.add_argument("--arrival-rate", type=float, default=None,
                     metavar="HZ",
                     help="open-loop arrival rate in scenarios/s (unset/0 = "
                     "open throttle: submit as fast as admission allows)")
    run.add_argument("--deadline-s", type=float, default=None,
                     help="per-ticket deadline: a scenario still queued "
                     "past this expires with a complete FailureEvent")
    run.add_argument("--max-queue", type=int, default=64,
                     help="admission-queue bound: submissions beyond this "
                     "shed with ServiceOverloaded (default 64)")
    run.add_argument("--residency-budget", type=int, default=None,
                     metavar="BYTES",
                     help="scenario-tiering residency budget: scenario "
                     "state bytes allowed resident; beyond it scenarios "
                     "hibernate to --hibernate-dir (keyframe and delta "
                     "chains, a TJ1 lifecycle journal) and wake as capacity "
                     "frees, so only an exhausted vault sheds")
    run.add_argument("--hibernate-dir", default=None, metavar="DIR",
                     help="vault directory of the hibernation tier "
                     "(required with --residency-budget)")
    run.add_argument("--status", default=None, metavar="PATH",
                     help="with --serve: write the telemetry snapshot "
                     "(obs.fleet_snapshot: serving stats, tracer rollups, "
                     "flight-recorder ledger; one versioned JSON document) "
                     "to PATH every --status-interval-s and at the soak's "
                     "end; validate or scrape it with python -m "
                     "mpi_model_tpu_torch.obs. Also dumps the flight "
                     "recorder under PATH.flight.d/")
    run.add_argument("--status-interval-s", type=float, default=5.0,
                     metavar="S",
                     help="seconds between --status snapshots (default 5)")
    run.add_argument("--status-port", type=int, default=None,
                     metavar="PORT",
                     help="with --serve: serve GET /metrics (Prometheus "
                     "text) and GET / (the snapshot) on 127.0.0.1:PORT "
                     "for the soak (0 = an ephemeral port)")
    run.add_argument("--trace", default=None, metavar="FILE",
                     help="write a Chrome trace of the run's spans "
                     "(model.execute, executor.run, the dispatch spans, "
                     "supervise.chunk) to FILE")
    run.add_argument("--compile-cache", default=None, metavar="DIR|off",
                     help="build the CUDA kernels (and the native engine) "
                     "into DIR, created if missing, loading what an "
                     "earlier process built there; 'off' builds into a "
                     "private directory removed at exit. Default: the "
                     "package's _build/")
    run.add_argument("--mesh", default=None, metavar="LxC",
                     help="run sharded (ShardMapExecutor, or with "
                     "--executor=gspmd AutoShardedExecutor) over an LxC "
                     "mesh (N or Nx1: N row stripes)")
    run.add_argument("--executor", default="auto",
                     choices=("auto", "serial", "shardmap", "gspmd"),
                     help="'auto' = serial without --mesh, shardmap with "
                     "it; 'gspmd' = AutoShardedExecutor (the global step's "
                     "values on the mesh: runs ANY flow, including "
                     "footprint='unknown' user flows the explicit shardmap "
                     "path refuses)")
    run.add_argument("--rectangular", default=None, metavar="LxC",
                     help="run ModelRectangular over an LxC block mesh (the "
                     "reference's rectangular decomposition)")
    run.add_argument("--owner-of", default=None, metavar="X,Y",
                     help="with --rectangular: report the block owner of "
                     "cell (X, Y)")
    run.add_argument("--halo-depth", type=int, default=1,
                     help="sharded runs: ghost-ring depth d, one exchange "
                     "per d steps")
    run.add_argument("--checkpoint-dir", default=None,
                     help="checkpoint the run into this directory and "
                     "resume from its newest verified checkpoint (the run "
                     "goes through the supervisor)")
    run.add_argument("--checkpoint-every", type=int, default=1,
                     help="steps per supervised chunk and checkpoint")
    run.add_argument("--checkpoint-layout", default="full",
                     choices=("full", "sharded", "delta"),
                     help="'full' = one .npz a checkpoint; 'delta' = "
                     "periodic keyframes + dirty-tile delta records, "
                     "restore replays the chain (io/delta.py); 'sharded' "
                     "= a directory of per-shard pieces and a manifest "
                     "(io/sharded.py)")
    run.add_argument("--keyframe-every", type=int, default=None,
                     help="delta layout: records per chain segment (1 "
                     "keyframe + N-1 deltas; default 8; 1 = every save is "
                     "a keyframe)")
    run.add_argument("--async-checkpoints", action="store_true",
                     help="overlap checkpoint writes with compute (needs "
                     "--checkpoint-layout=sharded)")
    run.add_argument("--max-failures", type=int, default=3,
                     help="consecutive failures the supervisor recovers "
                     "from before the run fails")
    run.add_argument("--chaos", default=None, metavar="KIND[:N]",
                     help="arm a deterministic fault plan against the "
                     "supervised run and prove it heals: exc|nan inject "
                     "an executor exception / NaN state at chunk N, halo "
                     "perturbs one chunk's ghost exchanges (sharded runs), "
                     "torn tears the checkpoint written at step N (with "
                     "--checkpoint-dir), torn-keyframe|torn-delta|"
                     "torn-chain one delta-chain part; the row reports "
                     "injected_faults, recovered_failures and the events")
    run.add_argument("--chaos-seed", type=int, default=0,
                     help="seed for the fault plan's derived perturbation "
                     "values (reproducible chaos)")
    run.add_argument("--device", default="cuda",
                     help="torch device (default: the card)")
    run.add_argument("--output", default=None,
                     help="write the reference-parity per-rank dump + "
                     "merged output file to this directory")
    run.add_argument("--json", action="store_true")
    info = sub.add_parser("info", help="print version, device and peak "
                          "information")
    info.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    if args.cmd == "info":
        return cmd_info(args)
    if args.steps == -1:
        args.steps = None  # -1 = the time/time_step schedule
    elif args.steps < -1:
        raise SystemExit(
            f"--steps={args.steps} is invalid: pass a non-negative step "
            "count or -1 for the time/time_step schedule")
    return cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
