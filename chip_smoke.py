#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check (needs one card)

Phases (any failure exits non-zero, and no result line is printed):

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi --query-gpu=name,power.limit``.
2. build: builds every kernel from the sources in this checkout, one nvcc
   per source started together, and prints the build seconds and ptxas.
3. each kernel against its plain version on the card, over dtypes, depths,
   neighborhoods and small and odd shapes, the main paths' own shapes
   included:
   - K1 (``dense_step_plain``) and K3 (``composed_dense_step_plain``): f32
     ``atol = rtol = 1e-6 * k``, bf16 one bf16 ulp of the value scale. Both
     sum a neighborhood in ``offsets`` order with every operation rounded,
     as the plain versions do; K3's tap loop is left to nvcc's FMA
     contraction (and, in bf16, that decides which side of a rounding
     boundary a value lands on).
   - K6 (``fused_compute_plain``) and K7 (``fused_scatter_plain``): bit for
     bit at k=1 and for K7 (K6 computes in the storage dtype with every
     operation rounded, in the plain version's order); at k>1 within f32
     ``1e-6 * k``, f64 ``1e-12``, bf16 one ulp of the scale per step.
   - K4 (``field_step_plain``): bit for bit, f32 and bf16, nsteps 1, 4, 8
     (and 16 at bf16), over config 4's flows, ``Coupled`` alone (the
     modulator must come back as the same tensor), an affine user flow, a
     row-reading flow (``cell_coords``), a 3-channel chain and one flow
     with every whitelisted operation. That last one uses ``exp``, where
     CUDA's ``expf`` and torch's may differ by an ulp: it is held to
     ``8·eps·nsteps·max|v|`` (plus one bf16 ulp of the scale at bf16).
   - K5 (``pipeline_step_plain``): bit for bit, f32 and bf16, nsteps 1, 4,
     8, Moore, von Neumann and a custom neighborhood, B 1, 3 and 8, on
     16×128 (auto block) and 48×384 with block (16, 128) (closed-form
     tiles inside), and the ensemble path's 8 × 4096² (Moore, nsteps 1
     and 8).
4. the K1 main path at full width: ``Model(Diffusion(0.1)).execute`` of a
   16384² grid through ``SerialExecutor("pallas")``, 64 steps, f32
   substeps=8 and bf16 substeps=16; conservation checked, the launch
   counters set to 0 just before and read just after each run; the 512²
   chained checks against the plain version; K1's timing against
   ``conv2d`` 3x3 (TF32 off; the port never calls it).
5. the active paths at full width, f32: the sparse state of
   ``bench.py::_active_workload`` (a zero 16384² grid with a centred square
   of side ``round(16384 * sqrt(frac))`` holding ``U(0.5, 2.0)`` values from
   a numpy seed) at activity 0.01, 0.05 and 0.15, through
   ``SerialExecutor("active")``, ``("active_fused", substeps=1)`` and
   ``("active_fused", substeps=8)`` (k=8), 20 steps after a warm-up, each
   run with the counters set to 0 just before and read just after:
   conservation, K6 and K7 launches == ``flags_fused``, K1 launches ==
   ``fallback_steps``; per row the cell-updates/s (host clock, median of
   three runs), mean active fraction, fallback steps, the time of one pass
   against K6 + K7 kernel time, and the peak device memory. Then the gates: one step at 0.01, ``active`` ==
   ``active_fused`` k=1 == the plain dense step, bitwise; a dense nonzero
   16384² state falls back every step and equals
   ``SerialExecutor("pallas", substeps=1)`` bitwise (K1 serves the
   fallback); a 1024² f64 state at 0.02, 12 steps, ``active`` ==
   ``active_fused`` == ``xla`` bitwise.
6. the composed path at full width: ``SerialExecutor("composed")`` at
   16384², f32 substeps=8 (k=8) and bf16 substeps=16 (k=16), 64 steps,
   conservation checked; on 512², against the K1 path under the derived
   tolerance below; K3's time per call against its bound and against one
   ``conv2d`` with the same table (TF32 off; the port never calls it).
6b. the field path at full width (BASELINE config 4): ``Model([Diffusion(0.1,
   "a"), Coupled(0.05, "a", "b"), Diffusion(0.2, "b")]).execute`` of an 8192²
   two-channel space of ``U(0.5, 2.0)`` from a numpy seed through
   ``SerialExecutor("pallas")``: f32 at substeps 1 and 8, bf16 at 1 and 16,
   64 steps each, the counters set to 0 just before and read just after
   each run (K4 launches == steps / substeps); conservation checked;
   ``SerialExecutor("auto")`` reports ``pallas``; on 512², 64 steps against
   the plain version chained call by call, bit for bit; cell-updates/s
   (CUDA events, median), K4 ms per call against its bound (computed from
   the lowered program), the plain version's and the ``impl="xla"`` step's
   times, and the peak device memory.
6c. ensemble serving at full width (``bench.py``'s serving row uncut): B = 8
   lanes of 4096², 8 steps, lane i = ``np.roll(base, 7·i, axis=0)`` of a
   ``U(0.5, 2.0)`` base from a numpy seed. Gates first, on lanes 0 and 7
   against per-scenario serial runs: ``impl="xla"`` with per-lane rates
   ``0.1·(1 + 0.05·i/7)`` bit for bit against ``SerialExecutor("xla")`` at
   f32; ``impl="pipeline"`` (rate 0.1) bit for bit against
   ``SerialExecutor("pallas", substeps)`` (K1) at f32 and bf16, since at
   4096² no K5 tile takes the closed form and both run one exact path (one
   bf16 ulp of the scale for the run where a tile would), and within
   ``1e-6·steps`` of ``SerialExecutor("xla")`` at f32. Then the rows, each
   through ``EnsembleService(buckets=buckets_for(8), retry="solo")``:
   pipeline f32 and bf16 at substeps 1 and 8, xla f32 and bf16; each row's
   first dispatch builds the runner, the next is the counted one (counters
   set to 0 just before, read just after: K5 launches == steps/substeps;
   the peak device memory above what the spaces held), then 5 warm
   dispatches timed with CUDA events (median): scenarios/s, cell-updates/s,
   occupancy, runner builds and cache hits. The sequential baselines: 8
   runs of ``SerialExecutor("xla")`` and 8 of ``SerialExecutor("pallas",
   substeps=8)`` (K1). One more pipeline substeps=8 dispatch and one f32
   K1 baseline run under ``torch.profiler``, device activity only: busy
   time against the call's CUDA-event time (the idle share) and device time
   by kind of work. A third baseline runs the 8 K1 scenarios through
   ``Model.execute``, which takes the totals, conservation check and report
   that a served scenario carries. K5 per call against its bound, its plain version and
   one ``conv2d`` 3×3 box over ``[B, 1, H, W]`` times nsteps (TF32 off; the
   port never calls it). A B = 3 dispatch into the 4-bucket (occupancy
   0.75), and a padded batch whose pad lane stays zero.
7. the CLI (K1, active_fused, K4 and ensemble pipeline rows) and the
   100×100 ``Exponencial`` reference run at f64 against the port's own
   ``oracle.reference_run_np``.
8. the kernels line, the card line, and the last line
   ``{"ok": true, "device": {...}}``. ``chip_smoke.json`` in the output
   directory keeps every row, every kernel case and the build record.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

N = 16384          # main-path grid side (bench.py's headline grid)
N4 = 8192          # the field path's grid side (BASELINE config 4)
N5 = 4096          # the ensemble path's grid side (bench.py's serving row)
B5 = 8             # the ensemble path's lanes
STEPS5 = 8
STEPS = 64
ACTIVE_STEPS = 20
FRACS = (0.01, 0.05, 0.15)
SEED = 1234
#: H100 SXM data-sheet peaks (NVIDIA): HBM bytes/s and f32 non-tensor FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
CUSTOM_OFFSETS = ((-1, 0), (1, 1), (0, -1))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def timed_ms(torch, fn, reps: int, warmup: int = 1) -> list[float]:
    """Per-call device times of ``fn`` from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def profile_dispatch(torch, fn, wall_ms: float) -> dict:
    """Where one call of ``fn`` spends its device time, from a
    ``torch.profiler`` trace of the device alone: the busy time (the union
    of kernel, copy and memset intervals), the device time and operation
    count by kind of work, and the idle share against ``wall_ms``, the
    call's unprofiled CUDA-event time (the profiler's own host cost
    stretches the traced call, so only device durations are taken from
    it). A profiler that sees no device activity gives ``{"error": ...}``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type.name == "CUDA"
                   and e.time_range.end > e.time_range.start)
    if not spans:
        return {"error": "the profiler recorded no device activity"}
    busy, cur_s, cur_e = 0.0, None, None
    for s, e, _ in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy = (busy + cur_e - cur_s) / 1e3
    kinds: dict[str, list] = {}
    for s, e, name in spans:
        low = name.lower()
        kind = ("K5" if "pipeline_stencil" in low else
                "K1" if "fused_stencil" in low else
                "reduction" if "reduce" in low else
                "copy" if "memcpy" in low or "copy" in low else
                "memset" if "memset" in low else "elementwise/other")
        k = kinds.setdefault(kind, [0, 0.0])
        k[0] += 1
        k[1] += (e - s) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms,
            "device_by_kind": {k: {"ops": n, "ms": ms}
                               for k, (n, ms) in kinds.items()}}


def print_profile(what: str, prof: dict) -> None:
    if "error" in prof:
        print(f"{what} profile: not measured ({prof['error']})", flush=True)
        return
    kinds = ", ".join(f"{k} {v['ms']:.3f} ({v['ops']} ops)" for k, v in
                      sorted(prof["device_by_kind"].items()))
    print(f"{what} profile: device busy {prof['device_busy_ms']:.3f} of "
          f"{prof['wall_ms']:.3f} ms (idle share {prof['idle_share']:.3f}); "
          f"{kinds}", flush=True)


def bound_ms(shape, itemsize: int, nsteps: int, k: int) -> tuple[float, str]:
    """Least time for one K1 call: the grid read once and written once over
    HBM bandwidth, or (k + 3) f32 flops per cell-step (share: multiply and
    divide; gather: k - 1 adds; keep-multiply and add) over the f32 peak,
    whichever is larger."""
    cells = shape[0] * shape[1]
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = cells * nsteps * (k + 3) / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def larger(bytes_ms: float, ops_ms: float) -> tuple[float, str]:
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def bf16_ulp(scale: float) -> float:
    return 2.0 ** (math.floor(math.log2(scale)) - 7)


def workload(np, h: int, w: int, frac: float, seed: int):
    """``bench.py::_active_workload``: zeros with a centred square of side
    ``round(h * sqrt(frac))`` of ``U(0.5, 2.0)`` f32 values."""
    side = max(1, int(round(h * math.sqrt(frac))))
    v = np.zeros((h, w), np.float32)
    r0, c0 = (h - side) // 2, (w - side) // 2
    v[r0:r0 + side, c0:c0 + side] = np.random.default_rng(seed).uniform(
        0.5, 2.0, (side, side)).astype(np.float32)
    return v


def field_flow_sets(mt, torch) -> dict:
    """K4's flow sets: config 4's, ``Coupled`` alone, an affine user flow
    (outflow(0) != 0), a row-reading flow, a 3-channel chain and one flow
    with every whitelisted operation (beside a Diffusion on its
    modulator)."""
    from mpi_model_tpu_torch.ops.flow import Flow, cell_coords

    class Affine(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            return 0.05 * (3.0 - values["a"])

    class RowRate(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            v = values["a"]
            rows, _ = cell_coords(v, origin)
            return 0.002 * rows.to(v.dtype) * v

    class EveryOp(Flow):
        footprint = "pointwise"
        attr = "a"

        def outflow(self, values, origin=(0, 0)):
            a, b = values["a"], values["b"]
            r, c = cell_coords(a, origin)
            x = (torch.minimum(a, b) * 0.3
                 + torch.maximum(a, 2.0 - b) / (b + 1.5))
            y = (-a).abs() * torch.exp(-b) + a ** 2 * 0.01 - b ** 3 * 0.001
            z = ((c + 1).to(a.dtype) * 1e-4 * a
                 - (r - 2).to(a.dtype) * 1e-5 * torch.clamp(b, 0.7, 1.8))
            return (x + y + z).clamp(min=0.0) * 0.05

    return {
        "config4": config4_flows(mt),
        "coupled_alone": [mt.Coupled(0.05, "a", "b")],
        "affine": [Affine()],
        "row_rate": [RowRate()],
        "chain3": [mt.Diffusion(0.1, "a"), mt.Diffusion(0.1, "b"),
                   mt.Diffusion(0.1, "c"), mt.Coupled(0.05, "a", "b"),
                   mt.Coupled(0.05, "b", "c")],
        "every_op": [EveryOp(), mt.Diffusion(0.1, "b")],
    }


def config4_flows(mt) -> list:
    """BASELINE config 4's flow set (``benchmarks/ladder.py``)."""
    return [mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
            mt.Diffusion(0.2, "b")]


def field_bound_ms(prog, shape, itemsize: int, nsteps: int,
                   k: int) -> tuple[float, str]:
    """Least time for one K4 call, from the lowered program: every loaded
    channel read once and every written channel written once over HBM
    bandwidth, or the flops per cell-step (the program's, which include the
    adds that sum flows of one channel, and per written channel a divide, k
    inflow adds and two more) over the f32 peak, whichever is larger."""
    cells = shape[0] * shape[1]
    n_out = len(prog.outputs)
    bytes_ms = ((len(prog.channels) + n_out) * cells * itemsize
                / HBM_BYTES_PER_S * 1e3)
    flops = prog.flops() + n_out * (k + 3)
    ops_ms = cells * nsteps * flops / F32_FLOPS * 1e3
    return larger(bytes_ms, ops_ms)


def k5_bound_ms(batch: int, shape, itemsize: int, nsteps: int, k: int,
                interior_cells: int) -> tuple[float, str]:
    """Least time for one K5 call: the batch read once and written once over
    HBM bandwidth, or its flops over the f32 peak: 7 a cell-step on
    closed-form (interior) tiles, k + 3 on the exact path (share: multiply
    and divide; k - 1 gather adds; keep-multiply and add), whichever is
    larger. Which tiles are interior is fixed by the grid and the block."""
    cells = batch * shape[0] * shape[1]
    inner = batch * interior_cells
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    flops = nsteps * (7 * inner + (k + 3) * (cells - inner))
    return larger(bytes_ms, flops / F32_FLOPS * 1e3)


def main() -> int:
    import numpy as np
    import torch

    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    try:
        import mpi_model_tpu_torch as mt
        from mpi_model_tpu_torch import oracle
        from mpi_model_tpu_torch.core.cell import (MOORE_OFFSETS,
                                                   VON_NEUMANN_OFFSETS)
        from mpi_model_tpu_torch.models.model import kernel_launches
        from mpi_model_tpu_torch.ops import _build
        from mpi_model_tpu_torch.ops import active as act
        from mpi_model_tpu_torch.ops import composed_stencil as cs
        from mpi_model_tpu_torch.ops import field_stencil as k4
        from mpi_model_tpu_torch.ops import fused_active as fa
        from mpi_model_tpu_torch.ops import fused_stencil as fs
        from mpi_model_tpu_torch.ops import pipeline_stencil as k5
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    card_line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else f"{kind}, power limit not readable"
    print(f"device: {kind} (torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}); nvidia-smi: {card_line}", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    neighborhoods = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
                     "custom": CUSTOM_OFFSETS}

    def reset_counts():
        fs.reset_launches()
        cs.reset_launches()
        k4.reset_launches()
        k5.reset_launches()
        fa.reset_launches()

    cases = []  # every kernel-vs-plain case, kept in chip_smoke.json

    def record(line: str, ok: bool) -> None:
        """Keep a case's line; print it only when it fails."""
        cases.append({"case": line, "ok": ok})
        if not ok:
            print(line, flush=True)

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (one nvcc per source, "
          "in parallel)", flush=True)
    for name, info in _build.build_info.items():
        print(f"  {name}: {info['seconds']:.2f} s cached={info['cached']}")
        for line in info["ptxas"].splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line):
                print(f"    {line.strip()}")

    # -- 3. K1 against its plain version --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(13, 17), (13, 160), (24, 256), (400, 1664), (2048, 2048),
              (N, N)]
    worst = 0.0
    main_err = {}
    ncases = 0
    for dtype, nsteps_set in ((torch.float32, (1, 4, 8)),
                              (torch.bfloat16, (1, 16))):
        for shape in shapes:
            x = (0.5 + 1.5 * torch.rand(shape, generator=gen, device=dev)).to(
                dtype)
            depth = fs.ghost_depth(shape, dtype)
            for ns in nsteps_set:
                if ns > depth:
                    continue
                for hood, offs in neighborhoods.items():
                    if shape == (N, N) and not (
                            hood == "moore" and ns == max(nsteps_set)):
                        continue  # the main path's own case only
                    got = fs.pallas_dense_step(x, 0.13, offs, nsteps=ns)
                    want = fs.dense_step_plain(x, 0.13, offs, ns)
                    torch.cuda.synchronize()
                    g32, w32 = got.float(), want.float()
                    err = float((g32 - w32).abs().max())
                    if dtype == torch.float32:
                        tol = 1e-6 * ns
                        ok = bool(((g32 - w32).abs()
                                   <= tol + tol * w32.abs()).all())
                        tol_s = f"atol=rtol={tol:.0e}"
                    else:
                        tol = bf16_ulp(float(w32.abs().max()))
                        ok = err <= tol
                        tol_s = f"atol={tol:g} (1 bf16 ulp)"
                    ncases += 1
                    dname = str(dtype).removeprefix("torch.")
                    record(f"K1 {dname} {shape} ns={ns} {hood}: max_abs_err="
                           f"{err:.3e} {tol_s} {'ok' if ok else 'FAIL'}", ok)
                    check(ok and math.isfinite(err),
                          f"K1 disagrees with its plain version: {dname} "
                          f"{shape} ns={ns} {hood} err={err}")
                    worst = max(worst, err)
                    if shape == (N, N):
                        main_err[dname] = err
                    del got, want, g32, w32
            del x
    print(f"K1: {ncases} cases agree with the plain version "
          f"(largest error {worst:.3e})", flush=True)

    # -- 3b. K3 against its plain version -------------------------------------
    k3_err = {}
    ncases = 0
    k3_shapes = [(13, 17), (77, 131), (400, 1664), (2048, 2048), (N, N)]
    for dtype, ks in ((torch.float32, (1, 4, 8)),
                      (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape in k3_shapes:
            x = (0.5 + 1.5 * torch.rand(shape, generator=gen, device=dev)).to(
                dtype)
            for k in ks:
                if k > cs.max_k(shape, dtype):
                    continue
                for hood, offs in neighborhoods.items():
                    if shape == (N, N) and not (hood == "moore"
                                                and k == max(ks)):
                        continue  # the main path's own case only
                    got = cs.composed_dense_step(x, 0.13, k, offs)
                    want = cs.composed_dense_step_plain(x, 0.13, k, offs)
                    torch.cuda.synchronize()
                    g32, w32 = got.float(), want.float()
                    err = float((g32 - w32).abs().max())
                    if dtype == torch.float32:
                        tol = 1e-6 * k
                        ok = bool(((g32 - w32).abs()
                                   <= tol + tol * w32.abs()).all())
                        tol_s = f"atol=rtol={tol:.0e}"
                    else:
                        tol = bf16_ulp(float(w32.abs().max()))
                        ok = err <= tol
                        tol_s = f"atol={tol:g} (1 bf16 ulp)"
                    ncases += 1
                    record(f"K3 {dname} {shape} k={k} {hood}: max_abs_err="
                           f"{err:.3e} {tol_s} {'ok' if ok else 'FAIL'}", ok)
                    check(ok and math.isfinite(err),
                          f"K3 disagrees with its plain version: {dname} "
                          f"{shape} k={k} {hood} err={err}")
                    if shape == (N, N):
                        k3_err[dname] = err
                    del got, want, g32, w32
            del x
            torch.cuda.empty_cache()
    print(f"K3: {ncases} cases agree with the plain version (at the main "
          f"path's shape: f32 k=8 {k3_err['float32']:.3e}, bf16 k=16 "
          f"{k3_err['bfloat16']:.3e})", flush=True)

    # -- 3c. K6 and K7 against their plain versions ---------------------------
    def active_case(v, dtype, tile, k, plan_kw=None):
        """A state (numpy or on the card) padded to ring k, its plan and
        its compacted active set."""
        x = (v if isinstance(v, torch.Tensor)
             else torch.from_numpy(v)).to(dev, dtype)
        plan = act.plan_for(tuple(x.shape), tile=tile, **(plan_kw or {}))
        tmap = act.tile_nonzero_map(x, plan)
        flags = act.dilate_tile_map(tmap)
        ids, count = act.compact_tile_ids(flags, plan)
        selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
        padded = torch.nn.functional.pad(x, (k, k, k, k)).contiguous()
        del x
        return padded, plan, ids, count, selfnz

    def k67_compare(padded, plan, ids, count, selfnz, dtype, k, offs, shape):
        """K6 and K7 against their plain versions on one state; returns
        (K6 max_abs_err, bitwise, within tolerance, K7 bitwise)."""
        taps = fa._fused_taps(0.13, offs, k)
        cnt1 = count.reshape(1).to(torch.int32)
        upd, anyf = fa.fused_compute(
            padded, ids, cnt1, selfnz, rate=0.13, plan=plan, origin=(0, 0),
            global_shape=shape, offsets=offs, dtype=dtype, k=k, ring=k,
            taps=taps)
        want_u, want_f = fa.fused_compute_plain(
            padded, ids, count, selfnz, 0.13, plan, (0, 0), shape, offs,
            dtype, k, k, taps)
        n = min(max(int(count), 1), plan.capacity)
        g, w = upd[:n].double(), want_u[:n].double()
        err = float((g - w).abs().max()) if n else 0.0
        bitwise = bool(torch.equal(upd[:n], want_u[:n])
                       and torch.equal(anyf, want_f))
        if dtype == torch.float32:
            tol = 1e-6 * k
            within = bool(((g - w).abs() <= tol + tol * w.abs()).all())
        elif dtype == torch.float64:
            within = bool(((g - w).abs() <= 1e-12 + 1e-12 * w.abs()).all())
        else:
            within = err <= k * bf16_ulp(max(float(w.abs().max()), 2 ** -100))
        within = within and bool(torch.equal(anyf, want_f))
        p_k = fa.fused_scatter(padded.clone(), upd, ids, cnt1, plan=plan,
                               ring=k)
        p_p = fa.fused_scatter_plain(padded.clone(), upd, ids, count, plan, k)
        k7_bitwise = bool(torch.equal(p_k, p_p))
        del upd, anyf, want_u, want_f, g, w, p_k, p_p
        return err, bitwise, within, k7_bitwise

    k6_err = {}
    ncases = 0
    small = [((200, 264), (40, 24)), ((256, 320), (64, 64)),
             ((96, 96), (16, 16))]
    for dtype, ks in ((torch.float32, (1, 4, 8)), (torch.float64, (1, 4, 8)),
                      (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape, tile in small:
            v_np = workload(np, shape[0], shape[1], 0.04, SEED)
            v_np[0:5, 0:7] = np.random.default_rng(SEED).uniform(
                0.5, 2.0, (5, 7))  # mass on the corner: near-edge tiles
            for k in ks:
                if k > min(tile):
                    continue
                for hood, offs in neighborhoods.items():
                    case = active_case(v_np, dtype, tile, k,
                                       {"max_active_frac": 1.0})
                    err, bitwise, within, k7_bit = k67_compare(
                        *case, dtype, k, offs, shape)
                    ok = k7_bit and (bitwise if k == 1 else within)
                    ncases += 1
                    record(f"K6/K7 {dname} {shape} tile={tile} k={k} {hood}: "
                           f"max_abs_err={err:.3e} bitwise={bitwise} "
                           f"K7 bitwise={k7_bit} {'ok' if ok else 'FAIL'}",
                           ok)
                    check(ok, f"K6/K7 disagree with their plain versions: "
                              f"{dname} {shape} k={k} {hood} err={err}")
                    del case
    # the main paths' own states: 16384² f32 at activity 0.05, 128² tiles
    v_main = workload(np, N, N, 0.05, SEED)
    for k in (1, 8):
        case = active_case(v_main, torch.float32, None, k)
        err, bitwise, within, k7_bit = k67_compare(
            *case, torch.float32, k, MOORE_OFFSETS, (N, N))
        ok = k7_bit and (bitwise if k == 1 else within)
        k6_err[k] = err
        line = (f"K6/K7 float32 {(N, N)} tile=(128, 128) k={k} moore: "
                f"max_abs_err={err:.3e} bitwise={bitwise} K7 bitwise="
                f"{k7_bit} {'ok' if ok else 'FAIL'}")
        record(line, ok)
        if ok:
            print(line, flush=True)
        check(ok, f"K6/K7 disagree at the main path's shape, k={k}")
        del case
        torch.cuda.empty_cache()
    del v_main
    n_bit = sum(c["case"].startswith("K6/K7") and " bitwise=True" in c["case"]
                for c in cases)
    print(f"K6/K7: {ncases + 2} cases agree with the plain versions, "
          f"{n_bit} of them bit for bit", flush=True)

    # -- 3d. K4 against its plain version -------------------------------------
    flow_sets = field_flow_sets(mt, torch)
    k4_err = {}
    ncases = n_bit = 0
    k4_shapes = [(5, 7), (37, 300), (77, 131), (N4, N4)]
    for dtype, nsteps_set in ((torch.float32, (1, 4, 8)),
                              (torch.bfloat16, (1, 4, 8, 16))):
        dname = str(dtype).removeprefix("torch.")
        for shape in k4_shapes:
            vals = {n: (0.5 + 1.5 * torch.rand(shape, generator=gen,
                                               device=dev)).to(dtype)
                    for n in ("a", "b", "c")}
            depth = fs.ghost_depth(shape, dtype)
            for ns in nsteps_set:
                if ns > depth:
                    continue
                for hood, offs in neighborhoods.items():
                    for fname, flows in flow_sets.items():
                        if shape == (N4, N4) and not (
                                hood == "moore" and fname == "config4"
                                and ns == max(nsteps_set)):
                            continue  # the main path's own case only
                        step = k4.PallasFieldStep(shape, flows, offsets=offs,
                                                  nsteps=ns)
                        got = step(vals)
                        want = k4.field_step_plain(vals, flows, offs, ns)
                        torch.cuda.synchronize()
                        written = {f.attr for f in flows}
                        ok = step.launches == 1 and all(
                            got[n] is vals[n] for n in vals
                            if n not in written)
                        err, exact = 0.0, True
                        for n in sorted(written):
                            g32, w32 = got[n].float(), want[n].float()
                            e = float((g32 - w32).abs().max())
                            err = max(err, e)
                            exact = exact and bool(torch.equal(got[n],
                                                               want[n]))
                            if fname == "every_op" and n == "a":
                                scale = float(w32.abs().max())
                                tol = 8 * 2.0 ** -23 * ns * scale
                                if dtype == torch.bfloat16:
                                    tol += bf16_ulp(scale)
                                ok = ok and e <= tol
                            else:
                                ok = ok and bool(torch.equal(got[n],
                                                             want[n]))
                        ncases += 1
                        n_bit += exact
                        record(f"K4 {dname} {shape} ns={ns} {hood} {fname}: "
                               f"max_abs_err={err:.3e} bitwise={exact} "
                               f"{'ok' if ok else 'FAIL'}", ok)
                        check(ok and math.isfinite(err),
                              f"K4 disagrees with its plain version: {dname} "
                              f"{shape} ns={ns} {hood} {fname} err={err}")
                        if shape == (N4, N4):
                            k4_err[dname] = err
                        del got, want
            del vals
            torch.cuda.empty_cache()
    print(f"K4: {ncases} cases agree with the plain version, {n_bit} of them "
          f"bit for bit (every_op, with exp, is held to a tolerance); at the "
          f"main path's shape f32 "
          f"ns=8 {k4_err['float32']:.3e}, bf16 ns=16 "
          f"{k4_err['bfloat16']:.3e}", flush=True)

    # -- 3e. K5 against its plain version -------------------------------------
    k5_err = {}
    ncases = 0
    k5_shapes = [((16, 128), None), ((48, 384), (16, 128))]
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).removeprefix("torch.")
        for B in (1, 3, 8):
            for shape, block in k5_shapes:
                x = (0.5 + 1.5 * torch.rand((B,) + shape, generator=gen,
                                            device=dev)).to(dtype)
                for ns in (1, 4, 8):
                    for hood, offs in neighborhoods.items():
                        got = k5.pipeline_dense_step(x, 0.13, offs,
                                                     block=block, nsteps=ns)
                        want = k5.pipeline_step_plain(x, 0.13, offs, ns,
                                                      block)
                        torch.cuda.synchronize()
                        ok = bool(torch.equal(got, want))
                        err = float((got.float() - want.float()).abs().max())
                        ncases += 1
                        record(f"K5 {dname} B={B} {shape} block={block} "
                               f"ns={ns} {hood}: max_abs_err={err:.3e} "
                               f"bitwise={ok} {'ok' if ok else 'FAIL'}", ok)
                        check(ok, f"K5 disagrees with its plain version: "
                                  f"{dname} B={B} {shape} ns={ns} {hood} "
                                  f"err={err}")
        # the ensemble path's own batch: 8 lanes of 4096², Moore
        x = (0.5 + 1.5 * torch.rand((B5, N5, N5), generator=gen,
                                    device=dev)).to(dtype)
        for ns in (1, 8):
            got = k5.pipeline_dense_step(x, 0.13, MOORE_OFFSETS, nsteps=ns)
            want = k5.pipeline_step_plain(x, 0.13, MOORE_OFFSETS, ns)
            torch.cuda.synchronize()
            ok = bool(torch.equal(got, want))
            err = float((got.float() - want.float()).abs().max())
            ncases += 1
            line = (f"K5 {dname} B={B5} {(N5, N5)} ns={ns} moore: "
                    f"max_abs_err={err:.3e} bitwise={ok} "
                    f"{'ok' if ok else 'FAIL'}")
            record(line, ok)
            check(ok, f"K5 disagrees with its plain version at the ensemble "
                      f"path's shape: {dname} ns={ns} err={err}")
            if ns == 8:
                k5_err[dname] = err
            del got, want
        del x
        torch.cuda.empty_cache()
    print(f"K5: {ncases} cases equal the plain version bit for bit",
          flush=True)

    # -- 4. K1 main path at full width ----------------------------------------
    results = {}
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        noise = torch.rand((N, N), generator=gen, device=dev)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname)
        space = space.with_values({"value": (1.0 + 0.1 * noise).to(tdt)})
        del noise
        model = mt.Model(mt.Diffusion(0.1))
        ex = mt.SerialExecutor(step_impl="pallas", substeps=sub)
        reset_counts()
        out, rep = model.execute(space, ex, steps=STEPS)  # raises on drift
        launched = fs.launches()
        v = out.values["value"]
        check(rep.impl == "pallas", f"main path ran impl {rep.impl!r}")
        check(launched == STEPS // sub,
              f"{dname}: K1 launched {launched} times, expected "
              f"{STEPS // sub}")
        check(rep.backend_report["launches"] == launched,
              "the report's launch count disagrees with the counter")
        check(tuple(v.shape) == (N, N) and v.dtype == tdt,
              "main-path output has the wrong shape or dtype")
        check(bool(torch.isfinite(v).all()), "main-path output not finite")
        run_ms = timed_ms(torch, lambda: ex.run_model(model, space, STEPS),
                          reps=5)
        med = statistics.median(run_ms)
        row = {"dtype": dname, "substeps": sub, "steps": STEPS,
               "launches": launched,
               "conservation_error": rep.conservation_error(),
               "run_ms_median": med, "run_ms_all": run_ms,
               "step_ms": med / STEPS,
               "cell_updates_per_s": N * N * STEPS / (med / 1e3)}
        results[dname] = row
        print(f"main path {dname} {N}x{N} substeps={sub}: conserved "
              f"(|d|={row['conservation_error']:.3e}), impl=pallas, "
              f"launches={launched}, {row['step_ms']:.4f} ms/step, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s", flush=True)
        del out, v, space
        torch.cuda.empty_cache()

    # the main path's answer against the plain-op path on a small grid
    small_space = mt.CellularSpace.create(512, 512, 1.0, dtype="float32")
    small_space = small_space.with_values({"value": 1.0 + 0.1 * torch.rand(
        (512, 512), generator=gen, device=dev)})
    model = mt.Model(mt.Diffusion(0.1))
    a, _ = model.execute(small_space, mt.SerialExecutor("pallas", substeps=8),
                         steps=STEPS)
    b, _ = model.execute(small_space, mt.SerialExecutor("xla"), steps=STEPS)
    d = float((a.values["value"] - b.values["value"]).abs().max())
    print(f"main path 512x512 f32 pallas vs xla, {STEPS} steps: "
          f"max_abs_err={d:.3e} (atol 1e-4)", flush=True)
    check(d <= 1e-4, "the kernel path disagrees with the plain-op path")

    # the main path's answer at each dtype against the plain version of K1
    # chained call by call (the same rounding points). A call differs by at
    # most `t` (f32: 1e-6*ns*(1+|v|); bf16: one ulp of the scale on top),
    # and a difference carried in grows by at most the gain G of one call:
    # the call is a nonnegative linear map, so G is the largest entry of
    # the map applied to ones (above 1 next to the corners). So after
    # `calls` calls the two differ by at most t * (1 + G + ... + G^(calls-1)).
    def gain(fn, sub):
        return float(fn(torch.ones((512, 512), device=dev), sub).max())

    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((512, 512), generator=gen,
                                    device=dev)).to(tdt)
        small_space = mt.CellularSpace.create(512, 512, 1.0, dtype=dname)
        small_space = small_space.with_values({"value": x})
        a, _ = model.execute(small_space,
                             mt.SerialExecutor("pallas", substeps=sub),
                             steps=STEPS)
        want = x
        for _ in range(STEPS // sub):
            want = fs.dense_step_plain(want, 0.1, MOORE_OFFSETS, sub)
        got32, want32 = a.values["value"].float(), want.float()
        d = float((got32 - want32).abs().max())
        calls = STEPS // sub
        scale = float(want32.abs().max())
        g = gain(lambda o, s: fs.dense_step_plain(o, 0.1, MOORE_OFFSETS, s),
                 sub)
        t = 1e-6 * sub * (1.0 + scale)
        if tdt == torch.bfloat16:
            t += bf16_ulp(scale)
        tol = t * sum(g ** i for i in range(calls))
        print(f"main path 512x512 {dname} substeps={sub} vs chained plain "
              f"K1, {STEPS} steps: max_abs_err={d:.3e} (atol {tol:g})",
              flush=True)
        check(d <= tol, f"{dname}: the kernel path disagrees with the plain "
                        "version")

    # kernel, plain and library times at the main path's shape
    timings = {}
    for dname, ns in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)).to(tdt)
        y = torch.empty_like(x)
        bufs = [x, y]

        def kernel_call():
            fs.pallas_dense_step(bufs[0], 0.1, nsteps=ns, out=bufs[1])
            bufs.reverse()

        k_ms = statistics.median(timed_ms(torch, kernel_call, reps=20))
        p_ms = statistics.median(timed_ms(
            torch, lambda: fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, ns),
            reps=3))
        # yardstick: the 3x3 neighbor sum one step is dominated by
        w = torch.ones((1, 1, 3, 3), device=dev, dtype=tdt)
        x4 = x.view(1, 1, N, N)
        l_ms = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, w, padding=1),
            reps=10))
        b_ms, b_by = bound_ms((N, N), x.element_size(), ns, 8)
        timings[dname] = {"nsteps": ns, "ms": k_ms, "plain_ms": p_ms,
                          "library_ms": l_ms, "bound_ms": b_ms,
                          "bound_by": b_by}
        print(f"K1 {dname} {N}x{N} ns={ns}: kernel {k_ms:.4f} ms/call, "
              f"plain {p_ms:.3f} ms, conv2d 3x3 {l_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), {k_ms / ns:.4f} ms per step",
              flush=True)
        del x, y, bufs, x4
        torch.cuda.empty_cache()

    # -- 5. the active paths at full width ------------------------------------
    # the runners read the dilated count on the host once per pass: the
    # round trip of one such read on an idle card
    probe = torch.ones(4, dtype=torch.int32, device=dev)
    sync_us = []
    for _ in range(200):
        t0 = time.perf_counter()
        int(probe.sum())
        sync_us.append((time.perf_counter() - t0) * 1e6)
    sync_us = statistics.median(sync_us)
    print(f"host read of a device count: {sync_us:.1f} us (median of 200)",
          flush=True)
    model = mt.Model(mt.Diffusion(0.1))
    configs = (("active", 1), ("active_fused", 1), ("active_fused", 8))
    active_rows = []
    k67_time = {}   # (frac, k) -> K6/K7 ms on the run's starting state
    for frac in FRACS:
        v_np = workload(np, N, N, frac, SEED)
        space = mt.CellularSpace.create(N, N, 0.0, dtype="float32")
        space = space.with_values({"value": torch.from_numpy(v_np).to(dev)})
        del v_np
        for impl, sub in configs:
            ex = mt.SerialExecutor(impl, substeps=sub)
            model.execute(space, ex, steps=2)  # warm-up (and first build)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            out, rep = model.execute(space, ex, steps=ACTIVE_STEPS)
            ran = kernel_launches()
            peak = torch.cuda.max_memory_allocated()
            br = rep.backend_report
            check(rep.impl == impl, f"active row ran impl {rep.impl!r}")
            check(bool(torch.isfinite(out.values["value"]).all()),
                  "active path output not finite")
            passes = br.get("passes", ACTIVE_STEPS)
            check(ran["fused_stencil"] == br["fallback_steps"],
                  f"{impl}: K1 fallback launches {ran['fused_stencil']} != "
                  f"fallback_steps {br['fallback_steps']}")
            if impl == "active_fused":
                check(ran["fused_compute"] == br["flags_fused"]
                      and ran["fused_scatter"] == br["flags_fused"],
                      f"K6/K7 launches {ran} != flags_fused "
                      f"{br['flags_fused']}")
                check(br["flags_fused"] + br["fallback_steps"] == passes,
                      "flags_fused + fallback_steps != passes")
                check(br["flags_fused"] > 0, "no fused pass ran")
            # host clock around the run and a synchronize; the median of
            # this run and two more (their launches are not counted)
            walls = [rep.wall_time_s * 1e3] + [
                model.execute(space, ex, steps=ACTIVE_STEPS)[1].wall_time_s
                * 1e3 for _ in range(2)]
            run_ms = statistics.median(walls)
            row = {"frac": frac, "impl": impl, "substeps": sub,
                   "steps": ACTIVE_STEPS, "passes": passes,
                   "run_ms": run_ms, "run_ms_all": walls,
                   "cell_updates_per_s": N * N * ACTIVE_STEPS
                   / (run_ms / 1e3),
                   "mean_active_fraction": br["mean_active_fraction"],
                   "fallback_steps": br["fallback_steps"],
                   "flags_fused": br.get("flags_fused"),
                   "launches": ran,
                   "conservation_error": rep.conservation_error(),
                   "peak_mem_bytes": peak,
                   "pass_ms": run_ms / passes}
            if impl == "active_fused":
                k = br["composed_k"]
                # K6 + K7 on the run's starting state, one pass at depth k
                case_p, plan, ids, count, selfnz = active_case(
                    space.values["value"], torch.float32, None, k)
                taps = fa._fused_taps(0.1, MOORE_OFFSETS, k)
                cnt1 = count.reshape(1).to(torch.int32)
                upd = torch.empty((plan.capacity,) + plan.tile,
                                  dtype=torch.float32, device=dev)
                anyf = torch.empty(plan.capacity, dtype=torch.int32,
                                   device=dev)
                kw = dict(rate=0.1, plan=plan, origin=(0, 0),
                          global_shape=(N, N), offsets=MOORE_OFFSETS,
                          dtype=torch.float32, k=k, ring=k, taps=taps,
                          upd=upd, anyf=anyf)
                k6 = statistics.median(timed_ms(torch, lambda: fa.fused_compute(
                    case_p, ids, cnt1, selfnz, **kw), reps=10))
                k7 = statistics.median(timed_ms(torch, lambda: fa.fused_scatter(
                    case_p, upd, ids, cnt1, plan=plan, ring=k), reps=10))
                n = int(count)
                t = ids[:n].long()
                th, tw = plan.tile
                tr0, tc0 = t // plan.grid[1] * th, t % plan.grid[1] * tw
                near = ((tr0 <= k) | (tr0 + th >= N - k) | (tc0 <= k)
                        | (tc0 + tw >= N - k))
                n_taps = (int(((selfnz[:n] != 0) & ~near).sum())
                          if taps is not None else 0)
                plain6 = plain7 = None
                if frac == 0.05:
                    plain6 = statistics.median(timed_ms(
                        torch, lambda: fa.fused_compute_plain(
                            case_p, ids, count, selfnz, 0.1, plan, (0, 0),
                            (N, N), MOORE_OFFSETS, torch.float32, k, k,
                            taps), reps=1))
                    plain7 = statistics.median(timed_ms(
                        torch, lambda: fa.fused_scatter_plain(
                            case_p, upd, ids, count, plan, k), reps=3))
                k67_time[(frac, k)] = {"k6_ms": k6, "k7_ms": k7, "count": n,
                                       "tap_lanes": n_taps,
                                       "k6_plain_ms": plain6,
                                       "k7_plain_ms": plain7}
                # the run's kernel time: each pass charged with K6 + K7 at
                # its own depth (n // k passes at depth k, then n % k at
                # depth 1), both timed on the run's starting state
                one = k67_time[(frac, 1)]
                q, r = divmod(ACTIVE_STEPS, k)
                kernel_ms = q * (k6 + k7) + r * (one["k6_ms"] + one["k7_ms"])
                row.update(k6_ms=k6, k7_ms=k7, kernel_ms_run=kernel_ms,
                           kernel_ms_per_pass=kernel_ms / passes,
                           host_share=1.0 - kernel_ms / run_ms)
                del case_p, upd, anyf
            active_rows.append(row)
            extra = (f", pass {row['pass_ms']:.3f} ms vs K6+K7 "
                     f"{row['kernel_ms_per_pass']:.3f} ms (host share "
                     f"{row['host_share']:.3f})"
                     if "k6_ms" in row else "")
            print(f"active {impl} substeps={sub} frac={frac}: "
                  f"{row['cell_updates_per_s']:.4e} cell-updates/s, "
                  f"mean active {row['mean_active_fraction']:.4f}, "
                  f"fallback {row['fallback_steps']}, passes {passes}, "
                  f"launches {ran}{extra}, peak "
                  f"{peak / 2 ** 30:.2f} GiB, conserved "
                  f"(|d|={row['conservation_error']:.3e})", flush=True)
            del out
            torch.cuda.empty_cache()
        if frac == FRACS[0]:
            # gate: one step, active == active_fused k=1 == plain dense
            one = {impl: model.execute(space, mt.SerialExecutor(impl),
                                       steps=1)[0].values["value"]
                   for impl in ("active", "active_fused", "xla")}
            ok = (torch.equal(one["active"], one["xla"])
                  and torch.equal(one["active_fused"], one["xla"]))
            print(f"one-step gate {N}x{N} f32 frac={frac}: active == "
                  f"active_fused == xla bitwise: {ok}", flush=True)
            check(ok, "one-step bitwise gate failed")
            del one
        del space
        torch.cuda.empty_cache()

    # gate: a dense nonzero state falls back every step, K1 serving it
    x = 1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)
    space = mt.CellularSpace.create(N, N, 0.0, dtype="float32").with_values(
        {"value": x})
    reset_counts()
    fb_out, fb_rep = model.execute(space, mt.SerialExecutor("active"),
                                   steps=3)
    fb_k1 = fs.launches()
    pl_out, _ = model.execute(space, mt.SerialExecutor("pallas"), steps=3)
    ok = (fb_rep.backend_report["fallback_steps"] == 3 and fb_k1 == 3
          and torch.equal(fb_out.values["value"], pl_out.values["value"]))
    print(f"fallback gate {N}x{N} f32 dense: fallback_steps="
          f"{fb_rep.backend_report['fallback_steps']}/3, K1 launches "
          f"{fb_k1}, equal to pallas substeps=1 bitwise: {ok}", flush=True)
    check(ok, "fallback gate failed")
    del x, space, fb_out, pl_out
    torch.cuda.empty_cache()

    # gate: f64, 1024², activity 0.02, 12 steps, three ways bitwise
    v64 = workload(np, 1024, 1024, 0.02, SEED).astype(np.float64)
    space = mt.CellularSpace.create(1024, 1024, 0.0, dtype="float64")
    space = space.with_values({"value": torch.from_numpy(v64).to(dev)})
    three = {impl: model.execute(space, mt.SerialExecutor(impl),
                                 steps=12)[0].values["value"]
             for impl in ("active", "active_fused", "xla")}
    ok = (torch.equal(three["active"], three["xla"])
          and torch.equal(three["active_fused"], three["xla"]))
    print(f"f64 gate 1024x1024 frac=0.02, 12 steps: active == active_fused "
          f"== xla bitwise: {ok}", flush=True)
    check(ok, "f64 three-way bitwise gate failed")
    del three, space

    # -- 6. the composed path at full width -----------------------------------
    composed = {}
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        noise = torch.rand((N, N), generator=gen, device=dev)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname)
        space = space.with_values({"value": (1.0 + 0.1 * noise).to(tdt)})
        del noise
        ex = mt.SerialExecutor("composed", substeps=sub)
        reset_counts()
        out, rep = model.execute(space, ex, steps=STEPS)
        launched = cs.launches()
        br = rep.backend_report
        check(rep.impl == "composed" and br["composed_k"] == sub,
              f"composed path ran {rep.impl!r} k={br.get('composed_k')}")
        check(launched == STEPS // sub == br["launches"],
              f"{dname}: K3 launched {launched} times, expected "
              f"{STEPS // sub}")
        check(bool(torch.isfinite(out.values["value"]).all()),
              "composed output not finite")
        run_ms = timed_ms(torch, lambda: ex.run_model(model, space, STEPS),
                          reps=3)
        med = statistics.median(run_ms)
        composed[dname] = {"substeps": sub, "k": sub, "steps": STEPS,
                           "launches": launched, "variant": br["variant"],
                           "conservation_error": rep.conservation_error(),
                           "run_ms_median": med, "run_ms_all": run_ms,
                           "cell_updates_per_s": N * N * STEPS / (med / 1e3)}
        print(f"composed path {dname} {N}x{N} substeps={sub}: conserved "
              f"(|d|={rep.conservation_error():.3e}), launches={launched}, "
              f"{med / STEPS:.4f} ms/step, "
              f"{composed[dname]['cell_updates_per_s']:.4e} cell-updates/s",
              flush=True)
        del out, space
        torch.cuda.empty_cache()

    # the composed path against the K1 path on 512², 64 steps. One call of
    # each approximates the same k exact steps: K1's iterated steps round
    # about 10 times per cell-step, K3's tap pass (2k+1)² times, each at
    # most one f32 ulp of the scale, so one call differs by at most
    # t = ((2k+1)² + 10k) · 2^-23 · scale (plus one bf16 ulp of the scale
    # at bf16); carried through the calls with the per-call gain G as in
    # phase 4.
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((512, 512), generator=gen,
                                    device=dev)).to(tdt)
        sp = mt.CellularSpace.create(512, 512, 1.0, dtype=dname)
        sp = sp.with_values({"value": x})
        a, _ = model.execute(sp, mt.SerialExecutor("composed", substeps=sub),
                             steps=STEPS)
        b, _ = model.execute(sp, mt.SerialExecutor("pallas", substeps=sub),
                             steps=STEPS)
        got32, want32 = a.values["value"].float(), b.values["value"].float()
        d = float((got32 - want32).abs().max())
        scale = float(want32.abs().max())
        g = gain(lambda o, s: fs.dense_step_plain(o, 0.1, MOORE_OFFSETS, s),
                 sub)
        t = ((2 * sub + 1) ** 2 + 10 * sub) * 2.0 ** -23 * scale
        if tdt == torch.bfloat16:
            t += bf16_ulp(scale)
        tol = t * sum(g ** i for i in range(STEPS // sub))
        composed[dname].update(vs_k1_512_err=d, vs_k1_512_tol=tol)
        print(f"composed path 512x512 {dname} substeps={sub} vs K1 path, "
              f"{STEPS} steps: max_abs_err={d:.3e} (atol {tol:g})",
              flush=True)
        check(d <= tol, f"{dname}: the composed path disagrees with K1's")

    # K3 per call: kernel, plain, bound and conv2d with the same table
    for dname, k in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device=dev)).to(tdt)
        y = torch.empty_like(x)
        k_ms = statistics.median(timed_ms(
            torch, lambda: cs.composed_dense_step(x, 0.1, k, out=y),
            reps=10))
        p_ms = statistics.median(timed_ms(
            torch, lambda: cs.composed_dense_step_plain(x, 0.1, k), reps=1,
            warmup=0))
        taps = torch.from_numpy(np.array(cs.composed_taps(
            0.1, MOORE_OFFSETS, k))).to(dev, tdt).view(1, 1, 2 * k + 1,
                                                    2 * k + 1)
        x4 = x.view(1, 1, N, N)
        l_ms = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, taps, padding=k),
            reps=5))
        b_ms, b_by = larger(2 * N * N * x.element_size() / HBM_BYTES_PER_S
                            * 1e3,
                            cs.interior_flops((N, N), k) / F32_FLOPS * 1e3)
        composed[dname].update(ms=k_ms, plain_ms=p_ms, library_ms=l_ms,
                               bound_ms=b_ms, bound_by=b_by)
        print(f"K3 {dname} {N}x{N} k={k}: kernel {k_ms:.4f} ms/call, plain "
              f"{p_ms:.3f} ms, conv2d {2 * k + 1}x{2 * k + 1} {l_ms:.4f} "
              f"ms, bound {b_ms:.4f} ms ({b_by}), {k_ms / k:.4f} ms per "
              f"step", flush=True)
        del x, y, x4
        torch.cuda.empty_cache()

    # -- 6b. the field path at full width (BASELINE config 4) ----------------
    model4 = mt.Model(config4_flows(mt))
    rng = np.random.default_rng(SEED)
    base4 = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (N4, N4)).astype(
        np.float32)).to(dev) for n in ("a", "b")}
    field_rows = []
    k4_run = {}  # dtype -> the launches of its deepest-substeps run
    for dname, sub in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                       ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0},
                                        dtype=dname)
        space = space.with_values({n: t.to(tdt) for n, t in base4.items()})
        ex = mt.SerialExecutor(step_impl="pallas", substeps=sub)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        out, rep = model4.execute(space, ex, steps=STEPS)  # raises on drift
        ran = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        check(rep.impl == "pallas" and rep.backend_report["kernel"]
              == "K4 field_stencil", f"field path ran {rep.impl!r} "
              f"{rep.backend_report}")
        check(ran["field_stencil"] == STEPS // sub
              == rep.backend_report["launches"],
              f"{dname} substeps={sub}: K4 launched {ran['field_stencil']} "
              f"times, expected {STEPS // sub}")
        check(sum(ran.values()) == ran["field_stencil"],
              f"another kernel ran on the field path: {ran}")
        for n in ("a", "b"):
            v = out.values[n]
            check(tuple(v.shape) == (N4, N4) and v.dtype == tdt
                  and bool(torch.isfinite(v).all()),
                  "field-path output has the wrong shape or dtype, or is "
                  "not finite")
        run_ms = timed_ms(torch, lambda: ex.run_model(model4, space, STEPS),
                          reps=3)
        med = statistics.median(run_ms)
        row = {"dtype": dname, "substeps": sub, "steps": STEPS,
               "launches": ran["field_stencil"],
               "conservation_error": rep.conservation_error(),
               "run_ms_median": med, "run_ms_all": run_ms,
               "step_ms": med / STEPS,
               "cell_updates_per_s": N4 * N4 * STEPS / (med / 1e3),
               "peak_mem_bytes": peak, "held_before_run_bytes": held,
               "run_peak_above_held_bytes": peak - held}
        field_rows.append(row)
        k4_run[dname] = row
        print(f"field path {dname} {N4}x{N4} substeps={sub}: conserved "
              f"(|d|={row['conservation_error']:.3e}), impl=pallas (K4), "
              f"launches={row['launches']}, {row['step_ms']:.4f} ms/step, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s, peak "
              f"{peak / 2 ** 30:.2f} GiB ({(peak - held) / 2 ** 30:.2f} GiB "
              f"above the {held / 2 ** 30:.2f} GiB held before the run)",
              flush=True)
        del out, space
        torch.cuda.empty_cache()
    space = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0})
    space = space.with_values(base4)
    _, rep = model4.execute(space, mt.SerialExecutor("auto", substeps=8),
                            steps=8)
    check(rep.impl == "pallas" and rep.backend_report["kernel"]
          == "K4 field_stencil", f"SerialExecutor('auto') ran {rep.impl!r}")
    del space

    # 512², 64 steps, against the plain version chained call by call
    small = {n: torch.from_numpy(rng.uniform(0.5, 2.0, (512, 512)).astype(
        np.float32)).to(dev) for n in ("a", "b")}
    for dname, sub in (("float32", 1), ("float32", 8), ("bfloat16", 1),
                       ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = {n: t.to(tdt) for n, t in small.items()}
        sp = mt.CellularSpace.create(512, 512, {"a": 1.0, "b": 1.0},
                                     dtype=dname).with_values(x)
        a, _ = model4.execute(sp, mt.SerialExecutor("pallas", substeps=sub),
                              steps=STEPS)
        want = x
        for _ in range(STEPS // sub):
            want = k4.field_step_plain(want, model4.flows, nsteps=sub)
        ok = all(torch.equal(a.values[n], want[n]) for n in ("a", "b"))
        d = max(float((a.values[n].float() - want[n].float()).abs().max())
                for n in ("a", "b"))
        print(f"field path 512x512 {dname} substeps={sub} vs chained plain "
              f"K4, {STEPS} steps: bitwise={ok} (max_abs_err={d:.3e})",
              flush=True)
        check(ok, f"{dname} substeps={sub}: the field path is not bitwise "
                  "the plain version")

    # K4 per call: kernel, plain version, bound; the xla step as context
    field_timing = {}
    for dname, ns in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = {n: t.to(tdt) for n, t in base4.items()}
        step = k4.PallasFieldStep((N4, N4), model4.flows, dtype=tdt,
                                  nsteps=ns, names=("a", "b"))
        bufs = [x, {n: torch.empty_like(t) for n, t in x.items()}]

        def kernel_call():
            step(bufs[0], out=bufs[1])
            bufs.reverse()

        k_ms = statistics.median(timed_ms(torch, kernel_call, reps=10))
        p_ms = statistics.median(timed_ms(
            torch, lambda: k4.field_step_plain(x, model4.flows, nsteps=ns),
            reps=3))
        sp = mt.CellularSpace.create(N4, N4, {"a": 1.0, "b": 1.0},
                                     dtype=dname).with_values(x)
        sx = model4.make_step(sp, impl="xla")
        x_ms = statistics.median(timed_ms(torch, lambda: sx(x), reps=3))
        b_ms, b_by = field_bound_ms(step.program, (N4, N4),
                                    x["a"].element_size(), ns, 8)
        field_timing[dname] = {
            "nsteps": ns, "ms": k_ms, "plain_ms": p_ms, "xla_step_ms": x_ms,
            "bound_ms": b_ms, "bound_by": b_by, "tile_h": step.tile_h,
            "program": step.program.describe(),
            "program_flops": step.program.flops()}
        print(f"K4 {dname} {N4}x{N4} ns={ns}: kernel {k_ms:.4f} ms/call, "
              f"plain {p_ms:.3f} ms, xla step {x_ms:.3f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), tile height {step.tile_h}, "
              f"{k_ms / ns:.4f} ms per step", flush=True)
        del x, bufs, sp, sx
        torch.cuda.empty_cache()
    del base4, small

    # -- 6c. ensemble serving at full width (bench.py's serving row) ----------
    from mpi_model_tpu_torch.ensemble.batch import (complete_ensemble,
                                                    launch_ensemble,
                                                    padding_scenarios)

    base5 = np.random.default_rng(SEED).uniform(0.5, 2.0, (N5, N5)).astype(
        np.float32)
    lanes5 = [torch.from_numpy(np.roll(base5, 7 * i, axis=0)).to(dev)
              for i in range(B5)]
    del base5
    lane_rates = [0.1 * (1 + 0.05 * i / (B5 - 1)) for i in range(B5)]
    model01 = mt.Model(mt.Diffusion(0.1))

    def lane_spaces(dname):
        tdt = getattr(torch, dname)
        return [mt.CellularSpace(
            {"value": lane.to(tdt)}, N5, N5) for lane in lanes5]

    # gates on lanes 0 and 7, before any timing
    gates = []
    sp32 = lane_spaces("float32")
    models5 = [mt.Model(mt.Diffusion(r)) for r in lane_rates]
    out = models5[0].execute_many(sp32, models=models5, steps=STEPS5)
    for i in (0, B5 - 1):
        want, wrep = models5[i].execute(sp32[i], mt.SerialExecutor("xla"),
                                        steps=STEPS5)
        ok = (torch.equal(out[i][0].values["value"], want.values["value"])
              and out[i][1].final_total == wrep.final_total)
        gates.append({"gate": f"xla float32 lane {i} == serial xla",
                      "bitwise": ok})
        check(ok, f"ensemble xla lane {i} is not bitwise its serial run")
    del out
    # Against serial K1 at the same substeps: where no TPU tile of K5 takes
    # the closed form (every tile at 4096²), both run the one exact path of
    # stencil_common.cuh in the same order, so the lanes are held bit for
    # bit; otherwise within one bf16 ulp of the scale for the whole run.
    for dname in ("float32", "bfloat16"):
        sps = sp32 if dname == "float32" else lane_spaces(dname)
        for sub in (1, 8):
            closed = bool(k5.interior_mask(
                (N5, N5), k5.pipeline_block((N5, N5), sub), sub).any())
            out = model01.execute_many(
                sps, steps=STEPS5,
                executor=mt.EnsembleExecutor("pipeline", substeps=sub))
            for i in (0, B5 - 1):
                got = out[i][0].values["value"].float()
                refs = [(f"serial pallas substeps={sub}",
                         mt.SerialExecutor("pallas", substeps=sub),
                         None if not closed else "ulp")]
                if dname == "float32":
                    refs.append(("serial xla", mt.SerialExecutor("xla"),
                                 "rel"))
                for what, ex, rule in refs:
                    want = model01.execute(sps[i], ex, steps=STEPS5)[0]
                    w = want.values["value"].float()
                    err = float((got - w).abs().max())
                    if rule is None:
                        tol = 0.0
                        ok = torch.equal(out[i][0].values["value"],
                                         want.values["value"])
                    elif rule == "ulp":
                        tol = bf16_ulp(float(w.abs().max()))
                        ok = err <= tol
                    else:
                        tol = 1e-6 * STEPS5
                        ok = bool(((got - w).abs()
                                   <= tol + tol * w.abs()).all())
                    gates.append({"gate": f"pipeline {dname} substeps={sub} "
                                          f"lane {i} vs {what}",
                                  "max_abs_err": err, "tol": tol,
                                  "bitwise": rule is None, "ok": ok})
                    print(f"ensemble gate: pipeline {dname} substeps={sub} "
                          f"lane {i} vs {what}: max_abs_err={err:.3e} "
                          f"({'bit for bit' if rule is None else f'tol {tol:g}'})",
                          flush=True)
                    check(ok, f"pipeline lane {i} ({dname}, substeps={sub}) "
                              f"disagrees with {what}")
                    del want, w
                del got
            del out
        del sps
    del sp32
    torch.cuda.empty_cache()

    # the serving rows: EnsembleService, one counted dispatch, 5 timed
    ens_rows = []
    for impl, dname, sub in (("pipeline", "float32", 1),
                             ("pipeline", "float32", 8),
                             ("pipeline", "bfloat16", 1),
                             ("pipeline", "bfloat16", 8),
                             ("xla", "float32", 1), ("xla", "bfloat16", 1)):
        spaces = lane_spaces(dname)
        models = ([model01] * B5 if impl == "pipeline"
                  else [mt.Model(mt.Diffusion(r)) for r in lane_rates])
        svc = mt.EnsembleService(models[0], steps=STEPS5, impl=impl,
                                 substeps=sub, buckets=mt.buckets_for(B5),
                                 retry="solo")

        def dispatch():
            tickets = [svc.submit(s, model=m)
                       for s, m in zip(spaces, models)]
            return [svc.result(t) for t in tickets]

        dispatch()  # the runner's build
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        reset_counts()
        res = dispatch()
        ran = kernel_launches()
        peak = torch.cuda.max_memory_allocated()
        want_k5 = (STEPS5 // sub + STEPS5 % sub) if impl == "pipeline" else 0
        check(ran["pipeline_stencil"] == want_k5
              and sum(ran.values()) == want_k5,
              f"ensemble {impl} {dname} substeps={sub}: launches {ran}, "
              f"expected {want_k5} of K5 and nothing else")
        for sp, rep in res:
            v = sp.values["value"]
            check(tuple(v.shape) == (N5, N5) and v.dtype == getattr(
                torch, dname) and bool(torch.isfinite(v).all()),
                "ensemble output has the wrong shape or dtype, or is not "
                "finite")
            check(rep.impl == impl, f"ensemble row ran {rep.impl!r}")
        cons = max(rep.conservation_error() for _, rep in res)
        del res
        times = timed_ms(torch, dispatch, reps=5)
        med = statistics.median(times)
        st = svc.stats()
        check(st["runner_builds"] == 1
              and st["runner_cache_hits"] == st["dispatches"] - 1
              and st["batch_occupancy"] == 1.0,
              f"ensemble {impl} {dname}: runner cache or occupancy off: "
              f"{st}")
        row = {"impl": impl, "dtype": dname, "substeps": sub, "B": B5,
               "grid": [N5, N5], "steps": STEPS5,
               "k5_launches_per_dispatch": ran["pipeline_stencil"],
               "launches": ran, "conservation_error": cons,
               "dispatch_ms_median": med, "dispatch_ms_all": times,
               "scenarios_per_s": B5 / (med / 1e3),
               "cell_updates_per_s": B5 * N5 * N5 * STEPS5 / (med / 1e3),
               "batch_occupancy": st["batch_occupancy"],
               "runner_builds": st["runner_builds"],
               "runner_cache_hits": st["runner_cache_hits"],
               "compile_cache_hit_rate": st["compile_cache_hit_rate"],
               "peak_mem_bytes": peak, "held_before_bytes": held,
               "peak_above_held_bytes": peak - held}
        ens_rows.append(row)
        print(f"ensemble {impl} {dname} B={B5} {N5}x{N5} substeps={sub}: "
              f"{row['scenarios_per_s']:.2f} scenarios/s, "
              f"{row['cell_updates_per_s']:.4e} cell-updates/s (dispatch "
              f"{med:.3f} ms), K5 launches/dispatch "
              f"{row['k5_launches_per_dispatch']}, occupancy "
              f"{row['batch_occupancy']}, builds {row['runner_builds']}, "
              f"hits {row['runner_cache_hits']} (rate "
              f"{row['compile_cache_hit_rate']:.3f}), peak "
              f"{(peak - held) / 2 ** 30:.2f} GiB above the "
              f"{held / 2 ** 30:.2f} GiB held", flush=True)
        if impl == "pipeline" and sub == 8:
            row["profile"] = profile_dispatch(torch, dispatch, med)
            print_profile(f"ensemble pipeline {dname} substeps=8 dispatch",
                          row["profile"])
        del spaces, svc
        torch.cuda.empty_cache()

    # the sequential baselines: B serial runs of the same lanes, through
    # the executor alone and (K1) through Model.execute, which also takes
    # the totals, conservation check and report a served scenario carries
    for dname in ("float32", "bfloat16"):
        spaces = lane_spaces(dname)
        for impl, sub, via in (("xla", 1, "run_model"),
                               ("pallas", 8, "run_model"),
                               ("pallas", 8, "execute")):
            ex = mt.SerialExecutor(impl, substeps=sub)

            def sequential():
                for s in spaces:
                    if via == "execute":
                        model01.execute(s, ex, steps=STEPS5)
                    else:
                        ex.run_model(model01, s, STEPS5)

            med = statistics.median(timed_ms(torch, sequential, reps=3))
            name = (f"{B5} x SerialExecutor({impl!r}, substeps={sub})"
                    + (" via Model.execute" if via == "execute" else ""))
            row = {"baseline": name, "via": via,
                   "impl": impl, "dtype": dname, "substeps": sub,
                   "B": B5, "steps": STEPS5, "ms": med,
                   "scenarios_per_s": B5 / (med / 1e3),
                   "cell_updates_per_s": B5 * N5 * N5 * STEPS5 / (med / 1e3)}
            if impl == "pallas" and dname == "float32":
                row["profile"] = profile_dispatch(torch, sequential, med)
                print_profile(f"sequential {name} {dname}", row["profile"])
            ens_rows.append(row)
            print(f"sequential {row['baseline']} {dname}: "
                  f"{row['scenarios_per_s']:.2f} scenarios/s, "
                  f"{row['cell_updates_per_s']:.4e} cell-updates/s "
                  f"({med:.3f} ms)", flush=True)
        del spaces
        torch.cuda.empty_cache()

    # a partial batch: 3 scenarios pad to the 4-bucket; the pad lane stays 0
    sp3 = lane_spaces("float32")[:3]
    svc = mt.EnsembleService(model01, steps=STEPS5, impl="pipeline",
                             substeps=8, buckets=mt.buckets_for(B5))
    ts = [svc.submit(s) for s in sp3]
    svc.flush()
    res3 = [svc.result(t) for t in ts]
    st = svc.stats()
    check(st["batch_occupancy"] == 0.75
          and svc.scheduler.dispatch_log[-1]["bucket"] == 4
          and len(res3) == 3, f"B=3 did not pad to the 4-bucket: {st}")
    psp, pmod = padding_scenarios(model01, sp3[0], 1)
    fl = launch_ensemble(model01, sp3 + psp, models=[model01] * 3 + pmod,
                         executor=mt.EnsembleExecutor("pipeline", substeps=8),
                         steps=STEPS5, count=3)
    complete_ensemble(fl)
    pad_zero = float(fl.out[0]["value"][3].abs().max()) == 0.0
    check(pad_zero, "the pad lane of a padded pipeline batch is not zero")
    print(f"ensemble B=3 into the 4-bucket: occupancy "
          f"{st['batch_occupancy']}, pad lane identically zero: {pad_zero}",
          flush=True)
    del sp3, svc, res3, fl, psp
    torch.cuda.empty_cache()

    # K5 per call on the path's batch: kernel, plain, bound, conv2d x ns
    k5_time = {}
    for dname in ("float32", "bfloat16"):
        tdt = getattr(torch, dname)
        x = torch.stack(lanes5).to(tdt)
        y = torch.empty_like(x)
        w = torch.ones((1, 1, 3, 3), device=dev, dtype=tdt)
        x4 = x.view(B5, 1, N5, N5)
        l1 = statistics.median(timed_ms(
            torch, lambda: torch.nn.functional.conv2d(x4, w, padding=1),
            reps=10))
        for ns in (8, 1):
            bufs = [x, y]

            def kernel_call():
                k5.pipeline_dense_step(bufs[0], 0.1, nsteps=ns, out=bufs[1])
                bufs.reverse()

            k_ms = statistics.median(timed_ms(torch, kernel_call, reps=20))
            p_ms = statistics.median(timed_ms(
                torch, lambda: k5.pipeline_step_plain(x, 0.1, MOORE_OFFSETS,
                                                      ns), reps=3))
            blk = k5.pipeline_block((N5, N5), ns)
            inner = int(k5.interior_mask((N5, N5), blk, ns).sum())
            b_ms, b_by = k5_bound_ms(B5, (N5, N5), x.element_size(), ns, 8,
                                     inner)
            k5_time[(dname, ns)] = {
                "nsteps": ns, "ms": k_ms, "plain_ms": p_ms,
                "library_ms": l1 * ns, "conv2d_one_ms": l1,
                "bound_ms": b_ms, "bound_by": b_by, "block": list(blk),
                "interior_cells_per_lane": inner}
            print(f"K5 {dname} B={B5} {N5}x{N5} ns={ns}: kernel {k_ms:.4f} "
                  f"ms/call, plain {p_ms:.3f} ms, conv2d 3x3 x {ns} "
                  f"{l1 * ns:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
                  f"block {blk}, {inner} interior cells a lane)", flush=True)
        del x, y, x4, bufs
        torch.cuda.empty_cache()
    for row in ens_rows:
        if row.get("impl") == "pipeline" and "dispatch_ms_median" in row:
            kt = k5_time[(row["dtype"], row["substeps"])]
            kernel_ms = row["k5_launches_per_dispatch"] * kt["ms"]
            row.update(k5_ms_per_call=kt["ms"], k5_ms_per_dispatch=kernel_ms,
                       host_share=1.0 - kernel_ms / row["dispatch_ms_median"])
            print(f"ensemble pipeline {row['dtype']} substeps="
                  f"{row['substeps']}: dispatch {row['dispatch_ms_median']:.3f}"
                  f" ms against {kernel_ms:.3f} ms of K5 (host share "
                  f"{row['host_share']:.3f})", flush=True)
    del lanes5

    # -- 7. CLI and the reference run ------------------------------------------
    from mpi_model_tpu_torch.cli import main as cli_main
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--impl=pallas", "--substeps=8", "--steps=8", "--json"])
    check(rc == 0, "the CLI run failed")
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--impl=active_fused", "--substeps=8", "--steps=8",
                   "--blob=0.05", "--json"])
    check(rc == 0, "the active_fused CLI run failed")
    rc = cli_main(["run", "--flow=coupled", "--channels=2", "--impl=pallas",
                   f"--dimx={N4}", f"--dimy={N4}", "--substeps=8",
                   "--steps=8", "--json"])
    check(rc == 0, "the coupled (K4) CLI run failed")
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N5}", f"--dimy={N5}",
                   f"--ensemble={B5}", "--ensemble-impl=pipeline",
                   "--substeps=8", f"--steps={STEPS5}", "--json"])
    check(rc == 0, "the ensemble (K5) CLI run failed")

    for steps in (1, 50):
        space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64")
        ref_model = mt.Model(mt.Exponencial(
            mt.Cell(19, 3, mt.Attribute(99, 2.2)), 0.1), 10.0, 0.2)
        out, rep = ref_model.execute(space, steps=steps)
        got = out.values["value"].cpu().numpy()
        want = oracle.reference_run_np(steps=steps)
        diff = float(abs(got - want).max())
        total = float(out.total("value"))
        print(f"reference run steps={steps}: impl={rep.impl} sum={total!r} "
              f"source cell={got[19, 3]!r} max_abs_err vs oracle={diff:.3e} "
              f"bitwise={bool((got == want).all())}", flush=True)
        check(diff <= 1e-12 and abs(total - 10000.0) <= 1e-9,
              "reference run disagrees with the oracle")
        if steps == 1:
            check(abs(got[19, 3] - 0.78) <= 1e-12, "source cell is not 0.78")

    # -- 8. result lines ------------------------------------------------------
    def row_of(impl, sub, frac):
        return next(r for r in active_rows if r["impl"] == impl
                    and r["substeps"] == sub and r["frac"] == frac)

    entries = [{
        "name": f"K1 fused_stencil {dname}",
        "route": "cuda",
        "source": "mpi_model_tpu_torch/csrc/fused_stencil.cu",
        "replaces": "mpi_model_tpu/ops/pallas_stencil.py:526",
        "launches": results[dname]["launches"],
        "max_abs_err": main_err[dname],
        "ms": timings[dname]["ms"],
        "plain_ms": timings[dname]["plain_ms"],
        "bound_ms": timings[dname]["bound_ms"],
        "bound_by": timings[dname]["bound_by"],
        "library_ms": timings[dname]["library_ms"],
        "shape": [N, N], "dtype": dname, "nsteps": timings[dname]["nsteps"],
        "main_path": results[dname],
    } for dname in ("float32", "bfloat16")]
    for dname in ("float32", "bfloat16"):
        c = composed[dname]
        entries.append({
            "name": f"K3 composed_stencil {dname}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/composed_stencil.cu",
            "replaces": "mpi_model_tpu/ops/pallas_stencil.py:526",
            "launches": c["launches"], "max_abs_err": k3_err[dname],
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"],
            "shape": [N, N], "dtype": dname, "k": c["k"],
            "main_path": {key: c[key] for key in (
                "steps", "substeps", "variant", "conservation_error",
                "run_ms_median", "cell_updates_per_s", "vs_k1_512_err")},
        })
    for k, sub in ((1, 1), (8, 8)):
        kt = k67_time[(0.05, k)]
        row = row_of("active_fused", sub, 0.05)
        b_bytes = 2 * kt["count"] * 128 * 128 * 4 / HBM_BYTES_PER_S * 1e3
        b_ops = (kt["tap_lanes"] * 128 * 128 * 2 * (2 * k + 1) ** 2
                 / F32_FLOPS * 1e3)
        b_ms, b_by = larger(b_bytes, b_ops)
        entries.append({
            "name": f"K6 fused_compute float32 k={k}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/fused_active.cu",
            "replaces": "mpi_model_tpu/ops/pallas_active.py:293",
            "launches": row["launches"]["fused_compute"],
            "max_abs_err": k6_err[k],
            "ms": kt["k6_ms"], "plain_ms": kt["k6_plain_ms"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": [N, N], "dtype": "float32", "k": k, "frac": 0.05,
            "active_tiles": kt["count"], "tap_lanes": kt["tap_lanes"],
        })
    kt = k67_time[(0.05, 1)]
    row = row_of("active_fused", 1, 0.05)
    entries.append({
        "name": "K7 fused_scatter float32",
        "route": "cuda",
        "source": "mpi_model_tpu_torch/csrc/fused_active.cu",
        "replaces": "mpi_model_tpu/ops/pallas_active.py:343",
        "launches": row["launches"]["fused_scatter"],
        "max_abs_err": 0.0,
        "ms": kt["k7_ms"], "plain_ms": kt["k7_plain_ms"],
        "bound_ms": 2 * kt["count"] * 128 * 128 * 4 / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None,
        "shape": [N, N], "dtype": "float32", "frac": 0.05,
        "active_tiles": kt["count"],
    })
    for dname in ("float32", "bfloat16"):
        t = field_timing[dname]
        entries.append({
            "name": f"K4 field_stencil {dname}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/field_stencil.cu",
            "replaces": "mpi_model_tpu/ops/pallas_stencil.py:1380",
            "launches": k4_run[dname]["launches"],
            "max_abs_err": k4_err[dname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": [N4, N4], "dtype": dname, "nsteps": t["nsteps"],
            "xla_step_ms": t["xla_step_ms"], "main_path": k4_run[dname],
        })
    for dname in ("float32", "bfloat16"):
        t = k5_time[(dname, 8)]
        row = next(r for r in ens_rows if r.get("impl") == "pipeline"
                   and r["dtype"] == dname and r.get("substeps") == 8
                   and "dispatch_ms_median" in r)
        entries.append({
            "name": f"K5 pipeline_stencil {dname}",
            "route": "cuda",
            "source": "mpi_model_tpu_torch/csrc/pipeline_stencil.cu",
            "replaces": "mpi_model_tpu/ops/pallas_stencil.py:728",
            "launches": row["k5_launches_per_dispatch"],
            "max_abs_err": k5_err[dname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": [B5, N5, N5], "dtype": dname, "nsteps": 8,
            "nsteps1": k5_time[(dname, 1)], "main_path": row,
        })
    kernels = {"kernels": entries}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card_line, "kind": kind, **kernels,
         "active_rows": active_rows, "k67_times": {
             f"{f}/k={k}": v for (f, k), v in k67_time.items()},
         "composed": composed, "field_rows": field_rows,
         "field_timing": field_timing, "ensemble_gates": gates,
         "ensemble_rows": ens_rows,
         "k5_times": {f"{d}/ns={n}": v for (d, n), v in k5_time.items()},
         "count_read_us": sync_us,
         "build": _build.build_info, "cases": cases,
         "seconds": time.perf_counter() - t_start}, indent=1))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
