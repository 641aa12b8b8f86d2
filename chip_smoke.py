#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # the whole check (needs one card)

Phases (any failure exits non-zero, and no result line is printed):

1. device: requires ``torch.cuda.is_available()``; prints the card's name
   and ``nvidia-smi --query-gpu=name,power.limit``.
2. build: builds every kernel from the sources in this checkout and prints
   the build seconds.
3. K1 against its plain version (``dense_step_plain``) on the card, over
   dtypes, ``nsteps``, neighborhoods and shapes, the main path's included.
   Tolerances: f32 ``atol = rtol = 1e-6 * nsteps`` and bf16 one bf16 ulp of
   the value scale: the two differ only in summation order and nvcc's FMA
   contraction (and, in bf16, in which side of a rounding boundary that
   leaves a value).
4. main path at full width: ``Model(Diffusion(0.1)).execute`` of a 16384²
   grid through ``SerialExecutor(step_impl="pallas")``, 64 steps, f32 with
   ``substeps=8`` and bf16 with ``substeps=16``; conservation checked, the
   kernel's launch counter reset just before and read just after each run.
   The conservation check cannot fail at bf16 (its default tolerance there
   is ~0.9 of the grid total), so the same 64-step run on a 512² grid is
   held, at each dtype, against the plain version chained call by call.
   Then the timing (CUDA events, warm, median) and the CLI entry point.
5. yardstick: one ``torch.nn.functional.conv2d`` 3x3 call over the grid
   (TF32 off); the port never calls it.
6. reference run: the 100×100 ``Exponencial`` run at f64 on the card
   against the port's own ``oracle.reference_run_np``.
7. the kernels line, the card line, and the last line
   ``{"ok": true, "device": {...}}``.
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
STEPS = 64
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


def bound_ms(shape, itemsize: int, nsteps: int, k: int) -> tuple[float, str]:
    """Least time for one K1 call: the grid read once and written once over
    HBM bandwidth, or (k + 3) f32 flops per cell-step (share: multiply and
    divide; gather: k - 1 adds; keep-multiply and add) over the f32 peak,
    whichever is larger."""
    cells = shape[0] * shape[1]
    bytes_ms = 2 * cells * itemsize / HBM_BYTES_PER_S * 1e3
    ops_ms = cells * nsteps * (k + 3) / F32_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def main() -> int:
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
        from mpi_model_tpu_torch.ops import _build
        from mpi_model_tpu_torch.ops import fused_stencil as fs
    except ImportError as e:
        fail(f"the port's package is not importable here: {e}")
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

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in _build.build_info.items():
        print(f"  {name}: {info['seconds']:.2f} s cached={info['cached']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                print(f"    {line.strip()}")

    # -- 3. K1 against its plain version --------------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    shapes = [(13, 17), (13, 160), (24, 256), (400, 1664), (2048, 2048),
              (N, N)]
    neighborhoods = {"moore": MOORE_OFFSETS, "von_neumann": VON_NEUMANN_OFFSETS,
                     "custom": CUSTOM_OFFSETS}
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
                        scale = float(w32.abs().max())
                        tol = 2.0 ** (math.floor(math.log2(scale)) - 7)
                        ok = err <= tol
                        tol_s = f"atol={tol:g} (1 bf16 ulp)"
                    ncases += 1
                    dname = str(dtype).removeprefix("torch.")
                    print(f"K1 {dname} {shape} ns={ns} {hood}: max_abs_err="
                          f"{err:.3e} {tol_s} {'ok' if ok else 'FAIL'}",
                          flush=True)
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

    # -- 4. main path at full width --------------------------------------------
    results = {}
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        noise = torch.rand((N, N), generator=gen, device=dev)
        space = mt.CellularSpace.create(N, N, 1.0, dtype=dname)
        space = space.with_values({"value": (1.0 + 0.1 * noise).to(tdt)})
        del noise
        model = mt.Model(mt.Diffusion(0.1))
        ex = mt.SerialExecutor(step_impl="pallas", substeps=sub)
        fs.reset_launches()
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
    small = mt.CellularSpace.create(512, 512, 1.0, dtype="float32")
    small = small.with_values({"value": 1.0 + 0.1 * torch.rand(
        (512, 512), generator=gen, device=dev)})
    model = mt.Model(mt.Diffusion(0.1))
    a, _ = model.execute(small, mt.SerialExecutor("pallas", substeps=8),
                         steps=STEPS)
    b, _ = model.execute(small, mt.SerialExecutor("xla"), steps=STEPS)
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
    for dname, sub in (("float32", 8), ("bfloat16", 16)):
        tdt = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((512, 512), generator=gen,
                                    device=dev)).to(tdt)
        small = mt.CellularSpace.create(512, 512, 1.0, dtype=dname)
        small = small.with_values({"value": x})
        a, _ = model.execute(small, mt.SerialExecutor("pallas", substeps=sub),
                             steps=STEPS)
        want = x
        for _ in range(STEPS // sub):
            want = fs.dense_step_plain(want, 0.1, MOORE_OFFSETS, sub)
        got32, want32 = a.values["value"].float(), want.float()
        d = float((got32 - want32).abs().max())
        calls = STEPS // sub
        scale = float(want32.abs().max())
        gain = float(fs.dense_step_plain(
            torch.ones((512, 512), device=dev), 0.1, MOORE_OFFSETS, sub).max())
        t = 1e-6 * sub * (1.0 + scale)
        if tdt == torch.bfloat16:
            t += 2.0 ** (math.floor(math.log2(scale)) - 7)
        tol = t * sum(gain ** i for i in range(calls))
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
        # -- 5. yardstick: the 3x3 neighbor sum one step is dominated by
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

    from mpi_model_tpu_torch.cli import main as cli_main
    rc = cli_main(["run", "--flow=diffusion", f"--dimx={N}", f"--dimy={N}",
                   "--impl=pallas", "--substeps=8", "--steps=8", "--json"])
    check(rc == 0, "the CLI run failed")

    # -- 6. reference run at f64 on the card --------------------------------
    for steps in (1, 50):
        space = mt.CellularSpace.create(100, 100, 1.0, dtype="float64")
        model = mt.Model(mt.Exponencial(mt.Cell(19, 3, mt.Attribute(99, 2.2)),
                                        0.1), 10.0, 0.2)
        out, rep = model.execute(space, steps=steps)
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

    # -- 7. result lines ------------------------------------------------------
    # one entry per main-path run: K1 at float32 (substeps=8) and at
    # bfloat16 (substeps=16), each with the launches of its own run
    kernels = {"kernels": [{
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
    } for dname in ("float32", "bfloat16")]}
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card_line, "kind": kind, **kernels}, indent=1))
    print(json.dumps(kernels), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
