#!/usr/bin/env python3
"""K4/K4-halo design measurements on one NVIDIA GPU (they need a card).

    python3 k4_variants.py                    # the window-row variants
    python3 k4_variants.py --parent DIR       # and an older checkout's K4
    python3 k4_variants.py --only as_is,c4bf_as_is     # some of them

Variants: config 4's generated unit (``ops/field_codegen.py``, the body in
``csrc/field_stencil.cuh``) built with one window height (ROWS) and with
the instance's launch bounds asking for two blocks an SM (128 registers a
thread) or one (255), and with the walk's rows fenced one, two or four at a
time, or not at all, in place of eight (``kFenceRows``); and a
one-written-channel program (``Coupled`` alone, its modulator in shared memory)
likewise. ``as_is`` is the unit the port builds, at the rows
``window_rows`` picks. The ``c4bf_`` variants are config 4 with bf16
interior math (``compute_dtype=bfloat16``, the ``mm_field_cbf16_*`` entry
points, two launches: the f32 walk off the bf16 rectangle, the paired walk
in it): the paired walk the port builds (at the rows ``window_rows16``
picks), the same at window heights from 32 to 112 rows and with its launch
bounds asking for one block an SM or three, and each launch alone (wrong on
purpose: the other launch's cells stay NaN). Each variant is built with the
port's nvcc flags, one nvcc per variant in parallel, against a copy of the
``csrc`` headers with its choices patched (``SETTINGS``; a text no longer
in the header stops the tool, naming it).

Timed in turns, two rounds: K4 on an 8192² grid (f32 nsteps 1 and 8, bf16
1 and 16; a variant whose rows are fewer than ``min_rows`` skips that
depth) and K4-halo on shard (1, 1) of a 2×2 mesh of it (f32 nsteps 8).
Before each launch the outputs are filled with NaN, and after it they are
held to the plain version (``field_step_plain``, ``field_halo_step_plain``)
bit for bit; so each variant's correctness is its own. The ptxas register
and spill lines of each variant are kept.

``--parent DIR`` times ``PallasFieldStep`` on config 4 at the same shapes
(f32 and bf16 interior math) in another checkout of the repository (for
example the parent commit unpacked with ``git archive``: its bf16 interior
math is the earlier walk, the f32 walk with every result rounded, in one
kernel) and in this one, each in a process of its own, in the order
parent, this, this, parent.

Times are CUDA events, warm, medians of 10 calls. Everything goes to
``chiprun_out/k4_variants.json``; the last line is the card's
``nvidia-smi --query-gpu=name,power.limit`` output.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 8192
CASES = (("float32", 1), ("float32", 8), ("bfloat16", 1), ("bfloat16", 16))
#: the header's choices a variant may change (each text must be in it)
SETTINGS = {"blocks": "constexpr int kTwoBlockValues = 112;",
            "fence": "constexpr int kFenceRows = 8;",
            "blocks16": "  return P::kOut * ROWS / 2 <= P::kTwoBlockWords ? "
                        "2 : 1;",
            "near_launch": "  if (cover != mm::kAll) {",
            "bf16_launch": "  if (err == 0 && cover != mm::kNone) {"}
#: what a variant sets them to
PATCHES = {("blocks", 2): "constexpr int kTwoBlockValues = 100000;",
           ("blocks", 1): "constexpr int kTwoBlockValues = 0;",
           **{("fence", f): f"constexpr int kFenceRows = {f};"
              for f in (0, 1, 2, 4)},
           **{("blocks16", b): f"  return {b};" for b in (1, 2, 3)},
           ("near_launch", "off"): "  if (false) {",
           ("bf16_launch", "off"): "  if (false) {"}
#: variant -> (program, window rows or None for the port's own, the
#: header's choices it changes, the interior math: "f32" or "bf16"). A
#: bf16 variant's rows are the paired walk's (its second launch).
VARIANTS = {
    "as_is": ("config4", None, {}),
    "config4_fence1": ("config4", None, {"fence": 1}),
    "config4_fence4": ("config4", None, {"fence": 4}),
    "config4_no_fence": ("config4", None, {"fence": 0}),
    "config4_rows32_2": ("config4", 32, {"blocks": 2}),
    "config4_rows40_2": ("config4", 40, {"blocks": 2}),
    "config4_rows48_1": ("config4", 48, {"blocks": 1}),
    "config4_rows64_1": ("config4", 64, {"blocks": 1}),
    "coupled_as_is": ("coupled", None, {}),
    "coupled_fence1": ("coupled", None, {"fence": 1}),
    "coupled_rows32_2": ("coupled", 32, {"blocks": 2}),
    "coupled_rows48_2": ("coupled", 48, {"blocks": 2}),
    "coupled_rows64_2": ("coupled", 64, {"blocks": 2}),
    "coupled_rows64_1": ("coupled", 64, {"blocks": 1}),
    "c4bf_as_is": ("config4", None, {}, "bf16"),
    # every row count at two blocks an SM (112 rows hold 112 pair words,
    # past the unit's kTwoBlockWords)
    **{f"c4bf_rows{r}": ("config4", r, {"blocks16": 2}, "bf16")
       for r in (32, 48, 64, 80, 96, 112)},
    **{f"c4bf_b{b}": ("config4", None, {"blocks16": b}, "bf16")
       for b in (1, 3)},
    # wrong on purpose (the other launch's cells stay NaN): each launch's
    # time alone
    "c4bf_paired_only": ("config4", None, {"near_launch": "off"}, "bf16"),
    "c4bf_near_only": ("config4", None, {"bf16_launch": "off"}, "bf16"),
}
VARIANTS = {k: v if len(v) == 4 else (*v, "f32") for k, v in
            VARIANTS.items()}

# one process's K4/K4-halo times on config 4 through the package's wrappers
TIMER = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
import mpi_model_tpu_torch as mt
from mpi_model_tpu_torch.ops import field_stencil as k4
from mpi_model_tpu_torch.parallel.halo import exchange_ring
N, CASES = %d, %r
flows = [mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
         mt.Diffusion(0.2, "b")]
def tm(fn):
    fn(); torch.cuda.synchronize(); out = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)
gen = torch.Generator(device="cuda").manual_seed(7)
res = {}
for dname, ns in CASES:
    dt = getattr(torch, dname)
    x = {n: (0.5 + 1.5 * torch.rand((N, N), generator=gen,
                                    device="cuda")).to(dt) for n in "ab"}
    y = {n: torch.empty_like(t) for n, t in x.items()}
    for cd, what in ((None, ""), (torch.bfloat16, " bf16-interior")):
        step = k4.PallasFieldStep((N, N), flows, dtype=dt, nsteps=ns,
                                  compute_dtype=cd)
        res[f"K4{what} {dname} ns={ns}"] = tm(lambda: step(x, out=y))
        if (dname, ns) == ("float32", 8):
            h = N // 2
            g = {n: [[t[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
                      for j in range(2)] for i in range(2)]
                 for n, t in x.items()}
            v = {n: g[n][1][1] for n in g}
            r = {n: exchange_ring(g[n], 1, 1, ns) for n in g}
            o = {n: torch.empty_like(t) for n, t in v.items()}
            hs = k4.PallasFieldStep((h, h), flows, nsteps=ns,
                                    compute_dtype=cd)
            res[f"K4-halo{what} {dname} ns={ns} shard"] = tm(
                lambda: hs.halo(v, r, (h, h), (N, N), out=o))
    del x, y
    torch.cuda.empty_cache()
print(json.dumps(res))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def programs(mt):
    return {"config4": [mt.Diffusion(0.1, "a"), mt.Coupled(0.05, "a", "b"),
                        mt.Diffusion(0.2, "b")],
            "coupled": [mt.Coupled(0.05, "a", "b")]}


def variant_plan(torch, k4, codegen, mt, name: str):
    """The variant's plan: its program's, with the variant's rows for every
    depth and dtype (the port's own unit for ``None``)."""
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS

    prog_name, rows, _, compute = VARIANTS[name]
    plan = k4.plan_field(programs(mt)[prog_name], ("a", "b"), (N, N),
                         torch.float32, 1, compute_dtype=(
                             torch.bfloat16 if compute == "bf16" else None))
    if rows is None:
        return plan
    n_out, n_mod = len(plan.program.outputs), len(k4.modulators(
        plan.program))
    if compute == "f32":
        unit = codegen.unit_source(plan.program, MOORE_OFFSETS,
                                   {"f32": (rows,), "bf16": (rows,)})
        return dataclasses.replace(plan, rows=rows, unit=unit)
    unit = codegen.unit_source(plan.program, MOORE_OFFSETS,
                               k4.unit_rows(n_out, n_mod), plan.program16,
                               {"f32": (rows,), "bf16": (rows,)})
    return dataclasses.replace(plan, unit=unit)


def build(name: str, plan, out_dir: Path, build_mod) -> dict:
    """nvcc the variant's unit against a patched copy of the headers."""
    _, _, changes, _ = VARIANTS[name]
    inc = out_dir / f"{name}_inc"
    shutil.rmtree(inc, ignore_errors=True)
    shutil.copytree(build_mod.CSRC, inc)
    hdr = inc / "field_stencil.cuh"
    text = hdr.read_text()
    for key, line in SETTINGS.items():
        if line not in text:
            raise RuntimeError(f"variant {name}: {line!r} is not in the "
                               "header")
        if key in changes:
            text = text.replace(line, PATCHES[(key, changes[key])])
    hdr.write_text(text)
    src = out_dir / f"{name}.cu"
    src.write_text(plan.unit.text)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([build_mod.find_nvcc(), *build_mod.unit_flags(),
                           "-I", str(inc), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return {"library": str(lib), "ptxas": ptxas}


def time_variants(torch, mt, k4, plans: dict, built: dict) -> list[dict]:
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel.halo import exchange_ring

    libs = {}
    for name, info in built.items():
        lib = ctypes.CDLL(info["library"])
        entry = "mm_field_cbf16" if VARIANTS[name][3] == "bf16" else \
            "mm_field"
        for key in ("f32", "bf16"):
            fn = getattr(lib, f"{entry}_{key}")
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = (lib, entry)

    def tm(fn):
        if fn() != 0:
            raise RuntimeError("a variant's launch failed")
        torch.cuda.synchronize()
        out = []
        for _ in range(10):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            out.append(a.elapsed_time(b))
        return statistics.median(out)

    rows_out = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    h = N // 2
    for dname, ns in CASES:
        dtype = getattr(torch, dname)
        key = k4.dtype_key(dtype)
        x = {n: (0.5 + 1.5 * torch.rand((N, N), generator=gen,
                                        device="cuda")).to(dtype)
             for n in ("a", "b")}
        y = {n: torch.empty_like(t) for n, t in x.items()}
        g = {n: [[t[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
                  for j in range(2)] for i in range(2)] for n, t in x.items()}
        sv = {n: g[n][1][1] for n in g}
        # the launch arguments hold raw pointers: the rings stay referenced
        rings = {n: exchange_ring(g[n], 1, 1, ns) for n in g}
        ys = {n: torch.empty_like(t) for n, t in sv.items()}
        want, want_halo = {}, {}
        for pname, flows in programs(mt).items():
            for compute, cd in (("f32", None), ("bf16", torch.bfloat16)):
                if pname != "config4" and compute == "bf16":
                    continue
                want[pname, compute] = k4.field_step_plain(
                    x, flows, nsteps=ns, compute_dtype=cd)
                if (dname, ns) == ("float32", 8):
                    want_halo[pname, compute] = k4.field_halo_step_plain(
                        sv, rings, (h, h), (N, N), flows, nsteps=ns,
                        compute_dtype=cd)
        rect = fs.kernel_rect((N, N), dtype, None, ns, torch.bfloat16)
        hrect = fs.kernel_rect((h, h), dtype, None, ns, torch.bfloat16,
                               (h, h), (N, N))

        for rnd in range(2):
            for name, (lib, entry) in libs.items():
                pname, fixed, _, compute = VARIANTS[name]
                plan = plans[name]
                if fixed is not None and fixed < k4.min_rows(ns):
                    continue
                shape_of = (len(plan.program.outputs),
                            len(k4.modulators(plan.program)), ns,
                            x["a"].element_size())
                rows = k4.window_rows(*shape_of)
                rows16 = None
                if compute == "f32":
                    rows = fixed or rows
                else:
                    rows16 = fixed or k4.window_rows16(*shape_of)
                    if k4.smem_bytes16(*shape_of[:2], rows16, shape_of[3]) \
                            > k4.SMEM_LIMIT:
                        continue
                p = dataclasses.replace(plan, rows=rows, rows16=rows16)
                order = k4.kernel_channels(p.program)
                outs = [y[n] for n in p.program.outputs]
                call = k4.pack_call(p, ns, [x[n] for n in order], outs,
                                    rect=rect)
                fn = getattr(lib, f"{entry}_{key}")
                for t in outs:
                    t.fill_(float("nan"))
                row = {"variant": name, "round": rnd, "dtype": dname,
                       "nsteps": ns, "rows": rows, "rows16": rows16,
                       "compute": compute,
                       "k4_ms": tm(lambda: fn(ctypes.addressof(call),
                                              stream))}
                ok = all(torch.equal(y[n], want[pname, compute][n])
                         for n in p.program.outputs)
                row["agrees"] = {"k4": ok}
                if want_halo:
                    houts = [ys[n] for n in p.program.outputs]
                    hcall = k4.pack_call(p, ns, [sv[n] for n in order], houts,
                                         [rings[n] for n in order], (h, h),
                                         (N, N), ns, hrect)
                    for t in houts:
                        t.fill_(float("nan"))
                    row["k4_halo_ms"] = tm(lambda: fn(
                        ctypes.addressof(hcall), stream))
                    row["agrees"]["k4_halo"] = all(
                        torch.equal(ys[n], want_halo[pname, compute][n])
                        for n in p.program.outputs)
                rows_out.append(row)
                print(f"round {rnd} {name:18s} {dname:9s} ns={ns:2d} "
                      f"rows={rows}"
                      + (f"/{rows16}" if rows16 else "")
                      + f": K4 {row['k4_ms']:.4f} ms"
                      + (f", K4-halo shard {row['k4_halo_ms']:.4f} ms"
                         if "k4_halo_ms" in row else "")
                      + f" (agrees: {row['agrees']})", flush=True)
        del x, y, g, sv, rings, ys, want, want_halo
        torch.cuda.empty_cache()
    return rows_out


def time_tree(path: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMER % (N, CASES)],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K4/K4-halo to time in turns")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    names = list(VARIANTS) if args.only is None else args.only.split(",")
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        print(f"k4_variants: unknown variants {unknown}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("k4_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import mpi_model_tpu_torch as mt
    from mpi_model_tpu_torch.ops import _build
    from mpi_model_tpu_torch.ops import field_codegen as codegen
    from mpi_model_tpu_torch.ops import field_stencil as k4

    out_dir = HERE / "chiprun_out"
    var_dir = out_dir / "k4_variants"
    var_dir.mkdir(parents=True, exist_ok=True)
    plans = {n: variant_plan(torch, k4, codegen, mt, n) for n in names}
    with ThreadPoolExecutor(len(names)) as pool:
        futs = {n: pool.submit(build, n, plans[n], var_dir, _build)
                for n in names}
        built = {n: f.result() for n, f in futs.items()}
    for name, info in built.items():
        print(f"{name}: " + "; ".join(info["ptxas"]), flush=True)
    result = {"card": card_line(),
              "variants": time_variants(torch, mt, k4, plans, built),
              "ptxas": {n: i["ptxas"] for n, i in built.items()}}
    if args.parent is not None:
        turns = []
        for who in ("parent", "this", "this", "parent"):
            path = args.parent.resolve() if who == "parent" else HERE
            times = time_tree(path)
            turns.append({"tree": who, **times})
            print(f"{who}: " + ", ".join(f"{k} {v:.4f} ms"
                                         for k, v in times.items()),
                  flush=True)
        result["parent_turns"] = turns
    shutil.rmtree(var_dir, ignore_errors=True)
    (out_dir / "k4_variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
