#!/usr/bin/env python3
"""K1/K2 design measurements on one NVIDIA GPU (they need a card).

    python3 k1_variants.py                    # the kernel's variants
    python3 k1_variants.py --parent DIR       # and an older checkout's K1/K2

Variants: ``csrc/fused_stencil.cu`` as it is, and copies of it with one
choice changed (the window rows ``rows_for`` gives each step count, among
them the 96-row window above nsteps 8 that the kernel no longer has; the
edge tiles' exact strips left out, which gives wrong results and measures
what they cost). Every patch is checked against the source before anything
is built: a variant whose text is no longer in the source stops the tool
and is named.
Each variant is built with the port's nvcc flags, one nvcc per variant in
parallel, and timed in turns, two rounds: K1 on a 16384² grid (f32
nsteps 1, 2, 4 and 8, bf16 nsteps 16), K1 on an 8192² grid and K2 on each
8192² shard of a 2×2 mesh of the 16384² grid. Before each of these the
output is filled with NaN, and after it the output is compared bit for bit
with the plain version (``dense_step_plain``; K2's shards with the whole
grid's), so each variant's correctness is its own. The ptxas register and
spill lines of each variant are kept.

``--parent DIR`` times ``pallas_dense_step`` and ``pallas_halo_step`` at
the same shapes in another checkout of the repository (for example the
parent commit unpacked with ``git archive``) and in this one, each in a
process of its own, in the order parent, this, this, parent.

Times are CUDA events, warm, medians of 10 calls. Everything goes to
``chiprun_out/k1_variants.json``; the last line is the card's
``nvidia-smi --query-gpu=name,power.limit`` output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 16384
CASES = (("float32", 1), ("float32", 2), ("float32", 4), ("float32", 8),
         ("bfloat16", 16))
ROWS_FOR = "return !p.moore || p.nsteps <= 2 ? 48 : 64;"
# each variant: (text, replacement) pairs, every occurrence replaced
VARIANTS = {
    "as_is": [],
    "rows_48_to_n8": [(ROWS_FOR,
                       "return !p.moore || p.nsteps <= 8 ? 48 : 64;")],
    "rows_64_from_n1": [(ROWS_FOR, "return !p.moore ? 48 : 64;")],
    "rows_96_above_n8": [
        (ROWS_FOR, "return !p.moore || p.nsteps <= 2 ? 48 "
                   ": (p.nsteps <= 8 ? 64 : 96);"),
        ("__launch_bounds__(32 * NWARPS, 2)",
         "__launch_bounds__(32 * NWARPS, ROWS <= 64 ? 2 : 1)"),
        ("    case 64: return launch<64,",
         "    case 96: return launch<96, true, BF, T>(in, out, H, W, p, q, "
         "stream);\n    case 64: return launch<64,"),
        ("    case 64: return launch_halo<64,",
         "    case 96: return launch_halo<96, true, BF, T>(a, out, p, q, "
         "stream);\n    case 64: return launch_halo<64,")],
    "no_exact_strips": [("    exact_cells(src, out, p, tl, t, work, "
                         "work + piece_floats(p.nsteps));\n", "")],
}

# one process's K1/K2 times through the package's own wrappers
TIMER = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel.halo import exchange_ring
N, CASES = %d, %r
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
    x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device="cuda")).to(
        getattr(torch, dname))
    y = torch.empty_like(x)
    res[f"K1 {dname} ns={ns}"] = tm(
        lambda: fs.pallas_dense_step(x, 0.1, nsteps=ns, out=y))
    h = N // 2
    g = [[x[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
          for j in range(2)] for i in range(2)]
    o = torch.empty_like(g[0][0])
    res[f"K2 {dname} ns={ns} 4 shards"] = sum(
        tm(lambda: fs.pallas_halo_step(g[i][j], r, (i * h, j * h), (N, N),
                                       0.1, nsteps=ns, out=o))
        for i in range(2) for j in range(2)
        for r in [exchange_ring(g, i, j, ns)])
    del x, y, g, o
    torch.cuda.empty_cache()
print(json.dumps(res))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def patched(name: str) -> str:
    """The kernel's source with variant ``name``'s patches applied."""
    src = (HERE / "mpi_model_tpu_torch/csrc/fused_stencil.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, out_dir: Path, build_mod) -> dict:
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([build_mod.find_nvcc(),
                           *build_mod.flags_for("fused_stencil"),
                           "-I", str(build_mod.CSRC), "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return {"library": str(lib), "ptxas": ptxas}


def time_variants(torch, built: dict) -> list[dict]:
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel.halo import exchange_ring

    # fs._step_args: four floats, the steps and neighbourhood, the bf16
    # interior math's flag and rectangle, its two constants
    step = [ctypes.c_float] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float] * 2
    libs = {}
    for name, info in built.items():
        lib = ctypes.CDLL(info["library"])
        for fn in (lib.mm_fused_stencil_f32, lib.mm_fused_stencil_bf16):
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + step
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        for fn in (lib.mm_fused_stencil_halo_f32,
                   lib.mm_fused_stencil_halo_bf16):
            fn.argtypes = [ctypes.c_void_p] * 2 + step + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib

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

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    h = N // 2
    for dname, ns in CASES:
        dtype = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen,
                                    device="cuda")).to(dtype)
        y = torch.empty_like(x)
        xs = x[:h, :h].contiguous()
        ys = torch.empty_like(xs)
        g = [[x[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
              for j in range(2)] for i in range(2)]
        # the launch arguments hold raw pointers: the rings stay referenced
        rings = {(i, j): exchange_ring(g, i, j, ns)
                 for i in range(2) for j in range(2)}
        args = {(i, j): fs.halo_args(g[i][j], ring, (i * h, j * h), (N, N))
                for (i, j), ring in rings.items()}
        sa = fs._step_args(0.1, MOORE_OFFSETS, ns)
        want = fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, ns)
        want_s = fs.dense_step_plain(xs, 0.1, MOORE_OFFSETS, ns)
        suffix = "f32" if dtype == torch.float32 else "bf16"

        def own(fn, out, ref):
            """fn's time, and whether what it wrote into out (filled with
            NaN first) is ref bit for bit."""
            out.fill_(float("nan"))
            ms = tm(fn)
            return ms, torch.equal(out, ref)

        for rnd in range(2):
            for name, lib in libs.items():
                dense = getattr(lib, f"mm_fused_stencil_{suffix}")
                halo = getattr(lib, f"mm_fused_stencil_halo_{suffix}")
                row = {"variant": name, "round": rnd, "dtype": dname,
                       "nsteps": ns}
                row["k1_ms"], ok1 = own(lambda: dense(
                    x.data_ptr(), y.data_ptr(), N, N, *sa, stream), y, want)
                row["k1_half_grid_ms"], ok_s = own(lambda: dense(
                    xs.data_ptr(), ys.data_ptr(), h, h, *sa, stream), ys,
                    want_s)
                row["k2_ms"], ok2 = {}, True
                for (i, j), a in args.items():
                    row["k2_ms"][f"{i},{j}"], ok = own(
                        lambda: halo(ctypes.addressof(a), ys.data_ptr(),
                                     *sa, stream), ys,
                        want[i * h:(i + 1) * h, j * h:(j + 1) * h])
                    ok2 = ok2 and ok
                row["bit_for_bit"] = {"k1": ok1, "k1_half_grid": ok_s,
                                      "k2": ok2}
                rows.append(row)
                print(f"round {rnd} {name:16s} {dname:9s} ns={ns:2d}: K1 "
                      f"{row['k1_ms']:.4f} ms, K1 {h}² "
                      f"{row['k1_half_grid_ms']:.4f}, K2 4 shards "
                      f"{sum(row['k2_ms'].values()):.4f} (bit for bit: K1 "
                      f"{ok1}, K1 {h}² {ok_s}, K2 {ok2})", flush=True)
        del x, y, xs, ys, g, rings, args, want, want_s
        torch.cuda.empty_cache()
    return rows


def time_tree(path: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMER % (N, CASES)],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K1/K2 to time in turns")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from mpi_model_tpu_torch.ops import _build

    out_dir = HERE / "chiprun_out"
    var_dir = out_dir / "k1_variants"
    var_dir.mkdir(parents=True, exist_ok=True)
    sources = {n: patched(n) for n in VARIANTS}
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {n: pool.submit(build, n, src, var_dir, _build)
                for n, src in sources.items()}
        built = {n: f.result() for n, f in futs.items()}
    for name, info in built.items():
        print(f"{name}: " + "; ".join(sorted(set(info["ptxas"]))),
              flush=True)
    result = {"card": card_line(), "variants": time_variants(torch, built),
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
    for p in var_dir.glob("*.so"):
        p.unlink()
    (out_dir / "k1_variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
