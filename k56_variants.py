#!/usr/bin/env python3
"""K6 and K5 design measurements on one NVIDIA GPU (they need a card).

    python3 k56_variants.py                   # the kernels' variants
    python3 k56_variants.py --parent DIR      # and an older checkout's
    python3 k56_variants.py --only k6_as_is,k5_as_is   # some of them

Variants: ``csrc/fused_active.cu`` (K6) and ``csrc/pipeline_stencil.cu``
(K5) as they are, and copies of each with one choice changed. K6: the
launch layout (a block per lane on a grid of the capacity, or 2, 4 or 8
persistent blocks an SM striding over the live lanes), the tap sum's run of
outputs a thread (4 or 16 in place of 8) and the exact walk's window rows
(32 or 64 in place of 48), and the walk's rows unfenced. K5: the window
rows (48 at every depth, or 64 at every depth, in place of 64 above two
steps for Moore), the window's output columns (128 columns, each window
inside one 128-column strip, in place of 256 - 2n clipped to the TPU
tile), the walk's rows fenced 4 or 16 at a time or not at all (in place of
8; ``csrc/exact_walk.cuh``), and one block an SM (255 registers) in place
of two; K6's tap sum inlined into the kernel (in place of one function an
instance, called), its staged-row loop unrolled by two, its staged chunk
held to 112, 56, 32 or 24 KB (in place of 40: other blocks an SM and L1
sizes, fewer or more halo rows staged), one row of outputs a thread (in
place of two), and K6 built for three blocks an SM (85 registers) in place
of two. Every patch is checked against the file before anything is built:
a variant whose text is no longer there stops the tool and is named. Each variant is built with the
port's nvcc flags, one nvcc per variant in parallel, and loaded in place of
the port's library, so it runs through the port's own wrappers (with the
wrapper's ``WALK_ROWS`` / ``TAP_SEG`` / ``TAP_ROWS`` / ``TAP_SMEM`` set as
the variant has them).

Timed in turns, two rounds: K6 on ``bench.py::_active_workload``'s 16384²
state at activity 0.05 (128² tiles, f32, k = 1, k = 8 with the tap table,
and k = 8 without it, every lane on the exact path, as the ensemble's
``active_fused`` lanes run), K6 at k = 1 on shard (1, 1) of a 2×2 mesh of
it (8192², ring 1, its ghost flags); K5 on 8 lanes of 4096² (f32 and bf16, nsteps 1 and 8). Before
each launch the output is filled with NaN, and after it the output is
compared bit for bit with the plain version (``fused_compute_plain``,
``pipeline_step_plain``), so each variant's correctness is its own. The
ptxas register and spill lines of each variant are kept.

``--parent DIR`` times the same calls through the package's wrappers in
another checkout of the repository (for example the parent commit unpacked
with ``git archive``) and in this one, each in a process of its own, in
the order parent, this, this, parent.

Times are CUDA events around 4 back-to-back calls (the wrapper's host time
overlapped), warm, medians of 10. Everything goes to
``chiprun_out/k56_variants.json``; the last line is the card's
``nvidia-smi --query-gpu=name,power.limit`` output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 16384
N5, B5 = 4096, 8
FRAC = 0.05
SEED = 1234
LAYOUT = "const int blocks = g.K;  // a block a lane"
SEG = "constexpr int kTapSeg = 8;"
ROWS6 = "constexpr int kRows = 48;"
ROWS5 = "mm_exact::kMooreCodes && p.nsteps > 2"
OW5 = "w.ow = kWinW - 2 * p.nsteps;"
BOUNDS5 = "__launch_bounds__(32 * kWarps, 2)"
WALK = "exact_walk.cuh"
TAP_FN = "__device__ __noinline__ int tap_lane("
BLOCKS6 = "constexpr int kMinBlocks = sizeof(T) == 8 ? 1 : 2;"
TAP_ROWS = "constexpr int kTapRows = 2;"
TAP_LOOP = "#pragma unroll 1\n        for (int q = 0; q < NT + R - 1; ++q) {"
FENCE = "kFenceRows = 8;"
def persist(per_sm: int) -> str:
    """K6's grid as ``per_sm`` persistent blocks an SM (the kernel's lane
    loop strides over the live lanes)."""
    return ("int sms = 0;\n  cudaDeviceGetAttribute(&sms, "
            "cudaDevAttrMultiProcessorCount, 0);\n  const int blocks = "
            f"g.K < {per_sm} * sms ? g.K : {per_sm} * sms;")


# each variant: (source stem, [(text, replacement)], wrapper settings)
VARIANTS = {
    "k6_as_is": ("fused_active", [], {}),
    "k6_persist2": ("fused_active", [(LAYOUT, persist(2))], {}),
    "k6_persist4": ("fused_active", [(LAYOUT, persist(4))], {}),
    "k6_persist8": ("fused_active", [(LAYOUT, persist(8))], {}),
    "k6_seg4": ("fused_active", [(SEG, "constexpr int kTapSeg = 4;")],
                {"TAP_SEG": 4}),
    "k6_seg16": ("fused_active", [(SEG, "constexpr int kTapSeg = 16;")],
                 {"TAP_SEG": 16}),
    "k6_rows32": ("fused_active", [(ROWS6, "constexpr int kRows = 32;")],
                  {"WALK_ROWS": 32}),
    "k6_rows64": ("fused_active", [(ROWS6, "constexpr int kRows = 64;")],
                  {"WALK_ROWS": 64}),
    "k5_as_is": ("pipeline_stencil", [], {}),
    "k5_rows48": ("pipeline_stencil",
                  [(ROWS5, "mm_exact::kMooreCodes && p.nsteps > 8")], {}),
    "k5_rows64": ("pipeline_stencil",
                  [(ROWS5, "mm_exact::kMooreCodes && p.nsteps > 0")], {}),
    "k5_cols128": ("pipeline_stencil", [(OW5, "w.ow = 128;")], {}),
    "k5_fence0": ("pipeline_stencil", [(WALK, FENCE, "kFenceRows = 0;")],
                  {}),
    "k5_fence4": ("pipeline_stencil", [(WALK, FENCE, "kFenceRows = 4;")],
                  {}),
    "k5_fence16": ("pipeline_stencil", [(WALK, FENCE, "kFenceRows = 16;")],
                   {}),
    "k5_one_block": ("pipeline_stencil",
                     [(BOUNDS5, "__launch_bounds__(32 * kWarps, 1)")], {}),
    "k6_fence0": ("fused_active", [(WALK, FENCE, "kFenceRows = 0;")], {}),
    "k6_tap_inline": ("fused_active", [(TAP_FN, TAP_FN.replace(
        "__noinline__", "__forceinline__"))], {}),
    "k6_tap_unroll2": ("fused_active", [(TAP_LOOP, TAP_LOOP.replace(
        "unroll 1", "unroll 2"))], {}),
    "k6_tap_smem112k": ("fused_active", [], {"TAP_SMEM": 112 * 1024}),
    "k6_tap_smem56k": ("fused_active", [], {"TAP_SMEM": 56 * 1024}),
    "k6_tap_smem32k": ("fused_active", [], {"TAP_SMEM": 32 * 1024}),
    "k6_tap_smem24k": ("fused_active", [], {"TAP_SMEM": 24 * 1024}),
    "k6_tap_rows1": ("fused_active", [(TAP_ROWS, TAP_ROWS.replace(
        "= 2;", "= 1;"))], {"TAP_ROWS": 1}),
    "k6_blocks3": ("fused_active", [(BLOCKS6, BLOCKS6.replace(": 2;",
                                                              ": 3;"))], {}),
}

# one process's K6/K5 times through the package's own wrappers
TIMER = r"""
import json, statistics, sys
sys.path.insert(0, %r)
sys.path.insert(0, ".")
import torch
import k56_variants as kv
from mpi_model_tpu_torch.ops import fused_active as fa
from mpi_model_tpu_torch.ops import pipeline_stencil as ps
res = {}
for name, case in kv.cases(torch).items():
    res[name] = kv.median_ms(torch, case["call"])
print(json.dumps(res))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def median_ms(torch, fn, reps: int = 10, calls: int = 4) -> float:
    """Median device ms of one call: CUDA events around ``calls``
    back-to-back calls (so the wrapper's host time overlaps the device's
    work on the call before), divided by ``calls``."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / calls)
    return statistics.median(out)


def workload(np, h: int, w: int, frac: float, seed: int):
    """``bench.py::_active_workload``: zeros with a centred square of side
    ``round(h * sqrt(frac))`` of ``U(0.5, 2.0)`` f32 values."""
    side = max(1, int(round(h * math.sqrt(frac))))
    v = np.zeros((h, w), np.float32)
    r0, c0 = (h - side) // 2, (w - side) // 2
    v[r0:r0 + side, c0:c0 + side] = np.random.default_rng(seed).uniform(
        0.5, 2.0, (side, side)).astype(np.float32)
    return v


def cases(torch) -> dict:
    """Each timed call, with its output and a function giving the plain
    version's: ``{name: {"call", "out", "plain"}}``. The calls go through
    the port's wrappers (whichever library is loaded)."""
    import numpy as np

    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.ops import pipeline_stencil as ps

    dev = torch.device("cuda")
    out = {}
    v = torch.from_numpy(workload(np, N, N, FRAC, SEED)).to(dev)

    def k6_case(padded, plan, ids, count, selfnz, origin, gshape, k, ring,
                use_taps=True):
        taps = fa._fused_taps(0.1, MOORE_OFFSETS, k) if use_taps else None
        cnt1 = count.reshape(1).to(torch.int32)
        upd = torch.empty((plan.capacity,) + plan.tile, device=dev)
        anyf = torch.empty(plan.capacity, dtype=torch.int32, device=dev)
        kw = dict(rate=0.1, plan=plan, origin=origin, global_shape=gshape,
                  offsets=MOORE_OFFSETS, dtype=torch.float32, k=k, ring=ring,
                  taps=taps, upd=upd, anyf=anyf)
        n = min(max(int(count), 1), plan.capacity)
        return {"call": lambda: fa.fused_compute(padded, ids, cnt1, selfnz,
                                                 **kw),
                "out": lambda: upd[:n],
                "fill": lambda: upd.fill_(float("nan")),
                "plain": lambda: fa.fused_compute_plain(
                    padded, ids, count, selfnz, 0.1, plan, origin, gshape,
                    MOORE_OFFSETS, torch.float32, k, ring, taps)[0][:n]}

    plan = act.plan_for((N, N))
    tmap = act.tile_nonzero_map(v, plan)
    ids, count = act.compact_tile_ids(act.dilate_tile_map(tmap), plan)
    selfnz = tmap.reshape(-1)[ids.long()].to(torch.int32)
    for k in (1, 8):
        padded = torch.nn.functional.pad(v, (k, k, k, k)).contiguous()
        out[f"K6 f32 k={k} {N}^2 at {FRAC}"] = k6_case(
            padded, plan, ids, count, selfnz, (0, 0), (N, N), k, k)
    # k = 8 without the tap table (the ensemble's lanes): every lane exact
    out[f"K6 f32 k=8 exact only {N}^2 at {FRAC}"] = k6_case(
        padded, plan, ids, count, selfnz, (0, 0), (N, N), 8, 8, False)
    # shard (1, 1) of 2x2, ring 1 from its neighbours (the global zero
    # border past the grid), its ghost flags
    h = N // 2
    padded = torch.nn.functional.pad(v, (1, 1, 1, 1))[
        h:h + h + 2, h:h + h + 2].contiguous()
    splan = act.plan_for((h, h))
    stmap = act.tile_nonzero_map(padded[1:-1, 1:-1], splan)
    sids, scount = act.compact_tile_ids(
        act.ghost_flags(padded, splan, stmap), splan)
    sselfnz = stmap.reshape(-1)[sids.long()].to(torch.int32)
    out[f"K6 f32 k=1 shard (1, 1) of 2x2 at {FRAC}"] = k6_case(
        padded, splan, sids, scount, sselfnz, (h, h), (N, N), 1, 1)
    del v
    gen = torch.Generator(device=dev).manual_seed(SEED)
    base = 0.5 + 1.5 * torch.rand((B5, N5, N5), generator=gen, device=dev)
    for dname in ("float32", "bfloat16"):
        x = base.to(getattr(torch, dname))
        y = torch.empty_like(x)
        for ns in (1, 8):
            out[f"K5 {dname} ns={ns} {B5}x{N5}^2"] = {
                "call": (lambda x=x, y=y, ns=ns: ps.pipeline_dense_step(
                    x, 0.1, nsteps=ns, out=y)),
                "out": lambda y=y: y,
                "fill": lambda y=y: y.fill_(float("nan")),
                "plain": (lambda x=x, ns=ns: ps.pipeline_step_plain(
                    x, 0.1, MOORE_OFFSETS, ns))}
    return out


def patched(name: str) -> dict[str, str]:
    """The variant's ``csrc`` files that differ from the checkout's: its
    source, and the walk's header when a change names it (a change is
    ``(text, replacement)`` in the source, or ``(file, text,
    replacement)``)."""
    stem, changes, _ = VARIANTS[name]
    from mpi_model_tpu_torch.ops import _build

    files = {}
    for change in changes:
        fname, old, new = (change if len(change) == 3
                           else (f"{stem}.cu", *change))
        text = files.get(fname, (_build.CSRC / fname).read_text())
        if old not in text:
            raise RuntimeError(f"variant {name}: {old!r} is not in "
                               f"csrc/{fname}")
        files[fname] = text.replace(old, new)
    files.setdefault(f"{stem}.cu", (_build.CSRC / f"{stem}.cu").read_text())
    return files


def build(name: str, files: dict, out_dir: Path, build_mod) -> dict:
    """nvcc the variant's source against a copy of ``csrc`` with its
    files in place."""
    stem = VARIANTS[name][0]
    inc = out_dir / name
    shutil.rmtree(inc, ignore_errors=True)
    shutil.copytree(build_mod.CSRC, inc)
    for fname, text in files.items():
        (inc / fname).write_text(text)
    src = inc / f"{stem}.cu"
    lib = out_dir / f"lib{name}.so"
    t0 = time.perf_counter()
    proc = subprocess.run([build_mod.find_nvcc(), *build_mod.flags_for(stem),
                           "-I", str(inc), "-o", str(lib), str(src)],
                          capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line]
    return {"library": str(lib), "ptxas": ptxas, "seconds": seconds}


def time_variants(torch, built: dict) -> list[dict]:
    from mpi_model_tpu_torch.ops import _build
    from mpi_model_tpu_torch.ops import fused_active as fa

    calls = cases(torch)
    plain = {}
    for name, c in calls.items():
        plain[name] = c["plain"]().clone()
        torch.cuda.synchronize()
    defaults = {"TAP_SEG": fa.TAP_SEG, "WALK_ROWS": fa.WALK_ROWS,
                "TAP_SMEM": fa.TAP_SMEM, "TAP_ROWS": fa.TAP_ROWS}
    rows = []
    for rnd in range(2):
        for vname, info in built.items():
            stem, _, settings = VARIANTS[vname]
            lib = ctypes.CDLL(info["library"])
            _build._libs[stem] = lib
            for key, val in defaults.items():
                setattr(fa, key, settings.get(key, val))
            for cname, c in calls.items():
                if not cname.startswith("K6" if stem == "fused_active"
                                        else "K5"):
                    continue
                c["fill"]()
                c["call"]()
                torch.cuda.synchronize()
                ok = bool(torch.equal(c["out"](), plain[cname]))
                row = {"variant": vname, "round": rnd, "case": cname,
                       "ms": median_ms(torch, c["call"]), "bitwise": ok}
                rows.append(row)
                print(f"round {rnd} {vname:16s} {cname:40s} "
                      f"{row['ms']:.4f} ms bitwise={ok}", flush=True)
            _build._libs.pop(stem, None)
    for key, val in defaults.items():
        setattr(fa, key, val)
    return rows


def time_tree(path: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMER % str(HERE)],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K6/K5 to time in turns")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time "
                         "(default: all)")
    args = ap.parse_args()
    chosen = list(VARIANTS) if args.only is None else args.only.split(",")
    for name in chosen:
        if name not in VARIANTS:
            ap.error(f"no variant {name!r}; the variants: {list(VARIANTS)}")
    import torch

    if not torch.cuda.is_available():
        print("k56_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from mpi_model_tpu_torch.ops import _build

    out_dir = HERE / "chiprun_out"
    var_dir = out_dir / "k56_variants"
    var_dir.mkdir(parents=True, exist_ok=True)
    texts = {n: patched(n) for n in VARIANTS}  # every patch still applies
    with ThreadPoolExecutor(len(chosen)) as pool:
        futs = {n: pool.submit(build, n, texts[n], var_dir, _build)
                for n in chosen}
        built = {n: f.result() for n, f in futs.items()}
    for name, info in built.items():
        print(f"{name}: built in {info['seconds']:.1f} s; "
              + "; ".join(info["ptxas"]), flush=True)
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
    shutil.rmtree(var_dir, ignore_errors=True)
    (out_dir / "k56_variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
