#!/usr/bin/env python3
"""K6, K5 and K7 design measurements on one NVIDIA GPU (they need a card).

    python3 k56_variants.py                   # the kernels' variants
    python3 k56_variants.py --parent DIR      # and an older checkout's
    python3 k56_variants.py --only k6_as_is,k5_as_is   # some of them
    python3 k56_variants.py --forms k5_bf16,k7 --parent DIR

Variants: ``csrc/fused_active.cu`` (K6, K7) and ``csrc/pipeline_stencil.cu``
(K5) as they are, and copies of each with one choice changed, in four
forms (``--forms``, default all):

- ``k6``: the launch layout (a block per lane on a grid of the capacity, or
  2, 4 or 8 persistent blocks an SM striding over the live lanes), the tap
  sum's run of outputs a thread (4 or 16 in place of 8) and the exact
  walk's window rows (32 or 64 in place of 48), and the walk's rows
  unfenced; K6's tap sum inlined into the kernel (in place of one function
  an instance, called), its staged-row loop unrolled by two, its staged
  chunk held to 112, 56, 32 or 24 KB (in place of 40: other blocks an SM
  and L1 sizes, fewer or more halo rows staged), one row of outputs a
  thread (in place of two), and K6 built for three blocks an SM (85
  registers) in place of two;
- ``k5`` (f32 interior math): the window rows (48 at every depth, or 64 at
  every depth, in place of 64 above two steps for Moore), the window's
  output columns (128 columns, each window inside one 128-column strip, in
  place of 256 - 2n clipped to the TPU tile), the walk's rows fenced 4 or
  16 at a time or not at all (in place of 8; ``csrc/exact_walk.cuh``), and
  one block an SM (255 registers) in place of two;
- ``k5_bf16`` (``compute_dtype=bfloat16``, Moore row-major: the near launch
  over JAX's near TPU tiles and the paired launch over each lane's
  rectangle): the near launch alone and the paired launch alone (wrong on
  purpose: what each costs), the near launch at 48 or at 64 rows at every
  depth (in place of 64 above two steps), the paired launch at 64 or at 96
  rows at every depth (in place of 96 above two steps);
- ``k7``: the persistent walk over the live rows at 1, 2 or 4 blocks an
  SM (in place of 3), 2 or 8 rows a warp in flight (in place of 4), and
  every element moved alone (in place of 16-byte chunks).

With ``--parent DIR`` the older checkout's ``pipeline_stencil.cu`` and
``fused_active.cu`` (built against its own headers) join each form as a
variant (``k6_parent``, ``k5_parent``, ``k5_bf16_parent``, ``k7_parent``),
timed in the same turns through this checkout's wrappers (the C interfaces
are the same). Every patch is checked against the file before anything is built: a
variant whose text is no longer there stops the tool and is named. Each
variant is built with the port's nvcc flags, one nvcc per variant in
parallel, and loaded in place of the port's library, so it runs through the
port's own wrappers (with the wrapper's ``WALK_ROWS`` / ``TAP_SEG`` /
``TAP_ROWS`` / ``TAP_SMEM`` set as the variant has them).

Timed in turns, two rounds: K6 on ``bench.py::_active_workload``'s 16384²
state at activity 0.05 (128² tiles, f32, k = 1, k = 8 with the tap table,
and k = 8 without it, every lane on the exact path, as the ensemble's
``active_fused`` lanes run), K6 at k = 1 on shard (1, 1) of a 2×2 mesh of
it (8192², ring 1, its ghost flags); K5 on 8 lanes of 4096² (f32 and bf16,
nsteps 1 and 8); K5 with ``compute_dtype=bfloat16`` on 4 lanes of 8192²
and 8 of 4096² (f32 and bf16 storage, nsteps 8 and 1); K7 (f32, ring 1) on
the 16384² states at activity 0.01, 0.05 and 0.15 and on shard (1, 1) of
their 2×2 meshes, its live count and bound (each live tile read and
written once) recorded. Before each launch the output is filled with NaN
(K7: the whole padded state), and after it the output is compared bit for
bit with the plain version (``fused_compute_plain``,
``pipeline_step_plain``, ``fused_scatter_plain``; K7's by its bits), so
each variant's correctness is its own. The ptxas register and spill lines
of each variant are kept.

``--parent DIR`` also times the same calls through the package's wrappers
in the other checkout (for example the parent commit unpacked with ``git
archive``) and in this one, each in a process of its own, in the order
parent, this, this, parent.

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
FRACS = (0.01, 0.05, 0.15)
SEED = 1234
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FORMS = ("k6", "k5", "k5_bf16", "k7")
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
PAIRED16 = ("int paired_rows(const Params& p) { return p.nsteps > 2 ? 96 : "
            "64; }")
SECOND16 = ("  if (err != cudaSuccess || q.empty()) return "
            "static_cast<int>(err);")
FIRST16 = "  if (tiles > 0) {\n    err = rows_for(p) == 64"
K7_BLOCKS = "constexpr int kScatterBlocksPerSM = 3;"
K7_ROWS = "constexpr int kScatterRows = 4;"
K7_WIDE = ("  const int wide = (tw * static_cast<int>(sizeof(E))) % 16 == 0 "
           "&&")
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
    "k5_bf16_as_is": ("pipeline_stencil", [], {}),
    "k5_bf16_near_only": ("pipeline_stencil", [(SECOND16, SECOND16.replace(
        "err != cudaSuccess || q.empty()", "true"))], {}),
    "k5_bf16_paired_only": ("pipeline_stencil", [(FIRST16, FIRST16.replace(
        "tiles > 0", "false"))], {}),
    # the near launch takes rows_for's rows (as the one kernel does)
    "k5_bf16_near48": ("pipeline_stencil",
                       [(ROWS5, "mm_exact::kMooreCodes && p.nsteps > 8")],
                       {}),
    "k5_bf16_near64": ("pipeline_stencil",
                       [(ROWS5, "mm_exact::kMooreCodes && p.nsteps > 0")],
                       {}),
    **{f"k5_bf16_paired{r}": ("pipeline_stencil", [(PAIRED16, PAIRED16.replace(
        "p.nsteps > 2 ? 96 : 64", str(r)))], {}) for r in (64, 96)},
    "k7_as_is": ("fused_active", [], {}),
    **{f"k7_blocks{b}": ("fused_active", [(K7_BLOCKS, K7_BLOCKS.replace(
        "= 3;", f"= {b};"))], {}) for b in (1, 2, 4)},
    **{f"k7_rows{r}": ("fused_active", [(K7_ROWS, K7_ROWS.replace(
        "= 4;", f"= {r};"))], {}) for r in (2, 8)},
    "k7_scalar": ("fused_active", [(K7_WIDE, K7_WIDE.replace(
        "= (tw", "= 0 && (tw"))], {}),
}
#: variants whose results are wrong on purpose (what one launch costs)
WRONG = ("k5_bf16_near_only", "k5_bf16_paired_only")
#: the older checkout's sources (``--parent``), as variants of their forms
PARENTS = {"k5_bf16_parent": "pipeline_stencil", "k5_parent":
           "pipeline_stencil", "k6_parent": "fused_active",
           "k7_parent": "fused_active"}


def form_of(name: str) -> str:
    """A variant's form (``FORMS``), from its name."""
    return next(f for f in ("k5_bf16", "k6", "k5", "k7")
                if name.startswith(f + "_"))


def case_form(case: str) -> str:
    """A timed case's form, from its name."""
    if case.startswith("K5 bf16-interior"):
        return "k5_bf16"
    return {"K6": "k6", "K5": "k5", "K7": "k7"}[case.split(" ")[0]]

# one process's times through the package's own wrappers (the package of
# the working directory; this file's cases, loaded by path)
TIMER = r"""
import importlib.util, json, sys
sys.path.insert(0, ".")
import torch
spec = importlib.util.spec_from_file_location("kv", %r)
kv = importlib.util.module_from_spec(spec)
spec.loader.exec_module(kv)
res = {}
for name, case in kv.cases(torch, %r).items():
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


def cases(torch, forms=FORMS) -> dict:
    """Each timed call of ``forms``, with its output and a function giving
    the plain version's: ``{name: {"call", "out", "fill", "plain"}}`` (and
    K7's ``"bound_ms"``, ``"live"``). The calls go through the port's
    wrappers (whichever library is loaded)."""
    import numpy as np

    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa
    from mpi_model_tpu_torch.ops import pipeline_stencil as ps

    dev = torch.device("cuda")
    out = {}
    if "k5" in forms or "k5_bf16" in forms:
        out.update(k5_cases(torch, forms))
    if "k7" in forms:
        out.update(k7_cases(torch))
    if "k6" not in forms:
        return out
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
    return out


def k5_cases(torch, forms) -> dict:
    """K5's cases: f32 interior math on 8 x 4096² (``k5``), bf16 interior
    math on 4 x 8192² and 8 x 4096² (``k5_bf16``)."""
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import pipeline_stencil as ps

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    batches = ([(None, B5, N5)] if "k5" in forms else []) + (
        [(torch.bfloat16, 4, 2 * N5), (torch.bfloat16, B5, N5)]
        if "k5_bf16" in forms else [])
    for cd, B, side in batches:
        base = 0.5 + 1.5 * torch.rand((B, side, side), generator=gen,
                                      device=dev)
        for dname in ("float32", "bfloat16"):
            x = base.to(getattr(torch, dname))
            y = torch.empty_like(x)
            for ns in ((8, 1) if cd is not None else (1, 8)):
                name = (f"K5 {dname} ns={ns} {B}x{side}^2" if cd is None
                        else f"K5 bf16-interior {dname} ns={ns} "
                             f"{B}x{side}^2")
                out[name] = {
                    "call": (lambda x=x, y=y, ns=ns, cd=cd:
                             ps.pipeline_dense_step(x, 0.1, nsteps=ns, out=y,
                                                    compute_dtype=cd)),
                    "out": lambda y=y: y,
                    "fill": lambda y=y: y.fill_(float("nan")),
                    "plain": (lambda x=x, ns=ns, cd=cd:
                              ps.pipeline_step_plain(
                                  x, 0.1, MOORE_OFFSETS, ns,
                                  compute_dtype=cd))}
        del base
    return out


def k7_cases(torch) -> dict:
    """K7's cases: f32, ring 1, on the 16384² states at ``FRACS`` (their
    dilated active sets) and on shard (1, 1) of their 2x2 meshes (ring 1
    from the neighbours, its ghost flags); the update buffer random. The
    output is the padded state, compared by its bits; ``bound_ms``: each
    live tile read once and written once."""
    import numpy as np

    from mpi_model_tpu_torch.ops import active as act
    from mpi_model_tpu_torch.ops import fused_active as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    out = {}
    h = N // 2
    for frac in FRACS:
        v = torch.from_numpy(workload(np, N, N, frac, SEED)).to(dev)
        full = torch.nn.functional.pad(v, (1, 1, 1, 1))
        for where, padded in (("serial", full.contiguous()),
                              ("shard (1, 1) of 2x2",
                               full[h:h + h + 2, h:h + h + 2].contiguous())):
            shape = (padded.shape[0] - 2, padded.shape[1] - 2)
            plan = act.plan_for(shape)
            tmap = act.tile_nonzero_map(padded[1:-1, 1:-1], plan)
            flags = (act.dilate_tile_map(tmap) if where == "serial"
                     else act.ghost_flags(padded, plan, tmap))
            ids, count = act.compact_tile_ids(flags, plan)
            cnt1 = count.reshape(1).to(torch.int32)
            upd = torch.rand((plan.capacity,) + plan.tile, generator=gen,
                             device=dev)
            live = min(max(int(count), 1), plan.capacity)
            th, tw = plan.tile
            out[f"K7 f32 {where} {N}^2 at {frac}"] = {
                "call": (lambda p=padded, u=upd, i=ids, c=cnt1, pl=plan:
                         fa.fused_scatter(p, u, i, c, plan=pl, ring=1)),
                "out": lambda p=padded: p.view(torch.int32),
                "fill": lambda p=padded: p.fill_(float("nan")),
                "plain": (lambda p=padded, u=upd, i=ids, n=live, pl=plan:
                          fa.fused_scatter_plain(
                              torch.full_like(p, float("nan")), u, i, n, pl,
                              1).view(torch.int32)),
                "live": live,
                "bound_ms": 2 * live * th * tw * 4 / HBM_BYTES_PER_S * 1e3}
        del v, full
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


def build(name: str, stem: str, files: dict, out_dir: Path, build_mod,
          csrc: Path) -> dict:
    """nvcc the variant's source ``stem`` against a copy of ``csrc`` (this
    checkout's, or an older one's) with its files in place."""
    inc = out_dir / name
    shutil.rmtree(inc, ignore_errors=True)
    shutil.copytree(csrc, inc)
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
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    return {"library": str(lib), "ptxas": ptxas, "seconds": seconds,
            "stem": stem}


def time_variants(torch, built: dict, forms) -> list[dict]:
    from mpi_model_tpu_torch.ops import _build
    from mpi_model_tpu_torch.ops import fused_active as fa

    calls = cases(torch, forms)
    plain = {}
    for name, c in calls.items():
        plain[name] = c["plain"]().clone()
        torch.cuda.synchronize()
    defaults = {"TAP_SEG": fa.TAP_SEG, "WALK_ROWS": fa.WALK_ROWS,
                "TAP_SMEM": fa.TAP_SMEM, "TAP_ROWS": fa.TAP_ROWS}
    rows = []
    for rnd in range(2):
        for vname, info in built.items():
            stem = info["stem"]
            settings = VARIANTS[vname][2] if vname in VARIANTS else {}
            lib = ctypes.CDLL(info["library"])
            _build._libs[stem] = lib
            for key, val in defaults.items():
                setattr(fa, key, settings.get(key, val))
            for cname, c in calls.items():
                if case_form(cname) != form_of(vname):
                    continue
                c["fill"]()
                c["call"]()
                torch.cuda.synchronize()
                ok = bool(torch.equal(c["out"](), plain[cname]))
                row = {"variant": vname, "round": rnd, "case": cname,
                       "ms": median_ms(torch, c["call"]), "bitwise": ok,
                       "wrong_on_purpose": vname in WRONG}
                for key in ("live", "bound_ms"):
                    if key in c:
                        row[key] = c[key]
                rows.append(row)
                print(f"round {rnd} {vname:20s} {cname:44s} "
                      f"{row['ms']:.4f} ms bitwise={ok}"
                      + (f" (live {c['live']}, bound {c['bound_ms']:.4f} ms)"
                         if "live" in c else ""), flush=True)
            _build._libs.pop(stem, None)
    for key, val in defaults.items():
        setattr(fa, key, val)
    return rows


def time_tree(path: Path, forms) -> dict:
    proc = subprocess.run([sys.executable, "-c", TIMER % (
        str(HERE / "k56_variants.py"), tuple(forms))], cwd=path,
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K5/K6/K7 to time in turns")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time "
                         "(default: all of the forms)")
    ap.add_argument("--forms", default=",".join(FORMS),
                    help=f"comma-separated forms of {FORMS} to time")
    args = ap.parse_args()
    forms = args.forms.split(",")
    for f in forms:
        if f not in FORMS:
            ap.error(f"no form {f!r}; the forms: {list(FORMS)}")
    chosen = ([n for n in VARIANTS if form_of(n) in forms]
              if args.only is None else args.only.split(","))
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
    jobs = {n: (VARIANTS[n][0], texts[n], _build.CSRC) for n in chosen}
    same = {}  # a parent variant whose source another one already builds
    if args.parent is not None:
        pcsrc = args.parent.resolve() / "mpi_model_tpu_torch" / "csrc"
        first = {}
        for name, stem in PARENTS.items():
            if form_of(name) in forms:
                if stem in first:
                    same[name] = first[stem]
                else:
                    first[stem] = name
                    jobs[name] = (stem, {}, pcsrc)
    with ThreadPoolExecutor(len(jobs)) as pool:
        futs = {n: pool.submit(build, n, stem, files, var_dir, _build, csrc)
                for n, (stem, files, csrc) in jobs.items()}
        built = {n: f.result() for n, f in futs.items()}
    built.update({n: built[o] for n, o in same.items()})
    from chip_smoke import ptxas_summary

    for name, info in built.items():
        print(f"{name}: built in {info['seconds']:.1f} s; " + "; ".join(
            f"{fn}: {regs} registers, {spill}" for fn, regs, spill in
            ptxas_summary("\n".join(info["ptxas"]))
            if "tap_lane" not in fn), flush=True)
    result = {"card": card_line(), "forms": forms,
              "wrong_on_purpose": list(WRONG),
              "variants": time_variants(torch, built, forms),
              "ptxas": {n: i["ptxas"] for n, i in built.items()}}
    if args.parent is not None:
        turns = []
        for who in ("parent", "this", "this", "parent"):
            path = args.parent.resolve() if who == "parent" else HERE
            times = time_tree(path, forms)
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
