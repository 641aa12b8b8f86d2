#!/usr/bin/env python3
"""K3/K3-halo design measurements on one NVIDIA GPU (they need a card).

    python3 k3_variants.py                    # the kernel's variants
    python3 k3_variants.py --parent DIR       # and an older checkout's K3
    python3 k3_variants.py --only as_is,mx16_ring2 --forms mxu_bf16
    python3 k3_variants.py --only as_is,vpu16_rows_80 --forms vpu_bf16

Variants: ``csrc/composed_stencil.cu`` as it is, and copies of it with one
choice changed. The vpu form's f32 walk (the f32 interior math, and the
bf16 interior math's near launch): the window rows of Moore k <= 8 (64
rows instead of 48, at two blocks an SM and at one), the accumulator in
shared memory instead of registers, 48 rows instead of 64 above k = 8, one
block an SM. The mxu form: the warp tile's width (16 columns instead of 32), the
m16 tiles a warp stacks under one set of B fragments (1; bf16 2 instead of
4), the block's warps across, no prefetch of the next row offset's B
fragments, and f32's TF32 split by cvt.rna in place of integer
operations. The mxu form's bf16 interior math (its persistent tile walk):
two staging slots instead of one (windows two tiles ahead), one block an SM
at f32 storage instead of two, the B table read through L1 instead of
resident in shared memory (and so two blocks an SM at bf16 storage). The
vpu form's bf16 interior math (its paired launch over the bf16 rectangle):
window rows 64 or 80 instead of 96 (at both row halos, or 80 at OFF 16
only), the accumulator in the staging buffer instead of registers (at 96
and 64 rows), the bands formed again in a step's second pass
(``walk_step_bf2``) instead of kept, one block an SM, the OFF-2 instance
for k <= 2 left out or at 96 rows instead of 64, and, wrong on purpose,
each of its two launches alone (``vpu16_near_only``,
``vpu16_paired_only``: what each costs). Every patch is checked
against the source before anything is built: a variant whose text is no
longer in the source stops the tool and is named.

Each variant is built with the port's nvcc flags, one nvcc per variant in
parallel, and timed in turns, two rounds: K3 on a 16384² grid (f32 k=8,
bf16 k=16; the vpu forms also f32 k=2, where ``"auto"`` runs vpu) and
K3-halo on each 8192² shard of a 2×2 mesh of it, in each form
(``--forms``: ``vpu``, ``mxu``, and ``vpu_bf16`` / ``mxu_bf16``, the form
with ``compute_dtype=bfloat16``, JAX's blocks, each shard's rectangle at
its origin). Before each launch the output is filled with NaN, and after it the
output is held to the plain version (``composed_dense_step_plain``; the
halo shards to the whole grid's): the vpu form bit for bit, the mxu form
within ``1e-6·k·max|v|`` (f32) or one bf16 ulp of the scale; so each
variant's correctness is its own. The ptxas register and spill lines of
each variant are kept. ``--only`` builds and times some variants.

``--parent DIR`` builds another checkout's ``composed_stencil.cu`` (for
example the parent commit unpacked with ``git archive``) as one more
variant, ``parent``, timed in the same turns through the same C entry
points; and times ``composed_dense_step`` and ``composed_halo_step``
(``variant="vpu"``, in f32 compute and with ``compute_dtype=bfloat16``) at
the same shapes in that checkout and in this one, each in a process of its
own, in the order parent, this, this, parent.

Times are CUDA events, warm, medians of 10 calls. Everything goes to
``chiprun_out/k3_variants.json``; the last line is the card's
``nvidia-smi --query-gpu=name,power.limit`` output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent
N = 16384
CASES = (("float32", 8), ("bfloat16", 16))
# the f32 walk's window (the f32 interior math and the near launch) of
# Moore k <= 8 and of k > 8: vpu_window's rows and the instances launched
K8_ROWS = [("Window{48, 8}", "Window{64, 8}"),
           ("<48, 8, true, T>", "<64, 8, true, T>")]
K16_ROWS = [("Window{64, 16}", "Window{48, 16}"),
            ("<64, 16, true, T>", "<48, 16, true, T>")]
F32_TILE = "KB = 8, KMAX = 8, REL_MIN = 0, MT = 2, WC = 4;"
BF16_TILE = "KB = 16, KMAX = 16, REL_MIN = -8, MT = 4, WC = 4;"
MX16_BLOCKS = "constexpr int kMx16Blocks = sizeof(T) == 4 ? 2 : 1;"
MX16_SMEM = ("return G::table_words(k) * 8 + G::win_bytes(k) + "
             "G::slot_bytes(k);")
# the walk's windows two tiles ahead: two staging slots, filled and read in
# turn, one copy group left in flight
MX16_RING2 = [
    (MX16_SMEM, MX16_SMEM.replace("+ G::slot", "+ 2 * G::slot")),
    ("  T* slot = reinterpret_cast<T*>(at + G::win_bytes(k));\n",
     "  T* const slots = reinterpret_cast<T*>(at + G::win_bytes(k));\n"
     "  const int slot_elems = G::slot_bytes(k) / static_cast<int>(sizeof(T));\n"
     "  int put = 0, get = 0;\n"
     "  T* slot = slots;\n"),
    ("Mx16Window<T>(lr0, lc0, k, g.h, g.w, p.vec), slot);",
     "Mx16Window<T>(lr0, lc0, k, g.h, g.w, p.vec),\n"
     "                    slots + put * slot_elems);"),
    ("    mm::cp_async_commit();  // one group a tile, empty past the last\n",
     "    mm::cp_async_commit();  // one group a tile, empty past the last\n"
     "    put ^= 1;\n"),
    ("  issue(blockIdx.x);\n",
     "  issue(blockIdx.x);\n  issue(ahead);\n  ahead += stride;\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();  // the slot has landed",
     "    slot = slots + get * slot_elems;\n    get ^= 1;\n"
     "    cp_async_wait<1>();\n    __syncthreads();  // the slot has landed"),
]
# the bf16 pass's one-term table read through L1 instead of copied into
# shared memory
MX16_TABLE_LDG = [
    (MX16_SMEM, "return G::win_bytes(k) + G::slot_bytes(k);"),
    ("  const int tid = threadIdx.y * 32 + threadIdx.x;\n"
     "  unsigned char* at = reinterpret_cast<unsigned char*>(smem);\n"
     "  uint2* tab = reinterpret_cast<uint2*>(at);\n"
     "  at += G::table_words(k) * 8;\n",
     "  unsigned char* at = reinterpret_cast<unsigned char*>(smem);\n"),
    ("  for (int e = tid; e < G::table_words(k) / 2; e += 32 * NWARPS) {\n"
     "    mm::cp_async16(tab + 2 * e, frags16 + 2 * e);\n  }\n", ""),
    ("      b[e] = fr[e * 32];", "      b[e] = __ldg(fr + e * 32);"),
    ("mx16_bf16_pass<T>(win, tab, out,", "mx16_bf16_pass<T>(win, frags16, out,"),
]
# the vpu form's paired launch (its window rows at each row halo, where its
# accumulator lives, its blocks an SM, the OFF-2 instance)
ROWS8 = "constexpr int kPairedRows8 = 96;"
ROWS16 = "constexpr int kPairedRows16 = 96;"
ROWS2 = "constexpr int kPairedRows2 = 64;"
BLOCKS16 = "constexpr int kPairedMinBlocks = 2;"
# the paired walk's accumulator in the staging buffer (column j, a row of
# kWinW words a pair, once every column is read into pairs) in place of
# registers
ACC16_SHARED = [
    ("""    // acc = coef_0 * v over the tile's rows, in pairs
    unsigned a2[HT];
    const unsigned c0 = pair(cf16.c[0]);
#pragma unroll
    for (int r = 0; r < HT; ++r) a2[r] = mm::mul_bf2(c0, w[H0 + r]);
""", """    unsigned* as = reinterpret_cast<unsigned*>(stage) + j;
    const unsigned c0 = pair(cf16.c[0]);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < HT; ++r) {
      as[r * mm::kWinW] = mm::mul_bf2(c0, w[H0 + r]);
    }
"""),
    ("              a2[m - H0] = mm::add_bf2(a2[m - H0], mm::mul_bf2(cj, g));",
     "              as[(m - H0) * mm::kWinW] = mm::add_bf2(\n"
     "                  as[(m - H0) * mm::kWinW], mm::mul_bf2(cj, g));"),
    ("      const unsigned a = a2[q];",
     "      const unsigned a = as[q * mm::kWinW];")]
# each launch alone (wrong on purpose: what each costs)
NEAR_ONLY = [("  if (err != cudaSuccess || s.empty()) return static_cast<int>(err);\n"
              "  const Window g16",
              "  if (true) return static_cast<int>(err);\n  const Window g16")]
PAIRED_ONLY = [("  if (near > 0) {\n    if (!p.moore) {\n      err = launch_near",
                "  if (false) {\n    if (!p.moore) {\n      err = launch_near")]


def _rows16(rows8: int, rows16: int) -> list:
    return [(ROWS8, ROWS8.replace("96", str(rows8))),
            (ROWS16, ROWS16.replace("96", str(rows16)))]

# each variant: (text, replacement) pairs, every occurrence replaced
VARIANTS = {
    "as_is": [],
    "vpu_k8_64_rows": K8_ROWS,
    "vpu_k8_64_rows_1_block": K8_ROWS + [
        ("constexpr int kVpuMinBlocks = 2;",
         "constexpr int kVpuMinBlocks = 1;")],
    "vpu_acc_shared": [("constexpr bool kAccShared = false;",
                        "constexpr bool kAccShared = true;")],
    "vpu_k16_48_rows": K16_ROWS,
    "vpu_1_block": [("constexpr int kVpuMinBlocks = 2;",
                     "constexpr int kVpuMinBlocks = 1;")],
    "mxu_n16": [("constexpr int MX_N = 32;", "constexpr int MX_N = 16;")],
    "mxu_mt1": [(F32_TILE, F32_TILE.replace("MT = 2", "MT = 1")),
                (BF16_TILE, BF16_TILE.replace("MT = 4", "MT = 1"))],
    "mxu_bf16_mt2_wc2": [(BF16_TILE, BF16_TILE.replace(
        "MT = 4, WC = 4", "MT = 2, WC = 2"))],
    "mxu_f32_wc2": [(F32_TILE, F32_TILE.replace("WC = 4", "WC = 2"))],
    "mxu_split_by_cvt": [("constexpr bool kSplitByCvt = false;",
                          "constexpr bool kSplitByCvt = true;")],
    "mxu_no_prefetch": [("constexpr bool kMxuPrefetch = true;",
                         "constexpr bool kMxuPrefetch = false;")],
    "mx16_ring2": MX16_RING2,
    "mx16_f32_1_block": [(MX16_BLOCKS, MX16_BLOCKS.replace("? 2 : 1",
                                                           "? 1 : 1"))],
    "mx16_table_ldg": MX16_TABLE_LDG,
    "mx16_table_ldg_bf16_2_blocks": MX16_TABLE_LDG + [
        (MX16_BLOCKS, MX16_BLOCKS.replace("? 2 : 1", "? 2 : 2"))],
    "vpu16_rows_64": _rows16(64, 64),
    "vpu16_rows_80": _rows16(80, 80),
    "vpu16_rows_80_off16": _rows16(96, 80),
    "vpu16_acc_shared": ACC16_SHARED,
    "vpu16_rows_64_acc_shared": _rows16(64, 64) + ACC16_SHARED,
    "vpu16_1_block": [(BLOCKS16, BLOCKS16.replace("2", "1"))],
    "vpu16_recompute_bands": [("      mm::paired_step<ROWS>(\n          w, ex16",
                               "      mm::walk_step_bf2<ROWS>(\n          w, ex16")],
    "vpu16_no_off2": [(ROWS2, ROWS2.replace("64;", "0;"))],
    "vpu16_off2_96": [(ROWS2, ROWS2.replace("64;", "96;"))],
    "vpu16_near_only": NEAR_ONLY,
    "vpu16_paired_only": PAIRED_ONLY,
}
FORMS = ("vpu", "mxu", "vpu_bf16", "mxu_bf16")
#: the cases a form is timed at: (storage, k); k = 2 is where "auto" runs
#: the vpu form
FORM_CASES = {"vpu": CASES + (("float32", 2),),
              "vpu_bf16": CASES + (("float32", 2),),
              "mxu": CASES, "mxu_bf16": CASES}

# one process's K3/K3-halo times through the package's own wrappers
TIMER = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
from mpi_model_tpu_torch.ops import composed_stencil as cs
from mpi_model_tpu_torch.parallel.halo import exchange_ring
N, CASES, VARIANT = %d, %r, %r
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
for dname, k in CASES:
    x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device="cuda")).to(
        getattr(torch, dname))
    y = torch.empty_like(x)
    h = N // 2
    g = [[x[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
          for j in range(2)] for i in range(2)]
    o = torch.empty_like(g[0][0])
    for cd, tag in ((None, ""), (torch.bfloat16, " bf16-interior")):
        res[f"K3 {dname} k={k}{tag}"] = tm(
            lambda: cs.composed_dense_step(x, 0.1, k, out=y,
                                           variant=VARIANT,
                                           compute_dtype=cd))
        res[f"K3-halo {dname} k={k}{tag} 4 shards"] = sum(
            tm(lambda: cs.composed_halo_step(g[i][j], r, (i * h, j * h),
                                             (N, N), 0.1, k, out=o,
                                             variant=VARIANT,
                                             compute_dtype=cd))
            for i in range(2) for j in range(2)
            for r in [exchange_ring(g, i, j, k)])
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
    src = (HERE / "mpi_model_tpu_torch/csrc/composed_stencil.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, out_dir: Path, build_mod,
          csrc: Path = None) -> dict:
    """Build one variant's source against the headers of ``csrc`` (this
    checkout's by default)."""
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([build_mod.find_nvcc(),
                           *build_mod.flags_for("composed_stencil"),
                           "-I", str(csrc or build_mod.CSRC), "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    return {"library": str(lib), "ptxas": ptxas}


def agrees(torch, got, want, form: str, k: int) -> bool:
    """The vpu form bit for bit; the mxu form within 1e-6·k·max|v| (f32)
    or one bf16 ulp of the scale. NaN (an unwritten cell) fails both."""
    if form == "vpu":
        return bool(torch.equal(got, want))
    g32, w32 = got.float(), want.float()
    scale = float(w32.abs().max())
    tol = (1e-6 * k * scale if got.dtype == torch.float32
           else 2.0 ** (math.floor(math.log2(scale)) - 7))
    return bool(((g32 - w32).abs() <= tol).all())


def time_variants(torch, built: dict, forms) -> list[dict]:
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import composed_stencil as cs
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel.halo import exchange_ring

    i, f, p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
    fp = ctypes.POINTER(ctypes.c_float)
    libs = {}
    for name, info in built.items():
        lib = ctypes.CDLL(info["library"])
        for dt in ("f32", "bf16"):
            bf = [i] * 5  # cs._form_args: the bf16 interior math's flag
            fn = getattr(lib, f"mm_composed_vpu_{dt}")
            fn.argtypes = [p, p, i, i, f, f, i, i, i, i, i, fp] + bf + [fp, p]
            fn = getattr(lib, f"mm_composed_mxu_{dt}")
            fn.argtypes = [p, p, i, i, f, f, i, i, i, i, p] + bf + [p, p]
            fn = getattr(lib, f"mm_composed_halo_vpu_{dt}")
            fn.argtypes = [p, p, f, f, i, i, i, i, i, fp] + bf + [fp, p]
            fn = getattr(lib, f"mm_composed_halo_mxu_{dt}")
            fn.argtypes = [p, p, f, f, i, i, i, i, p] + bf + [p, p]
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
    cases = sorted({c for name in forms for c in FORM_CASES[name]},
                   key=lambda c: (c[0] != "float32", -c[1]))
    for dname, k in cases:
        dtype = getattr(torch, dname)
        x = (1.0 + 0.1 * torch.rand((N, N), generator=gen,
                                    device="cuda")).to(dtype)
        y = torch.empty_like(x)
        ys = torch.empty((h, h), dtype=dtype, device="cuda")
        g = [[x[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
              for j in range(2)] for i in range(2)]
        # the launch arguments hold raw pointers: the rings stay referenced
        rings = {(i, j): exchange_ring(g, i, j, k)
                 for i in range(2) for j in range(2)}
        args = {(i, j): fs.halo_args(g[i][j], ring, (i * h, j * h), (N, N))
                for (i, j), ring in rings.items()}
        suffix = "f32" if dtype == torch.float32 else "bf16"
        for name in forms:
            if (dname, k) not in FORM_CASES[name]:
                continue
            form = name.removesuffix("_bf16")
            cd = torch.bfloat16 if name.endswith("_bf16") else None

            def rect(shape, origin=(0, 0)):
                return fs.kernel_rect(shape, dtype,
                                      fs.resolve_block(shape, dtype), k, cd,
                                      origin, (N, N))

            fargs = cs._form_args(form, 0.1, MOORE_OFFSETS, k, dtype,
                                  x.device, rect((N, N)))
            hargs = {(i, j): cs._form_args(form, 0.1, MOORE_OFFSETS, k,
                                           dtype, x.device,
                                           rect((h, h), (i * h, j * h)))
                     for i in range(2) for j in range(2)}
            want = cs.composed_dense_step_plain(x, 0.1, k, MOORE_OFFSETS,
                                                form, cd)

            def own(fn, out, ref):
                """fn's time, and whether what it wrote into out (filled
                with NaN first) agrees with ref."""
                out.fill_(float("nan"))
                ms = tm(fn)
                return ms, agrees(torch, out, ref, form, k)

            for rnd in range(2):
                for vname, lib in libs.items():
                    dense = getattr(lib, f"mm_composed_{form}_{suffix}")
                    halo = getattr(lib, f"mm_composed_halo_{form}_{suffix}")
                    row = {"variant": vname, "round": rnd, "dtype": dname,
                           "k": k, "form": name}
                    row["k3_ms"], ok3 = own(lambda: dense(
                        x.data_ptr(), y.data_ptr(), N, N, *fargs, stream), y,
                        want)
                    row["k3_halo_ms"], okh = {}, True
                    for (i, j), a in args.items():
                        row["k3_halo_ms"][f"{i},{j}"], ok = own(
                            lambda: halo(ctypes.addressof(a), ys.data_ptr(),
                                         *hargs[i, j], stream), ys,
                            want[i * h:(i + 1) * h, j * h:(j + 1) * h])
                        okh = okh and ok
                    row["agrees"] = {"k3": ok3, "k3_halo": okh}
                    rows.append(row)
                    print(f"round {rnd} {vname:28s} {name:8s} {dname:9s} "
                          f"k={k:2d}: "
                          f"K3 {row['k3_ms']:.4f} ms, K3-halo 4 shards "
                          f"{sum(row['k3_halo_ms'].values()):.4f} (agrees: "
                          f"K3 {ok3}, K3-halo {okh})", flush=True)
            del want
        del x, y, ys, g, rings, args
        torch.cuda.empty_cache()
    return rows


def time_tree(path: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           TIMER % (N, FORM_CASES["vpu"], "vpu")],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K3/K3-halo to time in turns")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    ap.add_argument("--forms", default=",".join(FORMS),
                    help=f"comma-separated forms of {FORMS} to time")
    args = ap.parse_args()
    chosen = list(VARIANTS) if args.only is None else args.only.split(",")
    forms = args.forms.split(",")
    for name in chosen:
        if name not in VARIANTS:
            raise SystemExit(f"k3_variants: no variant {name!r}")
    for name in forms:
        if name not in FORMS:
            raise SystemExit(f"k3_variants: no form {name!r}")
    import torch

    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from mpi_model_tpu_torch.ops import _build

    out_dir = HERE / "chiprun_out"
    var_dir = out_dir / "k3_variants"
    var_dir.mkdir(parents=True, exist_ok=True)
    sources = {n: (patched(n), None) for n in chosen}
    if args.parent is not None:
        csrc = args.parent.resolve() / "mpi_model_tpu_torch/csrc"
        sources["parent"] = ((csrc / "composed_stencil.cu").read_text(), csrc)
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(build, n, src, var_dir, _build, inc)
                for n, (src, inc) in sources.items()}
        built = {n: f.result() for n, f in futs.items()}
    for name, info in built.items():
        print(f"{name}: " + "; ".join(
            line for line in info["ptxas"] if "Compiling" not in line
            and ("spill stores" in line and "0 bytes spill" not in line
                 or "registers" in line)), flush=True)
    result = {"card": card_line(),
              "variants": time_variants(torch, built, forms),
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
    (out_dir / "k3_variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
