#!/usr/bin/env python3
"""K1/K2 design measurements on one NVIDIA GPU (they need a card).

    python3 k1_variants.py                    # the kernel's variants
    python3 k1_variants.py --parent DIR       # and an older checkout's K1/K2
    python3 k1_variants.py --only as_is,near_only

Variants: ``csrc/fused_stencil.cu`` as it is, and copies of it with one
choice changed:

- the f32 walk's window rows (``rows_for``): 48 up to nsteps 8, or 64 from
  nsteps 1 (this one also with the bf16 interior math, where it sets the
  near launch's rows: 64 at nsteps 2);
- the edge tiles' exact strips left out (wrong on purpose: measures what
  they cost);
- with the bf16 interior math (``compute_dtype=bfloat16``, two launches a
  call): the paired walk forming its bands again in pass 2 (the shared
  ``mm::walk_step_bf2``) instead of keeping pass 1's; its window loaded
  from device memory straight into pairs instead of staged raw by
  ``cp.async`` (the staging choice at f32 storage); the other pair
  layout (``column_pairs``: a register holds two columns of one row, a
  block's window 512 columns; at the launch's rows 64 it runs 48 rows with
  the bands kept, at 96 it runs 96 rows forming them again); 48-, 80- and
  128-row paired instances; and, wrong on purpose, each launch alone
  (``near_only``, ``paired_only``: what each costs). With ``--parent``,
  the older checkout's ``fused_stencil.cu`` is built beside them against
  its own headers and timed in the same turns through its own C entry
  points (a checkout from PR 14 on: the same C interface, the rows of
  ``fs.PAIRED_ROWS``).

Every patch is checked against the source before anything is built: a
variant whose text is no longer in the source stops the tool and is named.
Each variant is built with the port's nvcc flags, one nvcc per variant in
parallel, and timed in turns, two rounds, through the library's C entry
points. f32 interior math: K1 on a 16384² grid (f32 nsteps 1, 2, 4 and 8,
bf16 nsteps 16), K1 on an 8192² grid and K2 on each 8192² shard of a 2×2
mesh of the 16384² grid. bf16 interior math: K1 at 16384² (f32 nsteps 2, 4
and 8, bf16 nsteps 16) and K2 on the 2×2 mesh's shards (f32 nsteps 8), at
each of the paired walk's window rows (``fs.PAIRED_ROWS``; the rows rule is
``fs.paired_rows``). Before each call the output is filled with NaN, and
after it the output is compared bit for bit with the plain version
(``dense_step_plain``, with ``compute_dtype`` for the knob; K2's shards
with the whole grid's), so each variant's correctness is its own. The
ptxas register and spill lines of each variant are kept.

``--parent DIR`` times ``pallas_dense_step`` and ``pallas_halo_step`` at
the same shapes, with f32 and with bf16 interior math, in another checkout
of the repository (for example the parent commit unpacked with ``git
archive``) and in this one, each in a process of its own, in the order
parent, this, this, parent; each output is held bit for bit to the plain
version.

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
#: f32 interior math: (storage, nsteps)
CASES = (("float32", 1), ("float32", 2), ("float32", 4), ("float32", 8),
         ("bfloat16", 16))
#: bf16 interior math: (storage, nsteps, K2's shards too)
KNOB_CASES = (("float32", 8, True), ("bfloat16", 16, False),
              ("float32", 2, False), ("float32", 4, False))
ROWS_FOR = "return !p.moore || p.nsteps <= 2 ? 48 : 64;"
STAGED = """    const int skew =
        mm::stage_window<ROWS>(src, p, tl, t, tl.interior(t), stage);
    for (int k = j; k < 2 * kExch; k += 32 * NWARPS) ex16[k] = 0u;
    mm::cp_async_wait_all();
    __syncthreads();
    // the staged window into pairs of rows, rounded to bf16
    const T* col = stage + skew + j;
    unsigned w[P];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      w[m] = mm::pair_of(col + 2 * m * mm::kStagePitch<T>,
                         col + (2 * m + 1) * mm::kStagePitch<T>);
    }
"""
# the window read from device memory straight into pairs (a warp's load:
# 32 neighbouring cells of a row), the source element by element for a
# window not inside the array; the staging buffer unused
DIRECT = """    (void)stage;
    for (int k = j; k < 2 * kExch; k += 32 * NWARPS) ex16[k] = 0u;
    unsigned w[P];
    {
      const int r0 = tl.row_of(t) - tl.rh;
      const int cc = tl.col_of(t) - tl.n + j;
      if (tl.inside(t)) {
        const T* col =
            mm::array_of(src) + static_cast<size_t>(r0) * tl.w + cc;
#pragma unroll
        for (int m = 0; m < P; ++m) {
          w[m] = mm::pair_of(col + static_cast<size_t>(2 * m) * tl.w,
                             col + static_cast<size_t>(2 * m + 1) * tl.w);
        }
      } else {
#pragma unroll
        for (int m = 0; m < P; ++m) {
          w[m] = mm::pack_bf2(src.at(r0 + 2 * m, cc),
                              src.at(r0 + 2 * m + 1, cc));
        }
      }
    }
    __syncthreads();
"""
PAIRED_CALL = ("      mm::paired_step<ROWS>(w, ex16 + (s & 1) * kExch,\n"
               "                            [&](int, unsigned old, "
               "unsigned g) {")
# the other pair layout: a register holds columns c and c + 1 of one window
# row, a block's window 512 columns (two a thread); the rows above and
# below are whole words, the columns beside straddle a word and its
# neighbour's. Built only as this variant: at the launch's rows 64 it runs
# 48 rows with the bands kept, at 96 it runs 96 rows forming them again
# (96 words a thread either way)
COLUMN_PAIRS = r"""
constexpr int CP_COLS = 2 * WIN_W;

template <int ROWS, bool KEEP, typename Finish>
__device__ __forceinline__ void cols_step(unsigned (&v)[ROWS], unsigned* eb,
                                          Finish finish) {
  static_assert(ROWS % 4 == 0, "edge words move four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int own = 2 * (wp + 1) + (lane == 31 ? 1 : 0);
  const int nbr = lane == 0 ? 2 * wp + 1 : 2 * (wp + 2);
  const bool edge_lane = lane == 0 || lane == 31;
  unsigned b[KEEP ? ROWS : 1];
  uint4 x4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const unsigned up = i > 0 ? v[i - 1] : 0u;
    const unsigned dn = i + 1 < ROWS ? v[i + 1] : 0u;
    const unsigned x = mm::add_bf2_kept(mm::add_bf2_kept(up, v[i]), dn);
    if constexpr (KEEP) b[i] = x;
    if (i % 4 == 0) x4.x = x;
    if (i % 4 == 1) x4.y = x;
    if (i % 4 == 2) x4.z = x;
    if (i % 4 == 3) {
      x4.w = x;
      if (edge_lane) *reinterpret_cast<uint4*>(eb + own * ROWS + i - 3) = x4;
    }
  }
  __syncthreads();
  if constexpr (!KEEP) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) asm volatile("" : "+r"(v[i]));
  }
  const unsigned* nb = eb + nbr * ROWS;
  uint4 e4 = make_uint4(0u, 0u, 0u, 0u);
  unsigned prev = 0u;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i % 4 == 0 && edge_lane) {
      e4 = *reinterpret_cast<const uint4*>(nb + i);
    }
    unsigned bb;
    if constexpr (KEEP) {
      bb = b[i];
    } else {
      const unsigned dn = i + 1 < ROWS ? v[i + 1] : 0u;
      bb = mm::add_bf2(mm::add_bf2(prev, v[i]), dn);
    }
    unsigned L = __shfl_up_sync(mm::kFull, bb, 1);
    unsigned R = __shfl_down_sync(mm::kFull, bb, 1);
    if (lane == 0) L = mm::part_u(e4, i % 4);
    if (lane == 31) R = mm::part_u(e4, i % 4);
    const unsigned nine = mm::add_bf2(
        mm::add_bf2(mm::straddle(L, bb), bb), mm::straddle(bb, R));
    prev = v[i];
    v[i] = finish(v[i], nine);
  }
}

template <int ROWS, bool KEEP, typename T, typename Src>
__device__ __forceinline__ void cols_body(const Src& src, T* __restrict__ out,
                                          const Params& p,
                                          const RegionTiling& tl) {
  extern __shared__ __align__(16) float smem[];
  unsigned* ex = reinterpret_cast<unsigned*>(smem);
  constexpr int kExch = mm::kEdgeSlots * ROWS;
  const int t = blockIdx.x;
  const int n = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r0 = tl.row_of(t) - n;
  const int c = tl.col_of(t) - n + 2 * j;
  for (int k = j; k < 2 * kExch; k += 32 * NWARPS) ex[k] = 0u;
  const bool in = r0 >= 0 && tl.col_of(t) - n >= 0 && r0 + ROWS <= tl.h &&
                  tl.col_of(t) - n + CP_COLS <= tl.w;
  unsigned v[ROWS];
  if (in) {
    const T* base = mm::array_of(src) + static_cast<size_t>(r0) * tl.w + c;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      v[i] = mm::pair_of(base + static_cast<size_t>(i) * tl.w,
                         base + static_cast<size_t>(i) * tl.w + 1);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      v[i] = mm::pack_bf2(src.at(r0 + i, c), src.at(r0 + i, c + 1));
    }
  }
  __syncthreads();
  const unsigned ca = p.ca16 | (p.ca16 << 16);
  const unsigned cb = p.cb16 | (p.cb16 << 16);
  for (int s = 0; s < n; ++s) {
    cols_step<ROWS, KEEP>(v, ex + (s & 1) * kExch,
                          [&](unsigned old, unsigned g) {
                            return mm::add_bf2(mm::mul_bf2(old, ca),
                                               mm::mul_bf2(g, cb));
                          });
  }
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= n && i < ROWS - n && r0 + i < tl.r1) {
      T* row = out + static_cast<size_t>(r0 + i) * tl.w;
      if (2 * j >= n && 2 * j < CP_COLS - n && c < tl.c1) {
        mm::from_f32(row + c, mm::lo_f32(v[i]));
      }
      if (2 * j + 1 >= n && 2 * j + 1 < CP_COLS - n && c + 1 < tl.c1) {
        mm::from_f32(row + c + 1, mm::hi_f32(v[i]));
      }
    }
  }
}

template <int ROWS, bool KEEP, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_cols_kernel(const T* __restrict__ in, T* __restrict__ out,
                              Params p, RegionTiling tl) {
  cols_body<ROWS, KEEP>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p, tl);
}

template <int ROWS, bool KEEP, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_halo_cols_kernel(const mm::HaloSource<T> src,
                                   T* __restrict__ out, Params p,
                                   RegionTiling tl) {
  cols_body<ROWS, KEEP>(src, out, p, tl);
}

template <int ROWS, bool KEEP, typename T, typename In>
cudaError_t launch_cols(In in, void* out, const Params& p, RegionTiling tl,
                        void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;
  const int smem = 2 * mm::kEdgeSlots * ROWS * static_cast<int>(sizeof(float));
  tl.tw = CP_COLS - 2 * p.nsteps;
  tl.tiles_c = (tl.c1 - tl.c0 + tl.tw - 1) / tl.tw;
  tl.tiles = ((tl.r1 - tl.r0 + tl.th - 1) / tl.th) * tl.tiles_c;
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(fused_stencil_cols_kernel<ROWS, KEEP, T>, smem,
                             tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, tl);
  } else {
    return mm::launch_blocks(fused_stencil_halo_cols_kernel<ROWS, KEEP, T>,
                             smem, tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, tl);
  }
}

"""
COLS_LAUNCH_OLD = """  switch (rows16) {
    case 96: err = launch_bf16<96, true, T>(in, out, p, tl, stream); break;
    case 64: err = launch_bf16<64, true, T>(in, out, p, tl, stream); break;"""
COLS_LAUNCH_NEW = """  const RegionTiling t48 =
      mm::region_tiling(48, n, n, a, s.a0, s.a1, s.b0, s.b1);
  switch (rows16) {
    case 96: err = launch_cols<96, false, T>(in, out, p, tl, stream); break;
    case 64: err = launch_cols<48, true, T>(in, out, p, t48, stream); break;"""
# each variant: (text, replacement) pairs, every occurrence replaced, and
# the case sets it is timed on ("f32": f32 interior math, "knob": bf16)
VARIANTS = {
    "as_is": ([], ("f32", "knob")),
    "rows_48_to_n8": ([(ROWS_FOR,
                        "return !p.moore || p.nsteps <= 8 ? 48 : 64;")],
                      ("f32",)),
    "rows_64_from_n1": ([(ROWS_FOR, "return !p.moore ? 48 : 64;")],
                        ("f32", "knob")),
    "no_exact_strips": ([("    exact_cells(src, out, p, tl, t, work, "
                          "work + piece_floats(p.nsteps));\n", "")],
                        ("f32",)),
    "recompute_bands": ([(PAIRED_CALL,
                          "      mm::walk_step_bf2<ROWS>(w, ex16 + (s & 1) "
                          "* kExch,\n                            [&](int, "
                          "unsigned old, unsigned g) {")], ("knob",)),
    "direct_loads": ([(STAGED, DIRECT)], ("knob",)),
    "column_pairs": ([("bool valid_steps(const Params& p) {",
                       COLUMN_PAIRS + "bool valid_steps(const Params& p) {"),
                      (COLS_LAUNCH_OLD, COLS_LAUNCH_NEW)], ("knob",)),
    **{f"rows_{r}": ([("rows16 == 64 || rows16 == 96",
                       f"rows16 == 64 || rows16 == 96 || rows16 == {r}"),
                      ("    case 96: err = launch_bf16<96, true, T>",
                       f"    case {r}: err = launch_bf16<{r}, true, T>(in, "
                       "out, p, tl, stream); break;\n"
                       "    case 96: err = launch_bf16<96, true, T>")],
                     ("knob",)) for r in (48, 80, 128)},
    "near_only": ([("  if (err != cudaSuccess || s.empty()) return",
                    "  if (true) return")], ("knob",)),
    "paired_only": ([("  if (near > 0) {\n    if (rows == 64) {\n"
                      "      err = launch_near",
                      "  if (false) {\n    if (rows == 64) {\n"
                      "      err = launch_near")], ("knob",)),
}
#: variants whose results are wrong on purpose
WRONG = ("no_exact_strips", "near_only", "paired_only")
#: the paired rows a variant adds to the source's (``fs.PAIRED_ROWS``)
EXTRA_ROWS = {"rows_48": 48, "rows_80": 80, "rows_128": 128}
#: the older checkout's kernel (``--parent``), built and timed beside the
#: variants through its own C entry points (no rows argument)
PARENT = "parent"

# one process's K1/K2 times through the package's own wrappers, both
# compute dtypes, each output held bit for bit to its plain version
TIMER = r"""
import json, statistics, sys
sys.path.insert(0, ".")
import torch
from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
from mpi_model_tpu_torch.ops import fused_stencil as fs
from mpi_model_tpu_torch.parallel.halo import exchange_ring
N, CASES, KNOB = %d, %r, %r
BF = torch.bfloat16
def tm(fn):
    fn(); torch.cuda.synchronize(); out = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)
gen = torch.Generator(device="cuda").manual_seed(7)
res, same = {}, {}
todo = [(d, n, None) for d, n in CASES] + [(d, n, BF) for d, n, _ in KNOB]
for dname, ns, cd in todo:
    x = (1.0 + 0.1 * torch.rand((N, N), generator=gen, device="cuda")).to(
        getattr(torch, dname))
    y = torch.empty_like(x)
    tag = " bf16-interior" if cd is not None else ""
    want = fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, ns, cd)
    res[f"K1{tag} {dname} ns={ns}"] = tm(
        lambda: fs.pallas_dense_step(x, 0.1, nsteps=ns, out=y,
                                     compute_dtype=cd))
    same[f"K1{tag} {dname} ns={ns}"] = bool(torch.equal(y, want))
    h = N // 2
    g = [[x[i * h:(i + 1) * h, j * h:(j + 1) * h].contiguous()
          for j in range(2)] for i in range(2)]
    o = torch.empty_like(g[0][0])
    total, ok = 0.0, True
    for i in range(2):
        for j in range(2):
            r = exchange_ring(g, i, j, ns)
            total += tm(lambda: fs.pallas_halo_step(
                g[i][j], r, (i * h, j * h), (N, N), 0.1, nsteps=ns, out=o,
                compute_dtype=cd))
            ok = ok and bool(torch.equal(
                o, want[i * h:(i + 1) * h, j * h:(j + 1) * h]))
    res[f"K2{tag} {dname} ns={ns} 4 shards"] = total
    same[f"K2{tag} {dname} ns={ns} 4 shards"] = ok
    del x, y, g, o, want
    torch.cuda.empty_cache()
print(json.dumps({"ms": res, "bit_for_bit": same}))
"""


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def patched(name: str) -> str:
    """The kernel's source with variant ``name``'s patches applied."""
    src = (HERE / "mpi_model_tpu_torch/csrc/fused_stencil.cu").read_text()
    for old, new in VARIANTS[name][0]:
        if old not in src:
            raise RuntimeError(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    return src


def build(name: str, src: str, out_dir: Path, build_mod,
          csrc: Path = None) -> dict:
    """Build one variant's source (``csrc``: the headers' directory, the
    checkout's own by default)."""
    path = out_dir / f"{name}.cu"
    path.write_text(src)
    lib = out_dir / f"lib{name}.so"
    proc = subprocess.run([build_mod.find_nvcc(),
                           *build_mod.flags_for("fused_stencil"),
                           "-I", str(csrc or build_mod.CSRC), "-o", str(lib),
                           str(path)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    ptxas = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
             if "registers" in line or "spill" in line
             or "Compiling entry" in line]
    return {"library": str(lib), "ptxas": ptxas}


def tm(torch, fn):
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


def own(torch, fn, out, ref):
    """fn's time, and whether what it wrote into out (filled with NaN
    first) is ref bit for bit."""
    out.fill_(float("nan"))
    ms = tm(torch, fn)
    return ms, torch.equal(out, ref)


def load_variants(built: dict) -> dict:
    # fs._step_args: four floats, the steps and neighbourhood, the bf16
    # interior math's flag and rectangle, its two constants, its rows
    libs = {}
    for name, info in built.items():
        step = ([ctypes.c_float] * 4 + [ctypes.c_int] * 10
                + [ctypes.c_float] * 2 + [ctypes.c_int])
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
    return libs


def time_variants(torch, libs: dict) -> list[dict]:
    from mpi_model_tpu_torch.core.cell import MOORE_OFFSETS
    from mpi_model_tpu_torch.ops import fused_stencil as fs
    from mpi_model_tpu_torch.parallel.halo import exchange_ring

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream
    h = N // 2
    todo = ([(d, n, None, True) for d, n in CASES]
            + [(d, n, torch.bfloat16, k2) for d, n, k2 in KNOB_CASES])
    for dname, ns, cd, with_k2 in todo:
        knob = cd is not None
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
        want = fs.dense_step_plain(x, 0.1, MOORE_OFFSETS, ns, cd)
        want_s = None if knob else fs.dense_step_plain(xs, 0.1,
                                                       MOORE_OFFSETS, ns)
        suffix = "f32" if dtype == torch.float32 else "bf16"
        for rnd in range(2):
            for name, lib in libs.items():
                if name != PARENT and ("knob" if knob else "f32") not in \
                        VARIANTS[name][1]:
                    continue
                dense = getattr(lib, f"mm_fused_stencil_{suffix}")
                halo = getattr(lib, f"mm_fused_stencil_halo_{suffix}")
                # the paired walk's rows: each the source is built for, or
                # the one a variant adds; f32 math: none
                rows16s = ([0] if not knob
                           else [EXTRA_ROWS[name]] if name in EXTRA_ROWS
                           else list(fs.PAIRED_ROWS))
                for rows16 in rows16s:
                    if knob:
                        rect = fs.kernel_rect((N, N), dtype, None, ns, cd)
                        sa = fs._step_args(0.1, MOORE_OFFSETS, ns, rect)
                        sa = sa[:-1] + (rows16,)
                        sah = {(i, j): (fs._step_args(
                            0.1, MOORE_OFFSETS, ns, fs.kernel_rect(
                                (h, h), dtype, None, ns, cd, (i * h, j * h),
                                (N, N)))[:-1] + (rows16,))
                            for (i, j) in args}
                    else:
                        sa = fs._step_args(0.1, MOORE_OFFSETS, ns)
                        sah = {ij: sa for ij in args}
                    row = {"variant": name, "round": rnd, "dtype": dname,
                           "nsteps": ns, "compute_dtype":
                           "bfloat16" if knob else "float32",
                           "rows16": rows16 or None}
                    row["k1_ms"], ok1 = own(torch, lambda: dense(
                        x.data_ptr(), y.data_ptr(), N, N, *sa, stream), y,
                        want)
                    bits = {"k1": ok1}
                    if not knob:
                        row["k1_half_grid_ms"], bits["k1_half_grid"] = own(
                            torch, lambda: dense(xs.data_ptr(),
                                                 ys.data_ptr(), h, h, *sa,
                                                 stream), ys, want_s)
                    if with_k2:
                        row["k2_ms"], ok2 = {}, True
                        for (i, j), a in args.items():
                            row["k2_ms"][f"{i},{j}"], ok = own(
                                torch, lambda: halo(
                                    ctypes.addressof(a), ys.data_ptr(),
                                    *sah[(i, j)], stream), ys,
                                want[i * h:(i + 1) * h, j * h:(j + 1) * h])
                            ok2 = ok2 and ok
                        bits["k2"] = ok2
                    row["bit_for_bit"] = bits
                    rows.append(row)
                    k2 = (f", K2 4 shards {sum(row['k2_ms'].values()):.4f}"
                          if with_k2 else "")
                    print(f"round {rnd} {name:16s} {row['compute_dtype']} "
                          f"{dname:9s} ns={ns:2d}"
                          + (f" rows16={rows16}" if knob else "")
                          + f": K1 {row['k1_ms']:.4f} ms" + k2
                          + f" (bit for bit: {bits})", flush=True)
        del x, y, xs, ys, g, rings, args, want, want_s
        torch.cuda.empty_cache()
    return rows


def time_tree(path: Path) -> dict:
    proc = subprocess.run([sys.executable, "-c",
                           TIMER % (N, CASES, KNOB_CASES)],
                          cwd=path, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="another checkout whose K1/K2 to time in turns")
    ap.add_argument("--only", default=None,
                    help="comma-separated variants to build and time")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k1_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from mpi_model_tpu_torch.ops import _build

    names = (list(VARIANTS) if args.only is None
             else [n for n in args.only.split(",") if n])
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        print(f"k1_variants: unknown variants {unknown}", file=sys.stderr)
        return 1
    out_dir = HERE / "chiprun_out"
    var_dir = out_dir / "k1_variants"
    var_dir.mkdir(parents=True, exist_ok=True)
    sources = {n: (patched(n), None) for n in names}
    if args.parent is not None:
        pcsrc = args.parent.resolve() / "mpi_model_tpu_torch" / "csrc"
        sources[PARENT] = ((pcsrc / "fused_stencil.cu").read_text(), pcsrc)
    with ThreadPoolExecutor(len(sources)) as pool:
        futs = {n: pool.submit(build, n, src, var_dir, _build, csrc)
                for n, (src, csrc) in sources.items()}
        built = {n: f.result() for n, f in futs.items()}
    for name, info in built.items():
        print(f"{name}: " + "; ".join(info["ptxas"]), flush=True)
    result = {"card": card_line(), "wrong_on_purpose": list(WRONG),
              "variants": time_variants(torch, load_variants(built)),
              "ptxas": {n: i["ptxas"] for n, i in built.items()}}
    if args.parent is not None:
        turns = []
        for who in ("parent", "this", "this", "parent"):
            path = args.parent.resolve() if who == "parent" else HERE
            times = time_tree(path)
            turns.append({"tree": who, **times})
            print(f"{who}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                         times["ms"].items())
                  + f"; bit for bit {times['bit_for_bit']}", flush=True)
        result["parent_turns"] = turns
    for p in var_dir.glob("*.so"):
        p.unlink()
    (out_dir / "k1_variants.json").write_text(json.dumps(result, indent=1))
    print(result["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
