// K1: the fused dense stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_stencil_call
// in dense mode (the pl.pallas_call reached through _pallas_step,
// pallas_dense_step and PallasDiffusionStep). It computes what that kernel
// computes: `nsteps` (n <= 16) uniform-rate radius-1 transport steps over a
// [H, W] grid in one read and one write of device memory. Each step, every
// cell sheds share = rate * v / cnt(row, col) to each in-bounds neighbor,
// where cnt is its own in-bounds neighbor count; the grid is non-periodic,
// so off-grid cells are zero and are re-masked to zero after each step.
//
// The form is chosen per cell, from global coordinates. Let d = min(R,
// H-1-R, C, W-1-C) for the cell's global row R and column C. A cell with
// d > n takes the closed form, as the TPU kernel does on its interior
// tiles: every cell of its n-cone lies off the grid's outer ring, so every
// count it meets is full and the exact step is
//   Moore (the eight offsets, any order): band = (v[r-1,c] + v[r,c]) +
//     v[r+1,c], nine = (band[c-1] + band[c]) + band[c+1],
//     v' = v * a + nine * b, a = 1 - r - r/8, b = r/8;
//   other neighbourhoods: g = the neighbours summed in `offsets` order,
//     v' = v * a + g * b, a = 1 - r, b = r/k;
// with a and b formed in f64 on the host and rounded to f32 once (K5's
// constants). Every other cell takes the exact masked path of
// stencil_common.cuh (share = (rate * v) / cnt, v' = v * (1 - rate) + the
// shares in `offsets` order, off-grid cells zero). The two forms round
// differently; since the choice is per cell and not per block, K2's shards
// equal K1's whole grid bit for bit wherever the seams fall. Every
// operation is an explicitly rounded intrinsic and the source builds with
// --fmad=false, so the kernel equals its plain version
// (ops/fused_stencil.py::dense_step_plain) bit for bit.
//
// What bounds it: bytes at small n, operations at large n. One call must
// read the grid once and write it once (8 bytes a cell in f32, 4 in bf16);
// the closed form costs 7 f32 operations a cell-step. The first port ran
// the exact path on every cell (a division, a shared share array and two
// barriers a step: about 45-50 instructions a cell-step). This design:
//
//   - Output tiles of (ROWS - 2n) x (256 - 2n) cells; a block of 8 warps
//     holds the tile's ROWS x 256 window in registers, one window column a
//     thread (ROWS values: 48 for Moore up to n = 2 and for the other
//     neighbourhoods, 64 for Moore above), so the halo overhead is
//     ROWS/(ROWS-2n) x 256/(256-2n): 1.05x at n = 1, 1.42x at n = 8,
//     2.29x at n = 16.
//   - Interior tiles (every output cell with d > n, almost all of them)
//     run only the closed form in registers: a thread walks down its
//     column keeping the vertical band in registers, the neighbouring
//     columns' bands come from the neighbouring lanes through __shfl_sync,
//     and the two columns at a warp's edges through one shared row a step
//     (double buffered by step parity): one barrier a step, no count, no
//     division, no share array. The window's outer ring computes garbage
//     that never reaches the output (it moves in one cell a step).
//   - A block a tile, two blocks an SM: one block's window
//     loads overlap the other's steps. cp.async brings an interior tile's
//     window into the one shared staging buffer as 16-byte copies of an
//     aligned superset of it (when the rows are 16-byte aligned; other
//     windows are staged element by element through the source, eight
//     loads in flight a thread). About 96.5% of the tiles at 16384² are
//     interior (n = 1, 8 and 16). Persistent blocks that walk the tiles
//     and prefetch the next window while stepping one measured slower on
//     the H100 (K1 ns=1 1.3x, K2 shards at ns=1 2.6x; k1_variants.py), so
//     the kernel does not keep them.
//   - Edge tiles (some output cell with d <= n; a few percent) run the
//     same register closed form and keep it for their cells with d > n
//     (their window staged through the source, zero off the grid), then
//     the exact path (iterate_exact_f32, shared memory) on their part of
//     the grid's n + 1 deep border strips, in pieces of up to 128 along
//     the strip, each from its own window load.
//   - No tensor cores: at 7 flops a cell-step the kernel is far below the
//     card's balance point, and the sums are not a matrix product.
//
// The kernel is out of place: every read sees the values from before the
// call. Storage is float or __nv_bfloat16; the math is f32, converted with
// the intrinsics only, and bf16 is rounded once per call.
//
// bf16 interior math (compute_dtype=bfloat16 at n > 1): the TPU kernel
// computes its tiles that are not near the edge (JAX's tiles,
// pallas_stencil.py:391-392) in bf16 and its near tiles in f32 over the
// window rounded to bf16 (:441). The host passes the cells of the former as
// one rectangle of global rows and columns (mm::Rect). A call is two
// launches, each on its own tiling and each writing only its own cells:
//
//   - the near launch (fused_stencil_near_kernel) tiles the four bands of
//     the array around the rectangle, each from its own origin, and runs
//     the f32 forms above on its window rounded to bf16 (the exact strips
//     through mm::RoundedSource), at rows_for's rows;
//   - the paired launch (fused_stencil_bf16_kernel) tiles the rectangle
//     from its origin, and runs the closed form in bf16 and nothing else:
//     every cell of the rectangle has d > n. Moore on paired bf16
//     (paired_step: window rows 2m and 2m + 1 a register, add.rn.bf16x2
//     and mul.rn.bf16x2, the constants rounded to bf16 on the host; the
//     bands of a step's first pass kept for its second) over its window
//     staged raw by cp.async and read into pairs, at its own rows
//     (`rows16`, ops/fused_stencil.py::paired_rows: 96 above two steps,
//     with no f32 copy of the window beside the pairs); other
//     neighbourhoods on the f32 walk with every operation rounded.
//
// One kernel with both walks (every block testing the rectangle, the
// blocks across its edge running both) held the paired walk to the f32
// walk's window and registers. Measured on the H100 (k1_variants.py,
// PERF.md): the two launches, the kept bands, 96 rows and the staged
// window each came out faster than the alternative.
// Every bf16 operation rounds once and none is contracted, so the result is
// the plain version's (ops/fused_stencil.py::dense_step_plain(...,
// compute_dtype)) bit for bit.
//
// K2, the halo mode, is the same body on one shard of a sharded grid: it
// replaces _stencil_call in halo mode (reached through _pallas_halo_step and
// pallas_halo_step, used by parallel/executors.py::ShardMapExecutor). Its
// window reads the [h, w] shard, and where the window leaves the shard the
// exchanged ghost ring (eight pieces, depth d >= nsteps) in place of the
// dense kernel's zero border (mm::HaloSource). Windows inside the shard
// take the cp.async path; windows at the shard's edge read through
// src.at. Forms and counts use
// the shard's global origin against the global grid, so every cell
// computes exactly what K1 computes for it on the whole grid.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launches, 0 on success.

#include <algorithm>
#include <type_traits>

#include "stencil_common.cuh"

namespace {

// A block is (32, NWARPS) threads, warp = threadIdx.y, as the shared-memory
// helpers of stencil_common.cuh stride; its window is WIN_W columns (one a
// thread) by ROWS rows (in registers): 48 or 64, by rows_for (the paired
// launch: 64 or 96, by `rows16`). The register
// column walk, the window staging and the exact strips are
// stencil_common.cuh's (K3's vpu form shares them).
constexpr int NWARPS = mm::kThreadsY;
constexpr int WIN_W = mm::kWinW;
constexpr int MAX_STEPS = 16;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

using Params = mm::StepParams;
using mm::Array;
using mm::Bands;
using mm::RegionTiling;
using mm::Split;
using mm::Tiling;
using mm::piece_floats;

template <typename T, int ROWS>
int smem_of(int n) {
  const int exact = 2 * piece_floats(n) * static_cast<int>(sizeof(float));
  const int stage = mm::stage_bytes<T, ROWS>();
  const int work = stage > exact ? stage : exact;
  return mm::kExchFloats<ROWS> * static_cast<int>(sizeof(float)) + work;
}

// The closed form's n steps on the window held in registers (v[i] = window
// row i of this thread's column), then the tile's output written: every
// cell of it when `whole`, else only its cells inside the tiling's rows and
// columns with d > n. `ex` is the warp-edge exchange of the walk.
template <int ROWS, bool MOORE, typename T, typename TL>
__device__ __forceinline__ void closed_tile(float (&v)[ROWS], float* ex,
                                            const Params& p, const TL& tl,
                                            int t, bool whole,
                                            T* __restrict__ out) {
  const int n = p.nsteps;
  int drow[8], dcol[8];
  mm::offset_rows_cols(p.offcodes, drow, dcol);
  const float ca = p.ca, cb = p.cb;
  for (int s = 0; s < n; ++s) {
    mm::walk_step<ROWS, MOORE>(
        v, ex + (s & 1) * mm::kEdgeSlots * ROWS, drow, dcol, p.noff,
        [&](int, float old, float g) {
          return __fadd_rn(__fmul_rn(old, ca), __fmul_rn(g, cb));
        });
  }

  // rows [n, ROWS - n) of columns [n, WIN_W - n) are the tile
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r = tl.row_of(t) - n;  // the window's first row and column
  const int c = tl.col_of(t) + j - n;
  if (j < n || j >= WIN_W - n || c >= mm::col_end(tl)) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= n && i < ROWS - n) {
      if (whole ||
          (r + i < mm::row_end(tl) &&
           mm::edge_distance(tl.R0 + r + i, tl.C0 + c, tl.H, tl.W) > n)) {
        mm::from_f32(out + static_cast<size_t>(r + i) * tl.w + c, v[i]);
      }
    }
  }
}

// The exact path for tile t's cells with d <= n (stencil_common.cuh).
template <typename T, typename Src>
__device__ __forceinline__ void exact_cells(const Src& src,
                                            T* __restrict__ out,
                                            const Params& p,
                                            const Tiling& tl, int t,
                                            float* a, float* b) {
  mm::exact_cells(src, out, p, tl, tl.row_of(t),
                  min(tl.row_of(t) + tl.th, tl.h), tl.col_of(t),
                  min(tl.col_of(t) + tl.tw, tl.w), a, b);
}

// The body of K1 and K2 with f32 interior math: block t steps tile t of
// `tl`.
template <int ROWS, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void fused_body(const Src& src,
                                           T* __restrict__ out,
                                           const Params& p,
                                           const Tiling& tl) {
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;                             // warp-edge exchange
  float* work = smem + mm::kExchFloats<ROWS>;   // staging, or exact buffers
  T* stage = reinterpret_cast<T*>(work);
  const int t = blockIdx.x;
  const bool whole = tl.interior(t);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int skew = mm::stage_window<ROWS>(src, p, tl, t, whole, stage);
  for (int k = j; k < mm::kExchFloats<ROWS>; k += 32 * NWARPS) ex[k] = 0.f;
  mm::cp_async_wait_all();
  __syncthreads();
  const T* col = stage + skew + j;
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    v[i] = mm::to_f32(col[i * mm::kStagePitch<T>]);
  }
  closed_tile<ROWS, MOORE>(v, ex, p, tl, t, whole, out);
  if (!whole) {
    // the cells with d <= n, in the staging buffer's space
    __syncthreads();
    exact_cells(src, out, p, tl, t, work, work + piece_floats(p.nsteps));
  }
}

// K1: a whole [H, W] grid.
template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                         Params p, Tiling tl) {
  fused_body<ROWS, MOORE>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p, tl);
}

// K2: one shard and its ghost ring; `out` is the shard's [h, w].
template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_halo_kernel(const mm::HaloSource<T> src,
                              T* __restrict__ out, Params p, Tiling tl) {
  fused_body<ROWS, MOORE>(src, out, p, tl);
}

// -- the bf16 interior math: two launches -----------------------------------
//
// The regions and their tilings are stencil_common.cuh's (mm::RegionTiling,
// mm::Bands, mm::split_of, mm::bands_of), shared with K3 vpu's launches.

// The near launch on one tile of a band: the f32 forms over the window
// rounded to bf16 (the TPU kernel's near tiles, pallas_stencil.py:441), the
// closed form for its cells with d > n, the exact strips (through
// mm::RoundedSource) for the rest.
template <int ROWS, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void near_body(const Src& src,
                                          T* __restrict__ out,
                                          const Params& p,
                                          const Bands& bs) {
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;
  float* work = smem + mm::kExchFloats<ROWS>;
  T* stage = reinterpret_cast<T*>(work);
  const int band = mm::band_of(bs);
  const RegionTiling& tl = bs.band[band];
  const int t = blockIdx.x - bs.first[band];
  const bool whole = tl.interior(t);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int skew = mm::stage_window<ROWS>(src, p, tl, t, whole, stage);
  for (int k = j; k < mm::kExchFloats<ROWS>; k += 32 * NWARPS) ex[k] = 0.f;
  mm::cp_async_wait_all();
  __syncthreads();
  const T* col = stage + skew + j;
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    v[i] = mm::rb(mm::to_f32(col[i * mm::kStagePitch<T>]));
  }
  closed_tile<ROWS, MOORE>(v, ex, p, tl, t, whole, out);
  if (!whole) {
    __syncthreads();
    mm::exact_cells_of<true>(src, out, p, tl, tl.row_of(t),
                             min(tl.row_of(t) + tl.th, tl.r1), tl.col_of(t),
                             min(tl.col_of(t) + tl.tw, tl.c1), work,
                             work + piece_floats(p.nsteps));
  }
}

// The paired launch on one tile of the rectangle: the closed form in bf16.
// Moore on paired bf16 (mm::paired_tile, shared with K5's paired launch);
// other neighbourhoods on the f32 walk with every operation rounded
// (mm::closed_walk_bf16) over a staged window.
template <int ROWS, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void bf16_body(const Src& src,
                                          T* __restrict__ out,
                                          const Params& p,
                                          const RegionTiling& tl) {
  const int t = blockIdx.x;
  if constexpr (MOORE) {
    mm::paired_tile<ROWS>(src, out, p, tl, t);
  } else {
    const int n = p.nsteps;
    const int j = threadIdx.y * 32 + threadIdx.x;
    const int r = tl.row_of(t) - n;  // the window's first row and column
    const int c = tl.col_of(t) + j - n;
    const bool col_out = j >= n && j < WIN_W - n && c < tl.c1;
    extern __shared__ __align__(16) float smem[];
    float* ex = smem;
    T* stage = reinterpret_cast<T*>(smem + mm::kExchFloats<ROWS>);
    const int skew =
        mm::stage_window<ROWS>(src, p, tl, t, tl.interior(t), stage);
    for (int k = j; k < mm::kExchFloats<ROWS>; k += 32 * NWARPS) ex[k] = 0.f;
    mm::cp_async_wait_all();
    __syncthreads();
    const T* col = stage + skew + j;
    float v[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      v[i] = mm::to_f32(col[i * mm::kStagePitch<T>]);
    }
    mm::closed_walk_bf16<ROWS, false>(v, ex, n, p.ca16, p.cb16, p.offcodes,
                                      p.noff);
    if (!col_out) return;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (mm::writes_row<ROWS>(tl, r, i)) {
        mm::from_f32(out + static_cast<size_t>(r + i) * tl.w + c, v[i]);
      }
    }
  }
}

template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_near_kernel(const T* __restrict__ in, T* __restrict__ out,
                              Params p, const __grid_constant__ Bands bs) {
  near_body<ROWS, MOORE>(
      mm::DenseSource<T>{in, bs.band[0].H, bs.band[0].W}, out, p, bs);
}

template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_halo_near_kernel(const mm::HaloSource<T> src,
                                   T* __restrict__ out, Params p,
                                   const __grid_constant__ Bands bs) {
  near_body<ROWS, MOORE>(src, out, p, bs);
}

template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_bf16_kernel(const T* __restrict__ in, T* __restrict__ out,
                              Params p, RegionTiling tl) {
  bf16_body<ROWS, MOORE>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p, tl);
}

template <int ROWS, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_halo_bf16_kernel(const mm::HaloSource<T> src,
                                   T* __restrict__ out, Params p,
                                   RegionTiling tl) {
  bf16_body<ROWS, MOORE>(src, out, p, tl);
}

bool valid_steps(const Params& p) {
  return p.nsteps >= 1 && p.nsteps <= MAX_STEPS &&
         (p.mask9 & ~0x1EF) == 0 && p.mask9 != 0 &&
         p.noff == __builtin_popcount(p.mask9);
}

// Shared memory of a paired-launch block: the exchange (Moore in pair words,
// [2][kEdgeSlots][ROWS / 2]; other neighbourhoods the f32 walk's) and the
// staged window.
template <typename T, int ROWS, bool MOORE>
int smem16_of() {
  return (MOORE ? 2 * mm::kEdgeSlots * (ROWS / 2)
                : mm::kExchFloats<ROWS>) * static_cast<int>(sizeof(float)) +
         mm::stage_bytes<T, ROWS>();
}

// Each kernel's launch, on K1's input (In: const T*) or K2's source (In:
// mm::HaloSource<T>).
template <int ROWS, bool MOORE, typename T, typename In>
cudaError_t launch_f32(In in, void* out, const Params& p, const Tiling& tl,
                       void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(fused_stencil_kernel<ROWS, MOORE, T>,
                             smem_of<T, ROWS>(p.nsteps), tl.tiles, &limit,
                             stream, in, static_cast<T*>(out), p, tl);
  } else {
    return mm::launch_blocks(fused_stencil_halo_kernel<ROWS, MOORE, T>,
                             smem_of<T, ROWS>(p.nsteps), tl.tiles, &limit,
                             stream, in, static_cast<T*>(out), p, tl);
  }
}

template <int ROWS, bool MOORE, typename T, typename In>
cudaError_t launch_near(In in, void* out, const Params& p, const Bands& bs,
                        int tiles, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(fused_stencil_near_kernel<ROWS, MOORE, T>,
                             smem_of<T, ROWS>(p.nsteps), tiles, &limit,
                             stream, in, static_cast<T*>(out), p, bs);
  } else {
    return mm::launch_blocks(fused_stencil_halo_near_kernel<ROWS, MOORE, T>,
                             smem_of<T, ROWS>(p.nsteps), tiles, &limit,
                             stream, in, static_cast<T*>(out), p, bs);
  }
}

template <int ROWS, bool MOORE, typename T, typename In>
cudaError_t launch_bf16(In in, void* out, const Params& p,
                        const RegionTiling& tl, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(fused_stencil_bf16_kernel<ROWS, MOORE, T>,
                             smem16_of<T, ROWS, MOORE>(), tl.tiles, &limit,
                             stream, in, static_cast<T*>(out), p, tl);
  } else {
    return mm::launch_blocks(fused_stencil_halo_bf16_kernel<ROWS, MOORE, T>,
                             smem16_of<T, ROWS, MOORE>(), tl.tiles, &limit,
                             stream, in, static_cast<T*>(out), p, tl);
  }
}

// The window rows of the f32 walk (the f32 interior math, and the bf16
// interior math's near launch), chosen by measurement on the H100
// (k1_variants.py, PERF.md): the fewest rows keep the halo rows' share of
// the loads low at small n; more rows cut the halo's share of the steps at
// larger n, at two blocks an SM (128 registers). Neighbourhoods other than
// Moore keep 48 (their kernel holds more).
int rows_for(const Params& p) {
  return !p.moore || p.nsteps <= 2 ? 48 : 64;
}

// The paired launch's window rows the source is built for
// (ops/fused_stencil.py::paired_rows picks one and passes it): Moore on row
// pairs 64 or 96; other neighbourhoods 48.
bool valid_rows16(const Params& p, int rows16) {
  return p.moore ? rows16 == 64 || rows16 == 96 : rows16 == 48;
}

// One call of K1 or K2 on the array `a`. f32 interior math: one launch.
// bf16 interior math (`bf16`): the near launch over the bands around the
// rectangle q (rows_for's rows), then the paired launch over the rectangle
// (`rows16`), each on its own tiling, each writing only its own cells. A
// launch with no cell to write is not made (CUDA refuses 0 blocks): a call
// whose rectangle is empty, or holds the whole array, makes one launch.
// That is the call's geometry, not a fallback.
template <typename T, typename In>
int step(In in, void* out, const Array& a, Params p, int bf16,
         const mm::Rect& q, int rows16, void* stream) {
  p.vec = a.vec;
  const int n = p.nsteps;
  const int rows = rows_for(p);
  cudaError_t err = cudaSuccess;
  if (!bf16) {
    const Tiling tl =
        mm::make_tiling(rows, n, n, a.h, a.w, a.R0, a.C0, a.H, a.W);
    if (rows == 64) {
      err = launch_f32<64, true, T>(in, out, p, tl, stream);
    } else {
      err = p.moore ? launch_f32<48, true, T>(in, out, p, tl, stream)
                    : launch_f32<48, false, T>(in, out, p, tl, stream);
    }
    return static_cast<int>(err);
  }
  const Split s = mm::split_of(q, a);
  Bands bs;
  const int near = mm::bands_of(rows, n, n, a, s, bs);
  if (near > 0) {
    if (rows == 64) {
      err = launch_near<64, true, T>(in, out, p, bs, near, stream);
    } else {
      err = p.moore ? launch_near<48, true, T>(in, out, p, bs, near, stream)
                    : launch_near<48, false, T>(in, out, p, bs, near, stream);
    }
  }
  if (err != cudaSuccess || s.empty()) return static_cast<int>(err);
  const RegionTiling tl =
      mm::region_tiling(rows16, n, n, a, s.a0, s.a1, s.b0, s.b1);
  switch (rows16) {
    case 96: err = launch_bf16<96, true, T>(in, out, p, tl, stream); break;
    case 64: err = launch_bf16<64, true, T>(in, out, p, tl, stream); break;
    default: err = launch_bf16<48, false, T>(in, out, p, tl, stream);
  }
  return static_cast<int>(err);
}

template <typename T>
int dense(const void* in, void* out, int H, int W, const Params& p,
          int bf16, const mm::Rect& q, int rows16, void* stream) {
  if (!valid_steps(p) || H < 0 || W < 0 ||
      (bf16 && (p.nsteps < 2 || !valid_rows16(p, rows16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || W == 0) return 0;
  const Array a{H, W, 0, 0, H, W, mm::rows_aligned<T>(in, W)};
  return step<T>(static_cast<const T*>(in), out, a, p, bf16, q, rows16,
                 stream);
}

template <typename T>
int halo(const void* args, void* out, const Params& p, int bf16,
         const mm::Rect& q, int rows16, void* stream) {
  const auto* h = static_cast<const mm::HaloArgs*>(args);
  if (h == nullptr || !valid_steps(p) ||
      !mm::valid_halo(*h, p.nsteps, MAX_STEPS) ||
      (bf16 && (p.nsteps < 2 || !valid_rows16(p, rows16)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h->h == 0 || h->w == 0) return 0;
  const mm::HaloSource<T> src(*h);
  const Array a{src.h, src.w, src.R0, src.C0, src.H, src.W,
                mm::rows_aligned<T>(h->shard, h->w)};
  return step<T>(src, out, a, p, bf16, q, rows16, stream);
}

Params make_params(float rate, float keep, float ca, float cb, int nsteps,
                   int mask9, int noff, int offcodes, int moore,
                   float ca16 = 0.f, float cb16 = 0.f) {
  Params p;
  p.nsteps = nsteps;
  p.mask9 = mask9;
  p.noff = noff;
  p.offcodes = offcodes;
  p.moore = moore;
  p.vec = 0;
  p.rate = rate;
  p.keep = keep;
  p.ca = ca;
  p.cb = cb;
  p.ca16 = mm::bf16_bits(ca16);
  p.cb16 = mm::bf16_bits(cb16);
  return p;
}

}  // namespace

extern "C" {

// The step arguments (ops/fused_stencil.py::_step_args): the exact path's
// rate and 1 - rate, the closed form's f32 constants, the steps and the
// neighbourhood; then the bf16 interior math: on or off, its rectangle
// (global rows [r0, r1), columns [c0, c1)), its bf16 constants and the
// paired launch's window rows.
#define MM_STEP_ARGS                                                        \
  float rate, float keep, float ca, float cb, int nsteps, int mask9,       \
      int noff, int offcodes, int moore, int bf16, int r0, int r1, int c0, \
      int c1, float ca16, float cb16, int rows16
#define MM_PARAMS                                                         \
  make_params(rate, keep, ca, cb, nsteps, mask9, noff, offcodes, moore,  \
              ca16, cb16)

int mm_fused_stencil_f32(const void* in, void* out, int H, int W,
                         MM_STEP_ARGS, void* stream) {
  return dense<float>(in, out, H, W, MM_PARAMS, bf16,
                      mm::Rect{r0, r1, c0, c1}, rows16, stream);
}

int mm_fused_stencil_bf16(const void* in, void* out, int H, int W,
                          MM_STEP_ARGS, void* stream) {
  return dense<__nv_bfloat16>(in, out, H, W, MM_PARAMS, bf16,
                              mm::Rect{r0, r1, c0, c1}, rows16, stream);
}

int mm_fused_stencil_halo_f32(const void* args, void* out, MM_STEP_ARGS,
                              void* stream) {
  return halo<float>(args, out, MM_PARAMS, bf16, mm::Rect{r0, r1, c0, c1},
                     rows16, stream);
}

int mm_fused_stencil_halo_bf16(const void* args, void* out, MM_STEP_ARGS,
                               void* stream) {
  return halo<__nv_bfloat16>(args, out, MM_PARAMS, bf16,
                             mm::Rect{r0, r1, c0, c1}, rows16, stream);
}

// The geometry step() gives a bf16-interior call on an [h, w] array at
// global (R0, C0) of an [H, W] grid: out[0] the near launch's rows
// (rows_for), then the paired region and the four bands (top, bottom,
// left, right), five ints each: local rows [r0, r1), columns [c0, c1), and
// the tiles launched over it (26 ints). It launches nothing: the card
// tests and chip_smoke.py hold ops/fused_stencil.py's window_rows,
// bf16_regions and region_tiles to it.
int mm_fused_bf16_plan(int h, int w, int R0, int C0, int H, int W,
                       MM_STEP_ARGS, int* out) {
  const Params p = MM_PARAMS;
  if (!valid_steps(p) || h < 0 || w < 0 || nsteps < 2 ||
      !valid_rows16(p, rows16) || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  (void)bf16;
  const Array a{h, w, R0, C0, H, W, 0};
  const int rows = rows_for(p);
  const Split s = mm::split_of(mm::Rect{r0, r1, c0, c1}, a);
  Bands bs;
  mm::bands_of(rows, nsteps, nsteps, a, s, bs);
  out[0] = rows;
  mm::write_plan(mm::region_tiling(rows16, nsteps, nsteps, a, s.a0, s.a1,
                                   s.b0, s.b1),
                 bs, out + 1);
  return 0;
}

int mm_halo_args_size() { return static_cast<int>(sizeof(mm::HaloArgs)); }

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mm_max_steps() { return MAX_STEPS; }

}  // extern "C"
