// K3: the composed k-step dense filter, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_stencil_call
// run with the composed-filter interior hooks of
// mpi_model_tpu/ops/composed_stencil.py, reached through composed_dense_step
// and ComposedDiffusionStep. One call advances k uniform-rate transport
// steps. The form is chosen per cell, from global coordinates: a cell at
// distance d = min(R, H-1-R, C, W-1-C) > k from every global edge takes the
// composed operator S^k in the form of the resolved variant; every other
// cell takes the exact iterated path, K1's k masked steps
// (stencil_common.cuh), because near the edge the per-cell divisor makes
// the operator vary in space and it does not compose. Since the choice is
// per cell, a sharded run (K3-halo) takes the same form for every cell as
// the whole-grid run, wherever the shard edges fall.
//
// Two forms, one a JAX variant, each with its plain version in
// ops/composed_stencil.py:
//
//   - "vpu" (_make_vpu_hook): the binomial expansion
//       S^k = sum_j coef_j * B^j,  coef_j = C(k, j) a^(k-j) b^j,
//     B the 3 x 3 box for Moore (a = 1 - r - r/8, b = r/8) or the
//     neighbours summed in `offsets` order (a = 1 - r, b = r/|offsets|),
//     the coefficients formed in f64 on the host and rounded to f32 once.
//     acc = coef_0 * v, then for j = 1..k: cur = B(cur), acc = acc +
//     coef_j * cur. Every operation is an _rn intrinsic in that order and
//     the source builds with --fmad=false, so the kernel equals its plain
//     version bit for bit. Design: K1's register column walk
//     (stencil_common.cuh): a window column a thread, bands by __shfl_sync,
//     the warp edges through one shared row a step, cp.async windows, a
//     block a tile at two blocks an SM; the accumulator over the tile's
//     output rows sits in registers beside the window. Its rows are a
//     compile-time range, so the window's rows above the tile are a
//     compile-time offset OFF >= k (48 rows with OFF 8 for Moore k <= 8,
//     64 with OFF 16 above; 48 with OFF 16 for the other neighbourhoods):
//     tiles of (ROWS - 2 OFF) x (256 - 2k) cells.
//   - "mxu" (_make_mxu_hook): the (2k+1)^2 tap correlation with the f64
//     table rounded to f32 (composed_taps), on tensor cores (mma.sync). For
//     each row offset dr the output rows are a product A_dr B_dr: A the
//     window rows shifted by dr (16 rows a warp, read with ldmatrix from
//     per-row addresses, so the shift is only an address), B_dr the banded
//     tap matrix B_dr[m, c] = taps[dr][m - c] on 0 <= m - c <= 2k. B_dr's
//     blocks depend on m - c only, so the host builds them once per table,
//     in fragment order (ops/composed_stencil.py::mxu_fragments), and the
//     warps read them through the read-only cache. A warp's tile is MT m16
//     tiles (16 MT rows, under one set of B fragments) x MX_N columns; an A
//     block of KB columns feeds every n8 tile whose band it meets. Precision:
//     plain TF32 (an 11-bit significand) would miss the plain version's
//     1e-6 k; so f32 is split, x = hi + lo with hi and lo TF32, the window
//     here (split_tf32) and the taps on the host, and the product is
//     hi*hi + hi*lo + lo*hi (3xTF32, about 22 bits). The tensor cores add
//     into an f32 accumulator with truncation, a bias of about half an ulp
//     of the running sum per MMA: one accumulator over all 2k + 1 row
//     offsets lost about 1.3e-6 of the mass a call (f32 k = 8 on an H100),
//     past the model's conservation check. So each row offset's products
//     go into fresh partial sums (each A block's small terms before its
//     hi*hi), and the partial sums are added to the result with one
//     rounded add each: the bias falls to the scale of one row offset's
//     chain. bf16 values are exact in bf16,
//     so A needs no split; the taps are split into two bf16 terms (about 16
//     bits), both into one accumulator (the result is rounded to bf16).
//     Tiles are aligned to the global grid (origins at multiples of the
//     block tile's rows and columns), so every cell's products land in the
//     same MMA slots in a shard as in the whole grid and K3-halo's mosaic
//     equals K3 bit for bit; a shard whose origin is not aligned starts
//     with a partial tile.
//
// Edge tiles of both forms run their form on every cell, then the exact
// strips (mm::exact_cells) on their cells with d <= k.
//
// K3-halo is the same two bodies on one shard of a sharded grid: it replaces
// the composed hooks run through _stencil_call in halo mode
// (composed_halo_step, used by parallel/executors.py::ShardMapExecutor with
// step_impl "composed"). Windows inside the shard are read from it (the
// vpu form by cp.async); windows at its edge read the exchanged ghost ring
// of depth d >= k through mm::HaloSource; forms and counts use the cell's
// global row and column against the global grid.
//
// Storage is float or __nv_bfloat16; the math is f32; bf16 is rounded once
// per call, as in K1.
//
// bf16 interior math (compute_dtype=bfloat16; `bf16` and its rectangle
// mm::Rect of global cells, the TPU kernel's tiles that are not near the
// edge): the JAX hooks then run on the window cast to bf16. vpu: the
// binomial sum with every operation rounded to bf16 and the coefficients
// rounded to bf16 on the host (ops/composed_stencil.py::vpu_coefs_bf16),
// bit for bit its plain version, as two launches (the section "the vpu
// form's bf16 interior math" below): a near launch over the bands around
// the rectangle and a paired launch over the rectangle (Moore on row pairs,
// mm::paired_step, the accumulator in pairs too; other neighbourhoods the
// f32 walk with every result rounded, mm::walk_step<..., true>). mxu:
// A the window rounded to bf16 and B the taps rounded to bf16 (the first
// term of the bf16 table), m16n8k16 with f32 accumulation; bf16 products
// are exact in f32, so it differs from its plain version (the products
// summed from zero in row-major tap order) by the order of the f32 sums
// only. Cells outside the rectangle take the f32 form over the window
// rounded to bf16, exact strips included. Its kernels walk the f32 form's
// block tiles persistently (the section "the mxu form's bf16 interior
// math" below): one bf16 window a tile serves both passes.
//
// C interface (loaded with ctypes): one entry point a form, dtype and mode,
// each returning the cudaError_t of its launch, 0 on success.

#include <algorithm>
#include <type_traits>

#include "stencil_common.cuh"

namespace {

constexpr int MAX_K = 16;
constexpr int NWARPS = mm::kThreadsY;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

using mm::StepParams;
using mm::Tiling;
using mm::piece_floats;

// The vpu form's f32 coefficients coef_0 .. coef_k (a __grid_constant__
// kernel parameter: a step indexes it in place); the bf16 interior math's
// take values exact in bf16.
struct Coefs {
  float c[MAX_K + 1];
};

bool valid_k(int k, int kmax, int mask9, int noff) {
  return k >= 1 && k <= kmax && (mask9 & ~0x1EF) == 0 && mask9 != 0 &&
         noff == __builtin_popcount(mask9);
}

// -- the vpu form -------------------------------------------------------------

// Blocks an SM the f32 walk's kernels are built for (128 registers a thread
// at 2), and where its accumulator lives (registers; shared memory, one f32
// a cell, when true). Measured on the H100: k3_variants.py, PERF.md.
constexpr int kVpuMinBlocks = 2;
constexpr bool kAccShared = false;

// kThreadsY warps' exchange, (kAccShared) the accumulator, then the staging
// buffer or the exact buffers.
template <typename T, int ROWS, int OFF>
int vpu_smem(int k) {
  const int exact = 2 * piece_floats(k) * static_cast<int>(sizeof(float));
  const int stage = mm::stage_bytes<T, ROWS>();
  const int work = ((stage > exact ? stage : exact) + 15) / 16 * 16;
  const int acc = kAccShared ? (ROWS - 2 * OFF) * mm::kWinW * 4 : 0;
  return mm::kExchFloats<ROWS> * static_cast<int>(sizeof(float)) + work +
         acc;
}

// The binomial sum of tile t of `tl` (a Tiling, or one region's
// mm::RegionTiling) over its window in registers. PASS 0: f32; 1: f32 over
// the window rounded to bf16 (the bf16 interior math's near launch); 2:
// bf16, every operation rounded, `cf` the bf16 coefficients (the paired
// launch of the neighbourhoods other than Moore). Written where a cell lies
// in the tiling's rows and columns and (PASS 0 and 1) has d > k; every cell
// of the paired launch's rectangle has d > k. `col` is this thread's column
// of the staged window, `ex` the walk's exchange (its slots of warps -1 and
// kThreadsY zero), `accs` the accumulator when it is shared.
template <int ROWS, int OFF, bool MOORE, int PASS, typename T, typename TL>
__device__ __forceinline__ void vpu_pass(const T* col, float* ex,
                                         float* accs, T* __restrict__ out,
                                         const StepParams& p,
                                         const Coefs& cf, const TL& tl,
                                         int t, bool whole) {
  constexpr int TH = ROWS - 2 * OFF;  // the tile's rows
  constexpr bool RB = PASS == 2;      // bf16 operations
  const int k = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  float acc[kAccShared ? 1 : TH];
  accs += j;
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const float x = mm::to_f32(col[i * mm::kStagePitch<T>]);
    v[i] = PASS == 0 ? x : mm::rb(x);
  }
  // acc = coef_0 * v over the tile's rows
  if constexpr (kAccShared) {
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      accs[r * mm::kWinW] = mm::rnd<RB>(__fmul_rn(cf.c[0], v[OFF + r]));
    }
  } else {
#pragma unroll
    for (int r = 0; r < TH; ++r) {
      acc[r] = mm::rnd<RB>(__fmul_rn(cf.c[0], v[OFF + r]));
    }
  }
  int drow[8], dcol[8];
  mm::offset_rows_cols(p.offcodes, drow, dcol);
  for (int s = 0; s < k; ++s) {
    const float cj = cf.c[s + 1];
    mm::walk_step<ROWS, MOORE, RB>(
        v, ex + (s & 1) * mm::kEdgeSlots * ROWS, drow, dcol, p.noff,
        [&](int i, float, float g) {
          if (i >= OFF && i < ROWS - OFF) {
            if constexpr (kAccShared) {
              float* a = accs + (i - OFF) * mm::kWinW;
              *a = mm::rnd<RB>(__fadd_rn(*a, mm::rnd<RB>(__fmul_rn(cj, g))));
            } else {
              acc[i - OFF] = mm::rnd<RB>(
                  __fadd_rn(acc[i - OFF], mm::rnd<RB>(__fmul_rn(cj, g))));
            }
          }
          return g;
        });
  }

  // columns [k, kWinW - k) of the tile's rows
  const int r = tl.row_of(t);
  const int c = tl.col_of(t) + j - k;
  if (j >= k && j < mm::kWinW - k && c < mm::col_end(tl)) {
#pragma unroll
    for (int qr = 0; qr < TH; ++qr) {
      const bool ok =
          PASS == 2 ? r + qr < mm::row_end(tl)
                    : whole || (r + qr < mm::row_end(tl) &&
                                mm::edge_distance(tl.R0 + r + qr, tl.C0 + c,
                                                  tl.H, tl.W) > k);
      if (ok) {
        float a;
        if constexpr (kAccShared) {
          a = accs[qr * mm::kWinW];
        } else {
          a = acc[qr];
        }
        mm::from_f32(out + static_cast<size_t>(r + qr) * tl.w + c, a);
      }
    }
  }
}

// Block t of `tl` with f32 interior math: the binomial sum of tile t in
// registers, written where a cell has d > k, then the exact strips of an
// edge tile.
template <int ROWS, int OFF, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void vpu_body(const Src& src, T* __restrict__ out,
                                         const StepParams& p,
                                         const Coefs& cf, const Tiling& tl) {
  constexpr int TH = ROWS - 2 * OFF;  // the tile's rows
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;                            // warp-edge exchange
  float* accs = smem + mm::kExchFloats<ROWS>;  // (kAccShared) accumulator
  float* work = accs + (kAccShared ? TH * mm::kWinW : 0);  // staging, exact
  T* stage = reinterpret_cast<T*>(work);
  const int t = blockIdx.x;
  const int k = p.nsteps;
  const bool whole = tl.interior(t);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int skew = mm::stage_window<ROWS>(src, p, tl, t, whole, stage);
  for (int q = j; q < mm::kExchFloats<ROWS>; q += mm::kWinW) ex[q] = 0.f;
  mm::cp_async_wait_all();
  __syncthreads();
  vpu_pass<ROWS, OFF, MOORE, 0>(stage + skew + j, ex, accs, out, p, cf, tl,
                                t, whole);
  if (!whole) {
    // the cells with d <= k, in the staging buffer's space
    __syncthreads();
    mm::exact_cells(src, out, p, tl, tl.row_of(t),
                    min(tl.row_of(t) + tl.th, tl.h), tl.col_of(t),
                    min(tl.col_of(t) + tl.tw, tl.w), work,
                    work + piece_floats(k));
  }
}

// K3 vpu: a whole [H, W] grid. The kernels of the f32 interior math keep
// the parameter layout they were measured with, the bf16 interior math's
// coefficients and rectangle included though they read neither: without
// them ptxas gives the non-Moore instances 127 registers in place of 128
// (k3_variants.py, PERF.md).
template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_kernel(const T* __restrict__ in, T* __restrict__ out,
                        StepParams p, const __grid_constant__ Coefs cf,
                        const __grid_constant__ Coefs, Tiling tl, mm::Rect) {
  vpu_body<ROWS, OFF, MOORE>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p, cf,
                             tl);
}

// K3-halo vpu: one shard and its ghost ring; `out` is the shard's [h, w].
template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_halo_kernel(const mm::HaloSource<T> src,
                             T* __restrict__ out, StepParams p,
                             const __grid_constant__ Coefs cf,
                             const __grid_constant__ Coefs, Tiling tl,
                             mm::Rect) {
  vpu_body<ROWS, OFF, MOORE>(src, out, p, cf, tl);
}

// -- the vpu form's bf16 interior math: two launches ---------------------------
//
// A call is two launches, each on its own tiling (stencil_common.cuh's
// regions) and each writing only its own cells:
//
//   - the near launch (composed_vpu_near_kernel / _halo_near_kernel) tiles
//     the four bands of the array around the rectangle, each from its own
//     origin, at the f32 walk's window (vpu_window), and runs the f32 sum
//     over the window rounded to bf16 (PASS 1) on its cells with d > k and
//     the exact strips over the rounded source on the rest;
//   - the paired launch (composed_vpu16_kernel / _halo_kernel) tiles the
//     rectangle from its origin at its own window (paired_window) and runs
//     the bf16 sum and nothing else: every cell of the rectangle has d > k,
//     so it needs no distance test and no exact strip. Moore: the window
//     staged raw by cp.async and read into row pairs (rows 2m and 2m + 1 a
//     register, no f32 copy beside them), mm::paired_step (the bands of a
//     step's first pass kept for its second) with the accumulator's pairs
//     taking mul.rn.bf16x2 and add.rn.bf16x2 in the step's finish; other
//     neighbourhoods the f32 walk with every operation rounded (PASS 2).
//
// One kernel with both walks (every block testing the rectangle, the blocks
// across its edge running both) held the paired walk to the f32 walk's
// window and registers and formed its bands twice a step. Every bf16
// operation rounds once and none is contracted, so the result is the plain
// version's bit for bit.

// Blocks an SM the paired kernels are built for. Measured on the H100:
// k3_variants.py, PERF.md.
constexpr int kPairedMinBlocks = 2;
// The paired launch's window rows for Moore (a multiple of 8: pairs move
// four at a time), at OFF 8 (k <= 8) and OFF 16 (k <= 16), and at OFF 2
// (k <= 2; 0: no such instance, those k take OFF 8). Measured on the H100:
// k3_variants.py, PERF.md.
constexpr int kPairedRows8 = 96;
constexpr int kPairedRows16 = 96;
constexpr int kPairedRows2 = 64;

// A walk's window: its rows and the rows above a tile (OFF >= k).
struct Window {
  int rows, off;
};

// The f32 walk's window (f32 interior math, and the near launch): Moore 48
// rows (OFF 8) up to k = 8 and 64 (OFF 16) above; other neighbourhoods 48
// rows (OFF 16), their walk holds more.
Window vpu_window(int k, bool moore) {
  if (!moore) return {48, 16};
  return k <= 8 ? Window{48, 8} : Window{64, 16};
}

// The paired launch's window (ops/composed_stencil.py::paired_rows):
// Moore at the kPairedRows* above; other neighbourhoods the f32 walk's 48
// rows (OFF 16).
Window paired_window(int k, bool moore) {
  if (!moore) return {48, 16};
  if (kPairedRows2 > 0 && k <= 2) return {kPairedRows2, 2};
  return k <= 8 ? Window{kPairedRows8, 8} : Window{kPairedRows16, 16};
}

// The near launch on one tile of a band: the f32 sum over the window
// rounded to bf16 (the TPU kernel's near tiles) for its cells with d > k,
// the exact strips through mm::RoundedSource for the rest.
template <int ROWS, int OFF, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void vpu_near_body(const Src& src,
                                              T* __restrict__ out,
                                              const StepParams& p,
                                              const Coefs& cf,
                                              const mm::Bands& bs) {
  constexpr int TH = ROWS - 2 * OFF;
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;
  float* accs = smem + mm::kExchFloats<ROWS>;
  float* work = accs + (kAccShared ? TH * mm::kWinW : 0);
  T* stage = reinterpret_cast<T*>(work);
  const int band = mm::band_of(bs);
  const mm::RegionTiling& tl = bs.band[band];
  const int t = blockIdx.x - bs.first[band];
  const int k = p.nsteps;
  const bool whole = tl.interior(t);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int skew = mm::stage_window<ROWS>(src, p, tl, t, whole, stage);
  for (int q = j; q < mm::kExchFloats<ROWS>; q += mm::kWinW) ex[q] = 0.f;
  mm::cp_async_wait_all();
  __syncthreads();
  vpu_pass<ROWS, OFF, MOORE, 1>(stage + skew + j, ex, accs, out, p, cf, tl,
                                t, whole);
  if (!whole) {
    __syncthreads();
    mm::exact_cells_of<true>(src, out, p, tl, tl.row_of(t),
                             min(tl.row_of(t) + tl.th, tl.r1), tl.col_of(t),
                             min(tl.col_of(t) + tl.tw, tl.c1), work,
                             work + piece_floats(k));
  }
}

// The paired launch on one tile of the rectangle: the bf16 sum (the header
// of this section), the coefficients `cf16` exact in bf16.
template <int ROWS, int OFF, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void vpu16_body(const Src& src,
                                           T* __restrict__ out,
                                           const StepParams& p,
                                           const Coefs& cf16,
                                           const mm::RegionTiling& tl) {
  constexpr int TH = ROWS - 2 * OFF;  // the tile's rows
  extern __shared__ __align__(16) float smem[];
  const int t = blockIdx.x;
  const int k = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  if constexpr (MOORE) {
    static_assert(OFF % 2 == 0 && TH % 2 == 0, "rows pair up");
    constexpr int P = ROWS / 2, H0 = OFF / 2, HT = TH / 2;
    constexpr int kExch = mm::kEdgeSlots * P;  // one parity's words
    unsigned* ex16 = reinterpret_cast<unsigned*>(smem);
    T* stage = reinterpret_cast<T*>(smem + 2 * kExch);
    // every cell has d > k: a window inside the array is copied as it is
    const int skew = mm::stage_window<ROWS>(src, p, tl, t, true, stage);
    for (int e = j; e < 2 * kExch; e += mm::kWinW) ex16[e] = 0u;
    mm::cp_async_wait_all();
    __syncthreads();
    const T* col = stage + skew + j;
    unsigned w[P];
#pragma unroll
    for (int m = 0; m < P; ++m) {
      w[m] = mm::pair_of(col + 2 * m * mm::kStagePitch<T>,
                         col + (2 * m + 1) * mm::kStagePitch<T>);
    }
    const auto pair = [](float c) {
      const unsigned b = __float_as_uint(c) >> 16;  // c is a bf16 value
      return b | (b << 16);
    };
    // acc = coef_0 * v over the tile's rows, in pairs
    unsigned a2[HT];
    const unsigned c0 = pair(cf16.c[0]);
#pragma unroll
    for (int r = 0; r < HT; ++r) a2[r] = mm::mul_bf2(c0, w[H0 + r]);
    for (int s = 0; s < k; ++s) {
      const unsigned cj = pair(cf16.c[s + 1]);
      mm::paired_step<ROWS>(
          w, ex16 + (s & 1) * kExch, [&](int m, unsigned, unsigned g) {
            if (m >= H0 && m < H0 + HT) {
              a2[m - H0] = mm::add_bf2(a2[m - H0], mm::mul_bf2(cj, g));
            }
            return g;
          });
    }
    // columns [k, kWinW - k) of the tile's rows inside the rectangle
    const int r = tl.row_of(t);
    const int c = tl.col_of(t) + j - k;
    if (j < k || j >= mm::kWinW - k || c >= tl.c1) return;
#pragma unroll
    for (int q = 0; q < HT; ++q) {
      const unsigned a = a2[q];
      if (r + 2 * q < tl.r1) {
        mm::from_f32(out + static_cast<size_t>(r + 2 * q) * tl.w + c,
                     mm::lo_f32(a));
      }
      if (r + 2 * q + 1 < tl.r1) {
        mm::from_f32(out + static_cast<size_t>(r + 2 * q + 1) * tl.w + c,
                     mm::hi_f32(a));
      }
    }
  } else {
    float* ex = smem;
    float* accs = smem + mm::kExchFloats<ROWS>;
    T* stage = reinterpret_cast<T*>(accs + (kAccShared ? TH * mm::kWinW : 0));
    const int skew = mm::stage_window<ROWS>(src, p, tl, t, true, stage);
    for (int q = j; q < mm::kExchFloats<ROWS>; q += mm::kWinW) ex[q] = 0.f;
    mm::cp_async_wait_all();
    __syncthreads();
    vpu_pass<ROWS, OFF, false, 2>(stage + skew + j, ex, accs, out, p, cf16,
                                  tl, t, true);
  }
}

template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_near_kernel(const T* __restrict__ in, T* __restrict__ out,
                             StepParams p, const __grid_constant__ Coefs cf,
                             const __grid_constant__ mm::Bands bs) {
  vpu_near_body<ROWS, OFF, MOORE>(
      mm::DenseSource<T>{in, bs.band[0].H, bs.band[0].W}, out, p, cf, bs);
}

template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_halo_near_kernel(const mm::HaloSource<T> src,
                                  T* __restrict__ out, StepParams p,
                                  const __grid_constant__ Coefs cf,
                                  const __grid_constant__ mm::Bands bs) {
  vpu_near_body<ROWS, OFF, MOORE>(src, out, p, cf, bs);
}

template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kPairedMinBlocks)
    composed_vpu16_kernel(const T* __restrict__ in, T* __restrict__ out,
                          StepParams p, const __grid_constant__ Coefs cf16,
                          mm::RegionTiling tl) {
  vpu16_body<ROWS, OFF, MOORE>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p,
                               cf16, tl);
}

template <int ROWS, int OFF, bool MOORE, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kPairedMinBlocks)
    composed_vpu16_halo_kernel(const mm::HaloSource<T> src,
                               T* __restrict__ out, StepParams p,
                               const __grid_constant__ Coefs cf16,
                               mm::RegionTiling tl) {
  vpu16_body<ROWS, OFF, MOORE>(src, out, p, cf16, tl);
}

// The largest k each dtype composes (ops/composed_stencil.py::max_k: the
// window's ghost depth, 8 rows f32, 16 bf16).
template <typename T>
constexpr int kMaxK = sizeof(T) == 4 ? 8 : 16;

// Shared memory of a paired-launch block: the exchange (Moore in pair
// words, [2][kEdgeSlots][ROWS / 2]; other neighbourhoods the f32 walk's and
// its accumulator) and the staged window.
template <typename T, int ROWS, int OFF, bool MOORE>
int vpu16_smem() {
  return (MOORE ? 2 * mm::kEdgeSlots * (ROWS / 2)
                : mm::kExchFloats<ROWS> +
                      (kAccShared ? (ROWS - 2 * OFF) * mm::kWinW : 0)) *
             static_cast<int>(sizeof(float)) +
         mm::stage_bytes<T, ROWS>();
}

// Each kernel's launch, on K3's input (In: const T*) or K3-halo's source
// (In: mm::HaloSource<T>).
template <int ROWS, int OFF, bool MOORE, typename T, typename In>
cudaError_t launch_f32(In in, void* out, const StepParams& p,
                       const Coefs& cf, const Tiling& tl, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  const int smem = vpu_smem<T, ROWS, OFF>(p.nsteps);
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(composed_vpu_kernel<ROWS, OFF, MOORE, T>, smem,
                             tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, cf, Coefs{}, tl,
                             mm::Rect{});
  } else {
    return mm::launch_blocks(composed_vpu_halo_kernel<ROWS, OFF, MOORE, T>,
                             smem, tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, cf, Coefs{}, tl,
                             mm::Rect{});
  }
}

template <int ROWS, int OFF, bool MOORE, typename T, typename In>
cudaError_t launch_near(In in, void* out, const StepParams& p,
                        const Coefs& cf, const mm::Bands& bs, int tiles,
                        void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;
  const int smem = vpu_smem<T, ROWS, OFF>(p.nsteps);
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(composed_vpu_near_kernel<ROWS, OFF, MOORE, T>,
                             smem, tiles, &limit, stream, in,
                             static_cast<T*>(out), p, cf, bs);
  } else {
    return mm::launch_blocks(
        composed_vpu_halo_near_kernel<ROWS, OFF, MOORE, T>, smem, tiles,
        &limit, stream, in, static_cast<T*>(out), p, cf, bs);
  }
}

template <int ROWS, int OFF, bool MOORE, typename T, typename In>
cudaError_t launch16(In in, void* out, const StepParams& p,
                     const Coefs& cf16, const mm::RegionTiling& tl,
                     void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;
  const int smem = vpu16_smem<T, ROWS, OFF, MOORE>();
  if constexpr (std::is_pointer<In>::value) {
    return mm::launch_blocks(composed_vpu16_kernel<ROWS, OFF, MOORE, T>,
                             smem, tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, cf16, tl);
  } else {
    return mm::launch_blocks(composed_vpu16_halo_kernel<ROWS, OFF, MOORE, T>,
                             smem, tl.tiles, &limit, stream, in,
                             static_cast<T*>(out), p, cf16, tl);
  }
}

// One vpu call on the array `a`. f32 interior math: one launch at the f32
// walk's window. bf16 interior math (`bf16`): the near launch over the
// bands around the rectangle q, then the paired launch over the rectangle,
// each on its own tiling, each writing only its own cells. A launch with
// no cell to write is not made (CUDA refuses 0 blocks): a call whose
// rectangle is empty, or holds the whole array, makes one launch. That is
// the call's geometry, not a fallback.
template <typename T, typename In>
int vpu_step(In in, void* out, const mm::Array& a, StepParams p,
             const Coefs& cf, int bf16, const Coefs& cf16, const mm::Rect& q,
             void* stream) {
  p.vec = a.vec;
  const int k = p.nsteps;
  const Window g = vpu_window(k, p.moore);
  cudaError_t err = cudaSuccess;
  if (!bf16) {
    const Tiling tl =
        mm::make_tiling(g.rows, g.off, k, a.h, a.w, a.R0, a.C0, a.H, a.W);
    if (!p.moore) {
      err = launch_f32<48, 16, false, T>(in, out, p, cf, tl, stream);
    } else if (g.off == 8) {
      err = launch_f32<48, 8, true, T>(in, out, p, cf, tl, stream);
    } else if constexpr (kMaxK<T> > 8) {
      err = launch_f32<64, 16, true, T>(in, out, p, cf, tl, stream);
    }
    return static_cast<int>(err);
  }
  const mm::Split s = mm::split_of(q, a);
  mm::Bands bs;
  const int near = mm::bands_of(g.rows, g.off, k, a, s, bs);
  if (near > 0) {
    if (!p.moore) {
      err = launch_near<48, 16, false, T>(in, out, p, cf, bs, near, stream);
    } else if (g.off == 8) {
      err = launch_near<48, 8, true, T>(in, out, p, cf, bs, near, stream);
    } else if constexpr (kMaxK<T> > 8) {
      err = launch_near<64, 16, true, T>(in, out, p, cf, bs, near, stream);
    }
  }
  if (err != cudaSuccess || s.empty()) return static_cast<int>(err);
  const Window g16 = paired_window(k, p.moore);
  const mm::RegionTiling tl =
      mm::region_tiling(g16.rows, g16.off, k, a, s.a0, s.a1, s.b0, s.b1);
  if (!p.moore) {
    err = launch16<48, 16, false, T>(in, out, p, cf16, tl, stream);
  } else if (g16.off == 2) {
    if constexpr (kPairedRows2 > 0) {
      err = launch16<kPairedRows2, 2, true, T>(in, out, p, cf16, tl,
                                               stream);
    }
  } else if (g16.off == 8) {
    err = launch16<kPairedRows8, 8, true, T>(in, out, p, cf16, tl, stream);
  } else if constexpr (kMaxK<T> > 8) {
    err = launch16<kPairedRows16, 16, true, T>(in, out, p, cf16, tl, stream);
  }
  return static_cast<int>(err);
}

template <typename T>
int vpu(const T* in, const mm::HaloArgs* halo, void* out, int H, int W,
        const StepParams& p, const float* coefs, int bf16,
        const mm::Rect& q, const float* coefs16, void* stream) {
  if (!valid_k(p.nsteps, kMaxK<T>, p.mask9, p.noff) || coefs == nullptr ||
      (bf16 && coefs16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Coefs cf = {}, cf16 = {};
  for (int j = 0; j <= p.nsteps; ++j) {
    cf.c[j] = coefs[j];
    cf16.c[j] = bf16 ? coefs16[j] : 0.f;
  }
  if (halo == nullptr) {
    const mm::Array a{H, W, 0, 0, H, W, mm::rows_aligned<T>(in, W)};
    return vpu_step<T>(in, out, a, p, cf, bf16, cf16, q, stream);
  }
  const mm::HaloSource<T> src(*halo);
  const mm::Array a{src.h, src.w, src.R0, src.C0, src.H, src.W,
                    mm::rows_aligned<T>(halo->shard, halo->w)};
  return vpu_step<T>(src, out, a, p, cf, bf16, cf16, q, stream);
}

// -- the mxu form -------------------------------------------------------------

// The MMA shapes and tiles, by storage type. f32: m16n8k8 TF32 (A blocks of
// KB = 8 columns); bf16: m16n8k16 (KB = 16). A warp's output tile is MT m16
// tiles down (16 MT rows) by MX_N columns (MX_N / 8 n8 tiles): the B
// fragments of a row offset, held in registers, serve its MT m-tiles. The
// block's warps stand NWARPS / WC down and WC across, so its tile is
// BH x BW. REL_MIN is the least offset rel = (an A block's first column) -
// (an n8 tile's first column) whose B block meets the band; an A block of
// n8 tile nt at offset rel takes B block (rel - REL_MIN) / 8 of the row
// offset's NB. Chosen by measurement on the H100 (k3_variants.py, PERF.md).
constexpr int MX_N = 32;
constexpr int MX_NT = MX_N / 8;
// whether a row offset's B fragments are loaded during the one before
constexpr bool kMxuPrefetch = true;

template <typename T>
struct Mxu;
template <>
struct Mxu<float> {
  static constexpr int KB = 8, KMAX = 8, REL_MIN = 0, MT = 2, WC = 4;
  using E = float;  // the window's (the A operand's) element type
};
template <>
struct Mxu<__nv_bfloat16> {
  static constexpr int KB = 16, KMAX = 16, REL_MIN = -8, MT = 4, WC = 4;
  using E = __nv_bfloat16;
};
// The bf16 interior math of an f32 grid: bf16 MMAs on the f32 form's
// 64 x 128 block tile (two m16 tiles a warp), so both passes tile the grid
// alike. Its B table is the bf16 form's (the same KMAX, REL_MIN).
struct MxuBf16Half {
  static constexpr int KB = 16, KMAX = 16, REL_MIN = -8, MT = 2, WC = 4;
  using E = __nv_bfloat16;
};

// The helpers below take a layout L (Mxu<T> or MxuBf16Half).
template <typename L>
__host__ __device__ constexpr int mx_bh() {
  return 16 * L::MT * (NWARPS / L::WC);
}
template <typename L>
__host__ __device__ constexpr int mx_bw() {
  return MX_N * L::WC;
}
template <typename L>
__host__ __device__ constexpr int mx_nb() {
  return (2 * L::KMAX + 7 - L::REL_MIN) / 8 + 1;
}
// A blocks a warp reads (at KMAX), and the window's allocated columns
template <typename L>
__host__ __device__ constexpr int mx_na() {
  return (MX_N + 2 * L::KMAX + L::KB - 1) / L::KB;
}
template <typename L>
__host__ __device__ constexpr int mx_cols() {
  return (L::WC - 1) * MX_N + mx_na<L>() * L::KB;
}
// row pitch in elements: an odd number of 16-byte units, so the eight rows
// of an ldmatrix read fall in distinct banks
template <typename L>
__host__ __device__ constexpr int mx_pitch() {
  constexpr int unit = 16 / static_cast<int>(sizeof(typename L::E));
  constexpr int units = (mx_cols<L>() + unit - 1) / unit;
  return (units % 2 ? units : units + 1) * unit;
}
template <typename L>
__host__ __device__ constexpr int mx_rows() {
  return mx_bh<L>() + 2 * L::KMAX;
}
template <typename L>
constexpr int mx_window_bytes() {
  return mx_rows<L>() * mx_pitch<L>() *
         static_cast<int>(sizeof(typename L::E));
}
// The B block of layout L that A block a meets for n8 tile nt at k, or -1
// where it misses the band.
template <typename L>
__device__ __forceinline__ int mx_block_of(int a, int nt, int k) {
  const int rel = a * L::KB - 8 * nt;
  const int e = (rel - L::REL_MIN) / 8;
  return rel < L::REL_MIN || rel > 2 * k + 7 || e >= mx_nb<L>() ? -1 : e;
}

// Shared memory of an f32-compute launch of storage T.
template <typename T>
int mxu_smem(int k) {
  const int exact = 2 * piece_floats(k) * static_cast<int>(sizeof(float));
  const int window = mx_window_bytes<Mxu<T>>();
  return exact > window ? exact : window;
}

// The block tiles of one call, aligned to the global grid: tile (i, j) has
// global origin ((tr0 + i) BH, (tc0 + j) BW).
struct MxuTiles {
  int k, tr0, tc0, tiles_c;
  Tiling g;  // the array's geometry (h, w, R0, C0, H, W) and k
};

// How an f32 A value x is split into TF32 terms, x ~ hi + lo: by integer
// operations (hi = x with its 13 low significand bits cleared, exact;
// lo = x - hi, exact in f32, rounded to TF32 half away from zero by adding
// half a TF32 ulp to its bits and clearing them), or by cvt.rna for both.
// The two differ only in hi's rounding; either leaves |x - hi - lo| within
// a TF32 half-ulp of lo. Measured on the H100: k3_variants.py, PERF.md.
constexpr bool kSplitByCvt = false;

__device__ __forceinline__ unsigned tf32_of(float x) {
  unsigned u;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
  return u;
}

__device__ __forceinline__ void split_tf32(unsigned x, unsigned& hi,
                                           unsigned& lo) {
  if constexpr (kSplitByCvt) {
    hi = tf32_of(__uint_as_float(x));
    lo = tf32_of(__uint_as_float(x) - __uint_as_float(hi));
  } else {
    hi = x & 0xFFFFE000u;
    const unsigned r =
        __float_as_uint(__fsub_rn(__uint_as_float(x), __uint_as_float(hi)));
    lo = (r + 0x1000u) & 0xFFFFE000u;
  }
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    uint2 b, float) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4],
                                    uint2 b, __nv_bfloat16) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// the array's extent, for the inside test
template <typename T>
__device__ __forceinline__ int src_h(const mm::DenseSource<T>& s) {
  return s.H;
}
template <typename T>
__device__ __forceinline__ int src_w(const mm::DenseSource<T>& s) {
  return s.W;
}
template <typename T>
__device__ __forceinline__ int src_h(const mm::HaloSource<T>& s) {
  return s.h;
}
template <typename T>
__device__ __forceinline__ int src_w(const mm::HaloSource<T>& s) {
  return s.w;
}

// Stage the window of the tile at local (lr0, lc0) in layout L's element
// type: rows [lr0 - k, lr0 + BH + k), columns [lc0 - k, lc0 + BW + k) of
// the array, zero off the grid and in the columns past them.
template <typename L, typename Src>
__device__ __forceinline__ void mx_stage(const Src& src, int lr0, int lc0,
                                         int k, typename L::E* win) {
  constexpr int P = mx_pitch<L>();
  const int rows = mx_bh<L>() + 2 * k;
  const int cols = mx_bw<L>() + 2 * k;
  const int r0 = lr0 - k;
  const int c0 = lc0 - k;
  const bool inside = r0 >= 0 && c0 >= 0 && r0 + rows <= src_h(src) &&
                      c0 + cols <= src_w(src);
  for (int i = threadIdx.y; i < rows; i += NWARPS) {
    const auto* row = inside ? mm::array_of(src) +
                                   static_cast<size_t>(r0 + i) * src_w(src) +
                                   c0
                             : nullptr;
#pragma unroll 2
    for (int j = threadIdx.x; j < mx_cols<L>(); j += 32) {
      float x = 0.f;
      if (j < cols) x = inside ? mm::to_f32(row[j]) : src.at(r0 + i, c0 + j);
      mm::from_f32(win + i * P + j, x);
    }
  }
}

// The tap correlation's MMA loop on layout L, into acc (zeroed here). `frags`
// is the B table: [2k+1][NB][2 terms][32 lanes] uint2, in mma.sync's B
// fragment order; a row offset's fragments load under the one before
// (kMxuPrefetch). load_a(ah, al, dr, a) loads A block a of each m-tile at
// row offset dr into ah (TERMS == 3: split, its low TF32 terms into al).
// f32 (TF32 MMAs): A x B_lo, [A_lo x B_hi,] then A x B_hi go into fresh
// partial sums that are added to acc with one rounded add a row offset (see
// the header); bf16: the taps' small term, then the first, into acc. Shared
// by mxu_pass (TERMS 3 at f32) and the walk's f32 pass (TERMS 2, its A a
// bf16 value with no low term), so both keep one order of the products.
template <typename L, int TERMS, typename LoadA>
__device__ __forceinline__ void mx_taps(const uint2* __restrict__ frags,
                                        int k, float (&acc)[L::MT][MX_NT][4],
                                        const LoadA& load_a) {
  using E = typename L::E;
  constexpr int KB = L::KB;
  constexpr int MT = L::MT;
  constexpr int NB = mx_nb<L>();
  constexpr int NA = mx_na<L>();
  constexpr bool F32 = sizeof(E) == 4;
  static_assert(TERMS == 2 || (F32 && TERMS == 3), "the products a pair");
  const int lane = threadIdx.x;
  // f32: acc sums the row offsets' partial sums, one rounded add each;
  // bf16: the MMAs accumulate into acc directly
  float part[F32 ? MT : 1][MX_NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
    }
  }
  const E tag{};
  // the row offset's B fragments: NB blocks, 2 terms
  uint2 b[NB][2], bn[NB][2];
  const auto load_b = [&](uint2 (&dst)[NB][2], int dr) {
    const uint2* fr = frags + static_cast<size_t>(dr) * NB * 2 * 32 + lane;
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      dst[e][0] = __ldg(fr + (2 * e) * 32);
      dst[e][1] = __ldg(fr + (2 * e + 1) * 32);
    }
  };
  load_b(b, 0);
  for (int dr = 0; dr <= 2 * k; ++dr) {
    if constexpr (F32) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[m][nt][e] = 0.f;
        }
      }
    }
    if constexpr (kMxuPrefetch) {
      if (dr < 2 * k) load_b(bn, dr + 1);  // in flight under this offset
    } else if (dr > 0) {
      load_b(b, dr);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      if (a * KB >= MX_N + 2 * k) break;  // past every n8 tile's band
      // A block a of each m-tile; consecutive MMAs below go to different
      // accumulators
      unsigned ah[MT][4], al[TERMS == 3 ? MT : 1][4];
      load_a(ah, al, dr, a);
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
#pragma unroll
        for (int nt = 0; nt < MX_NT; ++nt) {
          const int e = mx_block_of<L>(a, nt, k);
          if (e < 0) continue;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            const unsigned (&am)[4] =
                TERMS == 3 && t == 1 ? al[TERMS == 3 ? m : 0] : ah[m];
            if constexpr (F32) {
              mma(part[m][nt], am, b[e][t == 0 ? 1 : 0], tag);
            } else {
              mma(acc[m][nt], am, b[e][t == 0 ? 1 : 0], tag);
            }
          }
        }
      }
    }
    if constexpr (F32) {
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[m][nt][e] = __fadd_rn(acc[m][nt][e], part[m][nt][e]);
          }
        }
      }
    }
    if constexpr (kMxuPrefetch) {
#pragma unroll
      for (int e = 0; e < NB; ++e) {
        b[e][0] = bn[e][0];
        b[e][1] = bn[e][1];
      }
    }
  }
}

// Block t's tap correlation on tensor cores in layout Mxu<T> (mx_taps; f32:
// each A fragment split here by split_tf32), written where a cell has
// d > k. Returns whether a cell of the tile has d <= k (uniform over the
// block); the caller runs its exact strips.
template <typename T, typename Src>
__device__ __forceinline__ bool mxu_pass(const Src& src, T* __restrict__ out,
                                         const uint2* __restrict__ frags,
                                         const MxuTiles& mt) {
  using L = Mxu<T>;
  using E = typename L::E;
  constexpr int KB = L::KB;
  constexpr int MT = L::MT;
  constexpr int P = mx_pitch<L>();
  constexpr int BH = mx_bh<L>();
  constexpr int BW = mx_bw<L>();
  constexpr bool F32 = sizeof(E) == 4;
  constexpr int ES = static_cast<int>(sizeof(E));
  extern __shared__ __align__(16) float smem[];
  E* win = reinterpret_cast<E*>(smem);
  const Tiling& g = mt.g;
  const int k = mt.k;
  const int bt = blockIdx.x;
  const int lr0 = (mt.tr0 + bt / mt.tiles_c) * BH - g.R0;  // local origin
  const int lc0 = (mt.tc0 + bt % mt.tiles_c) * BW - g.C0;
  // the tile's part of the array, [ar0, ar1) x [ac0, ac1), and whether a
  // cell of it has d <= k (uniform over the block)
  const int ar0 = max(lr0, 0), ar1 = min(lr0 + BH, g.h);
  const int ac0 = max(lc0, 0), ac1 = min(lc0 + BW, g.w);
  const bool near = g.R0 + ar0 < k + 1 || g.R0 + ar1 > g.H - 1 - k ||
                    g.C0 + ac0 < k + 1 || g.C0 + ac1 > g.W - 1 - k;
  const bool whole = !near && ar0 == lr0 && ac0 == lc0 &&
                     ar1 == lr0 + BH && ac1 == lc0 + BW;

  mx_stage<L>(src, lr0, lc0, k, win);
  __syncthreads();

  const int lane = threadIdx.x;
  const int wr = threadIdx.y / L::WC;
  const int wc = threadIdx.y % L::WC;
  // this lane's ldmatrix row address: row (lane & 7) + 8 ((lane >> 3) & 1),
  // 16-byte unit (lane >> 4), of the warp's first A block at dr = 0
  const unsigned char* a_base =
      reinterpret_cast<const unsigned char*>(win) +
      ((wr * 16 * MT + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
       wc * MX_N) * ES + (lane >> 4) * 16;
  float acc[MT][MX_NT][4];
  mx_taps<L, F32 ? 3 : 2>(
      frags, k, acc, [&](auto& ah, auto& al, int dr, int a) {
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldsm_x4(ah[m], a_base + ((m * 16 + dr) * P + a * KB) * ES);
          if constexpr (F32) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              split_tf32(ah[m][e], ah[m][e], al[m][e]);
            }
          }
        }
      });

  // c0, c1: row g, columns 2t, 2t + 1; c2, c3: row g + 8
  const int gr = lane >> 2;
  const int tc = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = lr0 + (wr * MT + m) * 16 + gr + (e >= 2 ? 8 : 0);
        const int c = lc0 + wc * MX_N + nt * 8 + tc + (e & 1);
        const bool in_array = r >= 0 && r < g.h && c >= 0 && c < g.w;
        if (whole || (in_array &&
                      mm::edge_distance(g.R0 + r, g.C0 + c, g.H, g.W) > k)) {
          mm::from_f32(out + static_cast<size_t>(r) * g.w + c,
                       acc[m][nt][e]);
        }
      }
    }
  }
  return near;
}

// Block t: the mxu form's pass, then the exact strips of an edge tile.
template <typename T, typename Src>
__device__ __forceinline__ void mxu_body(const Src& src, T* __restrict__ out,
                                         const StepParams& p,
                                         const uint2* __restrict__ frags,
                                         const MxuTiles& mt) {
  constexpr int BH = mx_bh<Mxu<T>>();
  constexpr int BW = mx_bw<Mxu<T>>();
  extern __shared__ __align__(16) float smem[];
  const Tiling& g = mt.g;
  const int bt = blockIdx.x;
  const int lr0 = (mt.tr0 + bt / mt.tiles_c) * BH - g.R0;
  const int lc0 = (mt.tc0 + bt % mt.tiles_c) * BW - g.C0;
  if (mxu_pass<T>(src, out, frags, mt)) {
    __syncthreads();  // the window is dead: the exact buffers take its place
    mm::exact_cells(src, out, p, g, max(lr0, 0), min(lr0 + BH, g.h),
                    max(lc0, 0), min(lc0 + BW, g.w), smem,
                    smem + piece_floats(mt.k));
  }
}

// K3 mxu: a whole [H, W] grid.
template <typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    composed_mxu_kernel(const T* __restrict__ in, T* __restrict__ out,
                        StepParams p, const uint2* __restrict__ frags,
                        MxuTiles mt) {
  mxu_body<T>(mm::DenseSource<T>{in, mt.g.H, mt.g.W}, out, p, frags, mt);
}

// K3-halo mxu: one shard and its ghost ring; `out` is the shard's [h, w].
template <typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    composed_mxu_halo_kernel(const mm::HaloSource<T> src,
                             T* __restrict__ out, StepParams p,
                             const uint2* __restrict__ frags, MxuTiles mt) {
  mxu_body<T>(src, out, p, frags, mt);
}

// The block tiles of a call of storage T (the array's geometry from `halo`
// when it is given): aligned to the global grid, so that a shard's tiles are
// the whole grid's. Returns the number of tiles.
template <typename T>
int mxu_tiles(const mm::HaloArgs* halo, int H, int W, int k, MxuTiles& mt) {
  constexpr int BH = mx_bh<Mxu<T>>();
  constexpr int BW = mx_bw<Mxu<T>>();
  mt.k = k;
  int h = H, w = W, R0 = 0, C0 = 0;
  if (halo != nullptr) {
    h = halo->h;
    w = halo->w;
    R0 = halo->R0;
    C0 = halo->C0;
    H = halo->H;
    W = halo->W;
  }
  mt.g = Tiling{};  // the geometry exact_cells reads
  mt.g.n = k;
  mt.g.h = h;
  mt.g.w = w;
  mt.g.R0 = R0;
  mt.g.C0 = C0;
  mt.g.H = H;
  mt.g.W = W;
  mt.tr0 = R0 / BH;
  mt.tc0 = C0 / BW;
  mt.tiles_c = (C0 + w + BW - 1) / BW - mt.tc0;
  return ((R0 + h + BH - 1) / BH - mt.tr0) * mt.tiles_c;
}

template <typename T>
int mxu_launch(const T* in, const mm::HaloArgs* halo, void* out, int H,
               int W, const StepParams& p, const void* frags, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  static int limit_halo = DEFAULT_SMEM_LIMIT;
  MxuTiles mt;
  const int tiles = mxu_tiles<T>(halo, H, W, p.nsteps, mt);
  const int smem = mxu_smem<T>(p.nsteps);
  const auto* fr = static_cast<const uint2*>(frags);
  if (halo == nullptr) {
    return static_cast<int>(
        mm::launch_blocks(composed_mxu_kernel<T>, smem, tiles, &limit,
                          stream, in, static_cast<T*>(out), p, fr, mt));
  }
  return static_cast<int>(mm::launch_blocks(
      composed_mxu_halo_kernel<T>, smem, tiles, &limit_halo, stream,
      mm::HaloSource<T>(*halo), static_cast<T*>(out), p, fr, mt));
}

// -- the mxu form's bf16 interior math: a persistent tile walk ---------------
//
// compute_dtype=bfloat16 (the cells of mm::Rect q in bf16, the rest in the
// f32 form over the window rounded to bf16) on the f32-compute form's
// block tiles (Mxu<T>'s BH x BW, aligned to the global grid, so K3-halo's
// mosaic is K3 bit for bit). Bounded by the bytes at f32 storage (each
// cell read and written once: 0.641 ms at 16384^2 on an H100) and by the
// banded bf16 MMAs at bf16 k = 16. A block a tile that stages its window
// element by element and synchronously runs near 0.75 TB/s, reads its B
// table through L1 for every tile, stages a straddling tile twice (once a
// pass) and runs 3xTF32 over bf16 values. Here:
//   - G persistent blocks (as many as the card holds) each walk the
//     positions b, b + G, b + 2G, ... of one order of the tiles: first
//     those at the grid's edge (exact strips), then those the f32 pass
//     takes, then those in q (Mx16Order), so each kind spreads evenly over
//     the blocks (in row-major order the grid's edge columns fell to a few
//     blocks, whose strips the call waited on);
//   - a block copies the bf16 pass's B table (the taps' first bf16 term,
//     ops/composed_stencil.py::mxu_fragments16) into shared memory once
//     and reads each row offset's fragments from there;
//   - a tile's window is copied raw (storage type) by 16-byte cp.async into
//     a staging slot a tile ahead, so the next tile's window loads while
//     this tile's MMAs run. Windows that are not inside the array (the
//     grid's edge tiles; a shard's tiles whose window reads its ghost ring)
//     or whose rows are not 16-byte aligned are staged element by element
//     through the source (zero off the grid);
//   - one convert pass rounds the staged window to bf16 (round to nearest
//     even, as mm::rb) into the bf16 window, its first column at a 16-byte
//     boundary and zero past the window's columns. Both passes read it: a
//     value rounded to bf16 is exact in bf16, and so in TF32;
//   - the bf16 pass (cells in q): m16n8k16 on Mx16<T>'s warp tiles, A by
//     ldmatrix, the first tap term straight into the accumulator;
//   - the f32 pass (cells outside q): f32 storage, mxu_pass's 3xTF32
//     without the window's low term, which is 0 for a bf16 value: A[g][t]
//     is its bf16 bits << 16, and the two MMAs that remain (A x B_lo, then
//     A x B_hi) are mxu_pass's in its order, so a finite window gives the
//     f32-compute kernel's bits over the window rounded to bf16; bf16
//     storage, the bf16 form's two tap terms as mxu_pass runs them. Its B
//     table (two terms) is read through L1, as mxu_pass reads it;
//   - tiles whose cells all take one pass store pairs (an 8-byte f32 or a
//     4-byte bf16x2 store); the others test each cell;
//   - an edge tile's exact strips (cells with d <= k, over the source
//     rounded to bf16) run in the walk, the window and the tile's slot as
//     their buffers, and the next window is staged after them. They cost
//     0.35 ms of a 1.82 ms call at f32 k = 8 and 1.45 of 3.95 at bf16
//     k = 16; a launch of their own after the walk was faster on whole
//     grids and slower on shards (k3_variants.py, PERF.md).
// Measured slower on the H100 (k3_variants.py, PERF.md): two staging slots,
// one block an SM at f32 storage, the table read through L1 (k3_variants.py
// patches these in); one launch against two (the bf16 pass on the tiles
// that meet q, then the rest), and the fragments loaded ahead or in turn.

// blocks an SM the instances are built for (their launch bound)
template <typename T>
constexpr int kMx16Blocks = sizeof(T) == 4 ? 2 : 1;

// The bf16 pass's layout for storage T.
template <typename T>
using Mx16 =
    std::conditional_t<sizeof(T) == 4, MxuBf16Half, Mxu<__nv_bfloat16>>;

// The walk's shared memory, for storage T: the bf16 window (its rows at
// k = KMAX; pitch in bf16 elements, an odd number of 16-byte units) and a
// staging slot (raw T, its first column 16-byte aligned, so a window that
// starts off that alignment sits `skew` elements in).
template <typename T>
struct Mx16Geo {
  static constexpr int BH = mx_bh<Mxu<T>>();
  static constexpr int BW = mx_bw<Mxu<T>>();
  static constexpr int KMAX = kMaxK<T>;
  static constexpr int COLS = BW + 2 * KMAX;  // the columns the MMAs read
  static constexpr int P16 = ((COLS + 7) / 8 % 2 ? (COLS + 7) / 8
                                                 : (COLS + 7) / 8 + 1) * 8;
  static constexpr int V = 16 / static_cast<int>(sizeof(T));
  static constexpr int SP = (V - 1 + COLS + V - 1) / V * V;  // slot pitch
  static __host__ __device__ int win_bytes(int k) {
    return (BH + 2 * k) * P16 * 2;
  }
  static __host__ __device__ int slot_bytes(int k) {
    return ((BH + 2 * k) * SP * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  }
  // uint2 entries of the resident table: [2k+1][NB][32 lanes]
  static __host__ __device__ int table_words(int k) {
    return (2 * k + 1) * mx_nb<Mx16<T>>() * 32;
  }
};
// The last column + 1 layout L's A blocks read at k.
template <typename L>
constexpr int mx_reads(int k) {
  return (L::WC - 1) * MX_N + (MX_N + 2 * k + L::KB - 1) / L::KB * L::KB;
}
// both passes tile alike, and their A reads stay in the window's columns
template <typename T>
constexpr bool mx16_fits() {
  using G = Mx16Geo<T>;
  return mx_bh<Mx16<T>>() == G::BH && mx_bw<Mx16<T>>() == G::BW &&
         mx_reads<Mx16<T>>(G::KMAX) <= G::COLS &&
         mx_reads<Mxu<T>>(G::KMAX) <= G::COLS;
}
static_assert(mx16_fits<float>() && mx16_fits<__nv_bfloat16>(),
              "the passes' tiles and windows");

template <typename T>
int mx16_smem(int k) {
  using G = Mx16Geo<T>;
  return G::table_words(k) * 8 + G::win_bytes(k) + G::slot_bytes(k);
}

// ldsm_x4 as an instruction the compiler may move past other loads (its
// order against the barriers and the other volatile statements stays)
__device__ __forceinline__ void ldsm_x4_free(unsigned (&r)[4],
                                             const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first staged element of a tile's window (its skew in the slot), and
// whether the window is copied by cp.async (inside the array, rows 16-byte
// aligned) rather than element by element.
template <typename T>
struct Mx16Window {
  int r0, c0, rows, cols;  // local origin and extent
  bool copied;
  int skew;
  __device__ __forceinline__ Mx16Window(int lr0, int lc0, int k, int h,
                                        int w, int vec) {
    using G = Mx16Geo<T>;
    r0 = lr0 - k;
    c0 = lc0 - k;
    rows = G::BH + 2 * k;
    cols = G::BW + 2 * k;
    copied = vec && r0 >= 0 && c0 >= 0 && r0 + rows <= h && c0 + cols <= w;
    skew = copied ? c0 & (G::V - 1) : 0;
  }
};

// Stage a tile's window into `slot`: 16-byte cp.async copies (committed by
// the caller) or, off the array, the source's values element by element.
template <typename T, typename Src>
__device__ __forceinline__ void mx16_issue(const Src& src,
                                           const Mx16Window<T>& wn,
                                           T* slot) {
  using G = Mx16Geo<T>;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  if (wn.copied) {
    const int a0 = wn.c0 - wn.skew;
    const int chunks = (wn.skew + wn.cols + G::V - 1) / G::V;
    const T* base = mm::array_of(src);
    const int w = src_w(src);
    for (int e = tid; e < wn.rows * chunks; e += 32 * NWARPS) {
      const int i = e / chunks;
      const int c = e - i * chunks;
      mm::cp_async16(slot + i * G::SP + c * G::V,
                     base + static_cast<size_t>(wn.r0 + i) * w + a0 +
                         c * G::V);
    }
    return;
  }
  for (int e = tid; e < wn.rows * wn.cols; e += 32 * NWARPS) {
    const int i = e / wn.cols;
    const int j = e - i * wn.cols;
    mm::from_f32(slot + i * G::SP + j, src.at(wn.r0 + i, wn.c0 + j));
  }
}

// The convert pass: the staged window rounded to bf16 (cvt.rn.bf16x2.f32;
// a bf16 grid is copied), eight columns a thread at a time, zero past the
// window's columns.
template <typename T>
__device__ __forceinline__ void mx16_convert(const T* slot,
                                             const Mx16Window<T>& wn,
                                             __nv_bfloat16* win) {
  using G = Mx16Geo<T>;
  constexpr int GROUPS = G::COLS / 8;  // per row
  static_assert(G::COLS % 8 == 0, "rows convert eight columns at a time");
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int e = tid; e < wn.rows * GROUPS; e += 32 * NWARPS) {
    const int i = e / GROUPS;
    const int j = (e - i * GROUPS) * 8;
    const T* s = slot + i * G::SP + wn.skew + j;
    uint4 o;
    unsigned* ow = reinterpret_cast<unsigned*>(&o);
    if constexpr (sizeof(T) == 4) {
      float x[8];
      if (wn.skew == 0) {
        const float4 lo = *reinterpret_cast<const float4*>(s);
        const float4 hi = *reinterpret_cast<const float4*>(s + 4);
        x[0] = lo.x, x[1] = lo.y, x[2] = lo.z, x[3] = lo.w;
        x[4] = hi.x, x[5] = hi.y, x[6] = hi.z, x[7] = hi.w;
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = s[q];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (j + q >= wn.cols) x[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) ow[q] = mm::pack_bf2(x[2 * q], x[2 * q + 1]);
    } else {
      unsigned short x[8];
      if (wn.skew == 0) {
        o = *reinterpret_cast<const uint4*>(s);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          x[2 * q] = static_cast<unsigned short>(ow[q] & 0xFFFFu);
          x[2 * q + 1] = static_cast<unsigned short>(ow[q] >> 16);
        }
      } else {
        const auto* u = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
        for (int q = 0; q < 8; ++q) x[q] = u[q];
      }
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        if (j + q >= wn.cols) x[q] = 0;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ow[q] = x[2 * q] | (static_cast<unsigned>(x[2 * q + 1]) << 16);
      }
    }
    *reinterpret_cast<uint4*>(win + i * G::P16 + j) = o;
  }
}

// Store a warp's accumulators: `all` (uniform over the block) every cell of
// the tile, two columns at a time; otherwise each cell that `keep` takes.
template <int MT, typename T, typename Keep>
__device__ __forceinline__ void mx16_store(const float (&acc)[MT][MX_NT][4],
                                           T* __restrict__ out, int w,
                                           int r_base, int c_base, bool all,
                                           const Keep& keep) {
  const int lane = threadIdx.x;
  const int gr = lane >> 2;
  const int tc = 2 * (lane & 3);
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int r = r_base + m * 16 + gr + 8 * h;
        const int c = c_base + nt * 8 + tc;
        const float x0 = acc[m][nt][2 * h], x1 = acc[m][nt][2 * h + 1];
        T* o = out + static_cast<size_t>(r) * w + c;
        if (all) {
          if constexpr (sizeof(T) == 4) {
            *reinterpret_cast<float2*>(o) = make_float2(x0, x1);
          } else {
            *reinterpret_cast<unsigned*>(o) = mm::pack_bf2(x0, x1);
          }
        } else {
          if (keep(r, c)) mm::from_f32(o, x0);
          if (keep(r, c + 1)) mm::from_f32(o + 1, x1);
        }
      }
    }
  }
}

// The bf16 pass of the tile at local (lr0, lc0) over the bf16 window: the
// taps' first bf16 term (`tab`, [2k+1][NB][32] uint2, in shared memory)
// against the window on Mx16<T>'s warp tiles, every product into one f32
// accumulator; written where a cell lies in q.
template <typename T>
__device__ __forceinline__ void mx16_bf16_pass(
    const __nv_bfloat16* win, const uint2* __restrict__ tab,
    T* __restrict__ out, const MxuTiles& mt, const mm::Rect& q, int lr0,
    int lc0, bool all) {
  using L = Mx16<T>;
  constexpr int KB = L::KB, MT = L::MT, NB = mx_nb<L>(), NA = mx_na<L>();
  constexpr int P = Mx16Geo<T>::P16;
  const Tiling& g = mt.g;
  const int k = mt.k;
  const int lane = threadIdx.x;
  const int wr = threadIdx.y / L::WC;
  const int wc = threadIdx.y % L::WC;
  const unsigned char* a_base =
      reinterpret_cast<const unsigned char*>(win) +
      ((wr * 16 * MT + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
       wc * MX_N) * 2 + (lane >> 4) * 16;
  float acc[MT][MX_NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int nt = 0; nt < MX_NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
    }
  }
  const __nv_bfloat16 tag{};
  // A blocks at the storage type's largest k
  constexpr int NA_T = (MX_N + 2 * Mx16Geo<T>::KMAX + KB - 1) / KB;
  static_assert(NA_T <= NA, "the layout's A blocks");
  for (int dr = 0; dr <= 2 * k; ++dr) {
    uint2 b[NB];
    const uint2* fr = tab + dr * NB * 32 + lane;
#pragma unroll
    for (int e = 0; e < NB; ++e) {
      b[e] = fr[e * 32];
    }
    // every A block's fragments, then the MMAs
    unsigned ah[NA_T][MT][4];
#pragma unroll
    for (int a = 0; a < NA_T; ++a) {
      if (a * KB >= MX_N + 2 * k) break;  // past every n8 tile's band
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldsm_x4_free(ah[a][m], a_base + ((m * 16 + dr) * P + a * KB) * 2);
      }
    }
#pragma unroll
    for (int a = 0; a < NA_T; ++a) {
      if (a * KB >= MX_N + 2 * k) break;
#pragma unroll
      for (int nt = 0; nt < MX_NT; ++nt) {
        const int e = mx_block_of<L>(a, nt, k);
        if (e < 0) continue;
#pragma unroll
        for (int m = 0; m < MT; ++m) mma(acc[m][nt], ah[a][m], b[e], tag);
      }
    }
  }
  mx16_store<MT>(acc, out, g.w, lr0 + wr * MT * 16, lc0 + wc * MX_N, all,
                 [&](int r, int c) {
                   return r >= 0 && r < g.h && c >= 0 && c < g.w &&
                          mm::in_rect(q, g.R0 + r, g.C0 + c);
                 });
}

// The f32 pass of the tile over the bf16 window, on Mxu<T>'s warp tiles
// with its two-term B table `frags` (mxu_pass's, read through L1): written
// where a cell has d > k and lies outside q. mx_taps with two products a
// pair: f32 storage, A x B_lo then A x B_hi, A[g][t] read as the value's
// bf16 bits, its TF32 bits those << 16 (a bf16 value's low TF32 term, and
// mxu_pass's A_lo x B_hi, are 0); bf16 storage, mxu_pass's bf16 form.
template <typename T>
__device__ __forceinline__ void mx16_f32_pass(
    const __nv_bfloat16* win, const uint2* __restrict__ frags,
    T* __restrict__ out, const MxuTiles& mt, const mm::Rect& q, int lr0,
    int lc0, bool whole, bool all) {
  using L = Mxu<T>;
  constexpr int KB = L::KB, MT = L::MT;
  constexpr int P = Mx16Geo<T>::P16;
  constexpr bool F32 = sizeof(T) == 4;
  const Tiling& g = mt.g;
  const int k = mt.k;
  const int lane = threadIdx.x;
  const int wr = threadIdx.y / L::WC;
  const int wc = threadIdx.y % L::WC;
  // f32: this lane's A element (row g, column t) of the warp's first A
  // block at dr = 0; bf16: its ldmatrix row address, as mxu_pass's
  const auto* e_base = reinterpret_cast<const unsigned short*>(win) +
                       (wr * 16 * MT + (lane >> 2)) * P + wc * MX_N +
                       (lane & 3);
  const unsigned char* a_base =
      reinterpret_cast<const unsigned char*>(win) +
      ((wr * 16 * MT + (lane & 7) + 8 * ((lane >> 3) & 1)) * P +
       wc * MX_N) * 2 + (lane >> 4) * 16;
  float acc[MT][MX_NT][4];
  mx_taps<L, 2>(frags, k, acc, [&](auto& ah, auto&, int dr, int a) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      if constexpr (F32) {
        // rows g, g + 8, columns t, t + 4 of the A block
        const unsigned short* s = e_base + (m * 16 + dr) * P + a * KB;
        ah[m][0] = static_cast<unsigned>(s[0]) << 16;
        ah[m][1] = static_cast<unsigned>(s[8 * P]) << 16;
        ah[m][2] = static_cast<unsigned>(s[4]) << 16;
        ah[m][3] = static_cast<unsigned>(s[8 * P + 4]) << 16;
      } else {
        ldsm_x4(ah[m], a_base + ((m * 16 + dr) * P + a * KB) * 2);
      }
    }
  });
  mx16_store<MT>(acc, out, g.w, lr0 + wr * MT * 16, lc0 + wc * MX_N, all,
                 [&](int r, int c) {
                   return (whole ||
                           (r >= 0 && r < g.h && c >= 0 && c < g.w &&
                            mm::edge_distance(g.R0 + r, g.C0 + c, g.H,
                                              g.W) > k)) &&
                          !mm::in_rect(q, g.R0 + r, g.C0 + c);
                 });
}

// The order of the walk, in tiles (row i, column j of the call's tiles):
// first the tiles with a cell within k of the global edge (outside the
// core rectangle [ci0, ci1) x [cj0, cj1): their exact strips are the
// costliest work), then those with a cell outside q (outside the inner
// rectangle [ii0, ii1) x [ij0, ij1), which lies in the core: the f32
// pass), then the inner tiles (the bf16 pass alone). Block b takes
// positions b, b + G, ...: each kind spreads evenly over the blocks.
struct Mx16Order {
  int ci0, ci1, cj0, cj1, ii0, ii1, ij0, ij1;
  int near, ring;  // tiles outside the core, and in it outside the inner
};

// Position idx of the [0, R) x [0, C) tiles outside [a0, a1) x [b0, b1)
// (empty: every tile), in row-major order.
__device__ __forceinline__ void frame_tile(int idx, int C, int a0, int a1,
                                           int b0, int b1, int& i, int& j) {
  if (a0 >= a1 || b0 >= b1) a0 = a1 = 0;
  const int top = a0 * C;
  const int side = C - (b1 - b0);  // tiles a row beside the hole
  if (idx >= top && idx < top + (a1 - a0) * side) {
    idx -= top;
    i = a0 + idx / side;
    j = idx % side;
    if (j >= b0) j += b1 - b0;
    return;
  }
  if (idx >= top) idx += (a1 - a0) * (b1 - b0);  // past the hole
  i = idx / C;
  j = idx % C;
}

// The tile at position idx of the walk.
__device__ __forceinline__ int mx16_tile(int idx, const Mx16Order& o,
                                         int tiles_c) {
  int i, j;
  if (idx < o.near) {
    frame_tile(idx, tiles_c, o.ci0, o.ci1, o.cj0, o.cj1, i, j);
  } else if (idx < o.near + o.ring) {
    frame_tile(idx - o.near, o.cj1 - o.cj0, o.ii0 - o.ci0, o.ii1 - o.ci0,
               o.ij0 - o.cj0, o.ij1 - o.cj0, i, j);
    i += o.ci0;
    j += o.cj0;
  } else {
    idx -= o.near + o.ring;
    i = o.ii0 + idx / (o.ij1 - o.ij0);
    j = o.ij0 + idx % (o.ij1 - o.ij0);
  }
  return i * tiles_c + j;
}

template <typename T, typename Src>
__device__ __forceinline__ void mx16_body(const Src& src, T* __restrict__ out,
                                          const StepParams& p,
                                          const uint2* __restrict__ frags,
                                          const uint2* __restrict__ frags16,
                                          const MxuTiles& mt, int tiles,
                                          const Mx16Order& order, int pairs,
                                          const mm::Rect& q) {
  using G = Mx16Geo<T>;
  extern __shared__ __align__(16) float smem[];
  const int k = mt.k;
  const Tiling& g = mt.g;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  unsigned char* at = reinterpret_cast<unsigned char*>(smem);
  uint2* tab = reinterpret_cast<uint2*>(at);
  at += G::table_words(k) * 8;
  auto* win = reinterpret_cast<__nv_bfloat16*>(at);
  T* slot = reinterpret_cast<T*>(at + G::win_bytes(k));
  // tile t's local origin and its part of the array
  const auto place = [&](int t, int& lr0, int& lc0, int& ar0, int& ar1,
                         int& ac0, int& ac1) {
    lr0 = (mt.tr0 + t / mt.tiles_c) * G::BH - g.R0;
    lc0 = (mt.tc0 + t % mt.tiles_c) * G::BW - g.C0;
    ar0 = max(lr0, 0);
    ar1 = min(lr0 + G::BH, g.h);
    ac0 = max(lc0, 0);
    ac1 = min(lc0 + G::BW, g.w);
  };

  for (int e = tid; e < G::table_words(k) / 2; e += 32 * NWARPS) {
    mm::cp_async16(tab + 2 * e, frags16 + 2 * e);
  }
  // stage the tile at walk position n (none past the end) into the slot
  const auto issue = [&](int n) {
    if (n < tiles) {
      int lr0, lc0, ar0, ar1, ac0, ac1;
      place(mx16_tile(n, order, mt.tiles_c), lr0, lc0, ar0, ar1, ac0, ac1);
      mx16_issue<T>(src, Mx16Window<T>(lr0, lc0, k, g.h, g.w, p.vec), slot);
    }
    mm::cp_async_commit();  // one group a tile, empty past the last
  };
  const int stride = gridDim.x;
  int ahead = blockIdx.x + stride;  // the walk position the next issue stages
  issue(blockIdx.x);
  for (int n = blockIdx.x; n < tiles; n += stride) {
    int lr0, lc0, ar0, ar1, ac0, ac1;
    place(mx16_tile(n, order, mt.tiles_c), lr0, lc0, ar0, ar1, ac0, ac1);
    const int cover = mm::rect_cover(q, g.R0 + ar0, g.R0 + ar1, g.C0 + ac0,
                                     g.C0 + ac1);
    const Mx16Window<T> wn(lr0, lc0, k, g.h, g.w, p.vec);
    cp_async_wait<0>();
    __syncthreads();  // the slot has landed; the last tile's MMAs are done
    mx16_convert<T>(slot, wn, win);
    __syncthreads();
    // whether a cell of the tile has d <= k, and whether it lies whole in
    // the array with every cell at d > k
    const bool near = g.R0 + ar0 < k + 1 || g.R0 + ar1 > g.H - 1 - k ||
                      g.C0 + ac0 < k + 1 || g.C0 + ac1 > g.W - 1 - k;
    const bool whole = !near && ar0 == lr0 && ac0 == lc0 &&
                       ar1 == lr0 + G::BH && ac1 == lc0 + G::BW;
    const bool strips = near && cover != mm::kAll;
    // the slot is free: the next tile's window loads under this one's MMAs
    // (after an edge tile's strips, which take the slot)
    if (!strips) {
      issue(ahead);
      ahead += stride;
    }
    if (cover != mm::kNone) {
      mx16_bf16_pass<T>(win, tab, out, mt, q, lr0, lc0,
                        pairs && whole && cover == mm::kAll);
    }
    if (cover != mm::kAll) {
      mx16_f32_pass<T>(win, frags, out, mt, q, lr0, lc0, whole,
                       pairs && whole && cover == mm::kNone);
    }
    if (strips) {
      __syncthreads();  // the window is dead: it and the slot take the strips
      mm::exact_cells_of<true>(src, out, p, g, ar0, ar1, ac0, ac1,
                               reinterpret_cast<float*>(win),
                               reinterpret_cast<float*>(slot));
      __syncthreads();
      issue(ahead);
      ahead += stride;
    }
  }
  cp_async_wait<0>();  // the empty groups past the last tile
}

// K3 mxu, bf16 interior math: a whole [H, W] grid.
template <typename T>
__global__ void __launch_bounds__(32 * NWARPS, kMx16Blocks<T>)
    composed_mxu16_kernel(const T* __restrict__ in, T* __restrict__ out,
                          StepParams p, const uint2* __restrict__ frags,
                          const uint2* __restrict__ frags16, MxuTiles mt,
                          int tiles, Mx16Order order, int pairs,
                          mm::Rect q) {
  mx16_body<T>(mm::DenseSource<T>{in, mt.g.H, mt.g.W}, out, p, frags,
               frags16, mt, tiles, order, pairs, q);
}

// K3-halo mxu, bf16 interior math: one shard and its ghost ring.
template <typename T>
__global__ void __launch_bounds__(32 * NWARPS, kMx16Blocks<T>)
    composed_mxu16_halo_kernel(const mm::HaloSource<T> src,
                               T* __restrict__ out, StepParams p,
                               const uint2* __restrict__ frags,
                               const uint2* __restrict__ frags16,
                               MxuTiles mt, int tiles, Mx16Order order,
                               int pairs, mm::Rect q) {
  mx16_body<T>(src, out, p, frags, frags16, mt, tiles, order, pairs, q);
}

// Launch a persistent kernel: as many blocks as the card holds at once
// (its occupancy at `smem`), at most one a tile. A request past the card's
// shared memory is refused (the error of cudaFuncSetAttribute).
template <typename K, typename... Args>
cudaError_t launch_walk(K kernel, int smem, int tiles, int* limit,
                        void* stream, Args... args) {
  if (smem > *limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *limit = smem;
  }
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel,
                                                      32 * NWARPS, smem);
  }
  if (e != cudaSuccess) return e;
  if (per < 1) return cudaErrorInvalidConfiguration;
  kernel<<<tiles < per * sms ? tiles : per * sms, dim3(32, NWARPS), smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// The tiles [first, last) of `n` (the first at index t0, BH rows each, a
// local origin R0 within an array of h rows) whose part of the array lies
// in the global rows [lo, hi); none when lo >= hi.
inline void tile_span(int n, int t0, int B, int R0, int h, int lo, int hi,
                      int& first, int& last) {
  first = last = 0;
  bool seen = false;
  for (int i = 0; i < n; ++i) {
    const int a0 = R0 + std::max((t0 + i) * B - R0, 0);
    const int a1 = R0 + std::min((t0 + i + 1) * B - R0, h);
    if (a0 >= lo && a1 <= hi) {
      if (!seen) first = i;
      seen = true;
      last = i + 1;
    }
  }
}

// The walk's order (Mx16Order) for the call's tiles and rectangle.
template <typename T>
Mx16Order mx16_order(const MxuTiles& mt, int tiles, const mm::Rect& q) {
  using G = Mx16Geo<T>;
  const Tiling& g = mt.g;
  const int k = mt.k;
  const int tiles_r = tiles / mt.tiles_c;
  Mx16Order o;
  tile_span(tiles_r, mt.tr0, G::BH, g.R0, g.h, k + 1, g.H - 1 - k, o.ci0,
            o.ci1);
  tile_span(mt.tiles_c, mt.tc0, G::BW, g.C0, g.w, k + 1, g.W - 1 - k, o.cj0,
            o.cj1);
  tile_span(tiles_r, mt.tr0, G::BH, g.R0, g.h, q.r0, q.r1, o.ii0, o.ii1);
  tile_span(mt.tiles_c, mt.tc0, G::BW, g.C0, g.w, q.c0, q.c1, o.ij0, o.ij1);
  // the inner tiles within the core (empty either way: none)
  o.ii0 = std::max(o.ii0, o.ci0);
  o.ii1 = std::min(o.ii1, o.ci1);
  o.ij0 = std::max(o.ij0, o.cj0);
  o.ij1 = std::min(o.ij1, o.cj1);
  const int core = (o.ci1 - o.ci0) * (o.cj1 - o.cj0);
  const int inner = o.ii0 < o.ii1 && o.ij0 < o.ij1
                        ? (o.ii1 - o.ii0) * (o.ij1 - o.ij0)
                        : 0;
  if (inner == 0) o.ii0 = o.ii1 = o.ij0 = o.ij1 = 0;
  o.near = tiles - core;
  o.ring = core - inner;
  return o;
}

template <typename T>
int mx16_launch(const T* in, const mm::HaloArgs* halo, void* out, int H,
                int W, StepParams p, const void* frags, const void* frags16,
                const mm::Rect& q, void* stream) {
  using G = Mx16Geo<T>;
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  static int limit_halo = DEFAULT_SMEM_LIMIT;
  // the exact strips take the window and a slot as their two buffers
  const int strip = piece_floats(p.nsteps) * static_cast<int>(sizeof(float));
  if (strip > G::win_bytes(p.nsteps) || strip > G::slot_bytes(p.nsteps)) {
    return static_cast<int>(cudaErrorInvalidValue);  // never at k <= KMAX
  }
  MxuTiles mt;
  const int tiles = mxu_tiles<T>(halo, H, W, p.nsteps, mt);
  const Mx16Order order = mx16_order<T>(mt, tiles, q);
  p.vec = halo == nullptr ? mm::rows_aligned<T>(in, W)
                          : mm::rows_aligned<T>(halo->shard, halo->w);
  // pair stores: every row's even columns start 2-element aligned
  const int pairs = reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0 &&
                    mt.g.w % 2 == 0 && mt.g.C0 % 2 == 0;
  const auto* fr = static_cast<const uint2*>(frags);
  const auto* fr16 = static_cast<const uint2*>(frags16);
  T* o = static_cast<T*>(out);
  const int smem = mx16_smem<T>(p.nsteps);
  if (halo == nullptr) {
    return static_cast<int>(launch_walk(composed_mxu16_kernel<T>, smem,
                                        tiles, &limit, stream, in, o, p, fr,
                                        fr16, mt, tiles, order, pairs, q));
  }
  return static_cast<int>(launch_walk(
      composed_mxu16_halo_kernel<T>, smem, tiles, &limit_halo, stream,
      mm::HaloSource<T>(*halo), o, p, fr, fr16, mt, tiles, order, pairs, q));
}

// `frags16` (the bf16 pass's one-term table) when `bf16`.
template <typename T>
int mxu(const T* in, const mm::HaloArgs* halo, void* out, int H, int W,
        const StepParams& p, const void* frags, int bf16, const mm::Rect& q,
        const void* frags16, void* stream) {
  if (!valid_k(p.nsteps, Mxu<T>::KMAX, p.mask9, p.noff) ||
      frags == nullptr || (bf16 && frags16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? mx16_launch<T>(in, halo, out, H, W, p, frags, frags16, q,
                               stream)
              : mxu_launch<T>(in, halo, out, H, W, p, frags, stream);
}

StepParams make_params(float rate, float keep, int k, int mask9, int noff,
                       int offcodes, int moore) {
  StepParams p = {};
  p.nsteps = k;
  p.mask9 = mask9;
  p.noff = noff;
  p.offcodes = offcodes;
  p.moore = moore;
  p.rate = rate;
  p.keep = keep;
  return p;
}

template <typename T>
int dense(int form, const void* in, void* out, int H, int W,
          const StepParams& p, const void* table, int bf16,
          const mm::Rect& q, const void* table16, void* stream) {
  if (H < 0 || W < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (H == 0 || W == 0) return 0;
  const T* src = static_cast<const T*>(in);
  return form == 0
             ? vpu<T>(src, nullptr, out, H, W, p,
                      static_cast<const float*>(table), bf16, q,
                      static_cast<const float*>(table16), stream)
             : mxu<T>(src, nullptr, out, H, W, p, table, bf16, q, table16,
                      stream);
}

template <typename T>
int halo(int form, const void* args, void* out, const StepParams& p,
         const void* table, int bf16, const mm::Rect& q,
         const void* table16, void* stream) {
  const auto* a = static_cast<const mm::HaloArgs*>(args);
  if (a == nullptr || !mm::valid_halo(*a, p.nsteps, MAX_K)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->h == 0 || a->w == 0) return 0;
  return form == 0
             ? vpu<T>(nullptr, a, out, 0, 0, p,
                      static_cast<const float*>(table), bf16, q,
                      static_cast<const float*>(table16), stream)
             : mxu<T>(nullptr, a, out, 0, 0, p, table, bf16, q, table16,
                      stream);
}

template <typename L>
void layout_of(int* out7) {
  out7[0] = L::KB;
  out7[1] = L::KMAX;
  out7[2] = L::REL_MIN;
  out7[3] = mx_nb<L>();
  out7[4] = MX_N;
  out7[5] = mx_bh<L>();
  out7[6] = mx_bw<L>();
}

}  // namespace

extern "C" {

// vpu: `coefs` is a host array of k + 1 floats. mxu: `frags` is the device
// B table (ops/composed_stencil.py::mxu_fragments). Then the bf16 interior
// math: `bf16`, its rectangle (global rows [r0, r1), columns [c0, c1)) and
// its table: the bf16 coefficients (vpu, host) or the bf16 pass's one-term
// B table (mxu, device: ops/composed_stencil.py::mxu_fragments16), used
// when `bf16`.
#define MM_BF16_ARGS int bf16, int r0, int r1, int c0, int c1
#define MM_RECT mm::Rect{r0, r1, c0, c1}

int mm_composed_vpu_f32(const void* in, void* out, int H, int W, float rate,
                        float keep, int k, int mask9, int noff, int offcodes,
                        int moore, const float* coefs, MM_BF16_ARGS,
                        const float* coefs16, void* stream) {
  return dense<float>(0, in, out, H, W,
                      make_params(rate, keep, k, mask9, noff, offcodes, moore),
                      coefs, bf16, MM_RECT, coefs16, stream);
}

int mm_composed_vpu_bf16(const void* in, void* out, int H, int W, float rate,
                         float keep, int k, int mask9, int noff, int offcodes,
                         int moore, const float* coefs, MM_BF16_ARGS,
                         const float* coefs16, void* stream) {
  return dense<__nv_bfloat16>(
      0, in, out, H, W,
      make_params(rate, keep, k, mask9, noff, offcodes, moore), coefs, bf16,
      MM_RECT, coefs16, stream);
}

int mm_composed_mxu_f32(const void* in, void* out, int H, int W, float rate,
                        float keep, int k, int mask9, int noff, int offcodes,
                        const void* frags, MM_BF16_ARGS, const void* frags16,
                        void* stream) {
  return dense<float>(1, in, out, H, W,
                      make_params(rate, keep, k, mask9, noff, offcodes, 0),
                      frags, bf16, MM_RECT, frags16, stream);
}

int mm_composed_mxu_bf16(const void* in, void* out, int H, int W, float rate,
                         float keep, int k, int mask9, int noff, int offcodes,
                         const void* frags, MM_BF16_ARGS, const void* frags16,
                         void* stream) {
  return dense<__nv_bfloat16>(
      1, in, out, H, W, make_params(rate, keep, k, mask9, noff, offcodes, 0),
      frags, bf16, MM_RECT, frags16, stream);
}

int mm_composed_halo_vpu_f32(const void* args, void* out, float rate,
                             float keep, int k, int mask9, int noff,
                             int offcodes, int moore, const float* coefs,
                             MM_BF16_ARGS, const float* coefs16,
                             void* stream) {
  return halo<float>(0, args, out,
                     make_params(rate, keep, k, mask9, noff, offcodes, moore),
                     coefs, bf16, MM_RECT, coefs16, stream);
}

int mm_composed_halo_vpu_bf16(const void* args, void* out, float rate,
                              float keep, int k, int mask9, int noff,
                              int offcodes, int moore, const float* coefs,
                              MM_BF16_ARGS, const float* coefs16,
                              void* stream) {
  return halo<__nv_bfloat16>(
      0, args, out, make_params(rate, keep, k, mask9, noff, offcodes, moore),
      coefs, bf16, MM_RECT, coefs16, stream);
}

int mm_composed_halo_mxu_f32(const void* args, void* out, float rate,
                             float keep, int k, int mask9, int noff,
                             int offcodes, const void* frags, MM_BF16_ARGS,
                             const void* frags16, void* stream) {
  return halo<float>(1, args, out,
                     make_params(rate, keep, k, mask9, noff, offcodes, 0),
                     frags, bf16, MM_RECT, frags16, stream);
}

int mm_composed_halo_mxu_bf16(const void* args, void* out, float rate,
                              float keep, int k, int mask9, int noff,
                              int offcodes, const void* frags, MM_BF16_ARGS,
                              const void* frags16, void* stream) {
  return halo<__nv_bfloat16>(
      1, args, out, make_params(rate, keep, k, mask9, noff, offcodes, 0),
      frags, bf16, MM_RECT, frags16, stream);
}

// The geometry vpu_step gives a vpu bf16-interior call on an [h, w] array
// at global (R0, C0) of an [H, W] grid (storage 0: f32, 1: bf16; the steps,
// the neighbourhood and the rectangle as the call's): out[0..3] the near
// launch's window rows and OFF and the paired launch's, then the paired
// region and the four bands (top, bottom, left, right), five ints each:
// local rows [r0, r1), columns [c0, c1), and the tiles launched over it (29
// ints). It launches nothing: the card tests and chip_smoke.py hold
// ops/composed_stencil.py's window_rows, paired_rows and the region tiles to
// it.
int mm_composed_vpu_bf16_plan(int h, int w, int R0, int C0, int H, int W,
                              int storage, int k, int mask9, int noff,
                              int moore, int r0, int r1, int c0, int c1,
                              int* out) {
  if (!valid_k(k, storage ? kMaxK<__nv_bfloat16> : kMaxK<float>, mask9,
               noff) ||
      h < 0 || w < 0 || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mm::Array a{h, w, R0, C0, H, W, 0};
  const Window g = vpu_window(k, moore), g16 = paired_window(k, moore);
  const mm::Split s = mm::split_of(mm::Rect{r0, r1, c0, c1}, a);
  mm::Bands bs;
  mm::bands_of(g.rows, g.off, k, a, s, bs);
  out[0] = g.rows;
  out[1] = g.off;
  out[2] = g16.rows;
  out[3] = g16.off;
  mm::write_plan(mm::region_tiling(g16.rows, g16.off, k, a, s.a0, s.a1, s.b0,
                                   s.b1),
                 bs, out + 4);
  return 0;
}

// The mxu form's layout, {KB, KMAX, REL_MIN, NB, MX_N, BH, BW}: `which` 0
// f32 storage, 1 bf16; 2 and 3 the bf16 interior math's bf16 pass at f32
// and bf16 storage. The Python side checks each against its own (the B
// tables' layouts, and the tiles its operation count assumes) before the
// first launch.
void mm_composed_mxu_layout(int which, int* out7) {
  switch (which) {
    case 0: layout_of<Mxu<float>>(out7); break;
    case 1: layout_of<Mxu<__nv_bfloat16>>(out7); break;
    case 2: layout_of<Mx16<float>>(out7); break;
    default: layout_of<Mx16<__nv_bfloat16>>(out7); break;
  }
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
