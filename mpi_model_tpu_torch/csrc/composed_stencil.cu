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
// Moore on the paired bf16 walk (mm::walk_step_bf2, the accumulator in
// pairs too), other neighbourhoods on the f32 walk with every result
// rounded (mm::walk_step<..., true>): bit for bit its plain version. mxu: A the window rounded to bf16 and B the taps rounded to bf16
// (the first term of the bf16 table), m16n8k16 with f32 accumulation;
// bf16 products are exact in f32, so it differs from its plain version
// (the products summed from zero in row-major tap order) by the order of
// the f32 sums only. For f32 storage the bf16 pass runs on a 64-row layout
// (MxuBf16Half) that tiles the grid as the f32 form does. Cells outside the
// rectangle take the f32 form over the window rounded to bf16, exact strips
// included. A block whose cells straddle the rectangle's edge runs both
// passes, each staging its own window and writing its own cells.
//
// C interface (loaded with ctypes): one entry point a form, dtype and mode,
// each returning the cudaError_t of its launch, 0 on success.

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

// Blocks an SM the vpu kernels are built for (128 registers a thread at 2),
// and where the accumulator lives (registers; shared memory, one f32 a
// cell, when true). Measured on the H100: k3_variants.py, PERF.md.
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

// The binomial sum of tile t over its window in registers (PASS 0: f32;
// 1: f32 over the window rounded to bf16; 2: bf16, every operation
// rounded, `cf` the bf16 coefficients), written where a cell has d > k
// (PASS 1: and lies outside `q`; PASS 2: where it lies in `q`). `col` is
// this thread's column of the staged window, `ex` the walk's exchange
// (its slots of warps -1 and kThreadsY zero), `accs` the accumulator when
// it is shared.
template <int ROWS, int OFF, bool MOORE, int PASS, typename T>
__device__ __forceinline__ void vpu_pass(const T* col, float* ex,
                                         float* accs, T* __restrict__ out,
                                         const StepParams& p,
                                         const Coefs& cf, const Tiling& tl,
                                         int t, bool whole,
                                         const mm::Rect& q) {
  constexpr int TH = ROWS - 2 * OFF;  // the tile's rows
  constexpr bool RB = PASS == 2;      // bf16 operations
  const int k = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  float acc[kAccShared ? 1 : TH];
  accs += j;
  if constexpr (PASS == 2 && MOORE && !kAccShared) {
    // Moore in bf16: the paired walk (two rows a register), the
    // accumulator in pairs too, every operation rounded once
    static_assert(OFF % 2 == 0 && TH % 2 == 0, "rows pair up");
    constexpr int H0 = OFF / 2, HT = TH / 2;
    unsigned w[ROWS / 2];
#pragma unroll
    for (int m = 0; m < ROWS / 2; ++m) {
      w[m] = mm::pack_bf2(mm::to_f32(col[2 * m * mm::kStagePitch<T>]),
                          mm::to_f32(col[(2 * m + 1) * mm::kStagePitch<T>]));
    }
    const auto pair = [](float c) {
      const unsigned b = __float_as_uint(c) >> 16;  // c is a bf16 value
      return b | (b << 16);
    };
    unsigned a2[HT];
    const unsigned c0 = pair(cf.c[0]);
#pragma unroll
    for (int r = 0; r < HT; ++r) a2[r] = mm::mul_bf2(c0, w[H0 + r]);
    unsigned* eu = reinterpret_cast<unsigned*>(ex);
    for (int s = 0; s < k; ++s) {
      const unsigned cj = pair(cf.c[s + 1]);
      mm::walk_step_bf2<ROWS>(
          w, eu + (s & 1) * mm::kEdgeSlots * (ROWS / 2),
          [&](int m, unsigned, unsigned g) {
            if (m >= H0 && m < H0 + HT) {
              a2[m - H0] = mm::add_bf2(a2[m - H0], mm::mul_bf2(cj, g));
            }
            return g;
          });
    }
#pragma unroll
    for (int r = 0; r < HT; ++r) {
      acc[2 * r] = mm::lo_f32(a2[r]);
      acc[2 * r + 1] = mm::hi_f32(a2[r]);
    }
  } else {
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
                *a = mm::rnd<RB>(
                    __fadd_rn(*a, mm::rnd<RB>(__fmul_rn(cj, g))));
              } else {
                acc[i - OFF] = mm::rnd<RB>(
                    __fadd_rn(acc[i - OFF], mm::rnd<RB>(__fmul_rn(cj, g))));
              }
            }
            return g;
          });
    }
  }

  // columns [k, kWinW - k) of the tile's rows
  const int r = tl.row_of(t);
  const int c = tl.col_of(t) + j - k;
  if (j >= k && j < mm::kWinW - k && c < tl.w) {
#pragma unroll
    for (int qr = 0; qr < TH; ++qr) {
      const bool inq = mm::in_rect(q, tl.R0 + r + qr, tl.C0 + c);
      const bool ok =
          PASS == 2 ? (r + qr < tl.h && inq)
                    : ((whole || (r + qr < tl.h &&
                                  mm::edge_distance(tl.R0 + r + qr,
                                                    tl.C0 + c, tl.H,
                                                    tl.W) > k)) &&
                       !(PASS == 1 && inq));
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

// Block t of `tl`: the binomial sum of tile t in registers, written where a
// cell has d > k, then the exact strips of an edge tile. BF: the bf16
// interior math on the cells in `q` (coefficients `cf16`), the rest over
// the window rounded to bf16 (the header).
template <int ROWS, int OFF, bool MOORE, bool BF, typename T, typename Src>
__device__ __forceinline__ void vpu_body(const Src& src, T* __restrict__ out,
                                         const StepParams& p,
                                         const Coefs& cf, const Coefs& cf16,
                                         const Tiling& tl,
                                         const mm::Rect& q) {
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
  const T* col = stage + skew + j;
  if constexpr (BF) {
    const int gr = tl.R0 + tl.row_of(t);
    const int gc = tl.C0 + tl.col_of(t);
    const int cover =
        mm::rect_cover(q, gr, min(gr + tl.th, tl.R0 + tl.h), gc,
                       min(gc + tl.tw, tl.C0 + tl.w));
    if (cover != mm::kNone) {
      vpu_pass<ROWS, OFF, MOORE, 2>(col, ex, accs, out, p, cf16, tl, t,
                                    whole, q);
      if (cover == mm::kAll) return;
      // the f32 pass reads the exchange slots of warps -1 and 8 as zero
      __syncthreads();
      for (int e = j; e < mm::kExchFloats<ROWS>; e += mm::kWinW) ex[e] = 0.f;
      __syncthreads();
    }
    vpu_pass<ROWS, OFF, MOORE, 1>(col, ex, accs, out, p, cf, tl, t, whole,
                                  q);
  } else {
    vpu_pass<ROWS, OFF, MOORE, 0>(col, ex, accs, out, p, cf, tl, t, whole,
                                  q);
  }
  if (!whole) {
    // the cells with d <= k, in the staging buffer's space
    __syncthreads();
    mm::exact_cells_of<BF>(src, out, p, tl, tl.row_of(t),
                       min(tl.row_of(t) + tl.th, tl.h), tl.col_of(t),
                       min(tl.col_of(t) + tl.tw, tl.w), work,
                       work + piece_floats(k));
  }
}

// K3 vpu: a whole [H, W] grid.
template <int ROWS, int OFF, bool MOORE, bool BF, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_kernel(const T* __restrict__ in, T* __restrict__ out,
                        StepParams p, const __grid_constant__ Coefs cf,
                        const __grid_constant__ Coefs cf16, Tiling tl,
                        mm::Rect q) {
  vpu_body<ROWS, OFF, MOORE, BF>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p,
                                 cf, cf16, tl, q);
}

// K3-halo vpu: one shard and its ghost ring; `out` is the shard's [h, w].
template <int ROWS, int OFF, bool MOORE, bool BF, typename T>
__global__ void __launch_bounds__(32 * NWARPS, kVpuMinBlocks)
    composed_vpu_halo_kernel(const mm::HaloSource<T> src,
                             T* __restrict__ out, StepParams p,
                             const __grid_constant__ Coefs cf,
                             const __grid_constant__ Coefs cf16, Tiling tl,
                             mm::Rect q) {
  vpu_body<ROWS, OFF, MOORE, BF>(src, out, p, cf, cf16, tl, q);
}

// The largest k each dtype composes (ops/composed_stencil.py::max_k: the
// window's ghost depth, 8 rows f32, 16 bf16).
template <typename T>
constexpr int kMaxK = sizeof(T) == 4 ? 8 : 16;

template <int ROWS, int OFF, bool MOORE, bool BF, typename T>
int vpu_launch(const T* in, const mm::HaloArgs* halo, void* out, int H,
               int W, StepParams p, const Coefs& cf, const Coefs& cf16,
               const mm::Rect& q, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  static int limit_halo = DEFAULT_SMEM_LIMIT;
  const int smem = vpu_smem<T, ROWS, OFF>(p.nsteps);
  if (halo == nullptr) {
    p.vec = mm::rows_aligned<T>(in, W);
    const Tiling tl =
        mm::make_tiling(ROWS, OFF, p.nsteps, H, W, 0, 0, H, W);
    return static_cast<int>(mm::launch_blocks(
        composed_vpu_kernel<ROWS, OFF, MOORE, BF, T>, smem, tl.tiles,
        &limit, stream, in, static_cast<T*>(out), p, cf, cf16, tl, q));
  }
  const mm::HaloSource<T> src(*halo);
  p.vec = mm::rows_aligned<T>(halo->shard, halo->w);
  const Tiling tl = mm::make_tiling(ROWS, OFF, p.nsteps, src.h, src.w,
                                    src.R0, src.C0, src.H, src.W);
  return static_cast<int>(mm::launch_blocks(
      composed_vpu_halo_kernel<ROWS, OFF, MOORE, BF, T>, smem, tl.tiles,
      &limit_halo, stream, src, static_cast<T*>(out), p, cf, cf16, tl, q));
}

template <bool BF, typename T>
int vpu_rows(const T* in, const mm::HaloArgs* halo, void* out, int H, int W,
             const StepParams& p, const Coefs& cf, const Coefs& cf16,
             const mm::Rect& q, void* stream) {
  if (!p.moore) {
    return vpu_launch<48, 16, false, BF, T>(in, halo, out, H, W, p, cf,
                                            cf16, q, stream);
  }
  if (p.nsteps <= 8) {
    return vpu_launch<48, 8, true, BF, T>(in, halo, out, H, W, p, cf, cf16,
                                          q, stream);
  }
  if constexpr (kMaxK<T> > 8) {
    return vpu_launch<64, 16, true, BF, T>(in, halo, out, H, W, p, cf, cf16,
                                           q, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The window of a call: Moore 48 rows (OFF 8) up to k = 8 and 64 (OFF 16)
// above; other neighbourhoods 48 rows (OFF 16), their walk holds more.
// `coefs16` (the bf16 interior math's) when `bf16`.
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
  return bf16 ? vpu_rows<true>(in, halo, out, H, W, p, cf, cf16, q, stream)
              : vpu_rows<false>(in, halo, out, H, W, p, cf, cf16, q, stream);
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
// 64 x 128 block tile (two m16 tiles a warp), so one launch tiles the grid
// for both passes. Its B table is the bf16 form's (the same KMAX, REL_MIN).
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
// Shared memory of a launch of storage T (bf16 interior math: both passes'
// windows, one at a time).
template <typename T, bool BF>
int mxu_smem(int k) {
  const int exact = 2 * piece_floats(k) * static_cast<int>(sizeof(float));
  int window = mx_window_bytes<Mxu<T>>();
  if (BF && sizeof(T) == 4 && mx_window_bytes<MxuBf16Half>() > window) {
    window = mx_window_bytes<MxuBf16Half>();
  }
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
// the array, zero off the grid and in the columns past them; with RND
// every value rounded to bf16 first (a bf16 window rounds in any case).
template <typename L, bool RND, typename Src>
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
      mm::from_f32(win + i * P + j, RND ? mm::rb(x) : x);
    }
  }
}

// One pass of block t: the tile's tap correlation on tensor cores in layout
// L, written where PASS allows: 0, every cell with d > k; 1 (the f32 form
// over the window rounded to bf16), those outside `q`; 2 (the bf16
// interior math: the bf16 window against the taps' first bf16 term), those
// in `q`. `frags` is the B table: [2k+1][NB][2 terms][32 lanes] uint2, in
// mma.sync's B fragment order. f32 (TF32 MMAs): each A fragment is split
// here (split_tf32), and each row offset's products go into fresh partial
// sums that are added to `acc` with one rounded add (see the header).
// bf16: the taps' terms into acc. Returns whether a cell of the tile has
// d <= k (uniform over the block); the caller runs its exact strips.
template <typename L, int PASS, typename T, typename Src>
__device__ __forceinline__ bool mxu_pass(const Src& src, T* __restrict__ out,
                                         const uint2* __restrict__ frags,
                                         const MxuTiles& mt,
                                         const mm::Rect& q) {
  using E = typename L::E;
  constexpr int KB = L::KB;
  constexpr int MT = L::MT;
  constexpr int NB = mx_nb<L>();
  constexpr int NA = mx_na<L>();
  constexpr int P = mx_pitch<L>();
  constexpr int BH = mx_bh<L>();
  constexpr int BW = mx_bw<L>();
  constexpr bool F32 = sizeof(E) == 4;
  constexpr int ES = static_cast<int>(sizeof(E));
  constexpr int TERMS = F32 ? 3 : (PASS == 2 ? 1 : 2);
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

  mx_stage<L, PASS != 0>(src, lr0, lc0, k, win);
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
  // f32: acc sums the row offsets' partial sums, one rounded add each;
  // bf16: the MMAs accumulate into acc directly
  float acc[MT][MX_NT][4], part[F32 ? MT : 1][MX_NT][4];
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
  // the B block of A block a for n8 tile nt, or -1 where it misses the band
  const auto block_of = [&](int a, int nt) {
    const int rel = a * KB - 8 * nt;
    const int e = (rel - L::REL_MIN) / 8;
    return rel < L::REL_MIN || rel > 2 * k + 7 || e >= NB ? -1 : e;
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
      // A block a of each m-tile (f32: split); consecutive MMAs below go
      // to different accumulators
      unsigned ah[MT][4], al[F32 ? MT : 1][4];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        ldsm_x4(ah[m], a_base + ((m * 16 + dr) * P + a * KB) * ES);
        if constexpr (F32) {
#pragma unroll
          for (int e = 0; e < 4; ++e) split_tf32(ah[m][e], ah[m][e], al[m][e]);
        }
      }
      // f32: the two small products, then hi*hi, into the row offset's
      // partial sums; bf16: the taps' small term, then the first, into
      // acc (the bf16 interior math: the first alone)
#pragma unroll
      for (int t = 0; t < TERMS; ++t) {
#pragma unroll
        for (int nt = 0; nt < MX_NT; ++nt) {
          const int e = block_of(a, nt);
          if (e < 0) continue;
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            if constexpr (F32) {
              mma(part[m][nt], t == 1 ? al[m] : ah[m],
                  b[e][t == 0 ? 1 : 0], tag);
            } else {
              mma(acc[m][nt], ah[m], b[e][TERMS - 1 - t], tag);
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
        const bool inq = mm::in_rect(q, g.R0 + r, g.C0 + c);
        const bool ok =
            PASS == 2
                ? in_array && inq
                : (whole || (in_array &&
                             mm::edge_distance(g.R0 + r, g.C0 + c, g.H,
                                               g.W) > k)) &&
                      !(PASS == 1 && inq);
        if (ok) {
          mm::from_f32(out + static_cast<size_t>(r) * g.w + c,
                       acc[m][nt][e]);
        }
      }
    }
  }
  return near;
}

// Block t: the mxu form's passes (BF: the bf16 interior math on the cells
// in `q`, with the bf16 table `frags16`; the rest over the window rounded
// to bf16), then the exact strips of an edge tile.
template <typename T, bool BF, typename Src>
__device__ __forceinline__ void mxu_body(const Src& src, T* __restrict__ out,
                                         const StepParams& p,
                                         const uint2* __restrict__ frags,
                                         const uint2* __restrict__ frags16,
                                         const MxuTiles& mt,
                                         const mm::Rect& q) {
  using L = Mxu<T>;
  // the bf16 pass's layout: the bf16 form's, or for an f32 grid the one
  // that tiles it as the f32 form does
  using L16 = std::conditional_t<sizeof(T) == 4, MxuBf16Half, L>;
  extern __shared__ __align__(16) float smem[];
  const Tiling& g = mt.g;
  const int k = mt.k;
  constexpr int BH = mx_bh<L>();
  constexpr int BW = mx_bw<L>();
  const int bt = blockIdx.x;
  const int lr0 = (mt.tr0 + bt / mt.tiles_c) * BH - g.R0;
  const int lc0 = (mt.tc0 + bt % mt.tiles_c) * BW - g.C0;
  const int ar0 = max(lr0, 0), ar1 = min(lr0 + BH, g.h);
  const int ac0 = max(lc0, 0), ac1 = min(lc0 + BW, g.w);
  bool near;
  if constexpr (BF) {
    const int cover = mm::rect_cover(q, g.R0 + ar0, g.R0 + ar1, g.C0 + ac0,
                                     g.C0 + ac1);
    if (cover != mm::kNone) {
      near = mxu_pass<L16, 2>(src, out, frags16, mt, q);
      if (cover == mm::kAll) return;  // every cell in q: none near
      __syncthreads();  // the window is dead: the next pass restages it
    }
    near = mxu_pass<L, 1>(src, out, frags, mt, q);
  } else {
    near = mxu_pass<L, 0>(src, out, frags, mt, q);
  }
  if (near) {
    __syncthreads();  // the window is dead: the exact buffers take its place
    mm::exact_cells_of<BF>(src, out, p, g, ar0, ar1, ac0, ac1, smem,
                       smem + piece_floats(k));
  }
}

// K3 mxu: a whole [H, W] grid.
template <typename T, bool BF>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    composed_mxu_kernel(const T* __restrict__ in, T* __restrict__ out,
                        StepParams p, const uint2* __restrict__ frags,
                        const uint2* __restrict__ frags16, MxuTiles mt,
                        mm::Rect q) {
  mxu_body<T, BF>(mm::DenseSource<T>{in, mt.g.H, mt.g.W}, out, p, frags,
                  frags16, mt, q);
}

// K3-halo mxu: one shard and its ghost ring; `out` is the shard's [h, w].
template <typename T, bool BF>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    composed_mxu_halo_kernel(const mm::HaloSource<T> src,
                             T* __restrict__ out, StepParams p,
                             const uint2* __restrict__ frags,
                             const uint2* __restrict__ frags16, MxuTiles mt,
                             mm::Rect q) {
  mxu_body<T, BF>(src, out, p, frags, frags16, mt, q);
}

template <typename T, bool BF>
int mxu_launch(const T* in, const mm::HaloArgs* halo, void* out, int H,
               int W, const StepParams& p, const void* frags,
               const void* frags16, const mm::Rect& q, void* stream) {
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  static int limit_halo = DEFAULT_SMEM_LIMIT;
  constexpr int BH = mx_bh<Mxu<T>>();
  constexpr int BW = mx_bw<Mxu<T>>();
  MxuTiles mt;
  mt.k = p.nsteps;
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
  mt.g.n = p.nsteps;
  mt.g.h = h;
  mt.g.w = w;
  mt.g.R0 = R0;
  mt.g.C0 = C0;
  mt.g.H = H;
  mt.g.W = W;
  mt.tr0 = R0 / BH;
  mt.tc0 = C0 / BW;
  const int tiles_r = (R0 + h + BH - 1) / BH - mt.tr0;
  mt.tiles_c = (C0 + w + BW - 1) / BW - mt.tc0;
  const int smem = mxu_smem<T, BF>(p.nsteps);
  const auto* fr = static_cast<const uint2*>(frags);
  const auto* fr16 = static_cast<const uint2*>(frags16);
  if (halo == nullptr) {
    return static_cast<int>(mm::launch_blocks(
        composed_mxu_kernel<T, BF>, smem, tiles_r * mt.tiles_c, &limit,
        stream, in, static_cast<T*>(out), p, fr, fr16, mt, q));
  }
  return static_cast<int>(mm::launch_blocks(
      composed_mxu_halo_kernel<T, BF>, smem, tiles_r * mt.tiles_c,
      &limit_halo, stream, mm::HaloSource<T>(*halo), static_cast<T*>(out),
      p, fr, fr16, mt, q));
}

// `frags16` (the bf16 table) when `bf16`.
template <typename T>
int mxu(const T* in, const mm::HaloArgs* halo, void* out, int H, int W,
        const StepParams& p, const void* frags, int bf16, const mm::Rect& q,
        const void* frags16, void* stream) {
  if (!valid_k(p.nsteps, Mxu<T>::KMAX, p.mask9, p.noff) ||
      frags == nullptr || (bf16 && frags16 == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return bf16 ? mxu_launch<T, true>(in, halo, out, H, W, p, frags, frags16,
                                    q, stream)
              : mxu_launch<T, false>(in, halo, out, H, W, p, frags, frags16,
                                     q, stream);
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

template <typename T>
void layout_of(int* out7) {
  using L = Mxu<T>;
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
// its table: the bf16 coefficients (vpu, host) or the bf16 B table (mxu,
// device), used when `bf16`.
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

// The mxu form's layout for a dtype (0 f32, 1 bf16): {KB, KMAX, REL_MIN,
// NB, MX_N, BH, BW}; the Python side checks it against its own (the B
// table's layout, and the tiles its operation count assumes) before the
// first launch.
void mm_composed_mxu_layout(int bf16, int* out7) {
  if (bf16) {
    layout_of<__nv_bfloat16>(out7);
  } else {
    layout_of<float>(out7);
  }
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
