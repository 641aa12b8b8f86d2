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
// bf16 interior math (compute_dtype=bfloat16 at n > 1; the _bf16c entry
// points): the TPU kernel computes its tiles that are not near the edge
// (JAX's tiles, pallas_stencil.py:391-392) in bf16 and its near tiles in
// f32 over the window rounded to bf16 (:441). The host passes the cells of
// the former as one rectangle of global rows and columns (mm::Rect). A
// block whose outputs lie in it runs the closed form in bf16 and writes
// them: Moore on paired bf16 (mm::walk_step_bf2: two rows a register,
// add.rn.bf16x2 and mul.rn.bf16x2 with the constants rounded to bf16 on
// the host), other neighbourhoods on the f32 walk with every operation
// rounded to bf16. A block whose outputs lie outside it runs the f32 forms
// above on its window rounded to bf16 (the exact strips through
// mm::RoundedSource). A block across its edge runs both, each writing its
// own cells. Every bf16 operation rounds once and none is contracted, so
// the result is the plain version's (ops/fused_stencil.py::
// dense_step_plain(..., compute_dtype)) bit for bit.
//
// K2, the halo mode, is the same body on one shard of a sharded grid: it
// replaces _stencil_call in halo mode (reached through _pallas_halo_step and
// pallas_halo_step, used by parallel/executors.py::ShardMapExecutor). Its
// window reads the [h, w] shard, and where the window leaves the shard the
// exchanged ghost ring (eight pieces, depth d >= nsteps) in place of the
// dense kernel's zero border (mm::HaloSource). Windows inside the shard
// take the cp.async path; windows at the shard's edge read through
// src.at. Forms and counts use the shard's global origin against the global
// grid, so every cell computes exactly what K1 computes for it on the whole
// grid.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include "stencil_common.cuh"

namespace {

// A block is (32, NWARPS) threads, warp = threadIdx.y, as the shared-memory
// helpers of stencil_common.cuh stride; its window is WIN_W columns (one a
// thread) by ROWS rows (in registers): 48 or 64, by rows_for. The register
// column walk, the window staging and the exact strips are
// stencil_common.cuh's (K3's vpu form shares them).
constexpr int NWARPS = mm::kThreadsY;
constexpr int WIN_W = mm::kWinW;
constexpr int MAX_STEPS = 16;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

using Params = mm::StepParams;
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
// cell of it when `whole`, else only its cells inside the array with
// d > n; with SKIP, none of the cells in `q` (the bf16 pass writes them).
// `ex` is the warp-edge exchange of the walk.
template <int ROWS, bool MOORE, bool SKIP = false, typename T>
__device__ __forceinline__ void closed_tile(float (&v)[ROWS], float* ex,
                                            const Params& p,
                                            const Tiling& tl, int t,
                                            bool whole, T* __restrict__ out,
                                            const mm::Rect& q = {}) {
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
  if (j < n || j >= WIN_W - n || c >= tl.w) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= n && i < ROWS - n) {
      if ((whole ||
           (r + i < tl.h && mm::edge_distance(tl.R0 + r + i, tl.C0 + c, tl.H,
                                              tl.W) > n)) &&
          !(SKIP && mm::in_rect(q, tl.R0 + r + i, tl.C0 + c))) {
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

// The bf16 closed form's n steps on tile t's staged window (`col`: this
// thread's column of it; mm::closed_walk_bf16), then its outputs in `q`
// written.
template <int ROWS, bool MOORE, typename T>
__device__ __forceinline__ void bf16_tile(const T* col, float* ex,
                                          const Params& p, const Tiling& tl,
                                          int t, const mm::Rect& q,
                                          T* __restrict__ out) {
  const int n = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r = tl.row_of(t) - n;  // the window's first row and column
  const int c = tl.col_of(t) + j - n;
  const bool col_out = j >= n && j < WIN_W - n && c < tl.w &&
                       tl.C0 + c >= q.c0 && tl.C0 + c < q.c1;
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) v[i] = mm::to_f32(col[i * mm::kStagePitch<T>]);
  mm::closed_walk_bf16<ROWS, MOORE>(v, ex, n, p.ca16, p.cb16, p.offcodes,
                                    p.noff);
  if (!col_out) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= n && i < ROWS - n && r + i < tl.h && tl.R0 + r + i >= q.r0 &&
        tl.R0 + r + i < q.r1) {
      mm::from_f32(out + static_cast<size_t>(r + i) * tl.w + c, v[i]);
    }
  }
}

// The body of K1 and K2: block t steps tile t of `tl`. BF: the bf16
// interior math, its cells `q` (the header).
template <int ROWS, bool MOORE, bool BF, typename T, typename Src>
__device__ __forceinline__ void fused_body(const Src& src,
                                           T* __restrict__ out,
                                           const Params& p,
                                           const Tiling& tl,
                                           const mm::Rect& q) {
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
  if constexpr (BF) {
    // the tile's outputs in global coordinates, against the rectangle
    const int gr = tl.R0 + tl.row_of(t);
    const int gc = tl.C0 + tl.col_of(t);
    const int cover =
        mm::rect_cover(q, gr, min(gr + tl.th, tl.R0 + tl.h), gc,
                       min(gc + tl.tw, tl.C0 + tl.w));
    if (cover != mm::kNone) {
      bf16_tile<ROWS, MOORE>(col, ex, p, tl, t, q, out);
      if (cover == mm::kAll) return;
      // the f32 walk reads the exchange slots of warps -1 and 8 as zero
      __syncthreads();
      for (int k = j; k < mm::kExchFloats<ROWS>; k += 32 * NWARPS) {
        ex[k] = 0.f;
      }
      __syncthreads();
    }
    float v[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      v[i] = mm::rb(mm::to_f32(col[i * mm::kStagePitch<T>]));
    }
    closed_tile<ROWS, MOORE, true>(v, ex, p, tl, t, whole, out, q);
    if (!whole) {
      __syncthreads();
      mm::exact_cells_of<true>(src, out, p, tl, tl.row_of(t),
                               min(tl.row_of(t) + tl.th, tl.h), tl.col_of(t),
                               min(tl.col_of(t) + tl.tw, tl.w), work,
                               work + piece_floats(p.nsteps));
    }
    return;
  }
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
template <int ROWS, bool MOORE, bool BF, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                         Params p, Tiling tl, mm::Rect q) {
  fused_body<ROWS, MOORE, BF>(mm::DenseSource<T>{in, tl.H, tl.W}, out, p,
                              tl, q);
}

// K2: one shard and its ghost ring; `out` is the shard's [h, w].
template <int ROWS, bool MOORE, bool BF, typename T>
__global__ void __launch_bounds__(32 * NWARPS, 2)
    fused_stencil_halo_kernel(const mm::HaloSource<T> src,
                              T* __restrict__ out, Params p, Tiling tl,
                              mm::Rect q) {
  fused_body<ROWS, MOORE, BF>(src, out, p, tl, q);
}

bool valid_steps(const Params& p) {
  return p.nsteps >= 1 && p.nsteps <= MAX_STEPS &&
         (p.mask9 & ~0x1EF) == 0 && p.mask9 != 0 &&
         p.noff == __builtin_popcount(p.mask9);
}

template <int ROWS, bool MOORE, bool BF, typename T>
int launch(const void* in, void* out, int H, int W, Params p,
           const mm::Rect& q, void* stream) {
  p.vec = mm::rows_aligned<T>(in, W);
  const Tiling tl =
      mm::make_tiling(ROWS, p.nsteps, p.nsteps, H, W, 0, 0, H, W);
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  return static_cast<int>(mm::launch_blocks(
      fused_stencil_kernel<ROWS, MOORE, BF, T>, smem_of<T, ROWS>(p.nsteps),
      tl.tiles, &limit, stream, static_cast<const T*>(in),
      static_cast<T*>(out), p, tl, q));
}

template <int ROWS, bool MOORE, bool BF, typename T>
int launch_halo(const mm::HaloArgs* args, void* out, Params p,
                const mm::Rect& q, void* stream) {
  const mm::HaloSource<T> src(*args);
  p.vec = mm::rows_aligned<T>(args->shard, args->w);
  const Tiling tl = mm::make_tiling(ROWS, p.nsteps, p.nsteps, src.h, src.w,
                                    src.R0, src.C0, src.H, src.W);
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  return static_cast<int>(mm::launch_blocks(
      fused_stencil_halo_kernel<ROWS, MOORE, BF, T>,
      smem_of<T, ROWS>(p.nsteps), tl.tiles, &limit, stream, src,
      static_cast<T*>(out), p, tl, q));
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

// The window rows of a call, chosen by measurement on the H100
// (k1_variants.py, PERF.md): the fewest rows keep the halo rows' share of
// the loads low at small n; more rows cut the halo's share of the steps at
// larger n, at two blocks an SM (128 registers). Neighbourhoods other than
// Moore keep 48 (their kernel holds more).
int rows_for(const Params& p) {
  return !p.moore || p.nsteps <= 2 ? 48 : 64;
}

template <bool BF, typename T>
int dense(const void* in, void* out, int H, int W, const Params& p,
          const mm::Rect& q, void* stream) {
  if (!valid_steps(p) || H < 0 || W < 0 || (BF && p.nsteps < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || W == 0) return 0;
  switch (rows_for(p)) {
    case 64: return launch<64, true, BF, T>(in, out, H, W, p, q, stream);
    default:
      return p.moore
                 ? launch<48, true, BF, T>(in, out, H, W, p, q, stream)
                 : launch<48, false, BF, T>(in, out, H, W, p, q, stream);
  }
}

template <bool BF, typename T>
int halo(const void* args, void* out, const Params& p, const mm::Rect& q,
         void* stream) {
  const auto* a = static_cast<const mm::HaloArgs*>(args);
  if (a == nullptr || !valid_steps(p) ||
      !mm::valid_halo(*a, p.nsteps, MAX_STEPS) || (BF && p.nsteps < 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->h == 0 || a->w == 0) return 0;
  switch (rows_for(p)) {
    case 64: return launch_halo<64, true, BF, T>(a, out, p, q, stream);
    default:
      return p.moore ? launch_halo<48, true, BF, T>(a, out, p, q, stream)
                     : launch_halo<48, false, BF, T>(a, out, p, q, stream);
  }
}

// The entry points' dispatch: f32 interior math, or bf16 (`bf16`, with
// its rectangle and its constants).
template <typename T>
int dense_entry(const void* in, void* out, int H, int W, const Params& p,
                int bf16, const mm::Rect& q, void* stream) {
  return bf16 ? dense<true, T>(in, out, H, W, p, q, stream)
              : dense<false, T>(in, out, H, W, p, q, stream);
}

template <typename T>
int halo_entry(const void* args, void* out, const Params& p, int bf16,
               const mm::Rect& q, void* stream) {
  return bf16 ? halo<true, T>(args, out, p, q, stream)
              : halo<false, T>(args, out, p, q, stream);
}

}  // namespace

extern "C" {

// The step arguments (ops/fused_stencil.py::_step_args): the exact path's
// rate and 1 - rate, the closed form's f32 constants, the steps and the
// neighbourhood; then the bf16 interior math: on or off, its rectangle
// (global rows [r0, r1), columns [c0, c1)) and its bf16 constants.
#define MM_STEP_ARGS                                                        \
  float rate, float keep, float ca, float cb, int nsteps, int mask9,       \
      int noff, int offcodes, int moore, int bf16, int r0, int r1, int c0, \
      int c1, float ca16, float cb16
#define MM_PARAMS                                                         \
  make_params(rate, keep, ca, cb, nsteps, mask9, noff, offcodes, moore,  \
              ca16, cb16)

int mm_fused_stencil_f32(const void* in, void* out, int H, int W,
                         MM_STEP_ARGS, void* stream) {
  return dense_entry<float>(in, out, H, W, MM_PARAMS, bf16,
                            mm::Rect{r0, r1, c0, c1}, stream);
}

int mm_fused_stencil_bf16(const void* in, void* out, int H, int W,
                          MM_STEP_ARGS, void* stream) {
  return dense_entry<__nv_bfloat16>(in, out, H, W, MM_PARAMS, bf16,
                                    mm::Rect{r0, r1, c0, c1}, stream);
}

int mm_fused_stencil_halo_f32(const void* args, void* out, MM_STEP_ARGS,
                              void* stream) {
  return halo_entry<float>(args, out, MM_PARAMS, bf16,
                           mm::Rect{r0, r1, c0, c1}, stream);
}

int mm_fused_stencil_halo_bf16(const void* args, void* out, MM_STEP_ARGS,
                               void* stream) {
  return halo_entry<__nv_bfloat16>(args, out, MM_PARAMS, bf16,
                                   mm::Rect{r0, r1, c0, c1}, stream);
}

int mm_halo_args_size() { return static_cast<int>(sizeof(mm::HaloArgs)); }

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mm_max_steps() { return MAX_STEPS; }

}  // extern "C"
