// K5: the pipelined-window dense stencil, written by hand for Hopper
// (sm_90a), over a batch of independent grids.
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_pipeline_call
// (the pl.pallas_call reached through pallas_dense_step(pipeline=True), whose
// one caller is the ensemble engine, EnsembleExecutor(impl="pipeline")). It
// computes what that kernel computes: `nsteps` (<= 8) uniform-rate radius-1
// transport steps of every lane of a contiguous [B, H, W] batch, in one read
// and one write of device memory, with the TPU kernel's two forms chosen per
// TPU tile of (BR, BC) cells (_pipeline_blocks, or the caller's block):
//
//   - a tile is near when g_r0 <= n, g_r0 + BR >= H - n, g_c0 <= n or
//     g_c0 + BC >= W - n. Near tiles take the exact masked path
//     (share = (rate * v) / cnt with the in-bounds count of the global cell,
//     v' = v * (1 - rate) + (0 + the shares in `offsets` order), off-grid
//     cells zero);
//   - other tiles take the closed form. Moore (the eight offsets, in any
//     order): band = (row r-1 + row r) + row r+1 per column, nine =
//     (band[c-1] + band[c]) + band[c+1], v' = v * a + nine * b with
//     a = 1 - r - r/8 and b = r/8. Other neighborhoods: g = the neighbours
//     summed in `offsets` order, v' = v * a + g * b with a = 1 - r,
//     b = r/k. The constants come rounded to f32 from the host (the TPU
//     kernel's weak-typed Python floats).
//
// bf16 interior math (compute_dtype=bfloat16, `bf16`): the closed tiles
// compute in bf16, as the TPU kernel's do (pallas_stencil.py:656), the
// constants rounded to bf16 on the host; near tiles stay f32, as the TPU
// kernel's do. Moore in its row-major order (the main path's) is two
// launches on the caller's stream, each writing only its own cells:
//
//   - the near launch (pipeline_near_kernel) steps the windows of the near
//     TPU tiles only (the tiles off the rectangle of closed tiles, as four
//     bands of tiles, NearTiles), with the near branch below and nothing of
//     the closed one, at rows_for's rows;
//   - the paired launch (pipeline_bf16_kernel) tiles each lane's rectangle
//     of closed tiles from its origin (one rectangle of cells: the closed
//     form does not depend on the position, so its windows need not restart
//     at the TPU tiles) with K1's paired walk (stencil_common.cuh
//     paired_tile: row pairs in bf16x2 registers, the bands of a step's
//     first pass kept for its second, the window staged raw by cp.async),
//     at paired_rows' rows.
//
//   A lane with no closed tile (every lane of 8 x 4096^2 at JAX's blocks)
//   makes the near launch alone. Measured on the H100 against the one
//   kernel with both branches (k56_variants.py, PERF.md): 1.09x faster at
//   4 x 8192^2 ns=8 in f32 storage, 1.15x in bf16 (the paired walk, 0.55
//   ms, in place of the bands re-formed every step); the near-only
//   instance keeps no spill at 64 rows (the one kernel's spills 188-276 B)
//   and runs no faster than the one kernel's near branch (8 x 4096^2);
//   at ns=1 in f32 storage the two launches are 4% slower.
//
// Other neighbourhoods and offset orders keep one kernel with both branches:
// mm::closed_walk_bf16 on the closed tiles (Moore on paired bf16, others the
// f32 walk with every operation rounded), the window rounded to bf16 on the
// way in. A runtime flag, not a template: the near branch, the long one to
// compile, is shared.
//
// Storage is float or __nv_bfloat16, cast to f32 once on the way in and
// once on the way out. Every operation is an explicitly rounded intrinsic
// and the source builds with --fmad=false, so the kernel equals its plain
// version (ops/pipeline_stencil.py::pipeline_step_plain) bit for bit.
//
// What bounds it: on paper, bytes. One call must read the batch once and
// write it once (8 bytes a cell in f32, 4 in bf16) against 7 f32 operations
// a cell-step on closed-form tiles and k + 3 on the exact path. At 4096²
// (the ensemble path) every TPU tile of _pipeline_blocks' (512, 2048)
// touches a column edge, so every cell takes the exact path, and the steps'
// instructions bound it. The design (K1's register column walk, with a lane
// axis):
//
//   - A block of 8 warps holds a ROWS x 256 window in registers, one window
//     column a thread, loaded straight from device memory (zero off the
//     grid), and writes (ROWS - 2n) x (256 - 2n) outputs. The two forms
//     round differently, so a window's outputs lie in one TPU tile: the
//     windows restart at each TPU tile's first row and column, and the last
//     window of a tile writes only its part of the tile. The grid is
//     (windows of a lane, B): one launch steps every lane.
//   - Closed tiles: K1's closed walk (stencil_common.cuh walk_step, K1's
//     constants: fused_stencil.py::closed_constants).
//   - Near tiles: the exact path as a register walk (exact_walk.cuh): the
//     shares computed row by row, c+-1 by __shfl_sync, one barrier a step,
//     with the full count (a power of two, Moore's 8 or von Neumann's 4, as
//     a multiply by its exact inverse) and no grid test. An output more
//     than n from the global edge has the full neighbourhood at every cell
//     it reads, so that is its exact value. The outputs within n + 1 of the
//     edge (the windows that reach the border band, 12.5% of them at 4096²)
//     then take K1's exact pieces (stencil_common.cuh exact_cells: shared
//     memory, the old body's arithmetic) on the n + 1 deep border strips.
//     A per-cell-count walk over the whole edge window (its counts from the
//     row's and column's on-grid bits) measured 6x the full-count walk's
//     instructions a row, 1.6x the kernel; it stays for neighbourhoods whose
//     full count is not a power of two.
//   - Window rows: 48, or 64 for Moore in its row-major order above 2
//     steps (rows_for; k56_variants.py measures the choice), the near
//     launch's too (48 against 64 rows at 8 steps: 1.05x slower); the
//     paired launch K1's (paired_rows: 64 up to 2 steps, 96 above).
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launches, 0 on success.

#include "exact_walk.cuh"

namespace {

constexpr int kWarps = mm::kThreadsY;
constexpr int kWinW = mm::kWinW;
constexpr int MAX_STEPS = 8;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

struct Params {
  int H, W;        // one lane's grid
  int BR, BC;      // the TPU tile that decides the form
  int nsteps;
  int mask9;       // neighbourhood bitmask (the in-bounds count)
  int noff;        // offsets, in order, 4 bits each
  int offcodes;
  int moore;       // the closed form's separable Moore sum
  float rate, keep;  // the exact path's rate and f32(1 - rate)
  float ca, cb;      // the closed form's f32 constants
  int bf16;          // closed tiles in bf16
  unsigned ca16, cb16;  // the closed form's bf16 constants (bits)
};

// The windows of one lane: oh x ow outputs each (before clipping to the
// TPU tile), wr x wc of them a TPU tile.
struct Windows {
  int rows;        // window rows
  int oh, ow;      // output rows and columns of a window
  int wr, wc;      // windows down and across a TPU tile
  int tiles_c;     // windows across the grid
  int tiles;       // windows of a lane
};

bool row_major_moore(const Params& p) {
  return p.moore &&
         static_cast<unsigned>(p.offcodes) == mm_exact::kMooreCodes;
}

// The window rows of a call (a compile-time constant of each instance).
int rows_for(const Params& p) {
  return p.moore && static_cast<unsigned>(p.offcodes) ==
                        mm_exact::kMooreCodes && p.nsteps > 2
             ? 64
             : 48;
}

// The paired launch's window rows: K1's rule
// (ops/fused_stencil.py::paired_rows), 64 up to 2 steps.
int paired_rows(const Params& p) { return p.nsteps > 2 ? 96 : 64; }

Windows windows_of(const Params& p, int rows) {
  Windows w;
  w.rows = rows;
  w.oh = w.rows - 2 * p.nsteps;
  w.ow = kWinW - 2 * p.nsteps;
  w.wr = (p.BR + w.oh - 1) / w.oh;
  w.wc = (p.BC + w.ow - 1) / w.ow;
  w.tiles_c = p.W / p.BC * w.wc;
  w.tiles = p.H / p.BR * w.wr * w.tiles_c;
  return w;
}

// The closed TPU tiles of a lane: tile rows [tr0, tr1) and columns
// [tc0, tc1), the tiles that are not near (the kernel's near test, JAX's
// pallas_stencil.py:391-392); the near test holds along each axis alone, so
// they form one rectangle. No closed tile: tr0 == tr1 == 0.
struct Closed {
  int tr0, tr1, tc0, tc1;
  bool empty() const { return tr0 >= tr1; }
};

// The tiles of [0, extent) in blocks of b that are not near an edge.
void closed_span(int extent, int b, int n, int& t0, int& t1) {
  t0 = t1 = 0;
  bool any = false;
  for (int t = 0; t < extent / b; ++t) {
    if (t * b > n && t * b + b < extent - n) {
      if (!any) t0 = t;
      t1 = t + 1;
      any = true;
    }
  }
}

Closed closed_of(const Params& p) {
  Closed q;
  closed_span(p.H, p.BR, p.nsteps, q.tr0, q.tr1);
  closed_span(p.W, p.BC, p.nsteps, q.tc0, q.tc1);
  if (q.tr0 >= q.tr1 || q.tc0 >= q.tc1) q = Closed{0, 0, 0, 0};
  return q;
}

// The near launch's TPU tiles: four bands of tiles around the closed ones
// (top, bottom, left, right; with no closed tile the top band is every
// tile). Block b of a lane steps window b % per of the band's tile
// (b / per) - first[k], k the last band with first[k] <= b / per, taken row
// by row across the band's `cols` tiles from tile (r0[k], c0[k]). A kernel
// parameter in the parameter space (__grid_constant__), read by index.
struct NearTiles {
  int first[4];
  int r0[4], c0[4], cols[4];
};

int near_tiles(const Params& p, const Closed& q, NearTiles& nt) {
  const int nr = p.H / p.BR, nc = p.W / p.BC;
  const int rows[4] = {q.empty() ? nr : q.tr0, q.empty() ? 0 : nr - q.tr1,
                       q.tr1 - q.tr0, q.tr1 - q.tr0};
  const int r0[4] = {0, q.tr1, q.tr0, q.tr0};
  const int c0[4] = {0, 0, 0, q.tc1};
  const int cols[4] = {nc, nc, q.tc0, nc - q.tc1};
  int tiles = 0;
  for (int k = 0; k < 4; ++k) {
    nt.first[k] = tiles;
    nt.r0[k] = r0[k];
    nt.c0[k] = c0[k];
    nt.cols[k] = cols[k] > 0 ? cols[k] : 1;
    tiles += cols[k] > 0 ? rows[k] * cols[k] : 0;
  }
  return tiles;
}

template <int ROWS>
constexpr int smem_floats() {
  return mm::kExchFloats<ROWS> > mm_exact::exchange_elems(ROWS, kWarps)
             ? mm::kExchFloats<ROWS>
             : mm_exact::exchange_elems(ROWS, kWarps);
}

// The exact path's n steps on the window in registers (its [0, 0] at
// global (r0, c - j)).
template <int ROWS, bool INNER, unsigned CODES, int NOFF>
__device__ __forceinline__ void exact_steps(float (&v)[ROWS], float* ex,
                                            const Params& p,
                                            const mm_exact::Cell<float>& cell,
                                            int r0, int c) {
  using A = mm_exact::Arith<float>;
  const int bits = INNER ? 7 : mm_exact::line_bits(c, p.W);
  const int bits_o =
      INNER ? 7 : mm_exact::line_bits(threadIdx.x == 0 ? c - 1 : c + 1, p.W);
  const float keep = p.keep;
  constexpr int half = mm_exact::exchange_elems(ROWS, kWarps) / 2;
  for (int s = 0; s < p.nsteps; ++s) {
    mm_exact::exact_step<ROWS, INNER, A, CODES, NOFF>(
        v, ex + (s & 1) * half, cell, r0, bits, bits_o,
        [&](int, float x, float, float g, int rb) {
          return INNER || ((rb & 2) && (bits & 2))
                     ? __fadd_rn(__fmul_rn(x, keep), g)
                     : 0.f;
        });
  }
}

// Write the window's outputs: rows [n, ROWS - n) of columns [n, 256 - n),
// clipped to the TPU tile (rows below o_r1, columns below o_c1); with
// `far`, only the cells more than n from the global edge.
template <int ROWS, typename T>
__device__ __forceinline__ void write_window(T* __restrict__ out,
                                             const float (&v)[ROWS],
                                             const Params& p, int r0, int c,
                                             int o_r1, int o_c1, bool far) {
  const int n = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  if (j < n || j >= kWinW - n || c >= o_c1) return;
  const bool col_far = c > n && c < p.W - 1 - n;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    if (i >= n && i < ROWS - n && r < o_r1 &&
        (!far || (col_far && r > n && r < p.H - 1 - n))) {
      mm::from_f32(out + static_cast<size_t>(r) * p.W + c, v[i]);
    }
  }
}

// This thread's column of the window whose first row is r0 (zero off the
// grid), from device memory.
template <int ROWS, typename T>
__device__ __forceinline__ void load_column(const T* __restrict__ in,
                                            const Params& p, int r0, int c,
                                            float (&v)[ROWS]) {
  const bool col_in = c >= 0 && c < p.W;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    v[i] = col_in && r >= 0 && r < p.H
               ? mm::to_f32(in[static_cast<size_t>(r) * p.W + c])
               : 0.f;
  }
}

// The near tiles' form on the window in registers (the exact path), for
// the window's outputs [o_r0, o_r1) x [o_c0, o_c1). Returns true when it
// has written them (an edge window: its cells more than n from the edge,
// then K1's exact pieces on the border strips); else the caller writes the
// window. pipeline_stencil_kernel's near branch is this code written out
// in place: called from there, it cost three of that kernel's instances 4
// to 8 more bytes of spill loads (ptxas on sm_90a).
template <int ROWS, unsigned CODES, int NOFF, typename T>
__device__ __forceinline__ bool near_steps(const T* __restrict__ in,
                                           T* __restrict__ out,
                                           float (&v)[ROWS], float* smem,
                                           const Params& p, int r0, int c,
                                           int o_r0, int o_r1, int o_c0,
                                           int o_c1) {
  const int n = p.nsteps;
  const mm_exact::Cell<float> cell = mm_exact::make_cell<float>(
      p.rate, p.mask9, p.noff, p.offcodes, p.H, p.W);
  // every output more than n from the global edge
  const bool inner = o_r0 >= n + 1 && o_r1 <= p.H - 1 - n &&
                     o_c0 >= n + 1 && o_c1 <= p.W - 1 - n;
  if (cell.inv == 0.f) {
    // a full count that is not a power of two: per-cell counts throughout
    exact_steps<ROWS, false, CODES, NOFF>(v, smem, p, cell, r0, c);
  } else {
    exact_steps<ROWS, true, CODES, NOFF>(v, smem, p, cell, r0, c);
    if (!inner) {
      // the walk's full count holds for the outputs more than n from the
      // edge; the n + 1 deep border strips take K1's exact pieces
      write_window<ROWS>(out, v, p, r0, c, o_r1, o_c1, true);
      __syncthreads();  // the walk's exchange becomes the pieces' buffers
      mm::StepParams sp{};
      sp.nsteps = n;
      sp.mask9 = p.mask9;
      sp.noff = p.noff;
      sp.offcodes = p.offcodes;
      sp.rate = p.rate;
      sp.keep = p.keep;
      mm::Tiling tl{};  // the whole grid: what exact_cells reads of it
      tl.h = tl.H = p.H;
      tl.w = tl.W = p.W;
      mm::exact_cells(mm::DenseSource<T>{in, p.H, p.W}, out, sp, tl, o_r0,
                      o_r1, o_c0, o_c1, smem, smem + mm::piece_floats(n));
      return true;
    }
  }
  return false;
}

template <typename T, int ROWS, bool MOORE, unsigned CODES, int NOFF>
__global__ void __launch_bounds__(32 * kWarps, 2)
    pipeline_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                            Params p, Windows wn) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.nsteps;
  const size_t lane = static_cast<size_t>(blockIdx.y) * p.H * p.W;
  in += lane;
  out += lane;
  // window t: its TPU tile, and its outputs [o_r0, o_r1) x [o_c0, o_c1)
  const int t = static_cast<int>(blockIdx.x);
  const int a = t / wn.tiles_c;
  const int b = t - a * wn.tiles_c;
  const int g_r0 = a / wn.wr * p.BR;
  const int g_c0 = b / wn.wc * p.BC;
  const int o_r0 = g_r0 + a % wn.wr * wn.oh;
  const int o_c0 = g_c0 + b % wn.wc * wn.ow;
  const int o_r1 = min(o_r0 + wn.oh, g_r0 + p.BR);
  const int o_c1 = min(o_c0 + wn.ow, g_c0 + p.BC);
  // the TPU tile's branch (uniform over the block)
  const bool near = g_r0 <= n || g_r0 + p.BR >= p.H - n || g_c0 <= n ||
                    g_c0 + p.BC >= p.W - n;
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r0 = o_r0 - n;  // the window's first row
  const int c = o_c0 - n + j;  // this thread's column
  const bool col_in = c >= 0 && c < p.W;
  float v[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    v[i] = col_in && r >= 0 && r < p.H
               ? mm::to_f32(in[static_cast<size_t>(r) * p.W + c])
               : 0.f;
  }
  if (!near) {
    // K1's closed form; the exchange slots of warps -1 and 8 stay zero
    for (int e = j; e < mm::kExchFloats<ROWS>; e += 32 * kWarps) {
      smem[e] = 0.f;
    }
    __syncthreads();
    if (p.bf16) {
      mm::closed_walk_bf16<ROWS, MOORE>(v, smem, n, p.ca16, p.cb16,
                                        p.offcodes, p.noff);
    } else {
      int drow[8], dcol[8];
      mm::offset_rows_cols(p.offcodes, drow, dcol);
      const float ca = p.ca, cb = p.cb;
      for (int s = 0; s < n; ++s) {
        mm::walk_step<ROWS, MOORE>(
            v, smem + (s & 1) * mm::kEdgeSlots * ROWS, drow, dcol, p.noff,
            [&](int, float old, float g) {
              return __fadd_rn(__fmul_rn(old, ca), __fmul_rn(g, cb));
            });
      }
    }
  } else {
    const mm_exact::Cell<float> cell = mm_exact::make_cell<float>(
        p.rate, p.mask9, p.noff, p.offcodes, p.H, p.W);
    // every output more than n from the global edge
    const bool inner = o_r0 >= n + 1 && o_r1 <= p.H - 1 - n &&
                       o_c0 >= n + 1 && o_c1 <= p.W - 1 - n;
    if (cell.inv == 0.f) {
      // a full count that is not a power of two: per-cell counts throughout
      exact_steps<ROWS, false, CODES, NOFF>(v, smem, p, cell, r0, c);
    } else {
      exact_steps<ROWS, true, CODES, NOFF>(v, smem, p, cell, r0, c);
      if (!inner) {
        // the walk's full count holds for the outputs more than n from the
        // edge; the n + 1 deep border strips take K1's exact pieces
        write_window<ROWS>(out, v, p, r0, c, o_r1, o_c1, true);
        __syncthreads();  // the walk's exchange becomes the pieces' buffers
        mm::StepParams sp{};
        sp.nsteps = n;
        sp.mask9 = p.mask9;
        sp.noff = p.noff;
        sp.offcodes = p.offcodes;
        sp.rate = p.rate;
        sp.keep = p.keep;
        mm::Tiling tl{};  // the whole grid: what exact_cells reads of it
        tl.h = tl.H = p.H;
        tl.w = tl.W = p.W;
        mm::exact_cells(mm::DenseSource<T>{in, p.H, p.W}, out, sp, tl, o_r0,
                        o_r1, o_c0, o_c1, smem,
                        smem + mm::piece_floats(n));
        return;
      }
    }
  }
  write_window<ROWS>(out, v, p, r0, c, o_r1, o_c1, false);
}

// The bf16 interior math's near launch: the windows of the near TPU tiles
// (NearTiles), the near branch alone. The grid is (near tiles x wr x wc
// windows, lanes).
template <typename T, int ROWS, unsigned CODES, int NOFF>
__global__ void __launch_bounds__(32 * kWarps, 2)
    pipeline_near_kernel(const T* __restrict__ in, T* __restrict__ out,
                         Params p, Windows wn,
                         const __grid_constant__ NearTiles nt) {
  extern __shared__ __align__(16) float smem[];
  const int n = p.nsteps;
  const size_t lane = static_cast<size_t>(blockIdx.y) * p.H * p.W;
  in += lane;
  out += lane;
  const int per = wn.wr * wn.wc;  // windows a TPU tile
  const int k = static_cast<int>(blockIdx.x) / per;
  const int w = static_cast<int>(blockIdx.x) - k * per;
  int band = 0;
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    if (k >= nt.first[q]) band = q;
  }
  const int kb = k - nt.first[band];
  const int g_r0 = (nt.r0[band] + kb / nt.cols[band]) * p.BR;
  const int g_c0 = (nt.c0[band] + kb % nt.cols[band]) * p.BC;
  const int o_r0 = g_r0 + w / wn.wc * wn.oh;
  const int o_c0 = g_c0 + w % wn.wc * wn.ow;
  const int o_r1 = min(o_r0 + wn.oh, g_r0 + p.BR);
  const int o_c1 = min(o_c0 + wn.ow, g_c0 + p.BC);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r0 = o_r0 - n;
  const int c = o_c0 - n + j;
  float v[ROWS];
  load_column<ROWS>(in, p, r0, c, v);
  if (near_steps<ROWS, CODES, NOFF>(in, out, v, smem, p, r0, c, o_r0, o_r1,
                                    o_c0, o_c1)) {
    return;
  }
  write_window<ROWS>(out, v, p, r0, c, o_r1, o_c1, false);
}

// The bf16 interior math's paired launch: tile blockIdx.x of the lane's
// rectangle (blockIdx.y), K1's paired walk.
template <typename T, int ROWS>
__global__ void __launch_bounds__(32 * kWarps, 2)
    pipeline_bf16_kernel(const T* __restrict__ in, T* __restrict__ out,
                         mm::StepParams sp, mm::RegionTiling tl) {
  const size_t lane = static_cast<size_t>(blockIdx.y) * tl.H * tl.W;
  mm::paired_tile<ROWS>(mm::DenseSource<T>{in + lane, tl.H, tl.W},
                        out + lane, sp, tl, static_cast<int>(blockIdx.x));
}

// Shared memory of a window of the near branch: the walks' exchange, or
// the border strips' two piece buffers (at most 28.8 KB at 8 steps: below
// the default limit).
template <int ROWS>
int near_smem(int n) {
  const int pieces = 2 * mm::piece_floats(n);
  return (smem_floats<ROWS>() > pieces ? smem_floats<ROWS>() : pieces) *
         static_cast<int>(sizeof(float));
}

template <typename T, int ROWS, bool MOORE, unsigned CODES, int NOFF>
int launch_rows(const void* in, void* out, int B, const Params& p,
                void* stream) {
  const Windows wn = windows_of(p, rows_for(p));
  if (wn.rows != ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pipeline_stencil_kernel<T, ROWS, MOORE, CODES, NOFF>;
  kernel<<<dim3(wn.tiles, B), dim3(32, kWarps), near_smem<ROWS>(p.nsteps),
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(in),
                                                static_cast<T*>(out), p, wn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
cudaError_t launch_near(const void* in, void* out, int B, const Params& p,
                        const NearTiles& nt, int tiles, void* stream) {
  const Windows wn = windows_of(p, ROWS);
  const auto kernel =
      pipeline_near_kernel<T, ROWS, mm_exact::kMooreCodes, 8>;
  kernel<<<dim3(tiles * wn.wr * wn.wc, B), dim3(32, kWarps),
           near_smem<ROWS>(p.nsteps), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p, wn, nt);
  return cudaGetLastError();
}

template <typename T, int ROWS>
cudaError_t launch_paired(const void* in, void* out, int B,
                          const mm::StepParams& sp,
                          const mm::RegionTiling& tl, void* stream) {
  const auto kernel = pipeline_bf16_kernel<T, ROWS>;
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  // the exchange in pair words and the staged window
  const int smem = 2 * mm::kEdgeSlots * (ROWS / 2) *
                       static_cast<int>(sizeof(float)) +
                   mm::stage_bytes<T, ROWS>();
  if (smem > limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    limit = smem;
  }
  kernel<<<dim3(tl.tiles, B), dim3(32, kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), sp, tl);
  return cudaGetLastError();
}

// The paired launch's tiling of a lane's rectangle and its step
// parameters.
mm::RegionTiling paired_tiling(const Params& p, const Closed& q, int rows16,
                               int vec) {
  const mm::Array a{p.H, p.W, 0, 0, p.H, p.W, vec};
  return mm::region_tiling(rows16, p.nsteps, p.nsteps, a, q.tr0 * p.BR,
                           q.tr1 * p.BR, q.tc0 * p.BC, q.tc1 * p.BC);
}

// A bf16-interior call of Moore in its row-major order: the near launch
// over the near TPU tiles, then the paired launch over the rectangle of
// closed tiles (none without a closed tile: CUDA refuses 0 blocks; that is
// the call's geometry, not a fallback).
template <typename T>
int launch_two(const void* in, void* out, int B, const Params& p,
               void* stream) {
  const Closed q = closed_of(p);
  NearTiles nt;
  const int tiles = near_tiles(p, q, nt);
  cudaError_t err = cudaSuccess;
  if (tiles > 0) {
    err = rows_for(p) == 64
              ? launch_near<T, 64>(in, out, B, p, nt, tiles, stream)
              : launch_near<T, 48>(in, out, B, p, nt, tiles, stream);
  }
  if (err != cudaSuccess || q.empty()) return static_cast<int>(err);
  mm::StepParams sp{};
  sp.nsteps = p.nsteps;
  sp.mask9 = p.mask9;
  sp.noff = p.noff;
  sp.offcodes = p.offcodes;
  sp.moore = p.moore;
  sp.vec = mm::rows_aligned<T>(in, p.W);
  sp.rate = p.rate;
  sp.keep = p.keep;
  sp.ca = p.ca;
  sp.cb = p.cb;
  sp.ca16 = p.ca16;
  sp.cb16 = p.cb16;
  const int rows16 = paired_rows(p);
  const mm::RegionTiling tl = paired_tiling(p, q, rows16, sp.vec);
  err = rows16 == 96 ? launch_paired<T, 96>(in, out, B, sp, tl, stream)
                     : launch_paired<T, 64>(in, out, B, sp, tl, stream);
  return static_cast<int>(err);
}

bool valid(const Params& p, int B) {
  return !(p.nsteps < 1 || p.nsteps > MAX_STEPS ||
           (p.mask9 & ~0x1EF) != 0 || p.mask9 == 0 ||
           p.noff != __builtin_popcount(p.mask9) || B < 0 || p.H < 0 ||
           p.W < 0 || p.BR < 1 || p.BC < 1 || p.BR % 16 != 0 ||
           p.BC % 128 != 0 || p.H % p.BR != 0 || p.W % p.BC != 0 ||
           B > 65535);
}

template <typename T>
int launch(const void* in, void* out, int B, const Params& p, void* stream) {
  if (!valid(p, B)) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || p.H == 0 || p.W == 0) return 0;
  if (p.bf16 && row_major_moore(p)) {
    return launch_two<T>(in, out, B, p, stream);
  }
  if (row_major_moore(p)) {
    return rows_for(p) == 64
               ? launch_rows<T, 64, true, mm_exact::kMooreCodes, 8>(
                     in, out, B, p, stream)
               : launch_rows<T, 48, true, mm_exact::kMooreCodes, 8>(
                     in, out, B, p, stream);
  }
  return p.moore ? launch_rows<T, 48, true, 0u, 0>(in, out, B, p, stream)
                 : launch_rows<T, 48, false, 0u, 0>(in, out, B, p, stream);
}

Params make_params(int H, int W, int BR, int BC, float rate, float keep,
                   float ca, float cb, int nsteps, int mask9, int noff,
                   int offcodes, int moore, int bf16, float ca16,
                   float cb16) {
  Params p;
  p.H = H;
  p.W = W;
  p.BR = BR;
  p.BC = BC;
  p.nsteps = nsteps;
  p.mask9 = mask9;
  p.noff = noff;
  p.offcodes = offcodes;
  p.moore = moore;
  p.rate = rate;
  p.keep = keep;
  p.ca = ca;
  p.cb = cb;
  p.bf16 = bf16;
  p.ca16 = mm::bf16_bits(ca16);
  p.cb16 = mm::bf16_bits(cb16);
  return p;
}

}  // namespace

extern "C" {

// bf16, ca16, cb16: the bf16 interior math on the closed tiles and its
// constants (exactly bf16 values).
int mm_pipeline_stencil_f32(const void* in, void* out, int B, int H, int W,
                            int BR, int BC, float rate, float keep, float ca,
                            float cb, int nsteps, int mask9, int noff,
                            int offcodes, int moore, int bf16, float ca16,
                            float cb16, void* stream) {
  return launch<float>(in, out, B,
                       make_params(H, W, BR, BC, rate, keep, ca, cb, nsteps,
                                   mask9, noff, offcodes, moore, bf16, ca16,
                                   cb16),
                       stream);
}

int mm_pipeline_stencil_bf16(const void* in, void* out, int B, int H, int W,
                             int BR, int BC, float rate, float keep, float ca,
                             float cb, int nsteps, int mask9, int noff,
                             int offcodes, int moore, int bf16, float ca16,
                             float cb16, void* stream) {
  return launch<__nv_bfloat16>(
      in, out, B,
      make_params(H, W, BR, BC, rate, keep, ca, cb, nsteps, mask9, noff,
                  offcodes, moore, bf16, ca16, cb16),
      stream);
}

// The window rows a call of these steps and neighbourhood uses.
int mm_pipeline_rows(int nsteps, int offcodes, int moore) {
  Params p{};
  p.nsteps = nsteps;
  p.offcodes = offcodes;
  p.moore = moore;
  return rows_for(p);
}

// The geometry launch() gives a call on one lane of [H, W] in (BR, BC) TPU
// tiles (ops/pipeline_stencil.py::kernel_plan; 10 ints): out[0] whether it
// takes the two launches; out[1] the near (or only) launch's window rows,
// out[2] its blocks a lane; out[3] the paired launch's rows, out[4] its
// tiles a lane (0: not launched), out[5..8] the rectangle (rows [r0, r1),
// columns [c0, c1)); out[9] the near launch's TPU tiles a lane. It launches
// nothing: the card tests and chip_smoke.py hold the wrapper's mirrors to
// it.
int mm_pipeline_plan(int H, int W, int BR, int BC, int nsteps, int mask9,
                     int noff, int offcodes, int moore, int bf16, int* out) {
  const Params p = make_params(H, W, BR, BC, 0.f, 0.f, 0.f, 0.f, nsteps,
                               mask9, noff, offcodes, moore, bf16, 0.f, 0.f);
  if (!valid(p, 1) || out == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int k = 0; k < 10; ++k) out[k] = 0;
  if (!(bf16 && row_major_moore(p))) {
    out[1] = rows_for(p);
    out[2] = windows_of(p, out[1]).tiles;
    return 0;
  }
  const Closed q = closed_of(p);
  NearTiles nt;
  const int tiles = near_tiles(p, q, nt);
  const Windows wn = windows_of(p, rows_for(p));
  out[0] = 1;
  out[1] = wn.rows;
  out[2] = tiles * wn.wr * wn.wc;
  out[3] = paired_rows(p);
  if (!q.empty()) {
    const mm::RegionTiling tl = paired_tiling(p, q, out[3], 0);
    out[4] = tl.tiles;
    out[5] = tl.r0;
    out[6] = tl.r1;
    out[7] = tl.c0;
    out[8] = tl.c1;
  }
  out[9] = tiles;
  return 0;
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
