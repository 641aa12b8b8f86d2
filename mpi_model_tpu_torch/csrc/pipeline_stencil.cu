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
// compute in bf16, as the TPU kernel's do (pallas_stencil.py:656):
// mm::closed_walk_bf16 (Moore on paired bf16, add.rn.bf16x2 / mul.rn.bf16x2;
// other neighbourhoods the f32 walk with every operation rounded), the
// window rounded to bf16 on the way in, the constants rounded to bf16 on
// the host. Near tiles stay f32, as the TPU kernel's do. A runtime flag,
// not a template: the near branch, the long one to compile, is shared.
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
//     steps (rows_for; k56_variants.py measures the choice).
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include "exact_walk.cuh"

namespace {

constexpr int kWarps = mm::kThreadsY;
constexpr int kWinW = mm::kWinW;
constexpr int MAX_STEPS = 8;

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

// The window rows of a call (a compile-time constant of each instance).
int rows_for(const Params& p) {
  return p.moore && static_cast<unsigned>(p.offcodes) ==
                        mm_exact::kMooreCodes && p.nsteps > 2
             ? 64
             : 48;
}

Windows windows_of(const Params& p) {
  Windows w;
  w.rows = rows_for(p);
  w.oh = w.rows - 2 * p.nsteps;
  w.ow = kWinW - 2 * p.nsteps;
  w.wr = (p.BR + w.oh - 1) / w.oh;
  w.wc = (p.BC + w.ow - 1) / w.ow;
  w.tiles_c = p.W / p.BC * w.wc;
  w.tiles = p.H / p.BR * w.wr * w.tiles_c;
  return w;
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

template <typename T, int ROWS, bool MOORE, unsigned CODES, int NOFF>
int launch_rows(const void* in, void* out, int B, const Params& p,
                void* stream) {
  const Windows wn = windows_of(p);
  if (wn.rows != ROWS) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = pipeline_stencil_kernel<T, ROWS, MOORE, CODES, NOFF>;
  // the walks' exchange, or the border strips' two piece buffers (at most
  // 28.8 KB at 8 steps: below the default limit)
  const int pieces = 2 * mm::piece_floats(p.nsteps);
  const int smem = (smem_floats<ROWS>() > pieces ? smem_floats<ROWS>()
                                                 : pieces) *
                   static_cast<int>(sizeof(float));
  kernel<<<dim3(wn.tiles, B), dim3(32, kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(static_cast<const T*>(in),
                                                static_cast<T*>(out), p, wn);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* in, void* out, int B, const Params& p, void* stream) {
  if (p.nsteps < 1 || p.nsteps > MAX_STEPS || (p.mask9 & ~0x1EF) != 0 ||
      p.mask9 == 0 || p.noff != __builtin_popcount(p.mask9) || B < 0 ||
      p.H < 0 || p.W < 0 || p.BR < 1 || p.BC < 1 || p.BR % 16 != 0 ||
      p.BC % 128 != 0 || p.H % p.BR != 0 || p.W % p.BC != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || p.H == 0 || p.W == 0) return 0;
  const bool row_major =
      static_cast<unsigned>(p.offcodes) == mm_exact::kMooreCodes;
  if (p.moore && row_major) {
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

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
