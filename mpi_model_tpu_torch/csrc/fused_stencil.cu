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

#include <cstdint>

#include "stencil_common.cuh"

namespace {

// A block is (32, NWARPS) threads, warp = threadIdx.y, as the shared-memory
// helpers of stencil_common.cuh stride; its window is WIN_W columns (one a
// thread) by ROWS rows (in registers): 48 or 64, by rows_for.
constexpr int NWARPS = mm::kThreadsY;
constexpr int WIN_W = 32 * NWARPS;
constexpr int MAX_STEPS = 16;
constexpr int STRIP_LEN = 128;  // an exact piece's length along its strip
constexpr int EDGE_SLOTS = 2 * (NWARPS + 2);    // warp -1 .. NWARPS, 2 sides
// warp-edge exchange floats: two step parities
template <int ROWS>
constexpr int kExchFloats = 2 * EDGE_SLOTS * ROWS;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  int nsteps;
  int mask9, noff, offcodes;  // neighbourhood: bitmask, ordered codes
  int moore;                  // the closed form's separable Moore sum
  int vec;                    // rows 16-byte aligned: cp.async windows
  float rate, keep;           // the exact path's rate and f32(1 - rate)
  float ca, cb;               // the closed form's f32 constants
};

// Elements of T in one 16-byte copy.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Staging row pitch (elements of T): the window and its alignment slack.
template <typename T>
constexpr int kStagePitch = WIN_W + kVec<T>;

template <typename T, int ROWS>
constexpr int stage_bytes() {
  return ROWS * kStagePitch<T> * static_cast<int>(sizeof(T));
}

// One exact piece's window, (STRIP_LEN + 2n) x (n + 1 + 2n) f32: the
// exact path's two buffers take twice that.
__host__ __device__ constexpr int piece_floats(int n) {
  return (STRIP_LEN + 2 * n) * (3 * n + 1);
}

template <typename T, int ROWS>
int smem_of(int n) {
  const int exact = 2 * piece_floats(n) * static_cast<int>(sizeof(float));
  const int work = stage_bytes<T, ROWS>() > exact ? stage_bytes<T, ROWS>()
                                                  : exact;
  return kExchFloats<ROWS> * static_cast<int>(sizeof(float)) + work;
}

__device__ __forceinline__ void cp_async16(void* smem_dst,
                                           const void* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a + b rounded to nearest, as an instruction the compiler keeps: pass 1's
// bands must not be reused in pass 2 across the barrier, which would hold
// ROWS more values live and spill the window.
__device__ __forceinline__ float add_kept(float a, float b) {
  float r;
  asm volatile("add.rn.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// A cell's distance to the global grid's edge.
__device__ __forceinline__ int edge_distance(int R, int C, int H, int W) {
  return min(min(R, H - 1 - R), min(C, W - 1 - C));
}

// The tiling of one call: tiles of th x tw output cells over the [h, w]
// array the kernel writes, whose global origin is (R0, C0) in an [H, W]
// grid.
struct Tiling {
  int rows, n, th, tw, tiles_c, tiles;  // window rows, steps, tile
  int h, w, R0, C0, H, W;

  __device__ __forceinline__ int row_of(int t) const {
    return (t / tiles_c) * th;
  }
  __device__ __forceinline__ int col_of(int t) const {
    return (t % tiles_c) * tw;
  }
  // tile t lies whole in the array and every output cell of it has d > n
  // (uniform over the block)
  __device__ __forceinline__ bool interior(int t) const {
    const int r = R0 + row_of(t);
    const int c = C0 + col_of(t);
    return row_of(t) + th <= h && col_of(t) + tw <= w && r >= n + 1 &&
           r + th <= H - 1 - n && c >= n + 1 && c + tw <= W - 1 - n;
  }
  // tile t's window lies inside the array: its rows may be copied
  __device__ __forceinline__ bool inside(int t) const {
    const int r0 = row_of(t) - n;
    const int c0 = col_of(t) - n;
    return r0 >= 0 && c0 >= 0 && r0 + rows <= h && c0 + WIN_W <= w;
  }
};

// Start the cp.async copies of tile t's window (an aligned superset of its
// columns) into `stage`; `base` is the array's [0, 0], `pitch` its row
// pitch in elements, a multiple of kVec<T>, and the array 16-byte aligned.
template <int ROWS, typename T>
__device__ __forceinline__ void fetch_window(const T* __restrict__ base,
                                             int pitch, const Tiling& tl,
                                             int t, T* stage) {
  constexpr int V = kVec<T>;
  const int r0 = tl.row_of(t) - tl.n;
  const int c0 = tl.col_of(t) - tl.n;
  const int a0 = c0 & ~(V - 1);
  const int chunks = (c0 + WIN_W - a0 + V - 1) / V;  // per row
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int k = tid; k < ROWS * chunks; k += 32 * NWARPS) {
    const int i = k / chunks;
    const int q = k - i * chunks;
    cp_async16(stage + i * kStagePitch<T> + q * V,
               base + static_cast<size_t>(r0 + i) * pitch + a0 + q * V);
  }
  cp_async_commit();
}

// The array a source's interior windows are copied from (K1: the grid;
// K2: the shard).
template <typename T>
__device__ __forceinline__ const T* array_of(const mm::DenseSource<T>& s) {
  return s.in;
}
template <typename T>
__device__ __forceinline__ const T* array_of(const mm::HaloSource<T>& s) {
  return s.shard;
}

// Component q of a float4.
__device__ __forceinline__ float part(const float4& e, int q) {
  return q == 0 ? e.x : (q == 1 ? e.y : (q == 2 ? e.z : e.w));
}

// The closed form's n steps on the window held in registers (v[i] = window
// row i of this thread's column), then the tile's output written: every
// cell of it when `whole`, else only its cells inside the array with
// d > n. `ex` is the warp-edge exchange: [parity][slot][ROWS], slot
// 2 * (warp + 1) + side (side 0: the warp's lane 0, side 1: its lane 31),
// read and written four rows at a time; slots of warps -1 and NWARPS stay
// zero.
template <int ROWS, bool MOORE, typename T>
__device__ __forceinline__ void closed_tile(float (&v)[ROWS], float* ex,
                                            const Params& p,
                                            const Tiling& tl, int t,
                                            bool whole, T* __restrict__ out) {
  static_assert(ROWS % 4 == 0, "edge rows move four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int n = p.nsteps;
  // where this warp's edge lanes publish, and where they read their
  // outer neighbour's column
  const int own = 2 * (wp + 1) + (lane == 31 ? 1 : 0);
  const int nbr = lane == 0 ? 2 * wp + 1 : 2 * (wp + 2);
  const bool edge_lane = lane == 0 || lane == 31;
  int drow[8], dcol[8];  // each offset's row and column in the 3 x 3
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int b = (p.offcodes >> (4 * o)) & 0xF;  // (dx + 1) * 3 + (dy + 1)
    drow[o] = b / 3;
    dcol[o] = b % 3;
  }

  for (int s = 0; s < n; ++s) {
    float* eb = ex + (s & 1) * EDGE_SLOTS * ROWS;
    // pass 1: the edge lanes publish their column's band (Moore) or values
    float4 x4;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      float x;
      if (MOORE) {
        const float up = i > 0 ? v[i - 1] : 0.f;
        const float dn = i + 1 < ROWS ? v[i + 1] : 0.f;
        x = add_kept(add_kept(up, v[i]), dn);
      } else {
        x = v[i];
      }
      if (i % 4 == 0) x4.x = x;
      if (i % 4 == 1) x4.y = x;
      if (i % 4 == 2) x4.z = x;
      if (i % 4 == 3) {
        x4.w = x;
        if (edge_lane) {
          *reinterpret_cast<float4*>(eb + own * ROWS + i - 3) = x4;
        }
      }
    }
    __syncthreads();
    // the window as pass 2 sees it: nothing of it is computed before the
    // barrier (pass 1's bands stay pass 1's)
#pragma unroll
    for (int i = 0; i < ROWS; ++i) asm volatile("" : "+f"(v[i]));
    const float* nb = eb + nbr * ROWS;
    float4 e4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (MOORE) {
      float prev = 0.f;  // the old value of row i - 1
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i % 4 == 0 && edge_lane) {
          e4 = *reinterpret_cast<const float4*>(nb + i);
        }
        const float dn = i + 1 < ROWS ? v[i + 1] : 0.f;
        const float b = __fadd_rn(__fadd_rn(prev, v[i]), dn);
        float bl = __shfl_up_sync(FULL, b, 1);
        float br = __shfl_down_sync(FULL, b, 1);
        if (lane == 0) bl = part(e4, i % 4);
        if (lane == 31) br = part(e4, i % 4);
        const float nine = __fadd_rn(__fadd_rn(bl, b), br);
        prev = v[i];
        v[i] = __fadd_rn(__fmul_rn(v[i], p.ca), __fmul_rn(nine, p.cb));
      }
    } else {
      // rolling 3 x 3 neighbourhood: rows i-1, i, i+1 of the columns to
      // the left (l), own (c) and right (r), old values
      if (edge_lane) e4 = *reinterpret_cast<const float4*>(nb);
      float lm = 0.f, cm = 0.f, rm = 0.f;
      float l0 = __shfl_up_sync(FULL, v[0], 1);
      float r0 = __shfl_down_sync(FULL, v[0], 1);
      if (lane == 0) l0 = e4.x;
      if (lane == 31) r0 = e4.x;
      float c0 = v[0];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        float lp = 0.f, cp = 0.f, rp = 0.f;
        if (i + 1 < ROWS) {
          const int k = i + 1;
          if (k % 4 == 0 && edge_lane) {
            e4 = *reinterpret_cast<const float4*>(nb + k);
          }
          cp = v[k];
          lp = __shfl_up_sync(FULL, cp, 1);
          rp = __shfl_down_sync(FULL, cp, 1);
          if (lane == 0) lp = part(e4, k % 4);
          if (lane == 31) rp = part(e4, k % 4);
        }
        float g = 0.f;
#pragma unroll
        for (int o = 0; o < 8; ++o) {
          if (o < p.noff) {
            const int dc = dcol[o];
            const float up = dc == 0 ? lm : (dc == 1 ? cm : rm);
            const float mid = dc == 0 ? l0 : (dc == 1 ? c0 : r0);
            const float dn = dc == 0 ? lp : (dc == 1 ? cp : rp);
            const int dr = drow[o];
            g = __fadd_rn(g, dr == 0 ? up : (dr == 1 ? mid : dn));
          }
        }
        v[i] = __fadd_rn(__fmul_rn(c0, p.ca), __fmul_rn(g, p.cb));
        lm = l0; cm = c0; rm = r0;
        l0 = lp; c0 = cp; r0 = rp;
      }
    }
  }

  // rows [n, ROWS - n) of columns [n, WIN_W - n) are the tile
  const int j = wp * 32 + lane;
  const int r = tl.row_of(t) - n;  // the window's first row and column
  const int c = tl.col_of(t) + j - n;
  if (j < n || j >= WIN_W - n || c >= tl.w) return;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i >= n && i < ROWS - n) {
      if (whole || (r + i < tl.h &&
                    edge_distance(tl.R0 + r + i, tl.C0 + c, tl.H, tl.W) >
                        n)) {
        mm::from_f32(out + static_cast<size_t>(r + i) * tl.w + c, v[i]);
      }
    }
  }
}

// The exact path for an edge tile's cells with d <= n: the tile's part of
// each of the grid's four border strips (n + 1 rows or columns deep), in
// pieces of at most STRIP_LEN along the strip, each on the shared-memory
// form (iterate_exact_f32) from its own window load. A corner cell lies
// in two strips and is computed twice, to the same bits. `a` and `b` are
// two piece_floats(n) buffers. Ends with a __syncthreads() when it
// computes anything.
template <typename T, typename Src>
__device__ __forceinline__ void exact_cells(const Src& src,
                                            T* __restrict__ out,
                                            const Params& p,
                                            const Tiling& tl, int t,
                                            float* a, float* b) {
  const int n = p.nsteps;
  // the tile in global coordinates, [r0, r1) x [c0, c1)
  const int r0 = tl.R0 + tl.row_of(t);
  const int c0 = tl.C0 + tl.col_of(t);
  const int r1 = tl.R0 + min(tl.row_of(t) + tl.th, tl.h);
  const int c1 = tl.C0 + min(tl.col_of(t) + tl.tw, tl.w);
  for (int strip = 0; strip < 4; ++strip) {
    int sr0 = r0, sr1 = r1, sc0 = c0, sc1 = c1;
    if (strip == 0) sr1 = min(sr1, n + 1);          // top
    if (strip == 1) sr0 = max(sr0, tl.H - 1 - n);   // bottom
    if (strip == 2) sc1 = min(sc1, n + 1);          // left
    if (strip == 3) sc0 = max(sc0, tl.W - 1 - n);   // right
    if (sr0 >= sr1 || sc0 >= sc1) continue;
    const bool across_rows = strip < 2;  // the strip runs along the rows
    const int len = across_rows ? sc1 - sc0 : sr1 - sr0;
    for (int k = 0; k < len; k += STRIP_LEN) {
      const int pr0 = across_rows ? sr0 : sr0 + k;
      const int pc0 = across_rows ? sc0 + k : sc0;
      const int eh = across_rows ? sr1 - sr0 : min(STRIP_LEN, len - k);
      const int ew = across_rows ? min(STRIP_LEN, len - k) : sc1 - sc0;
      const int WH = eh + 2 * n;
      const int WW = ew + 2 * n;
      mm::load_window_f32(src, a, pr0 - tl.R0 - n, pc0 - tl.C0 - n, WH, WW);
      __syncthreads();
      mm::iterate_exact_f32(a, b, pr0 - n, pc0 - n, WH, WW, tl.H, tl.W,
                            p.rate, p.keep, n, p.mask9, p.noff, p.offcodes);
      for (int i = threadIdx.y; i < eh; i += mm::kThreadsY) {
        for (int j = threadIdx.x; j < ew; j += mm::kThreadsX) {
          mm::from_f32(out + static_cast<size_t>(pr0 - tl.R0 + i) * tl.w +
                           (pc0 - tl.C0 + j),
                       a[(i + n) * WW + (j + n)]);
        }
      }
      __syncthreads();
    }
  }
}

// The body of K1 and K2: block t steps tile t of `tl`.
template <int ROWS, bool MOORE, typename T, typename Src>
__device__ __forceinline__ void fused_body(const Src& src,
                                           T* __restrict__ out,
                                           const Params& p,
                                           const Tiling& tl) {
  extern __shared__ __align__(16) float smem[];
  float* ex = smem;                          // warp-edge exchange
  float* work = smem + kExchFloats<ROWS>;    // staging, or exact buffers
  T* stage = reinterpret_cast<T*>(work);
  const int t = blockIdx.x;
  const bool whole = tl.interior(t);
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int c0 = tl.col_of(t) - p.nsteps;
  int skew = 0;  // the window's first column in the staging rows
  if (p.vec && whole && tl.inside(t)) {
    fetch_window<ROWS>(array_of(src), tl.w, tl, t, stage);
    skew = c0 - (c0 & ~(kVec<T> - 1));
  } else {
    // an edge tile, a window at the array's edge (K2: it reads the ring) or
    // of unaligned rows, staged element by element through the source
    // (zero off the grid): this thread's column, eight rows' loads in
    // flight at a time
    const int r0 = tl.row_of(t) - p.nsteps;
    static_assert(ROWS % 8 == 0, "rows are staged eight at a time");
    for (int i0 = 0; i0 < ROWS; i0 += 8) {
      float x[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) x[q] = src.at(r0 + i0 + q, c0 + j);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        mm::from_f32(stage + (i0 + q) * kStagePitch<T> + j, x[q]);
      }
    }
  }
  for (int k = j; k < kExchFloats<ROWS>; k += 32 * NWARPS) ex[k] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  float v[ROWS];
  const T* col = stage + skew + j;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) v[i] = mm::to_f32(col[i * kStagePitch<T>]);
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

bool valid_steps(const Params& p) {
  return p.nsteps >= 1 && p.nsteps <= MAX_STEPS &&
         (p.mask9 & ~0x1EF) == 0 && p.mask9 != 0 &&
         p.noff == __builtin_popcount(p.mask9);
}

Tiling make_tiling(int rows, int n, int h, int w, int R0, int C0, int H,
                   int W) {
  Tiling tl;
  tl.rows = rows;
  tl.n = n;
  tl.th = rows - 2 * n;
  tl.tw = WIN_W - 2 * n;
  tl.tiles_c = (w + tl.tw - 1) / tl.tw;
  tl.tiles = ((h + tl.th - 1) / tl.th) * tl.tiles_c;
  tl.h = h;
  tl.w = w;
  tl.R0 = R0;
  tl.C0 = C0;
  tl.H = H;
  tl.W = W;
  return tl;
}

// Rows of `pitch` elements from `ptr` can be copied 16 bytes at a time.
template <typename T>
int rows_aligned(const void* ptr, int pitch) {
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
          (static_cast<long long>(pitch) * sizeof(T)) % 16 == 0)
             ? 1
             : 0;
}

// Launch one kernel instance, a block a tile; `limit` is the instance's
// own record of its shared-memory limit.
template <typename K, typename... Args>
cudaError_t launch_tiles(K kernel, int smem, int tiles, int* limit,
                         void* stream, Args... args) {
  if (smem > *limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *limit = smem;
  }
  kernel<<<tiles, dim3(32, NWARPS), smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

template <int ROWS, bool MOORE, typename T>
int launch(const void* in, void* out, int H, int W, Params p, void* stream) {
  p.vec = rows_aligned<T>(in, W);
  const Tiling tl = make_tiling(ROWS, p.nsteps, H, W, 0, 0, H, W);
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  return static_cast<int>(launch_tiles(
      fused_stencil_kernel<ROWS, MOORE, T>, smem_of<T, ROWS>(p.nsteps),
      tl.tiles, &limit, stream, static_cast<const T*>(in),
      static_cast<T*>(out), p, tl));
}

// Host check of a halo launch: a ring at least nsteps deep, the shard
// inside the global grid.
bool valid_halo(const mm::HaloArgs& a, int nsteps) {
  return a.h >= 0 && a.w >= 0 && a.d >= nsteps && a.d <= MAX_STEPS &&
         a.R0 >= 0 && a.C0 >= 0 && a.R0 + a.h <= a.H && a.C0 + a.w <= a.W;
}

template <int ROWS, bool MOORE, typename T>
int launch_halo(const mm::HaloArgs* args, void* out, Params p,
                void* stream) {
  const mm::HaloSource<T> src(*args);
  p.vec = rows_aligned<T>(args->shard, args->w);
  const Tiling tl = make_tiling(ROWS, p.nsteps, src.h, src.w, src.R0, src.C0,
                                src.H, src.W);
  static int limit = DEFAULT_SMEM_LIMIT;  // per template instance
  return static_cast<int>(launch_tiles(
      fused_stencil_halo_kernel<ROWS, MOORE, T>, smem_of<T, ROWS>(p.nsteps),
      tl.tiles, &limit, stream, src, static_cast<T*>(out), p, tl));
}

Params make_params(float rate, float keep, float ca, float cb, int nsteps,
                   int mask9, int noff, int offcodes, int moore) {
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

template <typename T>
int dense(const void* in, void* out, int H, int W, const Params& p,
          void* stream) {
  if (!valid_steps(p) || H < 0 || W < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || W == 0) return 0;
  switch (rows_for(p)) {
    case 64: return launch<64, true, T>(in, out, H, W, p, stream);
    default:
      return p.moore ? launch<48, true, T>(in, out, H, W, p, stream)
                     : launch<48, false, T>(in, out, H, W, p, stream);
  }
}

template <typename T>
int halo(const void* args, void* out, const Params& p, void* stream) {
  const auto* a = static_cast<const mm::HaloArgs*>(args);
  if (a == nullptr || !valid_steps(p) || !valid_halo(*a, p.nsteps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->h == 0 || a->w == 0) return 0;
  switch (rows_for(p)) {
    case 64: return launch_halo<64, true, T>(a, out, p, stream);
    default:
      return p.moore ? launch_halo<48, true, T>(a, out, p, stream)
                     : launch_halo<48, false, T>(a, out, p, stream);
  }
}

}  // namespace

extern "C" {

int mm_fused_stencil_f32(const void* in, void* out, int H, int W, float rate,
                         float keep, float ca, float cb, int nsteps,
                         int mask9, int noff, int offcodes, int moore,
                         void* stream) {
  return dense<float>(in, out, H, W,
                      make_params(rate, keep, ca, cb, nsteps, mask9, noff,
                                  offcodes, moore),
                      stream);
}

int mm_fused_stencil_bf16(const void* in, void* out, int H, int W, float rate,
                          float keep, float ca, float cb, int nsteps,
                          int mask9, int noff, int offcodes, int moore,
                          void* stream) {
  return dense<__nv_bfloat16>(in, out, H, W,
                              make_params(rate, keep, ca, cb, nsteps, mask9,
                                          noff, offcodes, moore),
                              stream);
}

int mm_fused_stencil_halo_f32(const void* args, void* out, float rate,
                              float keep, float ca, float cb, int nsteps,
                              int mask9, int noff, int offcodes, int moore,
                              void* stream) {
  return halo<float>(args, out,
                     make_params(rate, keep, ca, cb, nsteps, mask9, noff,
                                 offcodes, moore),
                     stream);
}

int mm_fused_stencil_halo_bf16(const void* args, void* out, float rate,
                               float keep, float ca, float cb, int nsteps,
                               int mask9, int noff, int offcodes, int moore,
                               void* stream) {
  return halo<__nv_bfloat16>(args, out,
                             make_params(rate, keep, ca, cb, nsteps, mask9,
                                         noff, offcodes, moore),
                             stream);
}

int mm_halo_args_size() { return static_cast<int>(sizeof(mm::HaloArgs)); }

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mm_max_steps() { return MAX_STEPS; }

}  // extern "C"
