// Device helpers shared by the port's stencil kernels (K1 and K2 in
// fused_stencil.cu, K3 and K3-halo in composed_stencil.cu, K4 and K4-halo
// in field_stencil.cuh, K5 in pipeline_stencil.cu, K6/K7 in fused_active.cu;
// K5's and K6's exact register walk is exact_walk.cuh).
//
// One copy of: the f32 storage conversions, the grid test, the in-bounds
// neighbor count of a global cell, the window sources (a whole grid, or one
// shard and its exchanged ghost ring), the halo-window load, and the exact
// iterated step of K1, K3 and K5's border strips (the form the TPU kernels
// use near the global edge). The neighborhood is a 3x3 bitmask: bit (dx+1)*3 + (dy+1)
// set for each offset. Loops stride over a (kThreadsX, kThreadsY) block.
//
// Then the register column walk that K1/K2 and K3's vpu form share (the
// last section): cp.async window staging, the tiling, one walk step, and
// the exact strips of an edge tile. K4's walk (field_stencil.cuh) takes the
// staging and the tiling.
//
// And the bf16 interior math (compute_dtype=bfloat16, the TPU kernels'
// knob): the rectangle of cells it covers, rb() (an f32 value rounded to
// bf16: an f32 operation on bf16 values rounded once is the bf16
// operation, f32 carrying more than 2 * 8 + 2 bits), a rounded window
// source, the walk step with every add rounded (walk_step<..., true>), the
// Moore walk step on paired bf16 (walk_step_bf2: two rows a register,
// add.rn.bf16x2 / mul.rn.bf16x2, each rounded once and never contracted;
// its twin paired_step keeps pass 1's bands), and the geometry of the two
// launches K1/K2 and K3 vpu split such a call into (RegionTiling, Bands,
// split_of, bands_of).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace mm {

// One shard of a sharded grid and its depth-d ghost ring, as the Python
// wrappers pass it (ctypes mirrors it field for field): the ring pieces in
// the order n [d, w], s [d, w], w [h, d], e [h, d], nw, ne, sw, se [d, d],
// each a contiguous array; the shard's global origin (R0, C0) and the
// global grid's (H, W).
struct HaloArgs {
  const void* shard;
  const void* ring[8];
  int h, w, d;
  int R0, C0;
  int H, W;
  int pad_;
};

enum RingPiece : int { kN = 0, kS, kWest, kEast, kNW, kNE, kSW, kSE };

constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// An f32 value rounded to the nearest bf16 value (ties to even), in f32.
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The global rows [r0, r1) and columns [c0, c1) of the cells the bf16
// interior math takes (the TPU kernel's tiles that are not near the edge,
// ops/fused_stencil.py::bf16_rect); empty when r0 >= r1.
struct Rect {
  int r0, r1, c0, c1;
};

__host__ __device__ __forceinline__ bool in_rect(const Rect& q, int R,
                                                 int C) {
  return R >= q.r0 && R < q.r1 && C >= q.c0 && C < q.c1;
}

// How the global cells [r0, r1) x [c0, c1) meet the rectangle: kNone (no
// cell in it), kAll (every cell), kSome.
enum RectCover : int { kNone = 0, kAll = 1, kSome = 2 };
__host__ __device__ __forceinline__ int rect_cover(const Rect& q, int r0,
                                                   int r1, int c0, int c1) {
  const int ir0 = max(r0, q.r0), ir1 = min(r1, q.r1);
  const int ic0 = max(c0, q.c0), ic1 = min(c1, q.c1);
  if (ir0 >= ir1 || ic0 >= ic1) return kNone;
  return ir0 == r0 && ir1 == r1 && ic0 == c0 && ic1 == c1 ? kAll : kSome;
}

__device__ __forceinline__ bool on_grid(int r, int c, int H, int W) {
  return r >= 0 && r < H && c >= 0 && c < W;
}

// In-bounds neighbor count of global cell (r, c) for the offset bitmask,
// clamped to >= 1 (an off-grid cell holds 0, so its share is 0 anyway).
__device__ __forceinline__ int neighbor_count_int(int r, int c, int H, int W,
                                                  int mask9) {
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    if ((mask9 >> b) & 1) {
      cnt += on_grid(r + b / 3 - 1, c + b % 3 - 1, H, W) ? 1 : 0;
    }
  }
  return cnt > 0 ? cnt : 1;
}

__device__ __forceinline__ float neighbor_count(int r, int c, int H, int W,
                                                int mask9) {
  return static_cast<float>(neighbor_count_int(r, c, H, W, mask9));
}

// Window sources. A source gives the f32 value of the cell at local (r, c)
// of the array a kernel writes (0 off the grid: the non-periodic boundary),
// that array's global origin (row0, col0) and the global grid's (gH, gW),
// against which the grid test, the neighbour count and the near-edge tests
// are made. A kernel body takes its source as a template parameter, so the
// dense kernels compile as they did before sources existed.

// A whole grid: local is global.
template <typename T>
struct DenseSource {
  const T* in;
  int H, W;
  __device__ __forceinline__ int row0() const { return 0; }
  __device__ __forceinline__ int col0() const { return 0; }
  __device__ __forceinline__ int gH() const { return H; }
  __device__ __forceinline__ int gW() const { return W; }
  __device__ __forceinline__ float at(int r, int c) const {
    return on_grid(r, c, H, W) ? to_f32(in[static_cast<size_t>(r) * W + c])
                               : 0.f;
  }
};

// One [h, w] shard at global (R0, C0) and its depth-d ghost ring (HaloArgs).
// A cell inside the shard reads the shard; a cell within d of it reads the
// ring piece its position falls in; any other cell, and every cell off the
// global grid (whatever its ring piece holds), reads 0. With nsteps <= d no
// output of the kernel depends on a cell beyond the ring.
template <typename T>
struct HaloSource {
  const T* shard;
  const T* ring[8];
  int h, w, d, R0, C0, H, W;

  __host__ __device__ explicit HaloSource(const HaloArgs& a)
      : shard(static_cast<const T*>(a.shard)), h(a.h), w(a.w), d(a.d),
        R0(a.R0), C0(a.C0), H(a.H), W(a.W) {
    for (int p = 0; p < 8; ++p) ring[p] = static_cast<const T*>(a.ring[p]);
  }
  __device__ __forceinline__ int row0() const { return R0; }
  __device__ __forceinline__ int col0() const { return C0; }
  __device__ __forceinline__ int gH() const { return H; }
  __device__ __forceinline__ int gW() const { return W; }
  __device__ __forceinline__ float at(int r, int c) const {
    if (!on_grid(R0 + r, C0 + c, H, W) || r < -d || r >= h + d || c < -d ||
        c >= w + d) {
      return 0.f;
    }
    size_t k;
    int p;
    if (r < 0 || r >= h) {
      const int rr = r < 0 ? r + d : r - h;  // row within the piece
      const bool north = r < 0;
      if (c < 0) {
        p = north ? kNW : kSW;
        k = static_cast<size_t>(rr) * d + (c + d);
      } else if (c < w) {
        p = north ? kN : kS;
        k = static_cast<size_t>(rr) * w + c;
      } else {
        p = north ? kNE : kSE;
        k = static_cast<size_t>(rr) * d + (c - w);
      }
    } else if (c < 0) {
      p = kWest;
      k = static_cast<size_t>(r) * d + (c + d);
    } else if (c < w) {
      return to_f32(shard[static_cast<size_t>(r) * w + c]);
    } else {
      p = kEast;
      k = static_cast<size_t>(r) * d + (c - w);
    }
    // a switch on the piece keeps the pointer table in parameter space
    const T* src;
    switch (p) {
      case kN: src = ring[kN]; break;
      case kS: src = ring[kS]; break;
      case kWest: src = ring[kWest]; break;
      case kEast: src = ring[kEast]; break;
      case kNW: src = ring[kNW]; break;
      case kNE: src = ring[kNE]; break;
      case kSW: src = ring[kSW]; break;
      default: src = ring[kSE]; break;
    }
    return to_f32(src[k]);
  }
};

// A source whose values are rounded to bf16 (the window the TPU kernel's
// near tiles read under bf16 interior math, pallas_stencil.py:441).
template <class Src>
struct RoundedSource {
  Src s;
  __device__ __forceinline__ int row0() const { return s.row0(); }
  __device__ __forceinline__ int col0() const { return s.col0(); }
  __device__ __forceinline__ int gH() const { return s.gH(); }
  __device__ __forceinline__ int gW() const { return s.gW(); }
  __device__ __forceinline__ float at(int r, int c) const {
    return rb(s.at(r, c));
  }
};

// Load the [WH, WW] window whose [0, 0] is local cell (r0, c0) of `src`
// into `val` as f32; neighbouring threads read neighbouring columns of a
// (TX, TY) block.
template <int TX = kThreadsX, int TY = kThreadsY, typename Src>
__device__ __forceinline__ void load_window_f32(const Src& src, float* val,
                                                int r0, int c0, int WH,
                                                int WW) {
  for (int i = threadIdx.y; i < WH; i += TY) {
    const int r = r0 + i;
    for (int j = threadIdx.x; j < WW; j += TX) {
      val[i * WW + j] = src.at(r, c0 + j);
    }
  }
}

// A halo window that lies inside its shard (every block but those at the
// shard's edge) reads the shard directly, without the per-cell lookup:
// the same values, since the shard lies on the grid.
template <int TX = kThreadsX, int TY = kThreadsY, typename T>
__device__ __forceinline__ void load_window_f32(const HaloSource<T>& src,
                                                float* val, int r0, int c0,
                                                int WH, int WW) {
  if (r0 >= 0 && c0 >= 0 && r0 + WH <= src.h && c0 + WW <= src.w) {
    for (int i = threadIdx.y; i < WH; i += TY) {
      const T* row = src.shard + static_cast<size_t>(r0 + i) * src.w + c0;
      for (int j = threadIdx.x; j < WW; j += TX) {
        val[i * WW + j] = to_f32(row[j]);
      }
    }
    return;
  }
  for (int i = threadIdx.y; i < WH; i += TY) {
    const int r = r0 + i;
    for (int j = threadIdx.x; j < WW; j += TX) {
      val[i * WW + j] = src.at(r, c0 + j);
    }
  }
}

// Decode the ordered offset codes (4 bits each, bit index (dx+1)*3 +
// (dy+1)) into index deltas in a window of row pitch WW, once, so that the
// per-cell gather is an unrolled loop over registers.
__device__ __forceinline__ void window_deltas(int offcodes, int WW,
                                              int delta[8]) {
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int b = (offcodes >> (4 * o)) & 0xF;
    delta[o] = (b / 3 - 1) * WW + (b % 3 - 1);
  }
}

// 0 + p[delta[0]] + p[delta[1]] + ... over the first `noff` deltas, in
// order, each add rounded.
__device__ __forceinline__ float ordered_sum(const float* p, int noff,
                                             const int delta[8]) {
  float g = 0.f;
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    if (o < noff) g = __fadd_rn(g, p[delta[o]]);
  }
  return g;
}

// `nsteps` exact steps in f32 on the window in `val` (in place; `share` is
// scratch of the same [WH, WW] size). Step s updates the region
// [s + 1, WH - s - 1) x [s + 1, WW - s - 1), so after n steps the cells at
// least n from the window's edge are exact. Each cell sheds
// share = (rate * v) / cnt to each in-bounds neighbor and keeps v * keep:
// v' = v * keep + (0 + share[d0] + share[d1] + ...), the shares summed in
// the order of `offcodes` (4 bits an offset, bit index (dx+1)*3 + (dy+1)),
// every operation an explicitly rounded intrinsic, so no multiply-add is
// contracted whatever the build flags. Off-grid cells are re-zeroed each
// step. Ends with a __syncthreads().
__device__ __forceinline__ void iterate_exact_f32(float* val, float* share,
                                                  int r0, int c0, int WH,
                                                  int WW, int H, int W,
                                                  float rate, float keep,
                                                  int nsteps, int mask9,
                                                  int noff, int offcodes) {
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  int delta[8];
  window_deltas(offcodes, WW, delta);
  // A window off the grid's outer ring (uniform over the block): every cell
  // is on the grid with all `noff` neighbours, so the count needs no test.
  const bool inner = r0 >= 1 && r0 + WH <= H - 1 && c0 >= 1 &&
                     c0 + WW <= W - 1;
  const float full = static_cast<float>(noff);
  for (int s = 0; s < nsteps; ++s) {
    // Phase 1: shares on window rows/cols [s, WH - s).
    for (int i = s + ty; i < WH - s; i += kThreadsY) {
      const int r = r0 + i;
      for (int j = s + tx; j < WW - s; j += kThreadsX) {
        const float cnt =
            inner ? full : neighbor_count(r, c0 + j, H, W, mask9);
        share[i * WW + j] = __fdiv_rn(__fmul_rn(rate, val[i * WW + j]), cnt);
      }
    }
    __syncthreads();
    // Phase 2: update [s + 1, WH - s - 1). A cell's value is read and
    // written by its own thread only, so the update is in place in `val`.
    for (int i = s + 1 + ty; i < WH - s - 1; i += kThreadsY) {
      const int r = r0 + i;
      for (int j = s + 1 + tx; j < WW - s - 1; j += kThreadsX) {
        const float g = ordered_sum(share + i * WW + j, noff, delta);
        val[i * WW + j] =
            (inner || on_grid(r, c0 + j, H, W))
                ? __fadd_rn(__fmul_rn(val[i * WW + j], keep), g)
                : 0.f;
      }
    }
    __syncthreads();
  }
}


// -- the register column walk (K1/K2, K3/K3-halo vpu; K4 its staging) -------
//
// A block of kThreadsY warps holds a ROWS x kWinW window of the grid in
// registers, one window column a thread (warp = threadIdx.y, column = warp
// * 32 + lane). A step gives every row its neighbourhood sum: Moore the
// 3 x 3 box, band = (v[r-1] + v[r]) + v[r+1] down the column and
// (band[c-1] + band[c]) + band[c+1] across, the neighbouring columns' bands
// from the neighbouring lanes (__shfl_sync) and the warp's two edge
// columns' through one shared row a step; other neighbourhoods the
// neighbours summed in `offsets` order from 0. Rows and columns past the
// window read 0, so its outer ring is garbage that moves in a cell a step.

constexpr int kWinW = 32 * kThreadsY;  // window columns, one a thread
constexpr int kStripLen = 128;         // an exact piece's length
constexpr int kEdgeSlots = 2 * (kThreadsY + 2);  // warps -1 .. kThreadsY
// warp-edge exchange floats: [2 step parities][kEdgeSlots][ROWS]
template <int ROWS>
constexpr int kExchFloats = 2 * kEdgeSlots * ROWS;
constexpr unsigned kFull = 0xffffffffu;

// Elements of T in one 16-byte copy.
template <typename T>
constexpr int kVec = 16 / static_cast<int>(sizeof(T));

// Staging row pitch (elements of T): the window and its alignment slack.
template <typename T>
constexpr int kStagePitch = kWinW + kVec<T>;

template <typename T, int ROWS>
constexpr int stage_bytes() {
  return ROWS * kStagePitch<T> * static_cast<int>(sizeof(T));
}

// One exact piece's window, (kStripLen + 2n) x (n + 1 + 2n) f32: the
// exact path's two buffers take twice that.
__host__ __device__ constexpr int piece_floats(int n) {
  return (kStripLen + 2 * n) * (3 * n + 1);
}

// The parameters of one call's steps.
struct StepParams {
  int nsteps;
  int mask9, noff, offcodes;  // neighbourhood: bitmask, ordered codes
  int moore;                  // the closed form's separable Moore sum
  int vec;                    // rows 16-byte aligned: cp.async windows
  float rate, keep;           // the exact path's rate and f32(1 - rate)
  float ca, cb;               // K1's closed-form f32 constants
  unsigned ca16, cb16;        // the same rounded to bf16 (bits), for the
                              // bf16 interior math
};

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

// Component q of a float4.
__device__ __forceinline__ float part(const float4& e, int q) {
  return q == 0 ? e.x : (q == 1 ? e.y : (q == 2 ? e.z : e.w));
}

// The tiling of one call: tiles of th x tw output cells over the [h, w]
// array the kernel writes, whose global origin is (R0, C0) in an [H, W]
// grid. A tile's window starts rh rows above it and n columns left of it
// (K1: rh = n, the steps; K3: rh is its instance's row offset >= k).
struct Tiling {
  int rows, rh, n, th, tw, tiles_c, tiles;  // window rows, halos, tile
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
    const int r0 = row_of(t) - rh;
    const int c0 = col_of(t) - n;
    return r0 >= 0 && c0 >= 0 && r0 + rows <= h && c0 + kWinW <= w;
  }
};

inline Tiling make_tiling(int rows, int rh, int n, int h, int w, int R0,
                          int C0, int H, int W) {
  Tiling tl;
  tl.rows = rows;
  tl.rh = rh;
  tl.n = n;
  tl.th = rows - 2 * rh;
  tl.tw = kWinW - 2 * n;
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

// Start the cp.async copies of tile t's window (an aligned superset of its
// columns) into `stage`; `base` is the array's [0, 0], `pitch` its row
// pitch in elements, a multiple of kVec<T>, and the array 16-byte aligned.
// TL: Tiling, or a tiling of one region of the array with the same members
// (K1/K2's bf16 interior math).
template <int ROWS, typename T, typename TL>
__device__ __forceinline__ void fetch_window(const T* __restrict__ base,
                                             int pitch, const TL& tl,
                                             int t, T* stage) {
  constexpr int V = kVec<T>;
  const int r0 = tl.row_of(t) - tl.rh;
  const int c0 = tl.col_of(t) - tl.n;
  const int a0 = c0 & ~(V - 1);
  const int chunks = (c0 + kWinW - a0 + V - 1) / V;  // per row
  const int tid = threadIdx.y * 32 + threadIdx.x;
  for (int k = tid; k < ROWS * chunks; k += kWinW) {
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
__device__ __forceinline__ const T* array_of(const DenseSource<T>& s) {
  return s.in;
}
template <typename T>
__device__ __forceinline__ const T* array_of(const HaloSource<T>& s) {
  return s.shard;
}

// Stage tile t's ROWS x kWinW window in `stage` and return the skew of its
// first column there. An interior tile whose window lies inside the array
// (rows 16-byte aligned) starts cp.async copies, which the caller waits
// for; any other window is staged element by element through the source
// (zero off the grid): this thread's column, eight rows' loads in flight
// at a time.
template <int ROWS, typename T, typename Src, typename TL>
__device__ __forceinline__ int stage_window(const Src& src,
                                            const StepParams& p,
                                            const TL& tl, int t,
                                            bool whole, T* stage) {
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int c0 = tl.col_of(t) - tl.n;
  if (p.vec && whole && tl.inside(t)) {
    fetch_window<ROWS>(array_of(src), tl.w, tl, t, stage);
    return c0 - (c0 & ~(kVec<T> - 1));
  }
  const int r0 = tl.row_of(t) - tl.rh;
  static_assert(ROWS % 8 == 0, "rows are staged eight at a time");
  for (int i0 = 0; i0 < ROWS; i0 += 8) {
    float x[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = src.at(r0 + i0 + q, c0 + j);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      from_f32(stage + (i0 + q) * kStagePitch<T> + j, x[q]);
    }
  }
  return 0;
}

// x, rounded to bf16 when RB (a walk step of the bf16 interior math)
template <bool RB>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (RB) {
    return rb(x);
  } else {
    return x;
  }
}

// One step of the walk (the section's header): v[i] = window row i of this
// thread's column; `eb` is this step's half of the warp-edge exchange,
// [slot][ROWS], slot 2 * (warp + 1) + side (side 0: the warp's lane 0,
// side 1: its lane 31), read and written four rows at a time; slots of
// warps -1 and kThreadsY stay zero. drow/dcol are each offset's row and
// column in the 3 x 3. Row i's new value is finish(i, its old value, its
// sum g). RB: every add of the sums rounded to bf16 (the window holds bf16
// values). Ends past one __syncthreads().
template <int ROWS, bool MOORE, bool RB = false, typename Finish>
__device__ __forceinline__ void walk_step(float (&v)[ROWS], float* eb,
                                          const int (&drow)[8],
                                          const int (&dcol)[8], int noff,
                                          Finish finish) {
  static_assert(ROWS % 4 == 0, "edge rows move four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  // where this warp's edge lanes publish, and where they read their
  // outer neighbour's column
  const int own = 2 * (wp + 1) + (lane == 31 ? 1 : 0);
  const int nbr = lane == 0 ? 2 * wp + 1 : 2 * (wp + 2);
  const bool edge_lane = lane == 0 || lane == 31;
  // pass 1: the edge lanes publish their column's band (Moore) or values
  float4 x4;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    float x;
    if (MOORE) {
      const float up = i > 0 ? v[i - 1] : 0.f;
      const float dn = i + 1 < ROWS ? v[i + 1] : 0.f;
      x = rnd<RB>(add_kept(rnd<RB>(add_kept(up, v[i])), dn));
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
      const float b = rnd<RB>(__fadd_rn(rnd<RB>(__fadd_rn(prev, v[i])), dn));
      float bl = __shfl_up_sync(kFull, b, 1);
      float br = __shfl_down_sync(kFull, b, 1);
      if (lane == 0) bl = part(e4, i % 4);
      if (lane == 31) br = part(e4, i % 4);
      const float nine = rnd<RB>(__fadd_rn(rnd<RB>(__fadd_rn(bl, b)), br));
      prev = v[i];
      v[i] = finish(i, prev, nine);
    }
  } else {
    // rolling 3 x 3 neighbourhood: rows i-1, i, i+1 of the columns to
    // the left (l), own (c) and right (r), old values
    if (edge_lane) e4 = *reinterpret_cast<const float4*>(nb);
    float lm = 0.f, cm = 0.f, rm = 0.f;
    float l0 = __shfl_up_sync(kFull, v[0], 1);
    float r0 = __shfl_down_sync(kFull, v[0], 1);
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
        lp = __shfl_up_sync(kFull, cp, 1);
        rp = __shfl_down_sync(kFull, cp, 1);
        if (lane == 0) lp = part(e4, k % 4);
        if (lane == 31) rp = part(e4, k % 4);
      }
      float g = 0.f;
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        if (o < noff) {
          const int dc = dcol[o];
          const float up = dc == 0 ? lm : (dc == 1 ? cm : rm);
          const float mid = dc == 0 ? l0 : (dc == 1 ? c0 : r0);
          const float dn = dc == 0 ? lp : (dc == 1 ? cp : rp);
          const int dr = drow[o];
          g = rnd<RB>(__fadd_rn(g, dr == 0 ? up : (dr == 1 ? mid : dn)));
        }
      }
      v[i] = finish(i, c0, g);
      lm = l0; cm = c0; rm = r0;
      l0 = lp; c0 = cp; r0 = rp;
    }
  }
}

// -- the Moore walk on paired bf16 -------------------------------------------
//
// Two window rows a register: v[m] holds rows 2m (low half) and 2m + 1
// (high half) of this thread's column as bf16. A step is walk_step's Moore
// step on pairs: band = (row above + row) + row below, then (band[c-1] +
// band[c]) + band[c+1], each an add.rn.bf16x2 (rounded once, never fused),
// so it is walk_step<ROWS, true, true> on the same values bit for bit, at
// half the adds and shuffles. The edge exchange holds pairs: [slot][ROWS/2]
// 32-bit words a parity.

__device__ __forceinline__ unsigned add_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned add_bf2_kept(unsigned a, unsigned b) {
  unsigned d;
  asm volatile("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned mul_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// (the high half of a, the low half of b): rows 2m - 1 and 2m from pairs
// m - 1 and m
__device__ __forceinline__ unsigned straddle(unsigned a, unsigned b) {
  return __byte_perm(a, b, 0x5432);
}

// Two f32 values (each exactly a bf16 value, or rounded here) as a pair.
__device__ __forceinline__ unsigned pack_bf2(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&p);
}

__device__ __forceinline__ float lo_f32(unsigned p) {
  return __uint_as_float(p << 16);
}

__device__ __forceinline__ float hi_f32(unsigned p) {
  return __uint_as_float(p & 0xFFFF0000u);
}

__device__ __forceinline__ unsigned part_u(const uint4& e, int q) {
  return q == 0 ? e.x : (q == 1 ? e.y : (q == 2 ? e.z : e.w));
}

// One Moore step of the paired walk: pair m's new value is finish(m, its
// old value, its pair of box sums). Ends past one __syncthreads(). Its twin
// paired_step (below: the same straddles, exchange and sum order; pass 1's
// bands kept for pass 2) runs K1/K2's and K3 vpu's paired launches: the
// card tests pin both to one bit order, so a change to one is made to both.
template <int ROWS, typename Finish>
__device__ __forceinline__ void walk_step_bf2(unsigned (&v)[ROWS / 2],
                                              unsigned* eb, Finish finish) {
  constexpr int P = ROWS / 2;
  static_assert(P % 4 == 0, "edge pairs move four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int own = 2 * (wp + 1) + (lane == 31 ? 1 : 0);
  const int nbr = lane == 0 ? 2 * wp + 1 : 2 * (wp + 2);
  const bool edge_lane = lane == 0 || lane == 31;
  // pass 1: the edge lanes publish their column's bands
  uint4 x4;
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const unsigned up = m > 0 ? straddle(v[m - 1], v[m]) : v[m] << 16;
    const unsigned dn = m + 1 < P ? straddle(v[m], v[m + 1]) : v[m] >> 16;
    const unsigned x = add_bf2_kept(add_bf2_kept(up, v[m]), dn);
    if (m % 4 == 0) x4.x = x;
    if (m % 4 == 1) x4.y = x;
    if (m % 4 == 2) x4.z = x;
    if (m % 4 == 3) {
      x4.w = x;
      if (edge_lane) *reinterpret_cast<uint4*>(eb + own * P + m - 3) = x4;
    }
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < P; ++m) asm volatile("" : "+r"(v[m]));
  const unsigned* nb = eb + nbr * P;
  uint4 e4 = make_uint4(0u, 0u, 0u, 0u);
  unsigned prev = 0u;  // the old pair m - 1
#pragma unroll
  for (int m = 0; m < P; ++m) {
    if (m % 4 == 0 && edge_lane) {
      e4 = *reinterpret_cast<const uint4*>(nb + m);
    }
    const unsigned up = m > 0 ? straddle(prev, v[m]) : v[m] << 16;
    const unsigned dn = m + 1 < P ? straddle(v[m], v[m + 1]) : v[m] >> 16;
    const unsigned b = add_bf2(add_bf2(up, v[m]), dn);
    unsigned bl = __shfl_up_sync(kFull, b, 1);
    unsigned br = __shfl_down_sync(kFull, b, 1);
    if (lane == 0) bl = part_u(e4, m % 4);
    if (lane == 31) br = part_u(e4, m % 4);
    const unsigned nine = add_bf2(add_bf2(bl, b), br);
    prev = v[m];
    v[m] = finish(m, prev, nine);
  }
}

// One Moore step of the paired launches of K1/K2 and K3 vpu: the twin of
// walk_step_bf2, its operations in the same order (window rows 2m and
// 2m + 1 in v[m]; band = (row above + row) + row below, the rows above and
// below straddling two pairs; nine = (band[c-1] + band[c]) + band[c+1], the
// neighbouring columns' bands from the neighbouring lanes and, at a warp's
// edges, from the exchange), with the bands of pass 1 kept in registers for
// pass 2 instead of formed again there: ROWS / 2 more words a thread, four
// fewer instructions a pair. Pair m's new value is finish(m, its old value,
// its box sums). Ends past one __syncthreads().
template <int ROWS, typename Finish>
__device__ __forceinline__ void paired_step(unsigned (&v)[ROWS / 2],
                                            unsigned* eb, Finish finish) {
  constexpr int P = ROWS / 2;
  static_assert(P % 4 == 0, "edge pairs move four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int own = 2 * (wp + 1) + (lane == 31 ? 1 : 0);
  const int nbr = lane == 0 ? 2 * wp + 1 : 2 * (wp + 2);
  const bool edge_lane = lane == 0 || lane == 31;
  // pass 1: every column's bands; the edge lanes publish theirs
  unsigned b[P];
  uint4 x4;
#pragma unroll
  for (int m = 0; m < P; ++m) {
    const unsigned up = m > 0 ? straddle(v[m - 1], v[m]) : v[m] << 16;
    const unsigned dn = m + 1 < P ? straddle(v[m], v[m + 1]) : v[m] >> 16;
    b[m] = add_bf2(add_bf2(up, v[m]), dn);
    if (m % 4 == 0) x4.x = b[m];
    if (m % 4 == 1) x4.y = b[m];
    if (m % 4 == 2) x4.z = b[m];
    if (m % 4 == 3) {
      x4.w = b[m];
      if (edge_lane) *reinterpret_cast<uint4*>(eb + own * P + m - 3) = x4;
    }
  }
  __syncthreads();
  // pass 2: the box sums across the columns, then the new pairs
  const unsigned* nb = eb + nbr * P;
  uint4 e4 = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int m = 0; m < P; ++m) {
    if (m % 4 == 0 && edge_lane) {
      e4 = *reinterpret_cast<const uint4*>(nb + m);
    }
    unsigned bl = __shfl_up_sync(kFull, b[m], 1);
    unsigned br = __shfl_down_sync(kFull, b[m], 1);
    if (lane == 0) bl = part_u(e4, m % 4);
    if (lane == 31) br = part_u(e4, m % 4);
    v[m] = finish(m, v[m], add_bf2(add_bf2(bl, b[m]), br));
  }
}

// Rows r and r + 1 of one staged column as a bf16 pair (row r in the low
// half): an f32 pair rounded by one cvt.rn.bf16x2.f32, a bf16 pair moved.
__device__ __forceinline__ unsigned pair_of(const float* a, const float* b) {
  return pack_bf2(*a, *b);
}
__device__ __forceinline__ unsigned pair_of(const __nv_bfloat16* a,
                                            const __nv_bfloat16* b) {
  const unsigned lo = *reinterpret_cast<const unsigned short*>(a);
  const unsigned hi = *reinterpret_cast<const unsigned short*>(b);
  return lo | (hi << 16);
}

// Each offset's row and column in the 3 x 3, from the ordered codes.
__device__ __forceinline__ void offset_rows_cols(int offcodes, int (&drow)[8],
                                                 int (&dcol)[8]);

// n closed-form steps in bf16 on the window in registers (v[i] = window
// row i of this thread's column, as f32; rounded to bf16 on the way in):
// v' = v * a + g * b with a and b the bf16 constants (bits ca16, cb16),
// g the Moore box sum (paired walk) or the neighbours in `offcodes` order
// from 0 (the f32 walk, every operation rounded). `ex` is the walk's
// exchange, both parities, its slots of warps -1 and kThreadsY zero.
template <int ROWS, bool MOORE>
__device__ __forceinline__ void closed_walk_bf16(float (&v)[ROWS], float* ex,
                                                 int n, unsigned ca16,
                                                 unsigned cb16, int offcodes,
                                                 int noff) {
  if constexpr (MOORE) {
    unsigned w[ROWS / 2];
#pragma unroll
    for (int m = 0; m < ROWS / 2; ++m) w[m] = pack_bf2(v[2 * m], v[2 * m + 1]);
    const unsigned ca = ca16 | (ca16 << 16);
    const unsigned cb = cb16 | (cb16 << 16);
    unsigned* eu = reinterpret_cast<unsigned*>(ex);
    for (int s = 0; s < n; ++s) {
      walk_step_bf2<ROWS>(w, eu + (s & 1) * kEdgeSlots * (ROWS / 2),
                          [&](int, unsigned old, unsigned g) {
                            return add_bf2(mul_bf2(old, ca), mul_bf2(g, cb));
                          });
    }
#pragma unroll
    for (int m = 0; m < ROWS / 2; ++m) {
      v[2 * m] = lo_f32(w[m]);
      v[2 * m + 1] = hi_f32(w[m]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) v[i] = rb(v[i]);
    int drow[8], dcol[8];
    offset_rows_cols(offcodes, drow, dcol);
    const float ca = __uint_as_float(ca16 << 16);
    const float cb = __uint_as_float(cb16 << 16);
    for (int s = 0; s < n; ++s) {
      walk_step<ROWS, false, true>(
          v, ex + (s & 1) * kEdgeSlots * ROWS, drow, dcol, noff,
          [&](int, float old, float g) {
            return rb(__fadd_rn(rb(__fmul_rn(old, ca)), rb(__fmul_rn(g, cb))));
          });
    }
  }
}

__device__ __forceinline__ void offset_rows_cols(int offcodes, int (&drow)[8],
                                                 int (&dcol)[8]) {
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int b = (offcodes >> (4 * o)) & 0xF;  // (dx + 1) * 3 + (dy + 1)
    drow[o] = b / 3;
    dcol[o] = b % 3;
  }
}

// -- the bf16 interior math's two launches: regions and their tilings -------
//
// K1/K2 and K3 vpu run a bf16-interior call as two launches, each on its
// own tiling and each writing only its own cells: the near launch over the
// four bands of the array around the bf16 rectangle, the paired launch over
// the rectangle (ops/fused_stencil.py::bf16_regions and region_tiles are the
// same split and tilings).

// A tiling of one region of the array a kernel writes (local rows [r0, r1),
// columns [c0, c1)): Tiling's tiles (th x tw output cells, windows of `rows`
// x kWinW starting rh rows above and n columns left of a tile) aligned to
// the region's origin, `tiles_c` and `tiles` counting the region's. Nothing
// of a tile outside its region is written, so the tilings of disjoint
// regions write disjoint cells.
struct RegionTiling : Tiling {
  int r0, r1, c0, c1;

  __device__ __forceinline__ int row_of(int t) const {
    return r0 + (t / tiles_c) * th;
  }
  __device__ __forceinline__ int col_of(int t) const {
    return c0 + (t % tiles_c) * tw;
  }
  // tile t lies whole in the region and every output cell of it has d > n
  // (uniform over the block)
  __device__ __forceinline__ bool interior(int t) const {
    const int r = row_of(t), c = col_of(t);
    return r + th <= r1 && c + tw <= c1 && R0 + r >= n + 1 &&
           R0 + r + th <= H - 1 - n && C0 + c >= n + 1 &&
           C0 + c + tw <= W - 1 - n;
  }
  // tile t's window lies inside the array
  __device__ __forceinline__ bool inside(int t) const {
    const int wr = row_of(t) - rh, wc = col_of(t) - n;
    return wr >= 0 && wc >= 0 && wr + rows <= h && wc + kWinW <= w;
  }
};

// The end of the rows and columns a tiling writes: the array's, or a
// RegionTiling's region's.
__device__ __forceinline__ int row_end(const Tiling& tl) { return tl.h; }
__device__ __forceinline__ int col_end(const Tiling& tl) { return tl.w; }
__device__ __forceinline__ int row_end(const RegionTiling& tl) {
  return tl.r1;
}
__device__ __forceinline__ int col_end(const RegionTiling& tl) {
  return tl.c1;
}

// Whether window row i of a tile whose window starts at row r is one of the
// tile's output rows inside its region (every cell of a bf16 rectangle has
// d > n: no distance test).
template <int ROWS>
__device__ __forceinline__ bool writes_row(const RegionTiling& tl, int r,
                                           int i) {
  return i >= tl.n && i < ROWS - tl.n && r + i < tl.r1;
}

// The paired launch's walk on tile t of a rectangle's tiling (K1/K2's
// fused_stencil_bf16_kernel, K5's pipeline_bf16_kernel): the Moore closed
// form in bf16 (paired_step: window rows 2m and 2m + 1 a register, the bands
// of a step's first pass kept for its second) over the tile's window, staged
// raw by cp.async where it lies inside the array (else through the source)
// and read into its pairs (an f32 grid rounded to bf16 on the way in), then
// the tile's cells of the region written. `out` is the array the tiling
// describes (row pitch tl.w). Shared memory: the exchange in pair words,
// [2][kEdgeSlots][ROWS / 2], then the staged window.
template <int ROWS, typename T, typename Src>
__device__ __forceinline__ void paired_tile(const Src& src,
                                            T* __restrict__ out,
                                            const StepParams& p,
                                            const RegionTiling& tl, int t) {
  const int n = p.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int r = tl.row_of(t) - n;  // the window's first row and column
  const int c = tl.col_of(t) + j - n;
  const bool col_out = j >= n && j < kWinW - n && c < tl.c1;
  constexpr int P = ROWS / 2;
  constexpr int kExch = kEdgeSlots * P;  // one parity's words
  extern __shared__ __align__(16) float smem[];
  unsigned* ex16 = reinterpret_cast<unsigned*>(smem);
  T* stage = reinterpret_cast<T*>(smem + 2 * kExch);
  const int skew = stage_window<ROWS>(src, p, tl, t, tl.interior(t), stage);
  for (int k = j; k < 2 * kExch; k += kWinW) ex16[k] = 0u;
  cp_async_wait_all();
  __syncthreads();
  // the staged window into pairs of rows, rounded to bf16
  const T* col = stage + skew + j;
  unsigned w[P];
#pragma unroll
  for (int m = 0; m < P; ++m) {
    w[m] = pair_of(col + 2 * m * kStagePitch<T>,
                   col + (2 * m + 1) * kStagePitch<T>);
  }
  const unsigned ca = p.ca16 | (p.ca16 << 16);
  const unsigned cb = p.cb16 | (p.cb16 << 16);
  for (int s = 0; s < n; ++s) {
    paired_step<ROWS>(w, ex16 + (s & 1) * kExch,
                      [&](int, unsigned old, unsigned g) {
                        return add_bf2(mul_bf2(old, ca), mul_bf2(g, cb));
                      });
  }
  if (!col_out) return;
#pragma unroll
  for (int m = 0; m < P; ++m) {
    if (writes_row<ROWS>(tl, r, 2 * m)) {
      from_f32(out + static_cast<size_t>(r + 2 * m) * tl.w + c,
               lo_f32(w[m]));
    }
    if (writes_row<ROWS>(tl, r, 2 * m + 1)) {
      from_f32(out + static_cast<size_t>(r + 2 * m + 1) * tl.w + c,
               hi_f32(w[m]));
    }
  }
}

// The near launch's regions: the four bands of the array around the
// rectangle (top, bottom, left, right), each tiled from its origin. Block b
// steps tile b - first[k] of the last band k with first[k] <= b (an empty
// band has no tile: the band after it starts at the same block). The
// kernels take it as a __grid_constant__ parameter, so a block reads its
// band's tiling from the parameter space instead of a copy in registers.
struct Bands {
  RegionTiling band[4];
  int first[4];
};

__device__ __forceinline__ int band_of(const Bands& bs) {
  int k = 0;
#pragma unroll
  for (int b = 1; b < 4; ++b) {
    if (static_cast<int>(blockIdx.x) >= bs.first[b]) k = b;
  }
  return k;
}

// Host side. The array a call writes: [h, w] at global (R0, C0) of an
// [H, W] grid; `vec`: its rows 16-byte aligned (cp.async windows).
struct Array {
  int h, w, R0, C0, H, W, vec;
};

// The tiling of the region [r0, r1) x [c0, c1) of `a` by windows of `rows`
// rows starting rh rows above a tile, n steps (an empty region: no tile).
inline RegionTiling region_tiling(int rows, int rh, int n, const Array& a,
                                  int r0, int r1, int c0, int c1) {
  RegionTiling tl;
  static_cast<Tiling&>(tl) =
      make_tiling(rows, rh, n, a.h, a.w, a.R0, a.C0, a.H, a.W);
  tl.r0 = r0;
  tl.r1 = r1;
  tl.c0 = c0;
  tl.c1 = c1;
  const bool empty = r0 >= r1 || c0 >= c1;
  tl.tiles_c = empty ? 1 : (c1 - c0 + tl.tw - 1) / tl.tw;
  tl.tiles = empty ? 0 : ((r1 - r0 + tl.th - 1) / tl.th) * tl.tiles_c;
  return tl;
}

// The rectangle q (global) in the array's local rows [a0, a1) and columns
// [b0, b1); an empty one as a0 == a1 == h, which makes the top band the
// whole array.
struct Split {
  int a0, a1, b0, b1;
  bool empty() const { return a0 >= a1; }
};

inline Split split_of(const Rect& q, const Array& a) {
  Split s{std::min(std::max(q.r0 - a.R0, 0), a.h),
          std::min(std::max(q.r1 - a.R0, 0), a.h),
          std::min(std::max(q.c0 - a.C0, 0), a.w),
          std::min(std::max(q.c1 - a.C0, 0), a.w)};
  if (s.a0 >= s.a1 || s.b0 >= s.b1) s = Split{a.h, a.h, 0, 0};
  return s;
}

// The near launch's bands around the split's rectangle, by windows of
// `rows` rows starting rh above a tile; returns their tiles.
inline int bands_of(int rows, int rh, int n, const Array& a, const Split& s,
                    Bands& bs) {
  bs.band[0] = region_tiling(rows, rh, n, a, 0, s.a0, 0, a.w);
  bs.band[1] = region_tiling(rows, rh, n, a, s.a1, a.h, 0, a.w);
  bs.band[2] = region_tiling(rows, rh, n, a, s.a0, s.a1, 0, s.b0);
  bs.band[3] = region_tiling(rows, rh, n, a, s.a0, s.a1, s.b1, a.w);
  int tiles = 0;
  for (int k = 0; k < 4; ++k) {
    bs.first[k] = tiles;
    tiles += bs.band[k].tiles;
  }
  return tiles;
}

// Host side: a bf16-interior call's plan, as the plan entry points report
// it (ops/fused_stencil.py::kernel_plan, ops/composed_stencil.py::
// kernel_plan): for the paired region and the four bands, five ints each,
// local rows [r0, r1), columns [c0, c1), and the tiles launched over it.
inline void write_plan(const RegionTiling& paired, const Bands& bs,
                       int* out) {
  const RegionTiling* regions[5] = {&paired, &bs.band[0], &bs.band[1],
                                    &bs.band[2], &bs.band[3]};
  for (int k = 0; k < 5; ++k) {
    const RegionTiling& tl = *regions[k];
    int* o = out + 5 * k;
    o[0] = tl.r0;
    o[1] = tl.r1;
    o[2] = tl.c0;
    o[3] = tl.c1;
    o[4] = tl.tiles;
  }
}

// The exact path for an edge tile's cells with d <= n: the tile's part
// [lr0, lr1) x [lc0, lc1) (local rows and columns of the array `tl`
// describes) of each of the grid's four border strips (n + 1 rows or
// columns deep), in pieces of at most kStripLen along the strip, each on
// the shared-memory form (iterate_exact_f32) from its own window load. A
// corner cell lies in two strips and is computed twice, to the same bits.
// `a` and `b` are two piece_floats(n) buffers. Ends with a
// __syncthreads() when it computes anything.
template <typename T, typename Src>
__device__ __forceinline__ void exact_cells(const Src& src,
                                            T* __restrict__ out,
                                            const StepParams& p,
                                            const Tiling& tl, int lr0,
                                            int lr1, int lc0, int lc1,
                                            float* a, float* b) {
  const int n = p.nsteps;
  // the tile in global coordinates, [r0, r1) x [c0, c1)
  const int r0 = tl.R0 + lr0;
  const int c0 = tl.C0 + lc0;
  const int r1 = tl.R0 + lr1;
  const int c1 = tl.C0 + lc1;
  for (int strip = 0; strip < 4; ++strip) {
    int sr0 = r0, sr1 = r1, sc0 = c0, sc1 = c1;
    if (strip == 0) sr1 = min(sr1, n + 1);          // top
    if (strip == 1) sr0 = max(sr0, tl.H - 1 - n);   // bottom
    if (strip == 2) sc1 = min(sc1, n + 1);          // left
    if (strip == 3) sc0 = max(sc0, tl.W - 1 - n);   // right
    if (sr0 >= sr1 || sc0 >= sc1) continue;
    const bool across_rows = strip < 2;  // the strip runs along the rows
    const int len = across_rows ? sc1 - sc0 : sr1 - sr0;
    for (int k = 0; k < len; k += kStripLen) {
      const int pr0 = across_rows ? sr0 : sr0 + k;
      const int pc0 = across_rows ? sc0 + k : sc0;
      const int eh = across_rows ? sr1 - sr0 : min(kStripLen, len - k);
      const int ew = across_rows ? min(kStripLen, len - k) : sc1 - sc0;
      const int WH = eh + 2 * n;
      const int WW = ew + 2 * n;
      load_window_f32(src, a, pr0 - tl.R0 - n, pc0 - tl.C0 - n, WH, WW);
      __syncthreads();
      iterate_exact_f32(a, b, pr0 - n, pc0 - n, WH, WW, tl.H, tl.W, p.rate,
                        p.keep, n, p.mask9, p.noff, p.offcodes);
      for (int i = threadIdx.y; i < eh; i += kThreadsY) {
        for (int j = threadIdx.x; j < ew; j += kThreadsX) {
          from_f32(out + static_cast<size_t>(pr0 - tl.R0 + i) * tl.w +
                       (pc0 - tl.C0 + j),
                   a[(i + n) * WW + (j + n)]);
        }
      }
      __syncthreads();
    }
  }
}

// The exact strips of exact_cells, on the source rounded to bf16 when RND
// (the near tiles of the bf16 interior math; a bf16 grid is its own
// rounding).
template <bool RND, typename T, typename Src>
__device__ __forceinline__ void exact_cells_of(const Src& src,
                                               T* __restrict__ out,
                                               const StepParams& p,
                                               const Tiling& tl, int lr0,
                                               int lr1, int lc0, int lc1,
                                               float* a, float* b) {
  if constexpr (RND && sizeof(T) == 4) {
    exact_cells(RoundedSource<Src>{src}, out, p, tl, lr0, lr1, lc0, lc1, a,
                b);
  } else {
    exact_cells(src, out, p, tl, lr0, lr1, lc0, lc1, a, b);
  }
}

// Host side: the bf16 bits of an f32 value that is exactly a bf16 value
// (the bf16 interior math's constants, rounded on the host).
inline unsigned bf16_bits(float x) {
  unsigned u;
  memcpy(&u, &x, sizeof(u));
  return u >> 16;
}

// Host side: launch one kernel instance on `blocks` blocks of (32,
// kThreadsY) threads; `limit` is the instance's own record of its
// shared-memory limit, raised once a launch needs more than it.
template <typename K, typename... Args>
cudaError_t launch_blocks(K kernel, int smem, int blocks, int* limit,
                          void* stream, Args... args) {
  if (smem > *limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    *limit = smem;
  }
  kernel<<<blocks, dim3(32, kThreadsY), smem,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

// Host check of a halo launch: a ring at least n and at most max_depth
// deep, the shard inside the global grid.
inline bool valid_halo(const HaloArgs& a, int n, int max_depth) {
  return a.h >= 0 && a.w >= 0 && a.d >= n && a.d <= max_depth &&
         a.R0 >= 0 && a.C0 >= 0 && a.R0 + a.h <= a.H && a.C0 + a.w <= a.W;
}

// Host side: rows of `pitch` elements from `ptr` can be copied 16 bytes at
// a time.
template <typename T>
inline int rows_aligned(const void* ptr, int pitch) {
  return (reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
          (static_cast<long long>(pitch) * sizeof(T)) % 16 == 0)
             ? 1
             : 0;
}

}  // namespace mm
