// Device helpers shared by the port's stencil kernels (K1 and K2 in
// fused_stencil.cu, K3 and K3-halo in composed_stencil.cu, K4 and K4-halo
// in field_stencil.cu, K5 in pipeline_stencil.cu, K6/K7 in fused_active.cu).
//
// One copy of: the f32 storage conversions, the grid test, the in-bounds
// neighbor count of a global cell, the window sources (a whole grid, or one
// shard and its exchanged ghost ring), the halo-window load, and the exact
// iterated step of K1, K3 and K5 (the form the TPU kernels use near the
// global edge). The neighborhood is a 3x3 bitmask: bit (dx+1)*3 + (dy+1)
// set for each offset. Loops stride over a (kThreadsX, kThreadsY) block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

// The same for a whole [H, W] grid whose window starts at global (r0, c0).
template <typename T>
__device__ __forceinline__ void load_window_f32(const T* __restrict__ in,
                                                float* val, int r0, int c0,
                                                int WH, int WW, int H,
                                                int W) {
  load_window_f32(DenseSource<T>{in, H, W}, val, r0, c0, WH, WW);
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

}  // namespace mm
