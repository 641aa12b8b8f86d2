// Device helpers shared by the port's stencil kernels (K1 in
// fused_stencil.cu, K3 in composed_stencil.cu, K5 in pipeline_stencil.cu,
// K6/K7 in fused_active.cu).
//
// One copy of: the f32 storage conversions, the grid test, the in-bounds
// neighbor count of a global cell, the halo-window load, and the exact
// iterated step of K1, K3 and K5 (the form the TPU kernels use near the
// global edge). The neighborhood is a 3x3 bitmask: bit (dx+1)*3 + (dy+1)
// set for each offset. Loops stride over a (kThreadsX, kThreadsY) block.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace mm {

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

// Load the [WH, WW] window whose [0, 0] is global cell (r0, c0) into `val`
// as f32; neighbouring threads read neighbouring columns. Off-grid cells
// are zero: that zero is the non-periodic boundary.
template <typename T>
__device__ __forceinline__ void load_window_f32(const T* __restrict__ in,
                                                float* val, int r0, int c0,
                                                int WH, int WW, int H,
                                                int W) {
  for (int i = threadIdx.y; i < WH; i += kThreadsY) {
    const int r = r0 + i;
    for (int j = threadIdx.x; j < WW; j += kThreadsX) {
      const int c = c0 + j;
      val[i * WW + j] =
          on_grid(r, c, H, W) ? to_f32(in[static_cast<size_t>(r) * W + c])
                              : 0.f;
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

}  // namespace mm
