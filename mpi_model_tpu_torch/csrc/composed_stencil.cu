// K3: the composed k-step dense filter, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_stencil_call
// run with the composed-filter interior hooks of
// mpi_model_tpu/ops/composed_stencil.py (_make_vpu_hook, _make_mxu_hook),
// reached through composed_dense_step and ComposedDiffusionStep. One call
// advances k uniform-rate transport steps:
//
//   - an output cell at distance > k from every global edge gets ONE pass
//     of the k-fold filter S^k: out[r, c] = sum over (dr, dc) in [0, 2k]^2 of
//     taps[dr][dc] * v[r + dr - k][c + dc - k], the table composed in f64 on
//     the host (composed_taps) and passed here in f32 (k steps reach k cells
//     out, and S is the one-step operator only at cells whose neighbors are
//     all on the grid, so the composed table holds from distance k + 1);
//   - every other cell takes the exact iterated path, K1's k masked steps
//     (stencil_common.cuh), because near the edge the per-cell divisor makes
//     the operator vary in space and it does not compose.
//
// What bounds it: operations. (2k+1)^2 multiply-adds per interior cell per
// call against 8 (f32) or 4 (bf16) bytes of device traffic: at k = 8 that is
// 289 FMAs a cell, ~72 flops per byte, above the card's f32 non-tensor
// balance point (67 TFLOP/s over 3.35 TB/s = 20). This first design is
// simple: a block loads its (TILE_H + 2k) x (TILE_W + 2k) window to shared
// memory once and every thread runs the tap loop over its cells reading the
// window there, with the table in constant memory (every lane of a warp
// reads the same tap: a broadcast). Register blocking of the tap loop
// (fewer shared loads per FMA) and the tensor-core banded form of the
// "mxu" variant are later work. Every variant runs this one loop.
//
// The window covers the tile plus a ring of k; only blocks that touch the
// edge band run the iterated path, after the tap pass has written the
// interior cells of the tile (the iterated steps overwrite the window in
// place). Storage is float or __nv_bfloat16; the math is f32; bf16 is
// rounded once per call, as in K1.
//
// K3-halo is the same body on one shard of a sharded grid: it replaces the
// composed hooks run through _stencil_call in halo mode (composed_halo_step,
// used by parallel/executors.py::ShardMapExecutor with step_impl
// "composed"). The window reads the shard and, past its edge, the exchanged
// ghost ring of depth d >= k (mm::HaloSource); the interior/band choice and
// the iterated steps use the cell's global row and column against the
// global grid. Since the choice is made per cell, a sharded run takes the
// same path for every cell as the whole-grid run, wherever the shard edges
// fall.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch (or of the table copy), 0 on success.

#include "stencil_common.cuh"

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int MAX_K = 16;
constexpr int MAX_TAPS = (2 * MAX_K + 1) * (2 * MAX_K + 1);
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

__constant__ float c_taps[MAX_TAPS];

int smem_of(int k) {
  return 2 * (TILE_H + 2 * k) * (TILE_W + 2 * k) *
         static_cast<int>(sizeof(float));
}

// One block's work on the [h, w] output whose cells `src` reads at its
// global origin: the tap pass on the tile's interior cells, then, in blocks
// that reach the edge band, the iterated path on the band cells. The
// interior/band choice is per cell, from its global row and column.
template <typename T, typename Src>
__device__ __forceinline__ void composed_body(const Src& src,
                                              T* __restrict__ out, int h,
                                              int w, float rate, float keep,
                                              int k, int mask9, int noff,
                                              int offcodes) {
  extern __shared__ float smem[];
  const int WH = TILE_H + 2 * k;
  const int WW = TILE_W + 2 * k;
  const int ntap = 2 * k + 1;
  const int m = k + 1;  // first row/column the table is exact on
  const int H = src.gH();
  const int W = src.gW();
  float* val = smem;
  float* share = smem + WH * WW;
  const int tr0 = static_cast<int>(blockIdx.y) * TILE_H;  // tile origin
  const int tc0 = static_cast<int>(blockIdx.x) * TILE_W;
  const int gr0 = src.row0() + tr0;  // the tile's global origin
  const int gc0 = src.col0() + tc0;

  mm::load_window_f32(src, val, tr0 - k, tc0 - k, WH, WW);
  __syncthreads();

  // Interior cells: one pass of the composed table, taps in row-major order.
  for (int i = threadIdx.y; i < TILE_H; i += mm::kThreadsY) {
    if (tr0 + i >= h) break;
    const int r = gr0 + i;
    if (r < m || r >= H - m) continue;
    for (int j = threadIdx.x; j < TILE_W; j += mm::kThreadsX) {
      if (tc0 + j >= w) break;
      const int c = gc0 + j;
      if (c < m || c >= W - m) continue;
      const float* base = val + i * WW + j;
      float acc = 0.f;
      for (int dr = 0; dr < ntap; ++dr) {
        const float* row = base + dr * WW;
        const float* tp = c_taps + dr * ntap;
#pragma unroll 4
        for (int dc = 0; dc < ntap; ++dc) {
          acc += tp[dc] * row[dc];
        }
      }
      mm::from_f32(out + static_cast<size_t>(tr0 + i) * w + tc0 + j, acc);
    }
  }

  // Blocks that reach the edge band: the exact iterated path for the cells
  // within k of an edge. `near` is uniform over the block.
  const bool near = gr0 < m || gr0 + TILE_H > H - m || gc0 < m ||
                    gc0 + TILE_W > W - m;
  if (!near) return;
  __syncthreads();  // the tap pass has finished reading the window
  mm::iterate_exact_f32(val, share, gr0 - k, gc0 - k, WH, WW, H, W, rate,
                        keep, k, mask9, noff, offcodes);
  for (int i = threadIdx.y; i < TILE_H; i += mm::kThreadsY) {
    if (tr0 + i >= h) break;
    const int r = gr0 + i;
    const bool row_band = r < m || r >= H - m;
    for (int j = threadIdx.x; j < TILE_W; j += mm::kThreadsX) {
      if (tc0 + j >= w) break;
      const int c = gc0 + j;
      if (row_band || c < m || c >= W - m) {
        mm::from_f32(out + static_cast<size_t>(tr0 + i) * w + tc0 + j,
                     val[(i + k) * WW + (j + k)]);
      }
    }
  }
}

// K3: a whole [H, W] grid.
template <typename T>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    composed_kernel(const T* __restrict__ in, T* __restrict__ out, int H,
                    int W, float rate, float keep, int k, int mask9,
                    int noff, int offcodes) {
  composed_body(mm::DenseSource<T>{in, H, W}, out, H, W, rate, keep, k,
                mask9, noff, offcodes);
}

// K3-halo: one shard and its ghost ring (depth >= k); `out` is [h, w].
template <typename T>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    composed_halo_kernel(const mm::HaloSource<T> src, T* __restrict__ out,
                         float rate, float keep, int k, int mask9, int noff,
                         int offcodes) {
  composed_body(src, out, src.h, src.w, rate, keep, k, mask9, noff,
                offcodes);
}

bool valid_k(int k, int mask9, int noff) {
  return k >= 1 && k <= MAX_K && (mask9 & ~0x1EF) == 0 && mask9 != 0 &&
         noff == __builtin_popcount(mask9);
}

// The table rides the stream: a later call's table cannot overtake this
// call's launch. Then the kernel's shared-memory limit, raised once it
// needs more than the default 48 KB (`limit` is the instance's record).
template <typename K>
cudaError_t prepare(K kernel, const void* taps_dev, int k, int* limit,
                    cudaStream_t st) {
  const int ntap = 2 * k + 1;
  cudaError_t e = cudaMemcpyToSymbolAsync(
      c_taps, taps_dev, sizeof(float) * ntap * ntap, 0,
      cudaMemcpyDeviceToDevice, st);
  if (e != cudaSuccess) return e;
  const int smem = smem_of(k);
  if (smem > *limit) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return e;
    *limit = smem;
  }
  return cudaSuccess;
}

template <typename T>
int launch(const void* in, void* out, const void* taps_dev, int H, int W,
           float rate, float keep, int k, int mask9, int noff, int offcodes,
           void* stream) {
  if (!valid_k(k, mask9, noff) || H < 0 || W < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || W == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  cudaError_t e = prepare(composed_kernel<T>, taps_dev, k, &smem_limit, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  composed_kernel<T><<<grid, block, smem_of(k), st>>>(
      static_cast<const T*>(in), static_cast<T*>(out), H, W, rate, keep, k,
      mask9, noff, offcodes);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_halo(const mm::HaloArgs* args, void* out, const void* taps_dev,
                float rate, float keep, int k, int mask9, int noff,
                int offcodes, void* stream) {
  if (args == nullptr || !valid_k(k, mask9, noff)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const mm::HaloArgs& a = *args;
  if (a.h < 0 || a.w < 0 || a.d < k || a.d > MAX_K || a.R0 < 0 || a.C0 < 0 ||
      a.R0 + a.h > a.H || a.C0 + a.w > a.W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.h == 0 || a.w == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  cudaError_t e =
      prepare(composed_halo_kernel<T>, taps_dev, k, &smem_limit, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.w + TILE_W - 1) / TILE_W, (a.h + TILE_H - 1) / TILE_H);
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  composed_halo_kernel<T><<<grid, block, smem_of(k), st>>>(
      mm::HaloSource<T>(a), static_cast<T*>(out), rate, keep, k, mask9, noff,
      offcodes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mm_composed_f32(const void* in, void* out, const void* taps, int H,
                    int W, float rate, float keep, int k, int mask9, int noff,
                    int offcodes, void* stream) {
  return launch<float>(in, out, taps, H, W, rate, keep, k, mask9, noff,
                       offcodes, stream);
}

int mm_composed_bf16(const void* in, void* out, const void* taps, int H,
                     int W, float rate, float keep, int k, int mask9,
                     int noff, int offcodes, void* stream) {
  return launch<__nv_bfloat16>(in, out, taps, H, W, rate, keep, k, mask9,
                               noff, offcodes, stream);
}

int mm_composed_halo_f32(const void* args, void* out, const void* taps,
                         float rate, float keep, int k, int mask9, int noff,
                         int offcodes, void* stream) {
  return launch_halo<float>(static_cast<const mm::HaloArgs*>(args), out,
                            taps, rate, keep, k, mask9, noff, offcodes,
                            stream);
}

int mm_composed_halo_bf16(const void* args, void* out, const void* taps,
                          float rate, float keep, int k, int mask9, int noff,
                          int offcodes, void* stream) {
  return launch_halo<__nv_bfloat16>(static_cast<const mm::HaloArgs*>(args),
                                    out, taps, rate, keep, k, mask9, noff,
                                    offcodes, stream);
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
