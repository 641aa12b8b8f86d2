// K1: the fused dense stencil, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_stencil_call
// in dense mode (the pl.pallas_call reached through _pallas_step,
// pallas_dense_step and PallasDiffusionStep). It computes what that kernel
// computes, not how: `nsteps` uniform-rate radius-1 transport steps over a
// [H, W] grid in one read and one write of device memory. Each step, every
// cell sheds share = rate * v / cnt(row, col) to each in-bounds neighbor,
// where cnt is its own in-bounds neighbor count; the grid is non-periodic,
// so off-grid cells are zero and are re-masked to zero after each step.
//
// What bounds it: bytes. One call must read the grid once and write it once
// (8 bytes a cell in f32, 4 in bf16), and for small nsteps the arithmetic
// per byte is far below the card's balance point. The design answers that
// by fusing the steps: a block loads its (TILE_H + 2n) x (TILE_W + 2n) halo
// window into shared memory once, runs all n steps there in f32 on a region
// that shrinks one ring per step, and writes its TILE_H x TILE_W interior
// once, so one device-memory round trip buys n cell-updates. At large n the
// shared-memory traffic of the steps becomes the limit instead; the closed-
// form interior path, cp.async/TMA double buffering and larger tiles that
// would address it are later work.
//
// The kernel is out of place: every read sees the values from before the
// call. Storage is float or __nv_bfloat16; the math is f32, converted with
// the intrinsics only, and bf16 is rounded once per call (as the TPU kernel
// does). The neighborhood is a 3x3 bitmask (bit (dx+1)*3 + (dy+1)); shares
// are summed in row-major offset order.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 8;
constexpr int MAX_STEPS = 16;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

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
__device__ __forceinline__ float neighbor_count(int r, int c, int H, int W,
                                                int mask9) {
  int cnt = 0;
#pragma unroll
  for (int b = 0; b < 9; ++b) {
    if ((mask9 >> b) & 1) {
      cnt += on_grid(r + b / 3 - 1, c + b % 3 - 1, H, W) ? 1 : 0;
    }
  }
  return static_cast<float>(cnt > 0 ? cnt : 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS_X* THREADS_Y)
    fused_stencil_kernel(const T* __restrict__ in, T* __restrict__ out, int H,
                         int W, float rate, float keep, int nsteps,
                         int mask9) {
  extern __shared__ float smem[];
  const int WH = TILE_H + 2 * nsteps;  // window rows
  const int WW = TILE_W + 2 * nsteps;  // window cols (row pitch)
  float* val = smem;                   // [WH][WW] values
  float* share = smem + WH * WW;       // [WH][WW] shares of one step
  const int r0 = static_cast<int>(blockIdx.y) * TILE_H - nsteps;
  const int c0 = static_cast<int>(blockIdx.x) * TILE_W - nsteps;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // Load the halo window; neighbouring threads read neighbouring columns.
  // Off-grid cells are zero: that zero is the non-periodic boundary.
  for (int i = ty; i < WH; i += THREADS_Y) {
    const int r = r0 + i;
    for (int j = tx; j < WW; j += THREADS_X) {
      const int c = c0 + j;
      val[i * WW + j] =
          on_grid(r, c, H, W) ? to_f32(in[static_cast<size_t>(r) * W + c])
                              : 0.f;
    }
  }
  __syncthreads();

  for (int s = 0; s < nsteps; ++s) {
    // Phase 1: shares on window rows/cols [s, WH - s).
    for (int i = s + ty; i < WH - s; i += THREADS_Y) {
      const int r = r0 + i;
      for (int j = s + tx; j < WW - s; j += THREADS_X) {
        const float cnt = neighbor_count(r, c0 + j, H, W, mask9);
        share[i * WW + j] = (rate * val[i * WW + j]) / cnt;
      }
    }
    __syncthreads();
    // Phase 2: update [s + 1, WH - s - 1). A cell's value is read and
    // written by its own thread only, so the update is in place in `val`.
    for (int i = s + 1 + ty; i < WH - s - 1; i += THREADS_Y) {
      const int r = r0 + i;
      for (int j = s + 1 + tx; j < WW - s - 1; j += THREADS_X) {
        float g = 0.f;
#pragma unroll
        for (int b = 0; b < 9; ++b) {
          if ((mask9 >> b) & 1) {
            g += share[(i + b / 3 - 1) * WW + (j + b % 3 - 1)];
          }
        }
        val[i * WW + j] =
            on_grid(r, c0 + j, H, W) ? val[i * WW + j] * keep + g : 0.f;
      }
    }
    __syncthreads();
  }

  // Write the interior once, in the storage dtype.
  for (int i = ty; i < TILE_H; i += THREADS_Y) {
    const int r = r0 + nsteps + i;
    if (r >= H) break;
    for (int j = tx; j < TILE_W; j += THREADS_X) {
      const int c = c0 + nsteps + j;
      if (c < W) {
        from_f32(out + static_cast<size_t>(r) * W + c,
                 val[(i + nsteps) * WW + (j + nsteps)]);
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int H, int W, float rate, float keep,
           int nsteps, int mask9, void* stream) {
  if (nsteps < 1 || nsteps > MAX_STEPS || (mask9 & ~0x1EF) != 0 ||
      mask9 == 0 || H < 0 || W < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (H == 0 || W == 0) return 0;
  const int smem = 2 * (TILE_H + 2 * nsteps) * (TILE_W + 2 * nsteps) *
                   static_cast<int>(sizeof(float));
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_stencil_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_limit = smem;
  }
  const dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H);
  const dim3 block(THREADS_X, THREADS_Y);
  fused_stencil_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), H, W, rate, keep,
      nsteps, mask9);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mm_fused_stencil_f32(const void* in, void* out, int H, int W, float rate,
                         float keep, int nsteps, int mask9, void* stream) {
  return launch<float>(in, out, H, W, rate, keep, nsteps, mask9, stream);
}

int mm_fused_stencil_bf16(const void* in, void* out, int H, int W, float rate,
                          float keep, int nsteps, int mask9, void* stream) {
  return launch<__nv_bfloat16>(in, out, H, W, rate, keep, nsteps, mask9,
                               stream);
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mm_max_steps() { return MAX_STEPS; }

}  // extern "C"
