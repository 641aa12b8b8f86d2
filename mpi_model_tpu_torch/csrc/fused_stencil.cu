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
// does). The neighborhood is a 3x3 bitmask (bit (dx+1)*3 + (dy+1)) and its
// `noff` offsets in order, 4 bits each (`offcodes`); shares are summed in
// that order, every operation explicitly rounded (no multiply-add
// contracted). The window load and the iterated step live
// in stencil_common.cuh, shared with K3 and K5; blocks whose window is off
// the grid's outer ring skip the per-cell neighbour count there.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include "stencil_common.cuh"

namespace {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int MAX_STEPS = 16;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

template <typename T>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    fused_stencil_kernel(const T* __restrict__ in, T* __restrict__ out, int H,
                         int W, float rate, float keep, int nsteps,
                         int mask9, int noff, int offcodes) {
  extern __shared__ float smem[];
  const int WH = TILE_H + 2 * nsteps;  // window rows
  const int WW = TILE_W + 2 * nsteps;  // window cols (row pitch)
  float* val = smem;                   // [WH][WW] values
  float* share = smem + WH * WW;       // [WH][WW] shares of one step
  const int r0 = static_cast<int>(blockIdx.y) * TILE_H - nsteps;
  const int c0 = static_cast<int>(blockIdx.x) * TILE_W - nsteps;

  mm::load_window_f32(in, val, r0, c0, WH, WW, H, W);
  __syncthreads();
  mm::iterate_exact_f32(val, share, r0, c0, WH, WW, H, W, rate, keep, nsteps,
                        mask9, noff, offcodes);

  // Write the interior once, in the storage dtype.
  for (int i = threadIdx.y; i < TILE_H; i += mm::kThreadsY) {
    const int r = r0 + nsteps + i;
    if (r >= H) break;
    for (int j = threadIdx.x; j < TILE_W; j += mm::kThreadsX) {
      const int c = c0 + nsteps + j;
      if (c < W) {
        mm::from_f32(out + static_cast<size_t>(r) * W + c,
                     val[(i + nsteps) * WW + (j + nsteps)]);
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int H, int W, float rate, float keep,
           int nsteps, int mask9, int noff, int offcodes, void* stream) {
  if (nsteps < 1 || nsteps > MAX_STEPS || (mask9 & ~0x1EF) != 0 ||
      mask9 == 0 || noff != __builtin_popcount(mask9) || H < 0 || W < 0) {
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
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  fused_stencil_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), H, W, rate, keep,
      nsteps, mask9, noff, offcodes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mm_fused_stencil_f32(const void* in, void* out, int H, int W, float rate,
                         float keep, int nsteps, int mask9, int noff,
                         int offcodes, void* stream) {
  return launch<float>(in, out, H, W, rate, keep, nsteps, mask9, noff,
                       offcodes, stream);
}

int mm_fused_stencil_bf16(const void* in, void* out, int H, int W, float rate,
                          float keep, int nsteps, int mask9, int noff,
                          int offcodes, void* stream) {
  return launch<__nv_bfloat16>(in, out, H, W, rate, keep, nsteps, mask9,
                               noff, offcodes, stream);
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int mm_max_steps() { return MAX_STEPS; }

}  // extern "C"
