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
//     g_c0 + BC >= W - n. Near tiles take the exact masked path of K1
//     (stencil_common.cuh: share = (rate * v) / cnt with the in-bounds count
//     of the global cell, v' = v * (1 - rate) + (shares in `offsets` order),
//     off-grid cells zero);
//   - other tiles take the closed form. Moore (the eight offsets, in any
//     order): band = (row r-1 + row r) + row r+1 per column, nine =
//     (band[c-1] + band[c]) + band[c+1], v' = v * a + nine * b with
//     a = 1 - r - r/8 and b = r/8. Other neighborhoods: g = the neighbours
//     summed in `offsets` order, v' = v * a + g * b with a = 1 - r,
//     b = r/k. The constants come rounded to f32 from the host (the TPU
//     kernel's weak-typed Python floats).
//
// The two forms round differently, so the choice is made per TPU tile, not
// per CUDA block: a CUDA tile is TILE_W = 128 columns by tile_h = 16 or 32
// rows, and divides the TPU tile (BR % 16 == 0, BC % 128 == 0), so each
// block lies in one TPU tile and takes that tile's branch. Each block loads
// its (tile_h + 2n) x (128 + 2n) window once; an output cell's value after
// n steps depends only on the cells within n of it, so the block computes
// the same values the TPU tile does.
//
// Storage is float or __nv_bfloat16, cast to f32 once on the way in and
// once on the way out. Every operation is an explicitly rounded intrinsic
// and the source builds with --fmad=false, so the kernel equals its plain
// version (ops/pipeline_stencil.py::pipeline_step_plain) bit for bit.
// The grid is (W / 128, H / tile_h, B): one launch steps every lane.
//
// What bounds it: on paper, bytes. One call must read the batch once and
// write it once (8 bytes a cell in f32, 4 in bf16) against 7 f32 operations
// a cell-step on closed-form tiles and 11 on the exact path (Moore). In
// practice it is the instructions of the steps in shared memory: at 4096²
// every TPU tile touches an edge, so every cell takes the exact path, and
// the kernel runs ~18x its byte bound at n = 8. This first design is the
// simple one: a shared-memory window loaded once, n steps with a barrier
// between them, the output written once; blocks whose window is off the
// grid's outer ring skip the per-cell neighbour count (stencil_common.cuh).
// The window's halo re-reads (up to 1.6x the tile at n = 8), the two
// barriers per step and the lack of cp.async/TMA double buffering of the
// next window are what a later speed PR would attack.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include "stencil_common.cuh"

namespace {

constexpr int TILE_W = 128;
constexpr int MAX_STEPS = 8;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

struct Params {
  int H, W;        // one lane's grid
  int BR, BC;      // the TPU tile that decides the form
  int tile_h;      // CUDA tile rows (16 or 32; divides BR)
  int nsteps;
  int mask9;       // neighbourhood bitmask (the in-bounds count)
  int noff;        // offsets, in order, 4 bits each
  int offcodes;
  int moore;       // the closed form's separable Moore sum
  float rate, keep;  // the exact path's rate and f32(1 - rate)
  float ca, cb;      // the closed form's f32 constants
};

// One closed-form step on the region [s + 1, WH - s - 1) x
// [s + 1, WW - s - 1), from `cur` into `nxt`; `delta` holds the ordered
// neighbours' index offsets in the window (mm::window_deltas).
__device__ __forceinline__ void closed_step(const float* cur, float* nxt,
                                            int s, int WH, int WW,
                                            const Params& p,
                                            const int delta[8]) {
  for (int i = s + 1 + threadIdx.y; i < WH - s - 1; i += mm::kThreadsY) {
    for (int j = s + 1 + threadIdx.x; j < WW - s - 1; j += mm::kThreadsX) {
      const float* c = cur + i * WW + j;
      float g;
      if (p.moore) {
        const float b0 = __fadd_rn(__fadd_rn(c[-WW - 1], c[-1]), c[WW - 1]);
        const float b1 = __fadd_rn(__fadd_rn(c[-WW], c[0]), c[WW]);
        const float b2 = __fadd_rn(__fadd_rn(c[-WW + 1], c[1]), c[WW + 1]);
        g = __fadd_rn(__fadd_rn(b0, b1), b2);
      } else {
        g = mm::ordered_sum(c, p.noff, delta);
      }
      nxt[i * WW + j] = __fadd_rn(__fmul_rn(c[0], p.ca), __fmul_rn(g, p.cb));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    pipeline_stencil_kernel(const T* __restrict__ in, T* __restrict__ out,
                            Params p) {
  extern __shared__ float smem[];
  const int n = p.nsteps;
  const int WH = p.tile_h + 2 * n;  // window rows
  const int WW = TILE_W + 2 * n;    // window cols (row pitch)
  const size_t lane = static_cast<size_t>(blockIdx.z) * p.H * p.W;
  in += lane;
  out += lane;
  const int t_r0 = static_cast<int>(blockIdx.y) * p.tile_h;  // output tile
  const int t_c0 = static_cast<int>(blockIdx.x) * TILE_W;
  const int r0 = t_r0 - n;  // window origin
  const int c0 = t_c0 - n;
  // the TPU tile holding this block, and its branch (uniform over the block)
  const int g_r0 = t_r0 / p.BR * p.BR;
  const int g_c0 = t_c0 / p.BC * p.BC;
  const bool near = g_r0 <= n || g_r0 + p.BR >= p.H - n || g_c0 <= n ||
                    g_c0 + p.BC >= p.W - n;

  float* val = smem;             // [WH][WW]
  float* tmp = smem + WH * WW;   // [WH][WW]: shares, or the next step
  mm::load_window_f32(in, val, r0, c0, WH, WW, p.H, p.W);
  __syncthreads();
  const float* res = val;
  if (near) {
    mm::iterate_exact_f32(val, tmp, r0, c0, WH, WW, p.H, p.W, p.rate, p.keep,
                          n, p.mask9, p.noff, p.offcodes);
  } else {
    int delta[8];
    mm::window_deltas(p.offcodes, WW, delta);
    float* cur = val;
    float* nxt = tmp;
    for (int s = 0; s < n; ++s) {
      closed_step(cur, nxt, s, WH, WW, p, delta);
      __syncthreads();
      float* t = cur;
      cur = nxt;
      nxt = t;
    }
    res = cur;
  }

  // Write the tile once, in the storage dtype.
  for (int i = threadIdx.y; i < p.tile_h; i += mm::kThreadsY) {
    const int r = t_r0 + i;
    if (r >= p.H) break;
    for (int j = threadIdx.x; j < TILE_W; j += mm::kThreadsX) {
      const int c = t_c0 + j;
      if (c < p.W) {
        mm::from_f32(out + static_cast<size_t>(r) * p.W + c,
                     res[(i + n) * WW + (j + n)]);
      }
    }
  }
}

template <typename T>
int launch(const void* in, void* out, int B, Params p, void* stream) {
  if (p.nsteps < 1 || p.nsteps > MAX_STEPS || (p.mask9 & ~0x1EF) != 0 ||
      p.mask9 == 0 || p.noff < 1 || p.noff > 8 || B < 0 || p.H < 0 ||
      p.W < 0 || (p.tile_h != 16 && p.tile_h != 32) || p.BR < 1 ||
      p.BC < 1 || p.BR % p.tile_h != 0 || p.BC % TILE_W != 0 ||
      p.H % p.BR != 0 || p.W % p.BC != 0 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0 || p.H == 0 || p.W == 0) return 0;
  const int smem = 2 * (p.tile_h + 2 * p.nsteps) * (TILE_W + 2 * p.nsteps) *
                   static_cast<int>(sizeof(float));
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  if (smem > smem_limit) {
    cudaError_t e = cudaFuncSetAttribute(
        pipeline_stencil_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_limit = smem;
  }
  const dim3 grid(p.W / TILE_W, p.H / p.tile_h, B);
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  pipeline_stencil_kernel<T><<<grid, block, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(in), static_cast<T*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

Params make_params(int H, int W, int BR, int BC, int tile_h, float rate,
                   float keep, float ca, float cb, int nsteps, int mask9,
                   int noff, int offcodes, int moore) {
  Params p;
  p.H = H;
  p.W = W;
  p.BR = BR;
  p.BC = BC;
  p.tile_h = tile_h;
  p.nsteps = nsteps;
  p.mask9 = mask9;
  p.noff = noff;
  p.offcodes = offcodes;
  p.moore = moore;
  p.rate = rate;
  p.keep = keep;
  p.ca = ca;
  p.cb = cb;
  return p;
}

}  // namespace

extern "C" {

int mm_pipeline_stencil_f32(const void* in, void* out, int B, int H, int W,
                            int BR, int BC, int tile_h, float rate,
                            float keep, float ca, float cb, int nsteps,
                            int mask9, int noff, int offcodes, int moore,
                            void* stream) {
  return launch<float>(in, out, B,
                       make_params(H, W, BR, BC, tile_h, rate, keep, ca, cb,
                                   nsteps, mask9, noff, offcodes, moore),
                       stream);
}

int mm_pipeline_stencil_bf16(const void* in, void* out, int B, int H, int W,
                             int BR, int BC, int tile_h, float rate,
                             float keep, float ca, float cb, int nsteps,
                             int mask9, int noff, int offcodes, int moore,
                             void* stream) {
  return launch<__nv_bfloat16>(
      in, out, B,
      make_params(H, W, BR, BC, tile_h, rate, keep, ca, cb, nsteps, mask9,
                  noff, offcodes, moore),
      stream);
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
