// K6 and K7: the fused active-tile pass, written by hand for Hopper
// (sm_90a).
//
// K6 replaces mpi_model_tpu/ops/pallas_active.py::_fused_compute_call, K7
// replaces ::_fused_scatter_call (both reached through fused_active_pass and
// build_fused_runner). The active-tile engine steps only the tiles whose
// ring-1 tile neighbourhood holds mass; their ids are compacted into a [K]
// buffer on the device, and a device scalar holds how many lanes are live.
//
// K6, per live lane l < clip(count, 1, K), tile t = ids[l]:
//   loads the tile's ring-k window from the padded state and advances it
//   k transport steps, then writes upd[l] (the [th, tw] tile) and ORs the
//   tile's any-nonzero into anyf[l] (zeroed by the caller). Two forms:
//   - the exact iterated path, term for term the plain step
//     (ops/active.py::active_pass, itself bitwise ops/stencil.py::transport):
//     outflow = rate*v; share = outflow/cnt; inflow = 0 + share[d0] + ...
//     in the caller's offset order; out = (v - outflow) + inflow; counts
//     from global coordinates, clamped to >= 1; between in-window steps,
//     off-grid cells are multiplied by 0 (in-grid ones by 1), not after the
//     last step;
//   - at k > 1 on tiles away from the global edge whose own cells were
//     nonzero before the pass (selfnz): one pass of the composed (2k+1)^2
//     tap table (acc = 0 + tap*v + ... in row-major tap order).
//   The math runs in the storage dtype (f64 grids in f64). Every operation
//   is an explicitly rounded intrinsic (__fmul_rn, __fadd_rn, ...) and the
//   source is built with --fmad=false, so no multiply-add is contracted: at
//   k = 1 the pass equals the plain step bit for bit. bf16 is computed as
//   f32 rounded to bf16 after every operation, which is the correctly
//   rounded bf16 result (f32 carries more than 2*8+2 bits).
// K7, per live lane: copies upd[l] into the padded state at the tile's
//   place (offset by the ring). It is its own launch so that every K6
//   window reads the values from before the pass.
//
// Shared memory is the trap: the default 128 x 128 tile with a ring-k
// window and a second buffer for the shares needs 2 * 130^2 * 8 B = 270 KB
// in f64 at k = 1, above the 227 KB a block may use. So each lane's tile is
// cut into SUB x SUB sub-tiles, one block each with its own ring-k halo
// (at most 2 * (32 + 32)^2 * 8 B = 64 KB, f64 at k = 16); the lane's flag is
// the OR of its blocks'.
//
// What bounds them: bytes for K7 and for K6 at k = 1 (each live tile read
// once, written once); at k > 1 the tap flops on interior tiles. This first
// design reads windows straight from device memory into shared memory and
// loops over the taps there; the sub-tile halo re-reads (1.13x at k = 1,
// 2.25x at k = 8) and the per-step neighbour-count recompute are the costs
// a later speed PR would attack.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch (or of the table copy), 0 on success.

#include <cstdint>

#include "stencil_common.cuh"

namespace {

constexpr int SUB = 32;
constexpr int MAX_K = 16;
constexpr int MAX_TAPS = (2 * MAX_K + 1) * (2 * MAX_K + 1);
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

__constant__ double c_taps_f64[MAX_TAPS];
__constant__ float c_taps_f32[MAX_TAPS];

// Storage type T, compute type C, and the explicitly rounded operations.
template <typename T>
struct Arith;

template <>
struct Arith<float> {
  using C = float;
  static __device__ __forceinline__ C ld(float v) { return v; }
  static __device__ __forceinline__ float st(C v) { return v; }
  static __device__ __forceinline__ C mul(C a, C b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ C add(C a, C b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __fsub_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __fdiv_rn(a, b); }
  static __device__ __forceinline__ C tap(int i) { return c_taps_f32[i]; }
};

template <>
struct Arith<double> {
  using C = double;
  static __device__ __forceinline__ C ld(double v) { return v; }
  static __device__ __forceinline__ double st(C v) { return v; }
  static __device__ __forceinline__ C mul(C a, C b) { return __dmul_rn(a, b); }
  static __device__ __forceinline__ C add(C a, C b) { return __dadd_rn(a, b); }
  static __device__ __forceinline__ C sub(C a, C b) { return __dsub_rn(a, b); }
  static __device__ __forceinline__ C div(C a, C b) { return __ddiv_rn(a, b); }
  static __device__ __forceinline__ C tap(int i) { return c_taps_f64[i]; }
};

template <>
struct Arith<__nv_bfloat16> {
  using C = float;  // always holds a bf16 value
  static __device__ __forceinline__ C rnd(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ C ld(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 st(C v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ C mul(C a, C b) {
    return rnd(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ C add(C a, C b) {
    return rnd(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ C sub(C a, C b) {
    return rnd(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ C div(C a, C b) {
    return rnd(__fdiv_rn(a, b));
  }
  // the table is handed over already rounded to bf16, as f32
  static __device__ __forceinline__ C tap(int i) { return c_taps_f32[i]; }
};

struct Geometry {
  int Wp;          // padded state's row pitch
  int K;           // lanes (capacity)
  int th, tw;      // tile
  int gj;          // tiles per tile-grid row
  int ring;        // padding ring of the state
  int k;           // steps per pass (window ring)
  int orow, ocol;  // global origin of the state's interior
  int H, W;        // global grid
  int nsx;         // sub-tiles per tile row
};

template <typename T>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    fused_compute_kernel(const T* __restrict__ padded, T* __restrict__ upd,
                         int* __restrict__ anyf,
                         const int* __restrict__ ids,
                         const int* __restrict__ count,
                         const int* __restrict__ selfnz, Geometry g,
                         typename Arith<T>::C rate, int noff, int offcodes,
                         int mask9, int use_taps) {
  using A = Arith<T>;
  using C = typename A::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int l = static_cast<int>(blockIdx.x);
  const int cmax = min(max(count[0], 1), g.K);
  if (l >= cmax) return;  // uniform over the block
  const int t = ids[l];
  const int tr = t / g.gj;
  const int tc = t % g.gj;
  const int sy = static_cast<int>(blockIdx.y) / g.nsx;
  const int sx = static_cast<int>(blockIdx.y) % g.nsx;
  const int i0 = sy * SUB;
  const int j0 = sx * SUB;
  if (i0 >= g.th || j0 >= g.tw) return;
  const int sh = min(SUB, g.th - i0);
  const int sw = min(SUB, g.tw - j0);
  const int k = g.k;
  const int WH = sh + 2 * k;
  const int WW = sw + 2 * k;
  C* cur = reinterpret_cast<C*>(smem_raw);
  C* share = cur + WH * WW;
  // the window's [0, 0]: in the padded state, and as a global cell
  const int off = g.ring - k;
  const size_t pr = static_cast<size_t>(tr) * g.th + off + i0;
  const size_t pc = static_cast<size_t>(tc) * g.tw + off + j0;
  const int gr0 = g.orow + tr * g.th + i0 - k;
  const int gc0 = g.ocol + tc * g.tw + j0 - k;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  for (int i = ty; i < WH; i += mm::kThreadsY) {
    const T* src = padded + (pr + i) * g.Wp + pc;
    for (int j = tx; j < WW; j += mm::kThreadsX) {
      cur[i * WW + j] = A::ld(src[j]);
    }
  }
  __syncthreads();

  // lane-uniform choice of form (pallas_active.py's near/self predicates)
  const int tile_r0 = g.orow + tr * g.th;
  const int tile_c0 = g.ocol + tc * g.tw;
  const bool near = tile_r0 <= k || tile_r0 + g.th >= g.H - k ||
                    tile_c0 <= k || tile_c0 + g.tw >= g.W - k;
  const bool taps = use_taps && !near && selfnz[l] != 0;

  T* dst = upd + static_cast<size_t>(l) * g.th * g.tw;
  int nz = 0;
  if (taps) {
    const int ntap = 2 * k + 1;
    for (int i = ty; i < sh; i += mm::kThreadsY) {
      for (int j = tx; j < sw; j += mm::kThreadsX) {
        C acc = C(0);
        for (int dr = 0; dr < ntap; ++dr) {
          const C* row = cur + (i + dr) * WW + j;
          for (int dc = 0; dc < ntap; ++dc) {
            acc = A::add(acc, A::mul(A::tap(dr * ntap + dc), row[dc]));
          }
        }
        dst[(i0 + i) * g.tw + j0 + j] = A::st(acc);
        nz |= acc != C(0);
      }
    }
  } else {
    for (int s = 0; s < k; ++s) {
      // shares on the region [s, WH - s) x [s, WW - s)
      for (int i = s + ty; i < WH - s; i += mm::kThreadsY) {
        for (int j = s + tx; j < WW - s; j += mm::kThreadsX) {
          const C cnt = static_cast<C>(
              mm::neighbor_count_int(gr0 + i, gc0 + j, g.H, g.W, mask9));
          share[i * WW + j] = A::div(A::mul(rate, cur[i * WW + j]), cnt);
        }
      }
      __syncthreads();
      // update [s + 1, WH - s - 1): each thread reads and writes only its
      // own cells of `cur`, so the update is in place
      const bool last = s == k - 1;
      for (int i = s + 1 + ty; i < WH - s - 1; i += mm::kThreadsY) {
        for (int j = s + 1 + tx; j < WW - s - 1; j += mm::kThreadsX) {
          C inflow = C(0);
          for (int o = 0; o < noff; ++o) {
            const int b = (offcodes >> (4 * o)) & 0xF;
            inflow =
                A::add(inflow, share[(i + b / 3 - 1) * WW + (j + b % 3 - 1)]);
          }
          const C v = cur[i * WW + j];
          C out = A::add(A::sub(v, A::mul(rate, v)), inflow);
          if (!last) {
            out = A::mul(out, mm::on_grid(gr0 + i, gc0 + j, g.H, g.W)
                                  ? C(1)
                                  : C(0));
          }
          cur[i * WW + j] = out;
        }
      }
      __syncthreads();
    }
    for (int i = ty; i < sh; i += mm::kThreadsY) {
      for (int j = tx; j < sw; j += mm::kThreadsX) {
        const C v = cur[(i + k) * WW + (j + k)];
        dst[(i0 + i) * g.tw + j0 + j] = A::st(v);
        nz |= v != C(0);
      }
    }
  }
  if (__syncthreads_or(nz) && tx == 0 && ty == 0) atomicOr(anyf + l, 1);
}

// K7: land each live lane's tile in the padded state. E is an unsigned
// integer of the element's size: the copy moves bits.
template <typename E>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY)
    fused_scatter_kernel(E* __restrict__ padded, const E* __restrict__ upd,
                         const int* __restrict__ ids,
                         const int* __restrict__ count, int Wp, int K, int th,
                         int tw, int gj, int ring) {
  const int l = static_cast<int>(blockIdx.x);
  const int cmax = min(max(count[0], 1), K);
  if (l >= cmax) return;
  const int t = ids[l];
  const size_t r0 = static_cast<size_t>(t / gj) * th + ring;
  const size_t c0 = static_cast<size_t>(t % gj) * tw + ring;
  const E* src = upd + static_cast<size_t>(l) * th * tw;
  for (int i = threadIdx.y; i < th; i += mm::kThreadsY) {
    for (int j = threadIdx.x; j < tw; j += mm::kThreadsX) {
      padded[(r0 + i) * Wp + c0 + j] = src[i * tw + j];
    }
  }
}

template <typename T>
int launch_compute(const void* padded, void* upd, void* anyf,
                   const void* ids, const void* count, const void* selfnz,
                   const void* taps, Geometry g, double rate, int noff,
                   int offcodes, int mask9, void* stream) {
  using C = typename Arith<T>::C;
  if (g.k < 1 || g.k > MAX_K || g.ring < g.k || g.K < 1 || g.th < 1 ||
      g.tw < 1 || noff < 1 || noff > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntap = 2 * g.k + 1;
  cudaError_t e = cudaSuccess;
  if (taps != nullptr) {
    if (sizeof(C) == sizeof(double)) {
      e = cudaMemcpyToSymbolAsync(c_taps_f64, taps,
                                  sizeof(double) * ntap * ntap, 0,
                                  cudaMemcpyDeviceToDevice, st);
    } else {
      e = cudaMemcpyToSymbolAsync(c_taps_f32, taps,
                                  sizeof(float) * ntap * ntap, 0,
                                  cudaMemcpyDeviceToDevice, st);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int sub_h = min(SUB, g.th);
  const int sub_w = min(SUB, g.tw);
  const int smem = 2 * (sub_h + 2 * g.k) * (sub_w + 2 * g.k) *
                   static_cast<int>(sizeof(C));
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  if (smem > smem_limit) {
    e = cudaFuncSetAttribute(fused_compute_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_limit = smem;
  }
  g.nsx = (g.tw + SUB - 1) / SUB;
  const int nsy = (g.th + SUB - 1) / SUB;
  const dim3 grid(g.K, nsy * g.nsx);
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  fused_compute_kernel<T><<<grid, block, smem, st>>>(
      static_cast<const T*>(padded), static_cast<T*>(upd),
      static_cast<int*>(anyf), static_cast<const int*>(ids),
      static_cast<const int*>(count), static_cast<const int*>(selfnz), g,
      static_cast<C>(rate), noff, offcodes, mask9, taps != nullptr ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_scatter(void* padded, const void* upd, const void* ids,
                   const void* count, int Wp, int K, int th, int tw, int gj,
                   int ring, void* stream) {
  if (K < 1 || th < 1 || tw < 1 || ring < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  fused_scatter_kernel<E><<<K, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<E*>(padded), static_cast<const E*>(upd),
      static_cast<const int*>(ids), static_cast<const int*>(count), Wp, K, th,
      tw, gj, ring);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. `taps` is null for the
// iterated path only, else a device table of (2k+1)^2 values in the compute
// type (f64 for float64 grids, f32 holding bf16 values for bfloat16).
int mm_fused_compute(int dtype, const void* padded, void* upd, void* anyf,
                     const void* ids, const void* count, const void* selfnz,
                     const void* taps, int Wp, int K, int th, int tw, int gj,
                     int ring, int k, int orow, int ocol, int H, int W,
                     double rate, int noff, int offcodes, int mask9,
                     void* stream) {
  Geometry g{Wp, K, th, tw, gj, ring, k, orow, ocol, H, W, 0};
  switch (dtype) {
    case 0:
      return launch_compute<float>(padded, upd, anyf, ids, count, selfnz,
                                   taps, g, rate, noff, offcodes, mask9,
                                   stream);
    case 1:
      return launch_compute<double>(padded, upd, anyf, ids, count, selfnz,
                                    taps, g, rate, noff, offcodes, mask9,
                                    stream);
    case 2:
      return launch_compute<__nv_bfloat16>(padded, upd, anyf, ids, count,
                                           selfnz, taps, g, rate, noff,
                                           offcodes, mask9, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// itemsize: 2, 4 or 8 bytes
int mm_fused_scatter(int itemsize, void* padded, const void* upd,
                     const void* ids, const void* count, int Wp, int K,
                     int th, int tw, int gj, int ring, void* stream) {
  switch (itemsize) {
    case 2:
      return launch_scatter<uint16_t>(padded, upd, ids, count, Wp, K, th, tw,
                                      gj, ring, stream);
    case 4:
      return launch_scatter<uint32_t>(padded, upd, ids, count, Wp, K, th, tw,
                                      gj, ring, stream);
    case 8:
      return launch_scatter<uint64_t>(padded, upd, ids, count, Wp, K, th, tw,
                                      gj, ring, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int mm_fused_smem_bytes(int itemsize_compute, int th, int tw, int k) {
  const int sub_h = th < SUB ? th : SUB;
  const int sub_w = tw < SUB ? tw : SUB;
  return 2 * (sub_h + 2 * k) * (sub_w + 2 * k) * itemsize_compute;
}

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
