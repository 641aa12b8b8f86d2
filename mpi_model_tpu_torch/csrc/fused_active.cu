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
//   advances the tile's ring-k window of the padded state k transport steps,
//   then writes upd[l] (the [th, tw] tile) and sets anyf[l] (zeroed by the
//   caller) when any of it is nonzero. Two forms:
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
//   source is built with --fmad=false, so no multiply-add is contracted: the
//   pass equals its plain version bit for bit, both forms. bf16 is computed
//   as f32 rounded to bf16 after every operation, which is the correctly
//   rounded bf16 result (f32 carries more than 2*8+2 bits).
// K7, per live lane: copies upd[l] into the padded state at the tile's
//   place (offset by the ring). It is its own launch so that every K6
//   window reads the values from before the pass. A persistent grid of a
//   few blocks an SM walks the live lanes' rows (fused_scatter_kernel
//   below), each warp kScatterRows rows at a time in 16-byte chunks.
//
// What bounds them: bytes for K7 (each live tile read once and written
// once) and for K6 at k = 1 (each live tile's window read once, its tile
// written once); at k > 1 the tap flops on
// interior tiles (2 (2k+1)^2 a cell, each multiply and add an instruction
// of its own under --fmad=false). The design (k56_variants.py measures its
// choices on the H100; PERF.md):
//
//   - K6: a block a lane, the whole tile: the grid is K blocks and those
//     past the device count exit at once. Persistent blocks striding over
//     the live lanes (the kernel's lane loop; a grid of a few blocks an SM)
//     measured no faster. The host never reads the count. A block is
//     nw = ceil((tw + 2k) / 32) warps, up to 8 (5 for 128-wide tiles).
//   - The exact path is a register column walk (exact_walk.cuh): each
//     thread holds one window column of a band of kRows rows, loaded
//     straight from device memory (coalesced along the row; the padded
//     state's rows are rarely 16-byte aligned), and walks the k steps down
//     it, the c+-1 shares from the neighbouring lanes, one barrier a step.
//     A tile takes ceil(th / (kRows - 2k)) row bands of kRows - 2k outputs
//     (and, past 256 - 2k columns, column bands). Lanes away from the global
//     edge (the lane-uniform near test below: every window cell on the grid
//     with its full count) take the full count, when it is a power of two
//     as a multiply by its exact inverse, with no grid test or mask; edge
//     lanes (and neighbourhoods of other sizes) compute each cell's count
//     from its row's and column's on-grid bits and multiply by the grid
//     mask between steps.
//   - The tap sum stages the lane's window in shared memory, a chunk of
//     ch x cw outputs with its ring at a time (40 KB of f32 at most:
//     faster than 56 or 112 KB, the rest of the SM's 256 KB going to L1),
//     in the compute type, with an odd row pitch. Each thread owns kTapRows
//     x kTapSeg outputs (neighbouring threads neighbouring row groups); for
//     each staged row it loads the kTapSeg + 2k window values once into
//     registers and adds tap * value into every output row it serves, in
//     tap order, so each output's sum keeps the row-major order from 0.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch (or of the table copy), 0 on success.

#include <cstdint>

#include "exact_walk.cuh"

namespace {

using mm_exact::Arith;
using mm_exact::Cell;

constexpr int MAX_K = 16;
constexpr int MAX_TAPS = (2 * MAX_K + 1) * (2 * MAX_K + 1);
constexpr int SMEM_LIMIT = 232448;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;
// The walk's window rows: a band has kRows - 2k output rows.
constexpr int kRows = 48;
// A tap-sum thread's outputs: kTapRows rows of a run of kTapSeg.
constexpr int kTapSeg = 8;
constexpr int kTapRows = 2;

__constant__ double c_taps_f64[MAX_TAPS];
__constant__ float c_taps_f32[MAX_TAPS];

template <typename C>
__device__ __forceinline__ C tap_at(int i);
template <>
__device__ __forceinline__ float tap_at<float>(int i) {
  return c_taps_f32[i];
}
template <>
__device__ __forceinline__ double tap_at<double>(int i) {
  return c_taps_f64[i];
}

// Blocks an SM the instance asks registers for: f64 holds twice the values.
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 8 ? 1 : 2;

struct Geometry {
  int Wp;          // padded state's row pitch
  int K;           // lanes (capacity)
  int th, tw;      // tile
  int gj;          // tiles per tile-grid row
  int ring;        // padding ring of the state
  int k;           // steps per pass (window ring)
  int orow, ocol;  // global origin of the state's interior
  int H, W;        // global grid
  int nw;          // warps a block: the walk's window is 32 nw columns
  int bands_c;     // the walk's column bands a tile
  int ch, cw;      // the tap sum's chunk of the tile (rows, columns)
  int pitch;       // the chunk's staging row pitch (elements of C)
};

// Dynamic shared memory of a launch: the walk's exchange, and with a tap
// table the tap sum's staging, which reuses it (a lane takes one form); a
// launch without one passes ch = pitch = 0.
__host__ __device__ inline int smem_elems(int nw, int k, int ch, int pitch) {
  const int ex = mm_exact::exchange_elems(kRows, nw);
  const int st = ch > 0 ? (ch + 2 * k) * pitch : 0;
  return ex > st ? ex : st;
}

// The exact path on one lane: the tile's row and column bands in turn.
// `win` is the lane's window [0, 0] in the padded state (global cell
// (gr0, gc0)); `ex` the walk's exchange. Returns whether an output is
// nonzero.
template <typename T, bool INNER, unsigned CODES, int NOFF>
__device__ __forceinline__ int walk_lane(
    const T* __restrict__ win, T* __restrict__ dst, const Geometry& g,
    const Cell<typename Arith<T>::C>& cell, int gr0, int gc0,
    typename Arith<T>::C* ex) {
  using A = Arith<T>;
  using C = typename A::C;
  const int k = g.k;
  const int wh = g.th + 2 * k;
  const int ww = g.tw + 2 * k;
  const int orows = kRows - 2 * k;      // output rows a band
  const int ocols = 32 * g.nw - 2 * k;  // output columns a band
  const int bands = (g.th + orows - 1) / orows * g.bands_c;
  const int j = threadIdx.y * 32 + threadIdx.x;
  const int half = mm_exact::exchange_elems(kRows, g.nw) / 2;
  int nz = 0;
  int step = 0;  // steps walked, for the exchange's parity
  for (int b = 0; b < bands; ++b) {
    const int wr0 = b / g.bands_c * orows;  // the band's window in the lane's
    const int col = b % g.bands_c * ocols + j;
    const bool col_in = col < ww;
    C v[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      v[i] = col_in && wr0 + i < wh
                 ? A::ld(win[static_cast<size_t>(wr0 + i) * g.Wp + col])
                 : C(0);
    }
    const int c = gc0 + col;
    const int cb = INNER ? 7 : mm_exact::line_bits(c, g.W);
    const int cbo =
        INNER ? 7 : mm_exact::line_bits(threadIdx.x == 0 ? c - 1 : c + 1, g.W);
    for (int s = 0; s < k; ++s, ++step) {
      const bool mask = !INNER && s < k - 1;
      mm_exact::exact_step<kRows, INNER, A, CODES, NOFF>(
          v, ex + (step & 1) * half, cell, gr0 + wr0, cb, cbo,
          [&](int, C x, C of, C gin, int rb) {
            C out = A::add(A::sub(x, of), gin);
            if (mask) out = A::mul(out, (rb & 2) && (cb & 2) ? C(1) : C(0));
            return out;
          });
    }
    // rows [k, kRows - k) of columns [k, 32 nw - k) are the band's outputs
    if (j >= k && j < k + ocols && col - k < g.tw) {
      T* out = dst + (col - k);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int r = wr0 + i - k;
        if (i >= k && i < kRows - k && r < g.th) {
          out[static_cast<size_t>(r) * g.tw] = A::st(v[i]);
          nz |= v[i] != C(0);
        }
      }
    }
  }
  return nz;
}

// The tap sum on one lane, k = KT: chunk by chunk of ch x cw outputs, each
// chunk's window staged in `st`. A thread computes kTapRows x kTapSeg
// outputs (rows i0 .., columns p0 ..): for each staged row i0 + q it loads
// kTapSeg + 2k values into registers once and adds tap * value into every
// output row r it serves (tap row q - r), in tap order, so each output's
// sum keeps the row-major order from 0.
template <typename T, int KT>
__device__ __noinline__ int tap_lane(const T* __restrict__ win,
                                     T* __restrict__ dst, const Geometry& g,
                                     typename Arith<T>::C* st) {
  using A = Arith<T>;
  using C = typename A::C;
  constexpr int NT = 2 * KT + 1;
  constexpr int M = kTapSeg;
  constexpr int R = kTapRows;
  constexpr int WR = M + 2 * KT;
  const int nthr = 32 * blockDim.y;
  const int tid = threadIdx.y * 32 + threadIdx.x;
  int nz = 0;
  for (int r0 = 0; r0 < g.th; r0 += g.ch) {
    for (int c0 = 0; c0 < g.tw; c0 += g.cw) {
      const int hh = min(g.ch, g.th - r0);
      const int cw = min(g.cw, g.tw - c0);
      const int sr = hh + 2 * KT;
      const int sc = cw + 2 * KT;
      __syncthreads();  // the previous chunk's (or form's) reads are done
      for (int e = tid; e < sr * g.pitch; e += nthr) {
        const int i = e / g.pitch;
        const int q = e - i * g.pitch;
        st[e] = q < sc
                    ? A::ld(win[static_cast<size_t>(r0 + i) * g.Wp + c0 + q])
                    : C(0);
      }
      __syncthreads();
      const int nseg = (cw + M - 1) / M;
      const int ngrp = (hh + R - 1) / R;  // row groups
      for (int e = tid; e < ngrp * nseg; e += nthr) {
        const int i0 = e % ngrp * R;
        const int p0 = e / ngrp * M;
        C acc[R][M];
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
          for (int p = 0; p < M; ++p) acc[r][p] = C(0);
        }
#pragma unroll 1
        for (int q = 0; q < NT + R - 1; ++q) {
          // a row past the chunk serves only output rows past it (their
          // sums are dropped): read the last staged row instead
          const C* row = st + min(i0 + q, sr - 1) * g.pitch + p0;
          C w[WR];
#pragma unroll
          for (int x = 0; x < WR; ++x) w[x] = row[x];
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const int dr = q - r;
            if (dr >= 0 && dr < NT) {
#pragma unroll
              for (int dc = 0; dc < NT; ++dc) {
                const C t = tap_at<C>(dr * NT + dc);
#pragma unroll
                for (int p = 0; p < M; ++p) {
                  acc[r][p] = A::add(acc[r][p], A::mul(t, w[p + dc]));
                }
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (i0 + r < hh) {
            T* out = dst + static_cast<size_t>(r0 + i0 + r) * g.tw + c0 + p0;
#pragma unroll
            for (int p = 0; p < M; ++p) {
              if (p0 + p < cw) {
                out[p] = A::st(acc[r][p]);
                nz |= acc[r][p] != C(0);
              }
            }
          }
        }
      }
    }
  }
  return nz;
}

// The tap sum's instance of k.
template <typename T, int KT = 2>
__device__ __forceinline__ int tap_dispatch(int k, const T* __restrict__ win,
                                            T* __restrict__ dst,
                                            const Geometry& g,
                                            typename Arith<T>::C* st) {
  if constexpr (KT > MAX_K) {
    return 0;  // the host admits k <= MAX_K only
  } else {
    if (k == KT) return tap_lane<T, KT>(win, dst, g, st);
    return tap_dispatch<T, KT + 1>(k, win, dst, g, st);
  }
}

template <typename T, unsigned CODES, int NOFF>
__global__ void __launch_bounds__(256, kMinBlocks<T>)
    fused_compute_kernel(const T* __restrict__ padded, T* __restrict__ upd,
                         int* __restrict__ anyf,
                         const int* __restrict__ ids,
                         const int* __restrict__ count,
                         const int* __restrict__ selfnz, Geometry g,
                         typename Arith<T>::C rate, int noff, int offcodes,
                         int mask9, int use_taps) {
  using C = typename Arith<T>::C;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* sm = reinterpret_cast<C*>(smem_raw);
  const int cmax = min(max(count[0], 1), g.K);
  const Cell<C> cell =
      mm_exact::make_cell<C>(rate, mask9, noff, offcodes, g.H, g.W);
  const int k = g.k;
  for (int l = blockIdx.x; l < cmax; l += gridDim.x) {
    const int t = ids[l];
    const int tr = t / g.gj;
    const int tc = t % g.gj;
    // lane-uniform choice of form (pallas_active.py's near/self predicates)
    const int tile_r0 = g.orow + tr * g.th;
    const int tile_c0 = g.ocol + tc * g.tw;
    const bool near = tile_r0 <= k || tile_r0 + g.th >= g.H - k ||
                      tile_c0 <= k || tile_c0 + g.tw >= g.W - k;
    const bool taps = use_taps && !near && selfnz[l] != 0;
    const T* win = padded +
                   (static_cast<size_t>(tr) * g.th + g.ring - k) * g.Wp +
                   static_cast<size_t>(tc) * g.tw + g.ring - k;
    T* dst = upd + static_cast<size_t>(l) * g.th * g.tw;
    int nz;
    if (taps) {
      nz = tap_dispatch<T>(k, win, dst, g, sm);
    } else if (near || cell.inv == C(0)) {
      nz = walk_lane<T, false, CODES, NOFF>(win, dst, g, cell, tile_r0 - k,
                                            tile_c0 - k, sm);
    } else {
      nz = walk_lane<T, true, CODES, NOFF>(win, dst, g, cell, tile_r0 - k,
                                           tile_c0 - k, sm);
    }
    // also the barrier before the next lane reuses shared memory
    if (__syncthreads_or(nz) && threadIdx.x == 0 && threadIdx.y == 0) {
      anyf[l] = 1;
    }
  }
}

// K7: land each live lane's tile in the padded state, a persistent walk
// over the live lanes' rows: the rows of lanes l < clip(count, 1, K) (the
// count read on the device, as K6's lane loop reads it) are one sequence
// of cmax * th rows, upd's own order, and each warp of a grid of a few
// blocks an SM takes kScatterRows consecutive rows of it at a time: the
// rows' places in the state (their tiles' ids) read first, then all their
// loads in flight before any store. E is an unsigned integer of the
// element's size: the copy moves bits, so it is bit for bit by
// construction, and the state's other bytes are not touched. With `wide`
// (the host's check: the update rows, tw elements, are whole 16-byte
// chunks, and the buffer is 16-byte aligned) a lane loads chunk q of an
// update row with one 16-byte load and stores the destination row's
// aligned chunks whole: the destination row starts `head` elements before
// a 16-byte boundary (its column is t % gj * tw + ring, its pitch Wp: any
// alignment), so destination chunk q takes the last V - head elements of
// update chunk q and the first head of chunk q + 1, the next lane's (one
// shuffle of four words; past 32 chunks the last lane loads it itself),
// joined by a funnel shift of head * sizeof(E) bytes; the lanes holding
// the row's first and last chunks store its head and tail element by
// element from their registers. Otherwise every element moves alone. A TMA
// copy would need 16-byte multiples for the state's row pitch, which ring
// 1 at 16384 columns (16386 * 4 bytes) is not.
// rows a warp has in flight, and persistent blocks an SM: of 2, 4, 8 and
// 16 rows at 1 to 8 blocks an SM, 4 rows at 3 blocks measured fastest on
// the H100 (k56_variants.py, PERF.md)
constexpr int kScatterRows = 4;
constexpr int kScatterBlocksPerSM = 3;

// Word i of the 32 bytes a ++ b.
__device__ __forceinline__ unsigned word_of(const uint4& a, const uint4& b,
                                            int i) {
  switch (i) {
    case 0: return a.x;
    case 1: return a.y;
    case 2: return a.z;
    case 3: return a.w;
    case 4: return b.x;
    case 5: return b.y;
    case 6: return b.z;
    default: return b.w;
  }
}

// The 16 bytes of a ++ b from byte `off` (even, below 16).
__device__ __forceinline__ uint4 bytes_from(const uint4& a, const uint4& b,
                                            int off) {
  const int k = off >> 2;
  const unsigned sh = static_cast<unsigned>(off & 3) * 8u;
  uint4 r;
  r.x = __funnelshift_r(word_of(a, b, k), word_of(a, b, k + 1), sh);
  r.y = __funnelshift_r(word_of(a, b, k + 1), word_of(a, b, k + 2), sh);
  r.z = __funnelshift_r(word_of(a, b, k + 2), word_of(a, b, k + 3), sh);
  r.w = __funnelshift_r(word_of(a, b, k + 3), word_of(a, b, k + 4), sh);
  return r;
}

// Where row r of the live rows lands: row r % th of lane r / th's tile.
template <typename E>
__device__ __forceinline__ E* dst_row(E* __restrict__ padded,
                                      const int* __restrict__ ids, int r,
                                      int Wp, int th, int tw, int gj,
                                      int ring) {
  const int l = r / th;
  const int t = ids[l];
  return padded +
         (static_cast<size_t>(t / gj) * th + (r - l * th) + ring) * Wp +
         static_cast<size_t>(t % gj) * tw + ring;
}

// Element k of the 16 bytes in a (E of 2, 4 or 8 bytes).
template <typename E>
__device__ __forceinline__ E elem_of(const uint4& a, int k) {
  constexpr int S = static_cast<int>(sizeof(E));
  const unsigned w = word_of(a, a, k * S / 4);
  if constexpr (S == 2) {
    return static_cast<E>((k & 1) ? w >> 16 : w & 0xFFFFu);
  } else if constexpr (S == 4) {
    return static_cast<E>(w);
  } else {
    return static_cast<E>(w) |
           (static_cast<E>(word_of(a, a, 2 * k + 1)) << 32);
  }
}

// One warp's rows r0 .. r0 + kScatterRows - 1 (those below `rows`) in
// 16-byte chunks; upd's row r starts at upd + r * tw. The destination rows
// (their tiles' ids) are read first, then every row's chunks are loaded
// before any is stored. NEXT: rows of more than 32 chunks, whose last lane
// loads its chunk q + 1 itself (a row of at most 32 chunks has none past
// its last lane).
template <typename E, bool NEXT>
__device__ __forceinline__ void copy_rows_wide(E* __restrict__ padded,
                                               const E* __restrict__ upd,
                                               const int* __restrict__ ids,
                                               int r0, int rows, int Wp,
                                               int th, int tw, int gj,
                                               int ring) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  const int lane = threadIdx.x;
  const int nch = tw / V;  // 16-byte chunks of an update row
  E* drow[kScatterRows];
#pragma unroll
  for (int u = 0; u < kScatterRows; ++u) {
    drow[u] = r0 + u < rows ? dst_row(padded, ids, r0 + u, Wp, th, tw, gj,
                                      ring)
                            : padded;
  }
  for (int p0 = 0; p0 < nch; p0 += 32) {
    const int q = p0 + lane;
    uint4 a[kScatterRows];
    uint4 b[NEXT ? kScatterRows : 1];
#pragma unroll
    for (int u = 0; u < kScatterRows; ++u) {
      const uint4* row = reinterpret_cast<const uint4*>(
          upd + static_cast<size_t>(r0 + u) * tw);
      const bool in = r0 + u < rows;
      a[u] = in && q < nch ? row[q] : make_uint4(0u, 0u, 0u, 0u);
      if constexpr (NEXT) {
        b[u] = lane == 31 && in && q + 1 < nch ? row[q + 1]
                                               : make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < kScatterRows; ++u) {
      if (r0 + u >= rows) break;  // warp-uniform
      // chunk q + 1: the next lane's
      uint4 n = make_uint4(__shfl_down_sync(mm::kFull, a[u].x, 1),
                           __shfl_down_sync(mm::kFull, a[u].y, 1),
                           __shfl_down_sync(mm::kFull, a[u].z, 1),
                           __shfl_down_sync(mm::kFull, a[u].w, 1));
      if constexpr (NEXT) {
        if (lane == 31) n = b[u];
      }
      E* d = drow[u];
      // elements before the row's first 16-byte boundary (warp-uniform)
      const int head =
          static_cast<int>((16u - reinterpret_cast<uintptr_t>(d) % 16u) %
                           16u) / static_cast<int>(sizeof(E));
      if (head == 0) {
        if (q < nch) *reinterpret_cast<uint4*>(d + q * V) = a[u];
        continue;
      }
      // the aligned chunks (nch - 1 of them), then the head from chunk 0
      // and the tail from the last chunk, each by the lane that holds it
      if (q < nch - 1) {
        *reinterpret_cast<uint4*>(d + head + q * V) =
            bytes_from(a[u], n, head * static_cast<int>(sizeof(E)));
      }
      if (q == 0) {
        for (int k = 0; k < head; ++k) d[k] = elem_of<E>(a[u], k);
      }
      if (q == nch - 1) {
        for (int k = head; k < V; ++k) d[q * V + k] = elem_of<E>(a[u], k);
      }
    }
  }
}

// The same rows element by element (any tw, any alignment).
template <typename E>
__device__ __forceinline__ void copy_rows_scalar(E* __restrict__ padded,
                                                 const E* __restrict__ upd,
                                                 const int* __restrict__ ids,
                                                 int r0, int rows, int Wp,
                                                 int th, int tw, int gj,
                                                 int ring) {
  const int lane = threadIdx.x;
  E* drow[kScatterRows];
#pragma unroll
  for (int u = 0; u < kScatterRows; ++u) {
    drow[u] = r0 + u < rows ? dst_row(padded, ids, r0 + u, Wp, th, tw, gj,
                                      ring)
                            : padded;
  }
  for (int j0 = 0; j0 < tw; j0 += 32) {
    const int j = j0 + lane;
    E x[kScatterRows];
#pragma unroll
    for (int u = 0; u < kScatterRows; ++u) {
      x[u] = r0 + u < rows && j < tw
                 ? upd[static_cast<size_t>(r0 + u) * tw + j]
                 : E(0);
    }
#pragma unroll
    for (int u = 0; u < kScatterRows; ++u) {
      if (r0 + u >= rows) break;
      if (j < tw) drow[u][j] = x[u];
    }
  }
}

template <typename E>
__global__ void __launch_bounds__(mm::kThreadsX* mm::kThreadsY,
                                  kScatterBlocksPerSM)
    fused_scatter_kernel(E* __restrict__ padded, const E* __restrict__ upd,
                         const int* __restrict__ ids,
                         const int* __restrict__ count, int Wp, int K, int th,
                         int tw, int gj, int ring, int wide) {
  const int cmax = min(max(count[0], 1), K);
  const int rows = cmax * th;  // the live lanes' rows, in upd's order
  const int warps = static_cast<int>(gridDim.x * blockDim.y);
  const int warp = static_cast<int>(blockIdx.x * blockDim.y + threadIdx.y);
  for (int r0 = warp * kScatterRows; r0 < rows;
       r0 += warps * kScatterRows) {
    if (wide && tw * static_cast<int>(sizeof(E)) > 32 * 16) {
      copy_rows_wide<E, true>(padded, upd, ids, r0, rows, Wp, th, tw, gj,
                              ring);
    } else if (wide) {
      copy_rows_wide<E, false>(padded, upd, ids, r0, rows, Wp, th, tw, gj,
                               ring);
    } else {
      copy_rows_scalar(padded, upd, ids, r0, rows, Wp, th, tw, gj, ring);
    }
  }
}

// K7's grid: kScatterBlocksPerSM blocks an SM of the current device, at
// most one a lane.
cudaError_t scatter_blocks(int K, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int most = kScatterBlocksPerSM * sms;
  *blocks = K < most ? K : most;
  return e;
}

bool valid(const Geometry& g, int noff, int itemsize, bool taps) {
  const int orows = kRows - 2 * g.k;
  const int ocols = 32 * g.nw - 2 * g.k;
  if (g.k < 1 || g.k > MAX_K || g.ring < g.k || g.K < 1 || g.th < 1 ||
      g.tw < 1 || g.gj < 1 || noff < 1 || noff > 8 || g.nw < 1 ||
      g.nw > 8 || orows < 1 || ocols < 1 || g.bands_c < 1 ||
      g.bands_c * ocols < g.tw) {
    return false;
  }
  if (taps && (g.k < 2 || g.ch < 1 || g.cw < 1 ||
               g.pitch < (g.cw + kTapSeg - 1) / kTapSeg * kTapSeg + 2 * g.k)) {
    return false;
  }
  return smem_elems(g.nw, g.k, g.ch, g.pitch) * itemsize <= SMEM_LIMIT;
}

template <typename T, unsigned CODES, int NOFF>
int launch_kernel(const void* padded, void* upd, void* anyf, const void* ids,
                  const void* count, const void* selfnz, const Geometry& g,
                  double rate, int noff, int offcodes, int mask9,
                  int use_taps, cudaStream_t st) {
  using C = typename Arith<T>::C;
  const auto kernel = fused_compute_kernel<T, CODES, NOFF>;
  const int smem = smem_elems(g.nw, g.k, g.ch, g.pitch) *
                   static_cast<int>(sizeof(C));
  static int limit = DEFAULT_SMEM_LIMIT;  // per kernel instance
  if (smem > limit) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    limit = smem;
  }
  const int blocks = g.K;  // a block a lane
  kernel<<<blocks, dim3(32, g.nw), smem, st>>>(
      static_cast<const T*>(padded), static_cast<T*>(upd),
      static_cast<int*>(anyf), static_cast<const int*>(ids),
      static_cast<const int*>(count), static_cast<const int*>(selfnz), g,
      static_cast<C>(rate), noff, offcodes, mask9, use_taps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_compute(const void* padded, void* upd, void* anyf,
                   const void* ids, const void* count, const void* selfnz,
                   const void* taps, const Geometry& g, double rate,
                   int noff, int offcodes, int mask9, void* stream) {
  using C = typename Arith<T>::C;
  if (!valid(g, noff, static_cast<int>(sizeof(C)), taps != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int ntap = 2 * g.k + 1;
  if (taps != nullptr) {
    const cudaError_t e =
        sizeof(C) == sizeof(double)
            ? cudaMemcpyToSymbolAsync(c_taps_f64, taps,
                                      sizeof(double) * ntap * ntap, 0,
                                      cudaMemcpyDeviceToDevice, st)
            : cudaMemcpyToSymbolAsync(c_taps_f32, taps,
                                      sizeof(float) * ntap * ntap, 0,
                                      cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int use_taps = taps != nullptr ? 1 : 0;
  if (noff == 8 && static_cast<unsigned>(offcodes) == mm_exact::kMooreCodes) {
    return launch_kernel<T, mm_exact::kMooreCodes, 8>(
        padded, upd, anyf, ids, count, selfnz, g, rate, noff, offcodes, mask9,
        use_taps, st);
  }
  return launch_kernel<T, 0u, 0>(padded, upd, anyf, ids, count, selfnz, g,
                                 rate, noff, offcodes, mask9, use_taps, st);
}

template <typename E>
int launch_scatter(void* padded, const void* upd, const void* ids,
                   const void* count, int Wp, int K, int th, int tw, int gj,
                   int ring, void* stream) {
  if (K < 1 || th < 1 || tw < 1 || ring < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int blocks = 0;
  const cudaError_t e = scatter_blocks(K, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int wide = (tw * static_cast<int>(sizeof(E))) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(upd) % 16 == 0;
  const dim3 block(mm::kThreadsX, mm::kThreadsY);
  fused_scatter_kernel<E><<<blocks, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<E*>(padded), static_cast<const E*>(upd),
      static_cast<const int*>(ids), static_cast<const int*>(count), Wp, K, th,
      tw, gj, ring, wide);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = float64, 2 = bfloat16. `taps` is null for the
// iterated path only, else a device table of (2k+1)^2 values in the compute
// type (f64 for float64 grids, f32 holding bf16 values for bfloat16). nw,
// bands_c, ch, cw and pitch are the launch geometry
// (ops/fused_active.py::launch_geometry).
int mm_fused_compute(int dtype, const void* padded, void* upd, void* anyf,
                     const void* ids, const void* count, const void* selfnz,
                     const void* taps, int Wp, int K, int th, int tw, int gj,
                     int ring, int k, int orow, int ocol, int H, int W,
                     double rate, int noff, int offcodes, int mask9, int nw,
                     int bands_c, int ch, int cw, int pitch, void* stream) {
  const Geometry g{Wp, K,    th,   tw,      gj, ring, k,  orow,
                   ocol, H, W, nw, bands_c, ch, cw,   pitch};
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

// K7's blocks for a capacity of K lanes on the current device (-1 on an
// error).
int mm_fused_scatter_blocks(int K) {
  int blocks = 0;
  return scatter_blocks(K, &blocks) == cudaSuccess ? blocks : -1;
}

// K6's dynamic shared memory for a launch of this geometry.
int mm_fused_smem_bytes(int itemsize_compute, int nw, int k, int ch,
                        int pitch) {
  return smem_elems(nw, k, ch, pitch) * itemsize_compute;
}

// The source's choices the wrapper mirrors: walk rows, tap run and rows.
int mm_fused_walk_rows() { return kRows; }
int mm_fused_tap_seg() { return kTapSeg; }
int mm_fused_tap_rows() { return kTapRows; }

const char* mm_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
