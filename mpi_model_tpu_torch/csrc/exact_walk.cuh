// The exact transport step as a register column walk, shared by K5
// (pipeline_stencil.cu: the cells of its near TPU tiles) and K6
// (fused_active.cu: the iterated path of a live lane's tile window).
//
// A block of nw warps (nw = blockDim.y) holds a ROWS x 32 nw window of the
// grid in registers, one window column a thread (warp = threadIdx.y,
// column = warp * 32 + lane). One step, for every cell of the window:
//   of    = rate * v
//   share = of / cnt             cnt: the cell's in-grid neighbour count,
//                                clamped to >= 1 (mm::neighbor_count_int)
//   g     = 0 + share[d0] + share[d1] + ...   in `offsets` order
//   v'    = finish(v, of, g)     (K6: (v - of) + g; K5: v * keep + g)
// with every operation an explicitly rounded intrinsic of the arithmetic A
// (f32, f64, or f32 rounded to bf16 after each operation), so that no
// multiply-add is contracted and the walk does, cell for cell, the
// arithmetic of the shared-memory form it replaces.
//
// A step goes down the rows once: row i's shares are computed from its
// pre-step values, the c-1 and c+1 shares come from the neighbouring lanes
// (__shfl_sync), and row i-1 is finished from the shares of rows i-2, i-1
// and i (a rolling 3 x 3 in registers). A warp's two outer columns belong to
// the neighbouring warps: their edge lanes publish their columns' pre-step
// values in shared memory (double-buffered by step parity, so one block
// barrier a step), and lanes 0 and 31 compute those columns' shares
// themselves. Rows and columns past the window read 0, so its outer ring is
// garbage that moves in one cell a step.
//
// INNER: the caller knows that every cell whose count or grid test reaches
// an output lies on the grid with its full neighbourhood, and that the full
// count is a power of two (Moore's 8, von Neumann's 4): the share is a
// multiply by its exact inverse, which rounds as the division does, and no
// grid test is made. Otherwise each cell's count comes from its row's and
// column's on-grid bits (a power of two again a multiply, others a
// division).
//
// CODES/NOFF: the offsets as a compile-time constant (4 bits an offset,
// (dx + 1) * 3 + (dy + 1)), so that the ordered sum reads the rolling 3 x 3
// by constant indices; CODES = 0 decodes the call's runtime offsets.

#pragma once

#include "stencil_common.cuh"

namespace mm_exact {

constexpr unsigned kMooreCodes = 0x87653210u;  // MOORE_OFFSETS, row-major
// Keep the walk's rows in order, kFenceRows at a time (as K4's walk does):
// the compiler must not compute rows far ahead into registers.
constexpr int kFenceRows = 8;

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
};

// bf16 storage computed as f32 rounded to bf16 after every operation: the
// correctly rounded bf16 result (f32 carries more than 2 * 8 + 2 bits).
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
};

// What a step needs besides the window.
template <typename C>
struct Cell {
  C rate;          // share = (rate * v) / cnt
  C inv;           // the full count's exact inverse when it is a power of
                   // two (INNER), else 0
  int mask9;       // the neighbourhood as a 3 x 3 bitmask (the counts)
  int noff, offcodes;  // the ordered offsets (CODES = 0)
  int H, W;        // the global grid
};

template <typename C>
__device__ __forceinline__ Cell<C> make_cell(C rate, int mask9, int noff,
                                             int offcodes, int H, int W) {
  Cell<C> k;
  const int full = __popc(mask9);
  k.rate = rate;
  k.inv = (full & (full - 1)) == 0 ? static_cast<C>(__frcp_rn(float(full)))
                                   : C(0);
  k.mask9 = mask9;
  k.noff = noff;
  k.offcodes = offcodes;
  k.H = H;
  k.W = W;
  return k;
}

// Bit q set when line x - 1 + q lies in [0, n).
__device__ __forceinline__ int line_bits(int x, int n) {
  return (x >= 1 && x <= n ? 1 : 0) | (x >= 0 && x < n ? 2 : 0) |
         (x >= -1 && x < n - 1 ? 4 : 0);
}

// The in-grid count of the cell whose row and column bits are rb and cb,
// clamped to >= 1: mm::neighbor_count_int, bit b of mask9 being the cell
// (r + b / 3 - 1, c + b % 3 - 1).
__device__ __forceinline__ int count_of(int rb, int cb, int mask9) {
  const int m = ((rb & 1) ? cb : 0) | ((rb & 2) ? cb << 3 : 0) |
                ((rb & 4) ? cb << 6 : 0);
  const int n = __popc(m & mask9);
  return n > 0 ? n : 1;
}

// A cell's share of its outflow `of`.
template <bool INNER, class A>
__device__ __forceinline__ typename A::C share_of(
    const Cell<typename A::C>& k, typename A::C of, int rb, int cb) {
  using C = typename A::C;
  if constexpr (INNER) {
    return A::mul(of, k.inv);  // the full count, a power of two
  } else {
    const int cnt = count_of(rb, cb, k.mask9);
    return (cnt & (cnt - 1)) == 0
               ? A::mul(of, static_cast<C>(__frcp_rn(float(cnt))))
               : A::div(of, static_cast<C>(cnt));
  }
}

// 0 + S[d0] + S[d1] + ... in offsets order; S[1 + dx][1 + dy].
template <class A, unsigned CODES, int NOFF>
__device__ __forceinline__ typename A::C inflow(
    const typename A::C (&S)[3][3], const Cell<typename A::C>& k) {
  using C = typename A::C;
  C g = C(0);
  if constexpr (CODES != 0) {
#pragma unroll
    for (int o = 0; o < NOFF; ++o) {
      const int b = static_cast<int>((CODES >> (4 * o)) & 0xFu);
      g = A::add(g, S[b / 3][b % 3]);
    }
  } else {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      if (o < k.noff) {
        const int b = (k.offcodes >> (4 * o)) & 0xF;
        const int dr = b / 3;
        const int dc = b % 3;
        const C up = dc == 0 ? S[0][0] : (dc == 1 ? S[0][1] : S[0][2]);
        const C mid = dc == 0 ? S[1][0] : (dc == 1 ? S[1][1] : S[1][2]);
        const C dn = dc == 0 ? S[2][0] : (dc == 1 ? S[2][1] : S[2][2]);
        g = A::add(g, dr == 0 ? up : (dr == 1 ? mid : dn));
      }
    }
  }
  return g;
}

// x, as a value the compiler must take as changed here, in program order
// with every other fence and memory access.
__device__ __forceinline__ void fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void fence(double& x) {
  asm volatile("" : "+d"(x)::"memory");
}
__device__ __forceinline__ void fence(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// Shared memory of the walk's exchange, in elements of C: [2 parities][nw
// warps][2 sides][ROWS].
__host__ __device__ constexpr int exchange_elems(int rows, int nw) {
  return 2 * nw * 2 * rows;
}

// 16 bytes of C, the exchange's unit: a column is published and read this
// many rows at a time.
template <typename C>
struct Vec;
template <>
struct Vec<float> {
  using V = float4;
  static constexpr int n = 4;
  static __device__ __forceinline__ float get(const float4& v, int q) {
    return mm::part(v, q);
  }
  static __device__ __forceinline__ float4 make(const float* x) {
    return make_float4(x[0], x[1], x[2], x[3]);
  }
};
template <>
struct Vec<double> {
  using V = double2;
  static constexpr int n = 2;
  static __device__ __forceinline__ double get(const double2& v, int q) {
    return q == 0 ? v.x : v.y;
  }
  static __device__ __forceinline__ double2 make(const double* x) {
    return make_double2(x[0], x[1]);
  }
};

// One exact step of the window held in v (v[i]: window row i of this
// thread's column; global row r0 + i). `ex` is this step's half of the
// exchange ([nw][2][ROWS], 16-byte aligned); cb is this column's on-grid
// bits, cbo those of the column beside the warp that lanes 0 (left) and 31
// (right) compute. Row i's new value is finish(i, v, of, g, rb) with rb its
// row's on-grid bits (7 when INNER). INNER needs a power-of-two full count
// (k.inv != 0). Starts with one __syncthreads(). No lane branches inside
// the walk: every lane reads a published column (lanes other than 0 and 31,
// and those at the block's edge, read one they then ignore) and selects.
template <int ROWS, bool INNER, class A, unsigned CODES, int NOFF,
          class Finish>
__device__ __forceinline__ void exact_step(typename A::C (&v)[ROWS],
                                           typename A::C* ex,
                                           const Cell<typename A::C>& k,
                                           int r0, int cb, int cbo,
                                           Finish finish) {
  using C = typename A::C;
  using X = Vec<C>;
  static_assert(ROWS % 4 == 0, "the exchange moves four rows at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int nw = blockDim.y;
  const bool edge = lane == 0 || lane == 31;
  // 1. the warp's edge lanes publish their columns' pre-step values
  if (edge) {
    auto* dst = reinterpret_cast<typename X::V*>(
        ex + (2 * wp + (lane == 31 ? 1 : 0)) * ROWS);
#pragma unroll
    for (int i = 0; i < ROWS; i += X::n) dst[i / X::n] = X::make(v + i);
  }
  __syncthreads();
  // lane 0 reads the left warp's lane 31, lane 31 the right warp's lane 0;
  // past the block's edge the column is 0
  const int nbw = lane == 0 ? wp - 1 : wp + 1;
  const bool has = edge && nbw >= 0 && nbw < nw;
  const auto* side = reinterpret_cast<const typename X::V*>(
      ex + (has ? 2 * nbw + (lane == 0 ? 1 : 0) : 2 * wp) * ROWS);

  // 2. the walk down the rows
  C S[3][3];  // shares of rows i-2, i-1, i in columns c-1, c, c+1
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) S[a][b] = C(0);
  }
  C px = C(0), pof = C(0);
  int prb = 7;
  typename X::V e{};  // the published column, X::n rows
  constexpr int F = kFenceRows > 0 ? kFenceRows : ROWS + 1;
  int rg = r0;  // the global row of the fence group's first row
#pragma unroll
  for (int i = 0; i <= ROWS; ++i) {
    if (kFenceRows > 0 && i % F == 0) {
      rg = r0 + i;
      fence(rg);
#pragma unroll
      for (int q = i; q < i + F && q < ROWS; ++q) fence(v[q]);
    }
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      S[0][b] = S[1][b];
      S[1][b] = S[2][b];
      S[2][b] = C(0);
    }
    C x = C(0), of = C(0);
    int rb = 7;
    if (i < ROWS) {
      if constexpr (!INNER) rb = line_bits(rg + i % F, k.H);
      if (i % X::n == 0) e = side[i / X::n];
      x = v[i];
      of = A::mul(k.rate, x);
      const C sc = share_of<INNER, A>(k, of, rb, cb);
      const C xo = has ? X::get(e, i % X::n) : C(0);
      const C so = share_of<INNER, A>(k, A::mul(k.rate, xo), rb, cbo);
      const C sl = __shfl_up_sync(mm::kFull, sc, 1);
      const C sr = __shfl_down_sync(mm::kFull, sc, 1);
      S[2][0] = lane == 0 ? so : sl;
      S[2][1] = sc;
      S[2][2] = lane == 31 ? so : sr;
    }
    if (i >= 1) {
      v[i - 1] = finish(i - 1, px, pof, inflow<A, CODES, NOFF>(S, k), prb);
    }
    if (kFenceRows > 0 && i % F == F - 1) {
      // the group's finished rows end here
#pragma unroll
      for (int q = i - F; q < i; ++q) {
        if (q >= 0) fence(v[q]);
      }
    }
    px = x;
    pof = of;
    prb = rb;
  }
}

}  // namespace mm_exact
