// K4 and K4-halo: the fused multi-channel field step, written by hand for
// Hopper (sm_90a). This header is the body; each lowered flow set brings its
// own outflow function (ops/field_codegen.py generates it), and the two are
// compiled together into one library per flow set.
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_field_call
// in dense mode (K4, the pl.pallas_call reached through PallasFieldStep) and
// in halo mode (K4-halo, pallas_field_halo_step, used by
// parallel/executors.py::ShardMapExecutor's "field" plan). It computes what
// that kernel computes: `nsteps` steps of the summed-outflow update over the
// channels of one [H, W] grid, in one read of every loaded channel and one
// write of every written channel. Each step:
//   1. every flow's outflow at every cell, from the values before the step
//      (off-grid cells shed nothing: the affine-flow guard);
//   2. outflows summed per written channel, in flow order;
//   3. share = of / cnt, cnt the cell's in-grid neighbour count (>= 1);
//   4. inflow = 0 + each neighbour's share, in `offsets` order;
//   5. new = (v - of) + inflow, re-zeroed off the grid.
// Channels no flow writes (modulators) are read, never written.
//
// The TPU kernel calls each flow's own outflow in its body, so Mosaic
// compiles one kernel per flow set. The port lowers the flows once
// (ops/field_lower.py) and generates, per lowered program, one __device__
// function that computes every written channel's summed outflow at one cell
// from the cell's channel values and its global row and column: one named
// register and one _rn intrinsic per instruction, in program order. A
// program is a struct P:
//   P::kOut, P::kMod       written channels, modulators (kModSlots =
//                          max(kMod, 1), the modulator array's length)
//   P::kOffsets, P::kOffCodes   the neighbourhood in `offsets` order, 4 bits
//                          an offset: (dx + 1) * 3 + (dy + 1)
//   P::outflow(w, m, r, c, of)  w: the written channels' values, m: the
//                          modulators', (r, c): the cell's global row and
//                          column; of: the summed outflows.
//
// Design. The interpreter this replaces ran each instruction as a pass over
// shared-memory planes, about 1000 instructions a cell-step, bound by issue.
// Here:
//   - K1's register column walk (stencil_common.cuh): a block of 8 warps
//     steps a ROWS x 256 window, one window column a thread, every written
//     channel's column in registers. Modulators are staged once, in the
//     storage dtype, in shared memory. Windows that lie inside the array (the
//     shard, for K4-halo) arrive by cp.async; others element by element
//     through mm::HaloSource (zero off the grid, the ghost ring past the
//     shard). A dense grid is a shard with a ring of depth 0.
//   - One step goes down the rows: row k's outflows from its pre-step values
//     (the generated function), its shares, and v - of kept in place (a
//     cell's outflow reads only its own cell); the shares of columns c-1 and
//     c+1 from the neighbouring lanes (__shfl_sync); then row k-1 finished as
//     (v - of) + inflow. A warp's two outer columns belong to the
//     neighbouring warps: their edge lanes publish their values before the
//     step (double-buffered by step parity, so one block barrier a step),
//     and each warp computes those two columns' shares itself, spread over
//     its 32 lanes, into a warp-private row.
//   - The inflow is 0 + share[d0] + ... + share[dk-1] in `offsets` order, as
//     ops/stencil.py::gather_neighbors adds it; the leading 0 + turns a -0
//     share into +0. Where the offsets go down the rows (Moore, von Neumann)
//     the sums are carried as rows arrive, two partial sums a channel; other
//     orders keep the 3 x 3 of shares.
//   - share = of * (1/k) where the count k is a power of two (of * 2^-e and
//     of / 2^e are the same real number, rounded once), __fdiv_rn otherwise.
//   - Windows that lie, with their outer ring, on the global grid
//     (mm::Tiling::interior) compile the grid test and the count out; other
//     windows test each cell in registers. Both give the same bits.
//   - The window's outer ring computes garbage that moves in one cell a
//     step; rows [n, ROWS - n) of columns [n, 256 - n) are written.
//   - Registers: a thread holds kOut x ROWS window values. Left alone, the
//     compiler computes rows ahead (their outflows, counts and coordinates
//     depend only on values it already holds) and hoists per-row work out
//     of the step loop, and spilled 1.1 KB a thread for config 4 at 48 rows
//     and 128 registers. Empty asm fences on each group of kFenceRows rows'
//     values and first row index keep the walk in order; groups of 8 were
//     fastest (k4_variants.py, PERF.md).
//
// Bitwise contract: every operation is an _rn intrinsic in the plain
// version's order (ops/field_stencil.py::field_step_plain: build_outflow,
// then transport), and the unit builds with --fmad=false, so K4 equals its
// plain version bit for bit at f32 and at bf16 (both compute in f32 and
// round once per call). exp is CUDA's expf (not the fast __expf); the plain
// version's exp may differ from it by an ulp, so flows using exp are held
// to a tolerance instead.
//
// bf16 interior math (compute_dtype=bfloat16; mm_field_cbf16_* entry
// points, launch16): the TPU kernel runs its tiles that are not near the
// edge in bf16 and its near tiles in plain f32 (pallas_stencil.py:1290,
// :1334). The host passes the former's cells as one rectangle of global
// rows and columns (FieldCall::br0..bc1). A call is two launches on the
// stream, each writing only its own cells (in and out are distinct
// buffers): the f32 walk above over the cells outside the rectangle
// (field_kernel_near: tiles wholly inside it return), and a second walk
// over the cells in it (field_kernel16, on a tiling of its own window rows
// FieldCall::rows16: tiles with no cell in it return): the bf16 program
// (ProgramBf16: every bf16 result of the lowered flows rounded,
// ops/field_lower.py) over the channels rounded to bf16, with share =
// rb(of * (1/k)) (or rb(of / k)), the inflow from 0 in `offsets` order with
// each add rounded and rb(rb(v - of) + inflow). Those cells have their
// whole n-cone on the grid with full counts, so that walk takes the
// interior form: no grid test, no count. Bit for bit the plain version
// (ops/field_stencil.py::field_step_plain(..., compute_dtype)). Two
// kernels, not one: compiled into one kernel with the f32 walk, the paired
// walk ran about 3x slower than in a kernel of its own (PERF.md), and its
// window rows can be larger (it holds half the registers).
//
// That second walk is paired (field_step_bf2): two window rows a register
// as bf16x2, the low half row 2m and the high half row 2m + 1, so a thread
// holds kOut x ROWS / 2 words. The program's paired form P::outflow2
// (ops/field_codegen.py::pair_plan) runs each rounded add, sub, mul, neg,
// abs and acc on bf16-typed operands as one add.rn / sub.rn / mul.rn
// .bf16x2 or a sign-bit operation (an f32 operation on bf16 values rounded
// once is the bf16 operation: f32 carries more than 2 * 8 + 2 bits; never
// fma, whose product the plain version rounds), and every other one on
// the two f32 halves, packed back where it rounds. The transport runs on
// pairs too: share = mul.rn.bf16x2(of, bf16(1/k)) (or __fdiv_rn on the
// halves), one shuffle a pair for columns c-1 and c+1, the rows above and
// below from the neighbouring pairs (mm::straddle), the inflow from +0 in
// `offsets` order, one add.rn.bf16x2 an offset, and the warp-edge exchange
// and outer-column shares in pair words.
//
// What bounds it: bytes for f32 at one step ((loaded + written channels) x
// H x W x itemsize), operations at many steps (the program's flops and, per
// written channel, a share, k inflow adds and two more, a cell-step). The
// window rows are chosen per call by ops/field_stencil.py::window_rows (a
// compile-time constant of each instance; a unit carries every instance its
// program can ask for; window_rows16 the second launch's).
//
// C interface (loaded with ctypes; the generated unit defines it):
// mm_field_f32 / mm_field_bf16 and mm_field_cbf16_f32 / _bf16 (a FieldCall,
// a stream) return the cudaError_t of the launch, 0 on success.

#pragma once

#include "stencil_common.cuh"

namespace mm_field {

constexpr int kWarps = mm::kThreadsY;
constexpr int kWinW = mm::kWinW;
constexpr int kEdgeSlots = mm::kEdgeSlots;
constexpr int kMaxChannels = 8;
constexpr int kMaxSteps = 16;
// window values a thread holds (written channels x rows) up to which an
// instance is built for two blocks an SM (128 registers a thread)
constexpr int kTwoBlockValues = 112;
constexpr int kDefaultSmemLimit = 48 * 1024;
// Keep the walk's rows in order, kFenceRows at a time: a group of rows'
// loads and arithmetic start after the previous group is finished, so the
// compiler does not compute rows far ahead into registers (which spills the
// window at 128 registers a thread). 0: no fences.
constexpr int kFenceRows = 8;

// The launch argument; ops/field_stencil.py's _FieldCall mirrors it field
// for field (mm_field_call_size lets the wrapper check the layout). The
// loaded channels are the written ones in output order, then the
// modulators. K4: d = 0, the arrays are the grid (R0 = C0 = 0, h = H,
// w = W) and the rings are null. K4-halo: each channel's [h, w] shard at
// global (R0, C0) and its ghost ring of depth d >= nsteps (mm::RingPiece
// order).
struct FieldCall {
  const void* in[kMaxChannels];
  const void* ring[kMaxChannels][8];
  void* out[kMaxChannels];  // one per written channel
  int h, w, d, R0, C0, H, W;
  int nsteps, rows, vec;  // rows: the instance; vec: rows 16-byte aligned
  int br0, br1, bc0, bc1;  // the bf16 interior math's cells (launch16)
  int rows16;              // launch16's second launch: its instance
};

__device__ __forceinline__ float min_nan(float x, float y) {
  // torch.minimum: NaN if either is NaN, else std::min (x when equal)
  return (x != x) ? x : ((y != y) ? y : ((y < x) ? y : x));
}

__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : ((x < y) ? y : x));
}

// x, as a value the compiler must take as changed here, in program order
// with every other fence and memory access: what is computed from it (a
// row's counts, coordinates and outflows) stays after this point, and is
// neither hoisted out of the step loop nor computed rows ahead
__device__ __forceinline__ void row_fence(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}

__device__ __forceinline__ void row_fence(int& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// bf16x2 pairs (mm::add_bf2 and mm::mul_bf2 are stencil_common.cuh's):
// a - b rounded once, never fused (sm_90)
__device__ __forceinline__ unsigned sub_bf2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ unsigned neg_bf2(unsigned a) {
  return a ^ 0x80008000u;
}

__device__ __forceinline__ unsigned abs_bf2(unsigned a) {
  return a & 0x7FFF7FFFu;
}

// window rows i and i + 1 of a staged window as a pair (p: row i's element,
// `pitch` elements a row); f32 storage is rounded to bf16 here
template <typename T>
__device__ __forceinline__ unsigned stage_pair(const T* p, int pitch) {
  if constexpr (sizeof(T) == 4) {
    return mm::pack_bf2(p[0], p[pitch]);
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    return __byte_perm(q[0], q[pitch], 0x5410);
  }
}

// offset o of the program's neighbourhood: its row and column step
template <class P>
__host__ __device__ constexpr int off_dx(int o) {
  return static_cast<int>((P::kOffCodes >> (4 * o)) & 0xFu) / 3 - 1;
}

template <class P>
__host__ __device__ constexpr int off_dy(int o) {
  return static_cast<int>((P::kOffCodes >> (4 * o)) & 0xFu) % 3 - 1;
}

// the offsets go down the rows: the inflow can be summed as rows arrive
template <class P>
__host__ __device__ constexpr bool rows_in_order() {
  for (int o = 1; o < P::kOffsets; ++o) {
    if (off_dx<P>(o) < off_dx<P>(o - 1)) return false;
  }
  return true;
}

template <class P, int ROWS>
__host__ __device__ constexpr int min_blocks() {
  return P::kOut * ROWS <= kTwoBlockValues ? 2 : 1;
}

// Shared memory of one block: each modulator's staged window, then the
// written channels' staged windows, which the walk reuses for the
// warp-edge exchange ([2 parities][kEdgeSlots][kOut][ROWS] floats) and each
// warp's two outer columns' shares ([kWarps][2][kOut * ROWS + 1]).
template <class P, typename T, int ROWS>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int sb = ROWS * mm::kStagePitch<T> * static_cast<int>(sizeof(T));
  constexpr int walk = (2 * kEdgeSlots * P::kOut * ROWS +
                        kWarps * 2 * (P::kOut * ROWS + 1)) *
                       static_cast<int>(sizeof(float));
  return P::kMod * sb + (P::kOut * sb > walk ? P::kOut * sb : walk);
}

// loaded channel ch's window source
template <typename T>
__device__ __forceinline__ mm::HaloSource<T> source(const FieldCall& a,
                                                    int ch) {
  mm::HaloArgs ha;
  ha.shard = a.in[ch];
  for (int p = 0; p < 8; ++p) ha.ring[p] = a.ring[ch][p];
  ha.h = a.h;
  ha.w = a.w;
  ha.d = a.d;
  ha.R0 = a.R0;
  ha.C0 = a.C0;
  ha.H = a.H;
  ha.W = a.W;
  ha.pad_ = 0;
  return mm::HaloSource<T>(ha);
}

// The prologue and epilogue both walks share (field_pass, field_pass_bf2),
// written so that the f32 walk's near launch compiles as it did inline
// (closures or a slot-size parameter moved ptxas's allocation, PERF.md).
// Stage block t's window of every channel (the written channels' in
// out_stage, the modulators' in mod_stage) and wait for it; returns the
// window's skew, the same for every channel: one window, one alignment.
template <class P, typename T, int ROWS>
__device__ __forceinline__ int stage_channels(const FieldCall& a,
                                              const mm::Tiling& tl, int t,
                                              T* mod_stage, T* out_stage) {
  constexpr int kStage = ROWS * mm::kStagePitch<T>;
  mm::StepParams p{};
  p.vec = a.vec;
  int skew = 0;
#pragma unroll
  for (int ch = 0; ch < P::kOut + P::kMod; ++ch) {
    T* stage = ch < P::kOut ? out_stage + ch * kStage
                            : mod_stage + (ch - P::kOut) * kStage;
    skew = mm::stage_window<ROWS>(source<T>(a, ch), p, tl, t, true, stage);
  }
  mm::cp_async_wait_all();
  __syncthreads();
  return skew;
}

// Zero the exchange slots of warps -1 and kWarps (never published) in both
// parities; a slot holds kOut x ROWS words of type W (ROWS: the walk's
// register rows); j: the thread's index in the block.
template <typename W, int kOut, int ROWS>
__device__ __forceinline__ void zero_outer_slots(W* exch, int j) {
  constexpr int kExch = kEdgeSlots * kOut * ROWS;  // one parity's words
  constexpr int kOuter = 4 * kOut * ROWS;          // four slots' words
  for (int k = j; k < 2 * kOuter; k += 32 * kWarps) {
    const int par = k / kOuter;
    const int rem = k - par * kOuter;
    const int q = rem / (kOut * ROWS);
    const int slot = q < 2 ? q : 2 * kWarps + q;
    exch[par * kExch + slot * kOut * ROWS + rem - q * kOut * ROWS] = W(0);
  }
}

// Write tile t's cells (window rows [n, ROWS - n) of columns [n, kWinW - n))
// from v, PER window rows a word (1: f32 rows; 2: bf16x2 pairs, the low
// half the even row) of this thread's column j: every cell (KEEP 0), those
// outside the bf16 rectangle (1) or those in it (2).
template <int KEEP, typename T, int ROWS, int PER, typename W, int kOut>
__device__ __forceinline__ void store_tile(const FieldCall& a,
                                           const mm::Tiling& tl, int t, int j,
                                           const W (&v)[kOut][ROWS / PER]) {
  const int n = a.nsteps;
  const int lr = tl.row_of(t) - n;  // the window's first row and column
  const int lc = tl.col_of(t) - n + j;
  if (j < n || j >= kWinW - n || lc >= tl.w) return;
  const mm::Rect q{a.br0, a.br1, a.bc0, a.bc1};
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    T* dst = static_cast<T*>(a.out[o]);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const bool inq = mm::in_rect(q, tl.R0 + lr + i, tl.C0 + lc);
      if (i >= n && i < ROWS - n && lr + i < tl.h &&
          (KEEP == 0 || (KEEP == 2) == inq)) {
        float x;
        if constexpr (PER == 1) {
          x = v[o][i];
        } else {
          x = i % 2 ? mm::hi_f32(v[o][i / 2]) : mm::lo_f32(v[o][i / 2]);
        }
        mm::from_f32(dst + static_cast<size_t>(lr + i) * tl.w + lc, x);
      }
    }
  }
}

// One cell at global (r, c): its summed outflows and shares; returns
// whether it lies on the grid. INNER: the caller knows it does, with every
// neighbour.
template <class P, bool INNER>
__device__ __forceinline__ bool cell_flow(const float (&w)[P::kOut],
                                          const float (&m)[P::kModSlots],
                                          int r, int c, int H, int W,
                                          float (&of)[P::kOut],
                                          float (&sh)[P::kOut]) {
  P::outflow(w, m, r, c, of);
  if constexpr (INNER) {
    constexpr int k = P::kOffsets;
#pragma unroll
    for (int o = 0; o < P::kOut; ++o) {
      if constexpr ((k & (k - 1)) == 0) {
        sh[o] = __fmul_rn(of[o], 1.f / k);
      } else {
        sh[o] = __fdiv_rn(of[o], static_cast<float>(k));
      }
    }
    return true;
  } else {
    const bool ong = mm::on_grid(r, c, H, W);
    int cnt = 0;
#pragma unroll
    for (int d = 0; d < P::kOffsets; ++d) {
      cnt += mm::on_grid(r + off_dx<P>(d), c + off_dy<P>(d), H, W) ? 1 : 0;
    }
    cnt = cnt > 0 ? cnt : 1;
    const bool pow2 = (cnt & (cnt - 1)) == 0;
    const float inv = __int_as_float((127 - (__ffs(cnt) - 1)) << 23);
    const float fcnt = __int2float_rn(cnt);
#pragma unroll
    for (int o = 0; o < P::kOut; ++o) {
      of[o] = ong ? of[o] : 0.f;
      sh[o] = pow2 ? __fmul_rn(of[o], inv) : __fdiv_rn(of[o], fcnt);
    }
    return ong;
  }
}

// One step of the window held in v (v[o][i]: written channel o, window row
// i of this thread's column). `ex` is this step's half of the warp-edge
// exchange, `scr` this warp's two outer columns' shares, `mods` the first
// modulator's staged window at its column 0; (r0, c0) is the window's
// global origin in the [H, W] grid. Starts with one __syncthreads().
template <class P, typename T, int ROWS, bool INNER>
__device__ __forceinline__ void field_step(float (&v)[P::kOut][ROWS],
                                           float* ex, float* scr,
                                           const T* mods, int r0, int c0,
                                           int H, int W) {
  constexpr int kOut = P::kOut;
  constexpr int kPitch = mm::kStagePitch<T>;
  constexpr int kStage = ROWS * kPitch;  // elements of one staged window
  constexpr int kSide = kOut * ROWS + 1;  // lane 31's banks beside lane 0's
  static_assert(ROWS % 4 == 0, "edge columns are published four rows at a "
                               "time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int j = wp * 32 + lane;

  // 1. the warp's edge lanes publish their columns' pre-step values
  if (lane == 0 || lane == 31) {
    float* dst = ex + (2 * (wp + 1) + (lane == 31 ? 1 : 0)) * kOut * ROWS;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
#pragma unroll
      for (int i = 0; i < ROWS; i += 4) {
        *reinterpret_cast<float4*>(dst + o * ROWS + i) =
            make_float4(v[o][i], v[o][i + 1], v[o][i + 2], v[o][i + 3]);
      }
    }
  }
  __syncthreads();

  // 2. the shares of the two columns beside the warp (window columns
  // 32 wp - 1 and 32 wp + 32, the neighbouring warps' edge columns), half
  // the lanes a column, from the published values
  {
    const int side = lane >> 4;
    const int jc = side ? 32 * wp + 32 : 32 * wp - 1;
    const bool in_win = jc >= 0 && jc < kWinW;
    const int jm = in_win ? jc : 0;
    const float* src =
        ex + (side ? 2 * (wp + 2) : 2 * wp + 1) * kOut * ROWS;
    float* dst = scr + side * kSide;
#pragma unroll
    for (int q = 0; q < (ROWS + 15) / 16; ++q) {
      int k = (lane & 15) + 16 * q;
      if constexpr (kFenceRows > 0) row_fence(k);
      if (k < ROWS) {
        float w[kOut], m[P::kModSlots], of[kOut], sh[kOut];
#pragma unroll
        for (int o = 0; o < kOut; ++o) w[o] = src[o * ROWS + k];
        m[0] = 0.f;
#pragma unroll
        for (int u = 0; u < P::kMod; ++u) {
          const float x = mm::to_f32(mods[u * kStage + k * kPitch + jm]);
          m[u] = in_win ? x : 0.f;
        }
        cell_flow<P, INNER>(w, m, r0 + k, c0 + jc, H, W, of, sh);
#pragma unroll
        for (int o = 0; o < kOut; ++o) dst[o * ROWS + k] = sh[o];
      }
    }
  }
  __syncwarp();

  // 3. the walk down the rows
  const bool first_lane = lane == 0;
  const bool last_lane = lane == 31;
  const float* edge = scr + (last_lane ? kSide : 0);
  const int c = c0 + j;
  const T* mcol = mods + j;
  constexpr bool kInOrder = rows_in_order<P>();
  constexpr int F = kFenceRows > 0 ? kFenceRows : ROWS + 1;
  float gp[kOut], gc[kOut];  // in order: the sums of rows k-1 and k so far
  float S[kOut][3][3];       // otherwise: rows k-2, k-1, k; columns l, c, r
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
    gp[o] = gc[o] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) S[o][a][b] = 0.f;
    }
  }
  bool ong_prev = true;
  int rg = r0;  // the global row of the group's first row
#pragma unroll
  for (int k = 0; k <= ROWS; ++k) {
    if (kFenceRows > 0 && k % F == 0) {
      // the group's rows start here
      rg = r0 + k;
      row_fence(rg);
#pragma unroll
      for (int i = k; i < k + F && i < ROWS; ++i) {
#pragma unroll
        for (int o = 0; o < kOut; ++o) row_fence(v[o][i]);
      }
    }
    float X[kOut][3];  // row k's shares in columns c-1, c, c+1
    bool ong = true;
    if (k < ROWS) {
      float w[kOut], m[P::kModSlots], of[kOut], sh[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) w[o] = v[o][k];
      m[0] = 0.f;
#pragma unroll
      for (int u = 0; u < P::kMod; ++u) {
        m[u] = mm::to_f32(mcol[u * kStage + k * kPitch]);
      }
      ong = cell_flow<P, INNER>(w, m, rg + k % F, c, H, W, of, sh);
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        v[o][k] = __fsub_rn(w[o], of[o]);
        float L = __shfl_up_sync(mm::kFull, sh[o], 1);
        float R = __shfl_down_sync(mm::kFull, sh[o], 1);
        const float e = edge[o * ROWS + k];
        if (first_lane) L = e;
        if (last_lane) R = e;
        X[o][0] = L;
        X[o][1] = sh[o];
        X[o][2] = R;
      }
    } else {
#pragma unroll
      for (int o = 0; o < kOut; ++o) X[o][0] = X[o][1] = X[o][2] = 0.f;
    }
    // row k's shares complete row k-1's inflow and start rows k and k+1's
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      if constexpr (kInOrder) {
#pragma unroll
        for (int d = 0; d < P::kOffsets; ++d) {
          if (off_dx<P>(d) == 1) {
            gp[o] = __fadd_rn(gp[o], X[o][off_dy<P>(d) + 1]);
          }
        }
        if (k >= 1) {
          v[o][k - 1] = (INNER || ong_prev) ? __fadd_rn(v[o][k - 1], gp[o])
                                            : 0.f;
        }
#pragma unroll
        for (int d = 0; d < P::kOffsets; ++d) {
          if (off_dx<P>(d) == 0) {
            gc[o] = __fadd_rn(gc[o], X[o][off_dy<P>(d) + 1]);
          }
        }
        float gn = 0.f;
#pragma unroll
        for (int d = 0; d < P::kOffsets; ++d) {
          if (off_dx<P>(d) == -1) {
            gn = __fadd_rn(gn, X[o][off_dy<P>(d) + 1]);
          }
        }
        gp[o] = gc[o];
        gc[o] = gn;
      } else {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          S[o][0][b] = S[o][1][b];
          S[o][1][b] = S[o][2][b];
          S[o][2][b] = X[o][b];
        }
        if (k >= 1) {
          float g = 0.f;
#pragma unroll
          for (int d = 0; d < P::kOffsets; ++d) {
            g = __fadd_rn(g, S[o][off_dx<P>(d) + 1][off_dy<P>(d) + 1]);
          }
          v[o][k - 1] =
              (INNER || ong_prev) ? __fadd_rn(v[o][k - 1], g) : 0.f;
        }
      }
    }
    if (kFenceRows > 0 && (k + 1) % F == 0) {
      // the group's finished rows end here
#pragma unroll
      for (int i = k - F; i < k && i < ROWS; ++i) {
#pragma unroll
        for (int o = 0; o < kOut; ++o) {
          if (i >= 0) row_fence(v[o][i]);
        }
      }
    }
    ong_prev = ong;
  }
}

// a pair's shares: of * (1/k) where the count k is a power of two (exact
// in bf16), of / k on the f32 halves otherwise; each rounded once
template <class P>
__device__ __forceinline__ unsigned share_bf2(unsigned of) {
  constexpr int k = P::kOffsets;
  if constexpr ((k & (k - 1)) == 0) {
    // 1/k = 2^-log2(k): bf16 bits (127 - log2 k) << 7, in both halves
    constexpr unsigned e = 127u - (k >= 8 ? 3u : k >= 4 ? 2u : k >= 2 ? 1u
                                                                      : 0u);
    return mm::mul_bf2(of, (e << 7) | (e << 23));
  } else {
    return mm::pack_bf2(__fdiv_rn(mm::lo_f32(of), static_cast<float>(k)),
                        __fdiv_rn(mm::hi_f32(of), static_cast<float>(k)));
  }
}

// One step of the paired walk over the window held in v (v[o][m]: written
// channel o, window rows 2m and 2m + 1 of this thread's column), the
// interior form of field_step on pairs: `ex` is this step's half of the
// warp-edge exchange ([kEdgeSlots][kOut][ROWS / 2] words), `scr` this
// warp's two outer columns' shares, `mods` the first modulator's staged
// window at its column 0; (r0, c0) is the window's global origin. Starts
// with one __syncthreads().
template <class P, typename T, int ROWS>
__device__ __forceinline__ void field_step_bf2(
    unsigned (&v)[P::kOut][ROWS / 2], unsigned* ex, unsigned* scr,
    const T* mods, int r0, int c0) {
  constexpr int kOut = P::kOut;
  constexpr int PR = ROWS / 2;  // pairs
  constexpr int kPitch = mm::kStagePitch<T>;
  constexpr int kStage = ROWS * kPitch;
  constexpr int kSide = kOut * PR + 1;
  static_assert(PR % 4 == 0, "edge pairs are published four at a time");
  const int lane = threadIdx.x;
  const int wp = threadIdx.y;
  const int j = wp * 32 + lane;

  // 1. the warp's edge lanes publish their columns' pre-step pairs
  if (lane == 0 || lane == 31) {
    unsigned* dst = ex + (2 * (wp + 1) + (lane == 31 ? 1 : 0)) * kOut * PR;
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
#pragma unroll
      for (int m = 0; m < PR; m += 4) {
        *reinterpret_cast<uint4*>(dst + o * PR + m) =
            make_uint4(v[o][m], v[o][m + 1], v[o][m + 2], v[o][m + 3]);
      }
    }
  }
  __syncthreads();

  // 2. the shares of the two columns beside the warp, half the lanes a
  // column, from the published pairs
  {
    const int side = lane >> 4;
    const int jc = side ? 32 * wp + 32 : 32 * wp - 1;
    const bool in_win = jc >= 0 && jc < kWinW;
    const int jm = in_win ? jc : 0;
    const unsigned* src =
        ex + (side ? 2 * (wp + 2) : 2 * wp + 1) * kOut * PR;
    unsigned* dst = scr + side * kSide;
#pragma unroll
    for (int q = 0; q < (PR + 15) / 16; ++q) {
      const int m = (lane & 15) + 16 * q;
      if (m < PR) {
        unsigned w[kOut], md[P::kModSlots], of[kOut];
#pragma unroll
        for (int o = 0; o < kOut; ++o) w[o] = src[o * PR + m];
        md[0] = 0u;
#pragma unroll
        for (int u = 0; u < P::kMod; ++u) {
          const unsigned x =
              stage_pair(mods + u * kStage + 2 * m * kPitch + jm, kPitch);
          md[u] = in_win ? x : 0u;
        }
        P::outflow2(w, md, r0 + 2 * m, c0 + jc, of);
#pragma unroll
        for (int o = 0; o < kOut; ++o) dst[o * PR + m] = share_bf2<P>(of[o]);
      }
    }
  }
  __syncwarp();

  // 3. the walk down the pairs: pair m's outflows, shares and v - of, then
  // pair m - 1 finished as (v - of) + inflow
  const bool first_lane = lane == 0;
  const bool last_lane = lane == 31;
  const unsigned* edge = scr + (last_lane ? kSide : 0);
  const int c = c0 + j;
  const T* mcol = mods + j;
  // pair m - 1's shares (columns c-1, c, c+1), and the rows above it
  // (straddle(pair m - 2, pair m - 1))
  unsigned Xp[kOut][3], U[kOut][3];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int b = 0; b < 3; ++b) Xp[o][b] = U[o][b] = 0u;
  }
#pragma unroll
  for (int m = 0; m <= PR; ++m) {
    unsigned X[kOut][3];  // pair m's shares in columns c-1, c, c+1
    if (m < PR) {
      unsigned w[kOut], md[P::kModSlots], of[kOut];
#pragma unroll
      for (int o = 0; o < kOut; ++o) w[o] = v[o][m];
      md[0] = 0u;
#pragma unroll
      for (int u = 0; u < P::kMod; ++u) {
        md[u] = stage_pair(mcol + u * kStage + 2 * m * kPitch, kPitch);
      }
      P::outflow2(w, md, r0 + 2 * m, c, of);
#pragma unroll
      for (int o = 0; o < kOut; ++o) {
        const unsigned sh = share_bf2<P>(of[o]);
        v[o][m] = sub_bf2(w[o], of[o]);
        unsigned L = __shfl_up_sync(mm::kFull, sh, 1);
        unsigned R = __shfl_down_sync(mm::kFull, sh, 1);
        const unsigned e = edge[o * PR + m];
        if (first_lane) L = e;
        if (last_lane) R = e;
        X[o][0] = L;
        X[o][1] = sh;
        X[o][2] = R;
      }
    } else {
#pragma unroll
      for (int o = 0; o < kOut; ++o) X[o][0] = X[o][1] = X[o][2] = 0u;
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      unsigned D[3];  // rows 2m - 1 and 2m: below pair m - 1, above pair m
#pragma unroll
      for (int b = 0; b < 3; ++b) D[b] = mm::straddle(Xp[o][b], X[o][b]);
      if (m >= 1) {
        unsigned g = 0u;
#pragma unroll
        for (int d = 0; d < P::kOffsets; ++d) {
          const int dx = off_dx<P>(d);
          const int b = off_dy<P>(d) + 1;
          g = mm::add_bf2(g, dx < 0 ? U[o][b] : (dx == 0 ? Xp[o][b] : D[b]));
        }
        v[o][m - 1] = mm::add_bf2(v[o][m - 1], g);
      }
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        U[o][b] = D[b];
        Xp[o][b] = X[o][b];
      }
    }
  }
}

// The paired walk of block t over tile t of `tl` with the bf16 program P,
// writing its output cells that lie in the bf16 rectangle.
template <class P, typename T, int ROWS>
__device__ __forceinline__ void field_pass_bf2(const FieldCall& a,
                                               const mm::Tiling& tl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kOut = P::kOut;
  constexpr int PR = ROWS / 2;
  constexpr int kPitch = mm::kStagePitch<T>;
  constexpr int kStage = ROWS * kPitch;
  constexpr int kExch = kEdgeSlots * kOut * PR;  // one parity's words
  T* mod_stage = reinterpret_cast<T*>(smem);
  T* out_stage = mod_stage + P::kMod * kStage;
  unsigned* exch = reinterpret_cast<unsigned*>(out_stage);
  unsigned* scratch = exch + 2 * kExch;
  const int t = blockIdx.x;
  const int n = a.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;

  const int skew = stage_channels<P, T, ROWS>(a, tl, t, mod_stage, out_stage);
  unsigned v[kOut][PR];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int m = 0; m < PR; ++m) {
      v[o][m] = stage_pair(out_stage + o * kStage + 2 * m * kPitch + skew + j,
                           kPitch);
    }
  }
  __syncthreads();  // the written channels' windows become the exchange
  zero_outer_slots<unsigned, kOut, PR>(exch, j);

  const int r0 = tl.R0 + tl.row_of(t) - n;
  const int c0 = tl.C0 + tl.col_of(t) - n;
  unsigned* scr = scratch + threadIdx.y * 2 * (kOut * PR + 1);
  const T* mods = mod_stage + skew;
  for (int s = 0; s < n; ++s) {
    field_step_bf2<P, T, ROWS>(v, exch + (s & 1) * kExch, scr, mods, r0, c0);
  }
  store_tile<2, T, ROWS, 2>(a, tl, t, j, v);
}

// One walk of block t over tile t of `tl`, writing (PASS 0) every output
// cell, or (PASS 1) those outside the bf16 rectangle.
template <class P, typename T, int ROWS, int PASS>
__device__ __forceinline__ void field_pass(const FieldCall& a,
                                           const mm::Tiling& tl) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kOut = P::kOut;
  constexpr int kPitch = mm::kStagePitch<T>;
  constexpr int kStage = ROWS * kPitch;
  constexpr int kExch = kEdgeSlots * kOut * ROWS;  // one parity's floats
  T* mod_stage = reinterpret_cast<T*>(smem);
  T* out_stage = mod_stage + P::kMod * kStage;
  float* exch = reinterpret_cast<float*>(out_stage);
  float* scratch = exch + 2 * kExch;
  const int t = blockIdx.x;
  const int n = a.nsteps;
  const int j = threadIdx.y * 32 + threadIdx.x;

  const int skew = stage_channels<P, T, ROWS>(a, tl, t, mod_stage, out_stage);
  float v[kOut][ROWS];
#pragma unroll
  for (int o = 0; o < kOut; ++o) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      v[o][i] = mm::to_f32(out_stage[o * kStage + i * kPitch + skew + j]);
    }
  }
  __syncthreads();  // the written channels' windows become the exchange
  zero_outer_slots<float, kOut, ROWS>(exch, j);

  const int r0 = tl.R0 + tl.row_of(t) - n;  // the window's global origin
  const int c0 = tl.C0 + tl.col_of(t) - n;
  float* scr = scratch + threadIdx.y * 2 * (kOut * ROWS + 1);
  const T* mods = mod_stage + skew;
  if (tl.interior(t)) {
    for (int s = 0; s < n; ++s) {
      field_step<P, T, ROWS, true>(v, exch + (s & 1) * kExch, scr, mods, r0,
                                   c0, tl.H, tl.W);
    }
  } else {
    for (int s = 0; s < n; ++s) {
      field_step<P, T, ROWS, false>(v, exch + (s & 1) * kExch, scr, mods, r0,
                                    c0, tl.H, tl.W);
    }
  }
  store_tile<PASS, T, ROWS, 1>(a, tl, t, j, v);
}

template <class P, typename T, int ROWS>
__global__ void __launch_bounds__(32 * kWarps, min_blocks<P, ROWS>())
    field_kernel(const __grid_constant__ FieldCall a, const mm::Tiling tl) {
  field_pass<P, T, ROWS, 0>(a, tl);
}

// How tile t of `tl` meets the call's bf16 rectangle (mm::RectCover).
__device__ __forceinline__ int tile_cover(const FieldCall& a,
                                          const mm::Tiling& tl, int t) {
  const int gr = tl.R0 + tl.row_of(t);
  const int gc = tl.C0 + tl.col_of(t);
  return mm::rect_cover(mm::Rect{a.br0, a.br1, a.bc0, a.bc1}, gr,
                        min(gr + tl.th, tl.R0 + tl.h), gc,
                        min(gc + tl.tw, tl.C0 + tl.w));
}

// The bf16 interior math, first launch: the f32 program P over the cells
// outside the rectangle (tiles wholly inside it return).
template <class P, typename T, int ROWS>
__global__ void __launch_bounds__(32 * kWarps, min_blocks<P, ROWS>())
    field_kernel_near(const __grid_constant__ FieldCall a,
                      const mm::Tiling tl) {
  if (tile_cover(a, tl, blockIdx.x) == mm::kAll) return;
  field_pass<P, T, ROWS, 1>(a, tl);
}

// Blocks an SM an instance of the second launch is built for: the paired
// walk holds kOut x ROWS / 2 words a thread, two blocks up to the unit's
// P::kTwoBlockWords (ops/field_codegen.py::TWO_BLOCK_WORDS, the threshold
// ops/field_stencil.py::window_rows16 picks the rows by)
template <class P, int ROWS>
__host__ __device__ constexpr int min_blocks16() {
  return P::kOut * ROWS / 2 <= P::kTwoBlockWords ? 2 : 1;
}

// Second launch: the bf16 program P16 on the paired walk over the cells in
// the rectangle, on a tiling of its own window rows (tiles with no cell in
// it return).
template <class P16, typename T, int ROWS>
__global__ void __launch_bounds__(32 * kWarps, min_blocks16<P16, ROWS>())
    field_kernel16(const __grid_constant__ FieldCall a, const mm::Tiling tl) {
  if (tile_cover(a, tl, blockIdx.x) == mm::kNone) return;
  field_pass_bf2<P16, T, ROWS>(a, tl);
}

// Shared memory of a second-launch block: the staged windows, reused by the
// paired walk for its exchange ([2][kEdgeSlots][kOut][ROWS / 2] words) and
// outer columns ([kWarps][2][kOut * ROWS / 2 + 1]).
template <class P, typename T, int ROWS>
__host__ __device__ constexpr int smem_bytes16() {
  constexpr int sb = ROWS * mm::kStagePitch<T> * static_cast<int>(sizeof(T));
  constexpr int words = P::kOut * ROWS / 2;
  constexpr int walk = (2 * kEdgeSlots * words + kWarps * 2 * (words + 1)) *
                       static_cast<int>(sizeof(unsigned));
  return P::kMod * sb + (P::kOut * sb > walk ? P::kOut * sb : walk);
}

// The window rows of an instance: the unit's RS (f32 walk) or RS16 (the
// bf16 interior math's second launch).
template <int... RS>
struct Rows {};

// Host check of a call: steps within the ghost depth and the window's rows,
// K4's arrays the grid or K4-halo's shard inside it with a ring at least
// nsteps deep, every pointer the call reads or writes.
template <class P>
bool valid(const FieldCall& a) {
  const int n = a.nsteps;
  if (n < 1 || n > kMaxSteps || a.rows - 2 * n < 1 || a.h < 0 || a.w < 0 ||
      (a.vec != 0 && a.vec != 1)) {
    return false;
  }
  if (a.d == 0) {
    if (a.R0 != 0 || a.C0 != 0 || a.h != a.H || a.w != a.W) return false;
  } else if (a.d < n || a.d > kMaxSteps || a.R0 < 0 || a.C0 < 0 ||
             a.R0 + a.h > a.H || a.C0 + a.w > a.W) {
    return false;
  }
  for (int ch = 0; ch < P::kOut + P::kMod; ++ch) {
    if (a.in[ch] == nullptr) return false;
    for (int p = 0; a.d > 0 && p < 8; ++p) {
      if (a.ring[ch][p] == nullptr) return false;
    }
  }
  for (int o = 0; o < P::kOut; ++o) {
    if (a.out[o] == nullptr) return false;
  }
  return true;
}

template <class P, typename T, int ROWS>
int launch_rows(const FieldCall& a, void* stream) {
  const mm::Tiling tl = mm::make_tiling(ROWS, a.nsteps, a.nsteps, a.h, a.w,
                                        a.R0, a.C0, a.H, a.W);
  static int limit = kDefaultSmemLimit;  // per template instance
  return static_cast<int>(mm::launch_blocks(field_kernel<P, T, ROWS>,
                                            smem_bytes<P, T, ROWS>(),
                                            tl.tiles, &limit, stream, a, tl));
}

template <class P, typename T, int ROWS>
int launch_near(const FieldCall& a, void* stream) {
  const mm::Tiling tl = mm::make_tiling(ROWS, a.nsteps, a.nsteps, a.h, a.w,
                                        a.R0, a.C0, a.H, a.W);
  static int limit = kDefaultSmemLimit;  // per template instance
  return static_cast<int>(mm::launch_blocks(field_kernel_near<P, T, ROWS>,
                                            smem_bytes<P, T, ROWS>(),
                                            tl.tiles, &limit, stream, a, tl));
}

template <class P16, typename T, int ROWS>
int launch_rows16(const FieldCall& a, void* stream) {
  const mm::Tiling tl = mm::make_tiling(ROWS, a.nsteps, a.nsteps, a.h, a.w,
                                        a.R0, a.C0, a.H, a.W);
  static int limit = kDefaultSmemLimit;  // per template instance
  return static_cast<int>(mm::launch_blocks(field_kernel16<P16, T, ROWS>,
                                            smem_bytes16<P16, T, ROWS>(),
                                            tl.tiles, &limit, stream, a, tl));
}

// Launch the instance of `call`'s rows among the unit's RS.
template <class P, typename T, int... RS>
int launch(const void* call, void* stream) {
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (call == nullptr) return invalid;
  const FieldCall& a = *static_cast<const FieldCall*>(call);
  if (!((a.rows == RS) || ...) || !valid<P>(a)) return invalid;
  if (a.h == 0 || a.w == 0) return 0;
  int err = invalid;
  ((a.rows == RS ? (err = launch_rows<P, T, RS>(a, stream), 0) : 0), ...);
  return err;
}

// The same with the bf16 interior math (P16: the bf16 program): two launches
// on the stream, the f32 walk over the cells outside the rectangle (window
// rows `rows` among RS) and the paired walk over those in it (`rows16`
// among RS16); either is left out when it has no cell.
template <class P, class P16, typename T, int... RS, int... RS16>
int launch16(const void* call, void* stream, Rows<RS...>, Rows<RS16...>) {
  static_assert(P16::kOut == P::kOut && P16::kMod == P::kMod &&
                    P16::kOffCodes == P::kOffCodes,
                "the bf16 program is the same flows' lowering at bf16");
  const int invalid = static_cast<int>(cudaErrorInvalidValue);
  if (call == nullptr) return invalid;
  const FieldCall& a = *static_cast<const FieldCall*>(call);
  if (!((a.rows == RS) || ...) || !((a.rows16 == RS16) || ...) ||
      a.rows16 - 2 * a.nsteps < 1 || !valid<P>(a)) {
    return invalid;
  }
  if (a.h == 0 || a.w == 0) return 0;
  const int cover = mm::rect_cover(mm::Rect{a.br0, a.br1, a.bc0, a.bc1},
                                   a.R0, a.R0 + a.h, a.C0, a.C0 + a.w);
  int err = 0;
  if (cover != mm::kAll) {
    ((a.rows == RS ? (err = launch_near<P, T, RS>(a, stream), 0) : 0), ...);
  }
  if (err == 0 && cover != mm::kNone) {
    ((a.rows16 == RS16 ? (err = launch_rows16<P16, T, RS16>(a, stream), 0)
                       : 0),
     ...);
  }
  return err;
}

// The shared memory of the unit's instance of `rows`; -1 if it has none.
template <class P, typename T, int... RS>
int smem_of(int rows) {
  int bytes = -1;
  ((rows == RS ? (bytes = smem_bytes<P, T, RS>(), 0) : 0), ...);
  return bytes;
}

// The same for the bf16 interior math's second launch.
template <class P16, typename T, int... RS16>
int smem16_of(int rows) {
  int bytes = -1;
  ((rows == RS16 ? (bytes = smem_bytes16<P16, T, RS16>(), 0) : 0), ...);
  return bytes;
}

}  // namespace mm_field

// The entry points every unit shares.
#define MM_FIELD_COMMON_ENTRY_POINTS                                        \
  extern "C" int mm_field_call_size() {                                     \
    return static_cast<int>(sizeof(mm_field::FieldCall));                   \
  }                                                                         \
  extern "C" const char* mm_field_error_string(int err) {                   \
    return cudaGetErrorString(static_cast<cudaError_t>(err));               \
  }
