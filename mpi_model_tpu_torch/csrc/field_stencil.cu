// K4: the fused multi-channel field step, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel mpi_model_tpu/ops/pallas_stencil.py::_field_call
// in dense mode (the pl.pallas_call reached through PallasFieldStep). It
// computes what that kernel computes, not how: `nsteps` steps of the
// summed-outflow update over C channels of one [H, W] grid, in one read of
// every loaded channel and one write of every written channel. Each step:
//   1. every flow's outflow on every window cell, from the values before
//      the step (off-grid cells shed nothing: the affine-flow guard);
//   2. outflows summed per target channel, in flow order;
//   3. share = of / cnt, cnt the cell's in-grid neighbour count (>= 1);
//   4. inflow = 0 + each neighbour's share, in `offsets` order;
//   5. new = (v - of) + inflow, re-zeroed off the grid.
// Channels no flow writes (modulators) are read, never written.
//
// The outflows are user Python in the JAX package. The port lowers each
// flow once, when the step is built (ops/field_lower.py), to a short
// program over the cell's channel values, its global row and column and
// f32 constants: three-address instructions whose
// intermediate results live in "slots", and an `acc` per flow that adds
// its result to its channel's outflow. The program travels in the launch
// argument (FieldArgs, a __grid_constant__ parameter), so one compiled
// kernel runs every flow set. Each slot is a shared-memory plane over the
// block's window; each instruction is dispatched once per thread and
// applied to all of the thread's cells, so the interpretation costs a few
// instructions per cell and operation (a per-cell stack interpreter spent
// ~2000 instructions per cell-step on it).
//
// Bitwise contract: every operation is an _rn intrinsic in the plain
// version's order (ops/field_stencil.py::field_step_plain: build_outflow,
// then transport), and the source builds with --fmad=false, so K4 equals
// its plain version bit for bit at f32 and at bf16 (both compute in f32
// and round once per call). exp is CUDA's expf (not the fast __expf); the
// plain version's exp may differ from it by an ulp, so flows using exp are
// held to a tolerance instead.
//
// What bounds it: bytes for f32 with few steps ((C reads + written
// channels) x H x W x itemsize), operations for bf16 at 16 steps (the
// programs' flops plus a divide, k adds and two more per written channel
// per cell-step). The design is simple and right: one exact form
// everywhere (blocks whose window lies inside the grid skip the per-cell
// grid and neighbour-count tests, which give the same values there), a
// window of (TILE_H + 2n) x (TILE_W + 2n) cells per block in shared memory
// for every loaded channel, every written channel's outflow and the slots
// (the first slot doubles as the share buffer of the transport). The
// wrapper picks TILE_H in {32, 16, 8} so that this fits the 232,448 bytes
// a block may use. Specializing the kernel per flow set, the closed-form
// interior and cp.async/TMA loads are later work.
//
// K4-halo is the same body on one shard of a sharded grid: it replaces
// _field_call in halo mode (pallas_field_halo_step, used by
// parallel/executors.py::ShardMapExecutor's "field" plan). Every loaded
// channel's window reads its shard and, past the shard's edge, that
// channel's exchanged ghost ring of depth d >= nsteps (mm::HaloSource):
// outflows are evaluated on ghost cells too, so modulators ship rings like
// the written channels. The cells' rows and columns (the grid tests, the
// neighbour counts and the coordinates a program reads) are global: the
// shard's origin plus the local index. The second launch argument
// (FieldHalo) carries the 8 x 8 ring pointers, 536 bytes, so both together
// stay well inside the 4 KB a kernel's parameters may take.
//
// C interface (loaded with ctypes): each entry point returns the
// cudaError_t of its launch, 0 on success.

#include "stencil_common.cuh"

namespace {

constexpr int TILE_W = 128;
// 1024 threads a block: a block of config 4 at nsteps=8 takes 138 KB of
// shared memory, so one block fits an SM, and its 32 warps hide the
// latency of the shared-memory loads (with 256 threads the first version
// ran 1.8x slower per step at nsteps=8 than at nsteps=1).
constexpr int THREADS_X = 32;
constexpr int THREADS_Y = 32;
constexpr int MAX_STEPS = 16;
constexpr int MAX_CHANNELS = 8;
constexpr int MAX_CODE = 64;
constexpr int MAX_SLOTS = 8;
constexpr int MAX_OFFSETS = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int DEFAULT_SMEM_LIMIT = 48 * 1024;

// opcodes: ops/field_lower.py's OP_* numbers
enum Op : int {
  OP_ADD = 0, OP_SUB, OP_MUL, OP_DIV, OP_MIN, OP_MAX,
  OP_NEG, OP_EXP, OP_ABS, OP_ACC, OP_END
};
// operand kinds: ops/field_lower.py's K_* numbers
enum Kind : int { K_SLOT = 0, K_CHAN, K_CONST, K_ROW, K_COL, K_END };

// The launch argument; ops/field_stencil.py's _FieldArgs mirrors it field
// for field (mm_field_args_size lets the wrapper check the layout).
struct FieldArgs {
  const void* in[MAX_CHANNELS];   // loaded channels
  void* out[MAX_CHANNELS];        // one per written channel
  int out_chan[MAX_CHANNELS];     // written slot -> loaded channel
  int H, W, nsteps, tile_h;
  int n_chan, n_out, n_slots, n_off;
  int n_code, pad_;
  int off_dx[MAX_OFFSETS], off_dy[MAX_OFFSETS];
  int op[MAX_CODE];
  int dst[MAX_CODE];     // slot, or the written channel of an acc
  int first[MAX_CODE];   // acc: 1 when the flow starts its channel's sum
  int a_kind[MAX_CODE], a_arg[MAX_CODE];
  int b_kind[MAX_CODE], b_arg[MAX_CODE];
  float a_imm[MAX_CODE], b_imm[MAX_CODE];
};

// K4-halo's second launch argument; ops/field_stencil.py's _FieldHalo
// mirrors it (mm_field_halo_size). Per loaded channel its ghost ring's
// eight pieces in mm::RingPiece order; the ring depth, the shard's global
// origin and the global grid.
struct FieldHalo {
  const void* ring[MAX_CHANNELS][8];
  int d, R0, C0, H, W, pad_;
};

__device__ __forceinline__ float min_nan(float x, float y) {
  // torch.minimum: NaN if either is NaN, else std::min (x when equal)
  return (x != x) ? x : ((y != y) ? y : ((y < x) ? y : x));
}

__device__ __forceinline__ float max_nan(float x, float y) {
  return (x != x) ? x : ((y != y) ? y : ((x < y) ? y : x));
}

// One operand at window cell idx (global (r, c)); `p` is the slot's or
// channel's plane for those kinds.
__device__ __forceinline__ float operand(int kind, const float* p, int arg,
                                         float imm, int idx, int r, int c) {
  if (kind <= K_CHAN) return p[idx];
  if (kind == K_CONST) return imm;
  return __int2float_rn((kind == K_ROW ? r : c) + arg);
}

__device__ __forceinline__ float apply(int op, float x, float y) {
  switch (op) {
    case OP_ADD: return __fadd_rn(x, y);
    case OP_SUB: return __fsub_rn(x, y);
    case OP_MUL: return __fmul_rn(x, y);
    case OP_DIV: return __fdiv_rn(x, y);
    case OP_MIN: return min_nan(x, y);
    case OP_MAX: return max_nan(x, y);
    case OP_NEG: return -x;
    case OP_EXP: return expf(x);
    default: return fabsf(x);  // OP_ABS
  }
}

// Phase 1 of a step, one instruction: applied to this thread's cells of
// the region [s, WH - s) x [s, WW - s). Each cell is read and written by
// its own thread only, so instructions need no barrier between them; the
// operation is a template parameter, so the per-cell loop has no dispatch.
template <int OP>
__device__ __forceinline__ void run_op(const FieldArgs& a, int pc,
                                       const float* val, float* slots,
                                       float* of, int s, int WH, int WW,
                                       int WS, int r0, int c0, int H, int W,
                                       bool inner) {
  const int ak = a.a_kind[pc];
  const int bk = a.b_kind[pc];
  const int aa = a.a_arg[pc];
  const int ba = a.b_arg[pc];
  const float ai = a.a_imm[pc];
  const float bi = a.b_imm[pc];
  const float* pa = (ak == K_SLOT ? slots : val) + (ak <= K_CHAN ? aa : 0) * WS;
  const float* pb = (bk == K_SLOT ? slots : val) + (bk <= K_CHAN ? ba : 0) * WS;
  float* pd = (OP == OP_ACC ? of : slots) + a.dst[pc] * WS;
  const bool first = a.first[pc] != 0;
  for (int i = s + threadIdx.y; i < WH - s; i += THREADS_Y) {
    const int r = r0 + i;
    for (int j = s + threadIdx.x; j < WW - s; j += THREADS_X) {
      const int c = c0 + j;
      const int idx = i * WW + j;
      const float x = operand(ak, pa, aa, ai, idx, r, c);
      if (OP == OP_ACC) {
        // off-grid cells shed nothing (the affine-flow guard)
        pd[idx] = (inner || mm::on_grid(r, c, H, W))
                      ? (first ? x : __fadd_rn(pd[idx], x))
                      : 0.f;
      } else if (OP >= OP_NEG) {
        pd[idx] = apply(OP, x, 0.f);
      } else {
        pd[idx] = apply(OP, x, operand(bk, pb, ba, bi, idx, r, c));
      }
    }
  }
}

// Where a call's cells are. Both give each loaded channel's window source
// (mm::DenseSource / mm::HaloSource), the written arrays' global origin and
// the global grid.
// K4: a whole grid; local is global.
template <typename T>
struct WholeGrid {
  int H, W;
  __device__ __forceinline__ int row0() const { return 0; }
  __device__ __forceinline__ int col0() const { return 0; }
  __device__ __forceinline__ int gH() const { return H; }
  __device__ __forceinline__ int gW() const { return W; }
  __device__ __forceinline__ mm::DenseSource<T> channel(const FieldArgs& a,
                                                        int ch) const {
    return {static_cast<const T*>(a.in[ch]), H, W};
  }
};

// K4-halo: one [h, w] shard per channel (FieldArgs.in) and the channel's
// ghost ring (FieldHalo.ring[ch]).
template <typename T>
struct ShardGrid {
  const FieldHalo& x;
  int h, w;
  __device__ __forceinline__ int row0() const { return x.R0; }
  __device__ __forceinline__ int col0() const { return x.C0; }
  __device__ __forceinline__ int gH() const { return x.H; }
  __device__ __forceinline__ int gW() const { return x.W; }
  __device__ __forceinline__ mm::HaloSource<T> channel(const FieldArgs& a,
                                                       int ch) const {
    mm::HaloArgs ha;
    ha.shard = a.in[ch];
    for (int p = 0; p < 8; ++p) ha.ring[p] = x.ring[ch][p];
    ha.h = h;
    ha.w = w;
    ha.d = x.d;
    ha.R0 = x.R0;
    ha.C0 = x.C0;
    ha.H = x.H;
    ha.W = x.W;
    return mm::HaloSource<T>(ha);
  }
};

// One block's work. `a.H` x `a.W` is the extent of the arrays the call
// writes (the whole grid, or one shard); window coordinates are local to
// them, and the steps see them at `g`'s global origin.
template <typename T, typename G>
__device__ __forceinline__ void field_body(const FieldArgs& a, const G& g) {
  extern __shared__ float smem[];
  const int n = a.nsteps;
  const int H = g.gH();  // the global grid
  const int W = g.gW();
  const int WH = a.tile_h + 2 * n;  // window rows
  const int WW = TILE_W + 2 * n;    // window cols (row pitch)
  const int WS = WH * WW;
  float* val = smem;                  // [n_chan][WH][WW] values
  float* of = val + a.n_chan * WS;    // [n_out][WH][WW] summed outflows
  float* slots = of + a.n_out * WS;   // [max(n_slots, 1)][WH][WW]
  float* share = slots;               // slot 0 is free during transport
  const int lr0 = static_cast<int>(blockIdx.y) * a.tile_h - n;  // local
  const int lc0 = static_cast<int>(blockIdx.x) * TILE_W - n;
  const int r0 = g.row0() + lr0;  // the window's global origin
  const int c0 = g.col0() + lc0;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  // a block whose window and the window's neighbours all lie on the grid:
  // every cell is on the grid and has all n_off neighbours (the same
  // values the exact tests give, without the tests)
  const bool inner =
      r0 >= 1 && c0 >= 1 && r0 + WH + 1 <= H && c0 + WW + 1 <= W;

  for (int ch = 0; ch < a.n_chan; ++ch) {
    mm::load_window_f32<THREADS_X, THREADS_Y>(g.channel(a, ch),
                                              val + ch * WS, lr0, lc0, WH,
                                              WW);
  }
  __syncthreads();
  for (int s = 0; s < n; ++s) {
    // 1-2. every flow's outflow, summed per written channel, on [s, WH - s)
    for (int pc = 0; pc < a.n_code; ++pc) {
#define MM_RUN(OPC)                                                        \
  case OPC:                                                                \
    run_op<OPC>(a, pc, val, slots, of, s, WH, WW, WS, r0, c0, H, W, inner); \
    break;
      switch (a.op[pc]) {
        MM_RUN(OP_ADD)
        MM_RUN(OP_SUB)
        MM_RUN(OP_MUL)
        MM_RUN(OP_DIV)
        MM_RUN(OP_MIN)
        MM_RUN(OP_MAX)
        MM_RUN(OP_NEG)
        MM_RUN(OP_EXP)
        MM_RUN(OP_ABS)
        MM_RUN(OP_ACC)
        default: break;
      }
#undef MM_RUN
    }
    __syncthreads();
    for (int o = 0; o < a.n_out; ++o) {
      const float* ofo = of + o * WS;
      // 3. shares on [s, WH - s); off-grid cells share nothing
      for (int i = s + ty; i < WH - s; i += THREADS_Y) {
        const int r = r0 + i;
        for (int j = s + tx; j < WW - s; j += THREADS_X) {
          const int c = c0 + j;
          float sh = 0.f;
          if (inner || mm::on_grid(r, c, H, W)) {
            int cnt = a.n_off;
            if (!inner) {
              cnt = 0;
              for (int d = 0; d < a.n_off; ++d) {
                cnt += mm::on_grid(r + a.off_dx[d], c + a.off_dy[d], H, W);
              }
            }
            sh = __fdiv_rn(ofo[i * WW + j],
                           static_cast<float>(cnt > 0 ? cnt : 1));
          }
          share[i * WW + j] = sh;
        }
      }
      __syncthreads();
      // 4-5. update [s + 1, WH - s - 1) of this channel, in place (each
      // cell is read and written by its own thread; the outflows of every
      // channel were taken before the step)
      float* v = val + a.out_chan[o] * WS;
      for (int i = s + 1 + ty; i < WH - s - 1; i += THREADS_Y) {
        const int r = r0 + i;
        for (int j = s + 1 + tx; j < WW - s - 1; j += THREADS_X) {
          const int idx = i * WW + j;
          float g = 0.f;
          for (int d = 0; d < a.n_off; ++d) {
            g = __fadd_rn(g, share[(i + a.off_dx[d]) * WW + j + a.off_dy[d]]);
          }
          v[idx] = (inner || mm::on_grid(r, c0 + j, H, W))
                       ? __fadd_rn(__fsub_rn(v[idx], ofo[idx]), g)
                       : 0.f;
        }
      }
      __syncthreads();
    }
  }

  // Write the written channels' interiors once, in the storage dtype.
  for (int o = 0; o < a.n_out; ++o) {
    const float* v = val + a.out_chan[o] * WS;
    T* dst = static_cast<T*>(a.out[o]);
    for (int i = ty; i < a.tile_h; i += THREADS_Y) {
      const int r = lr0 + n + i;
      if (r >= a.H) break;
      for (int j = tx; j < TILE_W; j += THREADS_X) {
        const int c = lc0 + n + j;
        if (c < a.W) {
          mm::from_f32(dst + static_cast<size_t>(r) * a.W + c,
                       v[(i + n) * WW + (j + n)]);
        }
      }
    }
  }
}

// K4: the whole grid.
template <typename T>
__global__ void __launch_bounds__(THREADS_X* THREADS_Y)
    field_stencil_kernel(const __grid_constant__ FieldArgs a) {
  field_body<T>(a, WholeGrid<T>{a.H, a.W});
}

// K4-halo: one shard per channel and the channels' ghost rings.
template <typename T>
__global__ void __launch_bounds__(THREADS_X* THREADS_Y)
    field_stencil_halo_kernel(const __grid_constant__ FieldArgs a,
                              const __grid_constant__ FieldHalo x) {
  field_body<T>(a, ShardGrid<T>{x, a.H, a.W});
}

bool valid_operand(int kind, int arg, const FieldArgs& a,
                   const bool* written) {
  if (kind < 0 || kind >= K_END) return false;
  if (kind == K_SLOT) return arg >= 0 && arg < a.n_slots && written[arg];
  if (kind == K_CHAN) return arg >= 0 && arg < a.n_chan;
  return true;
}

// Host-side check of everything the kernel indexes with: counts within
// the arrays, channel, slot and output indices in range, slots written
// before they are read, and every written channel's sum started by a
// `first` acc before any other acc adds to it.
bool valid(const FieldArgs& a) {
  if (a.nsteps < 1 || a.nsteps > MAX_STEPS || a.H < 0 || a.W < 0) {
    return false;
  }
  if (a.tile_h != 8 && a.tile_h != 16 && a.tile_h != 32) return false;
  if (a.n_chan < 1 || a.n_chan > MAX_CHANNELS || a.n_out < 1 ||
      a.n_out > a.n_chan || a.n_slots < 0 || a.n_slots > MAX_SLOTS ||
      a.n_code < 1 || a.n_code > MAX_CODE || a.n_off < 1 ||
      a.n_off > MAX_OFFSETS) {
    return false;
  }
  for (int d = 0; d < a.n_off; ++d) {
    if (a.off_dx[d] < -1 || a.off_dx[d] > 1 || a.off_dy[d] < -1 ||
        a.off_dy[d] > 1) {
      return false;
    }
  }
  for (int o = 0; o < a.n_out; ++o) {
    if (a.out_chan[o] < 0 || a.out_chan[o] >= a.n_chan) return false;
  }
  bool written[MAX_SLOTS] = {};
  bool started[MAX_CHANNELS] = {};
  for (int pc = 0; pc < a.n_code; ++pc) {
    const int op = a.op[pc];
    if (op < OP_ADD || op >= OP_END) return false;
    if (!valid_operand(a.a_kind[pc], a.a_arg[pc], a, written)) return false;
    if (op < OP_NEG &&
        !valid_operand(a.b_kind[pc], a.b_arg[pc], a, written)) {
      return false;
    }
    const int d = a.dst[pc];
    if (op == OP_ACC) {
      if (d < 0 || d >= a.n_out || (!a.first[pc] && !started[d])) {
        return false;
      }
      started[d] = true;
    } else {
      if (d < 0 || d >= a.n_slots) return false;
      written[d] = true;
    }
  }
  for (int o = 0; o < a.n_out; ++o) {
    if (!started[o]) return false;
  }
  return true;
}

int smem_bytes(const FieldArgs& a) {
  const int planes = a.n_chan + a.n_out + (a.n_slots > 1 ? a.n_slots : 1);
  return planes * (a.tile_h + 2 * a.nsteps) * (TILE_W + 2 * a.nsteps) *
         static_cast<int>(sizeof(float));
}

// Raise the kernel's dynamic shared memory limit once it needs more than
// the default 48 KB; `limit` is the instance's own record of what it has.
template <typename K>
cudaError_t fit_smem(K kernel, int smem, int* limit) {
  if (smem <= *limit) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) *limit = smem;
  return e;
}

template <typename T>
int launch(const FieldArgs* args, void* stream) {
  if (args == nullptr || !valid(*args)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FieldArgs& a = *args;
  if (a.H == 0 || a.W == 0) return 0;
  const int smem = smem_bytes(a);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  cudaError_t e = fit_smem(field_stencil_kernel<T>, smem, &smem_limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.W + TILE_W - 1) / TILE_W,
                  (a.H + a.tile_h - 1) / a.tile_h);
  const dim3 block(THREADS_X, THREADS_Y);
  field_stencil_kernel<T><<<grid, block, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// K4-halo: the program's checks, then a ring at least nsteps deep and the
// shard (FieldArgs' H x W) inside the global grid.
template <typename T>
int launch_halo(const FieldArgs* args, const FieldHalo* halo, void* stream) {
  if (args == nullptr || halo == nullptr || !valid(*args)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FieldArgs& a = *args;
  const FieldHalo& x = *halo;
  if (x.d < a.nsteps || x.d > MAX_STEPS || x.R0 < 0 || x.C0 < 0 ||
      x.R0 + a.H > x.H || x.C0 + a.W > x.W) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.H == 0 || a.W == 0) return 0;
  const int smem = smem_bytes(a);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  static int smem_limit = DEFAULT_SMEM_LIMIT;  // per template instance
  cudaError_t e = fit_smem(field_stencil_halo_kernel<T>, smem, &smem_limit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.W + TILE_W - 1) / TILE_W,
                  (a.H + a.tile_h - 1) / a.tile_h);
  const dim3 block(THREADS_X, THREADS_Y);
  field_stencil_halo_kernel<T><<<grid, block, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a, x);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mm_field_stencil_f32(const void* args, void* stream) {
  return launch<float>(static_cast<const FieldArgs*>(args), stream);
}

int mm_field_stencil_bf16(const void* args, void* stream) {
  return launch<__nv_bfloat16>(static_cast<const FieldArgs*>(args), stream);
}

int mm_field_halo_f32(const void* args, const void* halo, void* stream) {
  return launch_halo<float>(static_cast<const FieldArgs*>(args),
                            static_cast<const FieldHalo*>(halo), stream);
}

int mm_field_halo_bf16(const void* args, const void* halo, void* stream) {
  return launch_halo<__nv_bfloat16>(static_cast<const FieldArgs*>(args),
                                    static_cast<const FieldHalo*>(halo),
                                    stream);
}

int mm_field_args_size() { return static_cast<int>(sizeof(FieldArgs)); }

int mm_field_halo_size() { return static_cast<int>(sizeof(FieldHalo)); }

const char* mm_field_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
