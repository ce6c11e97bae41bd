// FARGAN's subframe network, one launch a subframe: kernel K4.
//
// Replaces no TPU kernel. The JAX package runs FARGAN's frame loop as one
// nn.scan that XLA compiles for the TPU, with no Pallas kernel. The port
// runs the loop from Python, and each subframe of plain PyTorch was about 46
// launches of tiny GEMVs and elementwise kernels: the card sat idle while the
// host issued them. This kernel is promonet_tpu_torch/models/fargan.py::
// SubframeNetwork.forward itself, called once a subframe by the same loop
// (ops/fargan.py::subframe), so the module call stays, and with it every hook
// on it.
//
// What it computes, for the rows of one subframe:
//   x = [features 128, previous 64, lookback 68]          (the fwconv state)
//   f = glu(tanh(W_fw [x, state3]))
//   for k in 0..2: h_k = gru_k([g_{k-1}, lookback[2:66], previous], h_k),
//                  g_k = glu_k(h_k)                        (g_{-1} = f)
//   s = glu(tanh(W_skip [g_0, g_1, g_2, f, lookback[2:66], previous]))
//   out = bf16(tanh(W_out s))
// with glu(x) = x * sigmoid(W x) and the GRU cell of SubframeNetwork (gates
// r, z, n; its constant input bias and zero hidden bias read from the packed
// weights). Then it writes out, the new states h_k and x, the samples into
// the float32 history, and the NEXT subframe's previous subframe (= out) and
// pitch lookback (gathered from the history at the next row of the lookback
// index table, this subframe's samples read from shared memory), so that the
// loop issues no other launch.
//
// Rounding: products are bf16 weights times float32 activations with float32
// sums; every activation inside the call stays float32. What leaves the call
// is rounded to bf16 where the plain path rounds it: the output and the
// states (the history holds the bf16 output widened). Each rounding point is
// as fine as or finer than the plain path's.
//
// What bounds it. 2,246,656 bf16 weights (4.49 MB) a call, read from L2 (they
// stay resident from call to call), 4.5 MFLOP a row: at one row, 1.34 us of
// HBM bandwidth and 5 ns of tensor-core time. The real bound is latency:
// eleven dependent stages, each needing the whole vector of the one before.
//
// What the design does about it.
//  * One thread-block cluster of 16 blocks (the non-portable size). Block c
//    owns units [16c, 16c + 16) of every 256-wide layer (and samples
//    [4c, 4c + 4) of the output), so each block reads 1/16 of the weights.
//  * The weights of the later stages (each GRU's input projection and GLU,
//    the skip Dense and GLU, the output Dense: 178 KB a block) come in bulk
//    copies into shared memory, in four groups, each asked for a stage or
//    two before it is needed, so that the loads of the first stages do not
//    queue behind them; those (fwconv, its GLU, the hidden projections) go
//    to registers with the inputs. The resident weights are read once a
//    launch, the others once a tile of rows.
//  * A stage is warp-local: a warp computes two units (in a GRU stage their
//    three gates each), reduces each dot product with a fixed butterfly and
//    takes lane 0's sum, and its 32 lanes send the two units to the 16
//    blocks with st.async, each store counting its bytes on the target's
//    transaction barrier of that stage. A block waits on its own barrier for
//    the whole vector: no block-wide or cluster-wide barrier between stages,
//    one cluster barrier at each end of a tile of rows.
//  * The GRUs' hidden projections depend only on the carried states and run
//    while the first stage's vector travels.
//  * No atomics and fixed orders of summation, so two runs are bit-equal.
//  * Rows (B > 1) go in tiles of two, a cluster a tile, up to as many
//    clusters as the card holds at once; a cluster loops over its tiles with
//    its weights resident.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kHidden = 256;                           // hopsize
constexpr int kSubframe = 64;                          // samples a subframe
constexpr int kLookback = kSubframe + 4;               // 68
constexpr int kCond = 2 * kSubframe;                   // 128
constexpr int kInput = kCond + kSubframe + kLookback;  // 260
constexpr int kFw = 2 * kInput;                        // 520
constexpr int kGru = kHidden + 2 * kSubframe;          // 384
constexpr int kSkip = 4 * kHidden + 2 * kSubframe;     // 1152
constexpr int kGates = 3 * kHidden;                    // 768

constexpr int kCluster = 16;
constexpr int kThreads = 256;
constexpr int kUnits = kHidden / kCluster;       // 16 a block
constexpr int kOutUnits = kSubframe / kCluster;  // 4 a block
constexpr int kMaxClusters = 16;

// The packed weights (ops/fargan.py::pack_weights), in elements
constexpr size_t kOffFw = 0;
constexpr size_t kOffFwGlu = kOffFw + (size_t)kHidden * kFw;
constexpr size_t kOffGru = kOffFwGlu + (size_t)kHidden * kHidden;
constexpr size_t kGruIh = 0;
constexpr size_t kGruHh = kGruIh + (size_t)kGates * kGru;
constexpr size_t kGruGlu = kGruHh + (size_t)kGates * kHidden;
constexpr size_t kGruSize = kGruGlu + (size_t)kHidden * kHidden;
constexpr size_t kOffSkip = kOffGru + 3 * kGruSize;
constexpr size_t kOffSkipGlu = kOffSkip + (size_t)kHidden * kSkip;
constexpr size_t kOffOut = kOffSkipGlu + (size_t)kHidden * kHidden;
constexpr size_t kOffBias = kOffOut + (size_t)kSubframe * kHidden;
constexpr size_t kPacked = kOffBias + 3 * 2 * kGates;
static_assert(kOffBias == 2246656, "FARGAN's subframe has 2,246,656 weights");

// A block's resident weights in shared memory, in bf16 elements: for each
// GRU its 48 input-projection rows (gate by gate, 16 units each), then each
// GRU's GLU's 16 rows, the skip Dense's and GLU's 16 rows, the output's 4
constexpr int kWIh = 0;                               // [3][3][16][kGru]
constexpr int kWGlu = kWIh + 3 * 3 * kUnits * kGru;   // [3][16][kHidden]
constexpr int kWSkip = kWGlu + 3 * kUnits * kHidden;  // [16][kSkip]
constexpr int kWSkipGlu = kWSkip + kUnits * kSkip;    // [16][kHidden]
constexpr int kWOut = kWSkipGlu + kUnits * kHidden;   // [4][kHidden]
constexpr int kWeightElements = kWOut + kOutUnits * kHidden;

// The stages: each sends one vector to every block, counted on that block's
// transaction barrier of the stage
enum Stage {
  kStageFw,       // tanh(W_fw x)
  kStageF,        // f, fwconv's GLU
  kStageH0,       // each GRU's new state, then its GLU's output
  kStageG0,
  kStageH1,
  kStageG1,
  kStageH2,
  kStageG2,
  kStageSkip,     // tanh(W_skip ...)
  kStageSkipGlu,  // the skip GLU
  kStageOut,      // the output samples
  kStages
};
// Then the barriers of the resident weights' arrival, in four groups: each
// GRU's (its input projection and its GLU), then the skip's and output's
constexpr int kWeightBarriers = 4;

// Bytes of a stage's whole vector for R rows
__host__ __device__ constexpr int stage_bytes(int stage, int rows) {
  return 4 * rows * (stage == kStageOut ? kSubframe : kHidden);
}

// Shared memory of a block for tiles of R rows: floats, then the resident
// weights, then the barriers; every part 16-byte aligned
template <int R>
struct Layout {
  static constexpr int x = 0;                             // [R][kFw]
  static constexpr int state = x + R * kFw;               // [3][R][kHidden]
  static constexpr int fw = state + 3 * R * kHidden;      // [R][kHidden]
  // [g0 | g1 | g2 | f | lookback's middle | previous]: the skip input; GRU
  // k's input is [g_{k-1} (f for the first) | the last 128]
  static constexpr int skip_in = fw + R * kHidden;        // [R][kSkip]
  static constexpr int hidden = skip_in + R * kSkip;      // [3][R][kHidden]
  static constexpr int skip = hidden + 3 * R * kHidden;   // [R][kHidden]
  static constexpr int skip_glu = skip + R * kHidden;     // [R][kHidden]
  static constexpr int out = skip_glu + R * kHidden;      // [R][kSubframe]
  static constexpr int hh = out + R * kSubframe;          // [3][3 kUnits][R]
  static constexpr int ahead = hh + 9 * kUnits * R;       // [R][kLookback]
  static constexpr int ahead_own = ahead + R * kLookback;  // int, the same
  static constexpr int floats = (ahead_own + R * kLookback + 3) / 4 * 4;
  static constexpr int weight_bytes = 4 * floats;
  static constexpr int barrier_bytes = weight_bytes + 2 * kWeightElements;
  static constexpr int bytes =
      barrier_bytes + 8 * (kStages + kWeightBarriers);
};
static_assert(Layout<2>::bytes <= 232448, "K4 fits a block's shared memory");

struct Params {
  const bf16* weights;
  const bf16* features;
  const bf16* lookback;
  const bf16* previous;
  const bf16* state[4];
  long long features_stride, lookback_stride, previous_stride;
  long long state_stride[4];
  bf16* output;        // (rows, 64)
  bf16* state_out[4];  // (rows, 256) x 3, (rows, 260)
  float* window;       // the next subframe's history window, row stride
  long long window_stride;
  int history;         // its length; this subframe's samples are its last 64
  const long long* index;  // the next subframe's lookback indices, or null
  long long index_stride;
  bf16* lookback_next;  // (rows, 68), with index
  bf16* previous_next;  // (rows, 64), with index
  int rows;
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// The address of the same shared-memory location in block `rank`
__device__ __forceinline__ uint32_t remote_address(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ void barrier_init(uint32_t barrier) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(barrier)
               : "memory");
}

// This block's arrival on its barrier's current phase, which then also
// waits for `bytes` to arrive
__device__ __forceinline__ void barrier_expect(uint32_t barrier,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(barrier),
      "r"(bytes)
      : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void barrier_wait(uint32_t barrier,
                                             uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(barrier),
      "r"(parity)
      : "memory");
}

// A float into another block's shared memory, its four bytes counted on
// that block's transaction barrier
__device__ __forceinline__ void send(uint32_t address, float value,
                                     uint32_t barrier) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(address),
      "r"(__float_as_uint(value)), "r"(barrier)
      : "memory");
}

// `bytes` of device memory into this block's shared memory, counted on its
// barrier; both addresses 16-byte aligned, bytes a multiple of 16
__device__ __forceinline__ void copy_in(uint32_t target, const void* source,
                                        uint32_t bytes, uint32_t barrier) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(target),
      "l"(source), "r"(bytes), "r"(barrier)
      : "memory");
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float widen(bf16 x) { return __bfloat162float(x); }

// acc + the dot product of 8 bf16 weights with 8 floats, in a fixed order
__device__ __forceinline__ float dot8(uint4 w, float4 lo, float4 hi,
                                      float acc) {
  const __nv_bfloat162* pair = reinterpret_cast<const __nv_bfloat162*>(&w);
  const float2 a = __bfloat1622float2(pair[0]);
  const float2 b = __bfloat1622float2(pair[1]);
  const float2 c = __bfloat1622float2(pair[2]);
  const float2 d = __bfloat1622float2(pair[3]);
  acc = fmaf(a.x, lo.x, acc);
  acc = fmaf(a.y, lo.y, acc);
  acc = fmaf(b.x, lo.z, acc);
  acc = fmaf(b.y, lo.w, acc);
  acc = fmaf(c.x, hi.x, acc);
  acc = fmaf(c.y, hi.y, acc);
  acc = fmaf(d.x, hi.z, acc);
  return fmaf(d.y, hi.w, acc);
}

// Chunks lane, lane + 32, ... of ROWS rows of a (rows, 8 * chunks) matrix
// in device memory into registers; row_of(r) names the warp's r-th row
template <int ROWS, int CH, typename RowOf>
__device__ __forceinline__ void load_rows(uint4 (&w)[ROWS][CH],
                                          const bf16* matrix, int chunks,
                                          RowOf row_of, int lane) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const uint4* row =
        reinterpret_cast<const uint4*>(matrix) + (size_t)row_of(r) * chunks;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int c = lane + 32 * j;
      w[r][j] = c < chunks ? __ldg(row + c) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The warp's ROWS rows against R activation rows: weight(r, j, c) gives
// chunk c (= lane + 32 j) of row r, act(b, c) the address of the chunk's 8
// activations of row b. Every lane ends with lane 0's sums, each reduced in
// a fixed order
template <int R, int ROWS, int CH, typename Weight, typename Act>
__device__ __forceinline__ void dot_rows(Weight weight, Act act, int chunks,
                                         int lane, float (&acc)[ROWS][R]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < R; ++b) acc[r][b] = 0.f;
#pragma unroll
  for (int j = 0; j < CH; ++j) {
    const int c = lane + 32 * j;
    if (c < chunks) {
      uint4 w[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) w[r] = weight(r, j, c);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float4* a = reinterpret_cast<const float4*>(act(b, c));
        const float4 lo = a[0], hi = a[1];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          acc[r][b] = dot8(w[r], lo, hi, acc[r][b]);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
#pragma unroll
    for (int b = 0; b < R; ++b) {
#pragma unroll
      for (int offset = 16; offset; offset >>= 1)
        acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], offset);
      acc[r][b] = __shfl_sync(0xffffffffu, acc[r][b], 0);
    }
}

// Element e of a tile's inputs, row by row: x (kFw: features, previous,
// lookback, state 3), the states 0..2 (3 kHidden), then the lookback's
// middle and the previous subframe (2 kSubframe)
constexpr int kInRow = kFw + 3 * kHidden + 2 * kSubframe;

__device__ __forceinline__ float fetch(const Params& p, int row0, int e) {
  const int b = e / kInRow, k = e % kInRow;
  const long long row = row0 + b;
  if (row >= p.rows) return 0.f;
  if (k < kCond) return widen(p.features[row * p.features_stride + k]);
  if (k < kCond + kSubframe) {
    return widen(p.previous[row * p.previous_stride + k - kCond]);
  }
  if (k < kInput) {
    return widen(p.lookback[row * p.lookback_stride + k - kCond - kSubframe]);
  }
  if (k < kFw) {
    return widen(p.state[3][row * p.state_stride[3] + k - kInput]);
  }
  if (k < kFw + 3 * kHidden) {
    const int s = (k - kFw) / kHidden, j = (k - kFw) % kHidden;
    return widen(p.state[s][row * p.state_stride[s] + j]);
  }
  const int j = k - kFw - 3 * kHidden;
  return j < kSubframe
             ? widen(p.lookback[row * p.lookback_stride + 2 + j])
             : widen(p.previous[row * p.previous_stride + j - kSubframe]);
}

template <int R>
__device__ __forceinline__ void put(float* shared, int e, float v) {
  using L = Layout<R>;
  const int b = e / kInRow, k = e % kInRow;
  if (k < kFw) {
    shared[L::x + b * kFw + k] = v;
  } else if (k < kFw + 3 * kHidden) {
    const int s = (k - kFw) / kHidden, j = (k - kFw) % kHidden;
    shared[L::state + (s * R + b) * kHidden + j] = v;
  } else {
    // The lookback's middle and the previous subframe close every GRU
    // input and the skip input
    shared[L::skip_in + b * kSkip + 4 * kHidden + k - kFw - 3 * kHidden] = v;
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
    fargan_subframe_kernel(const Params p) {
  using L = Layout<R>;
  extern __shared__ float4 shared4[];
  float* shared = reinterpret_cast<float*>(shared4);
  float* x = shared + L::x;
  float* state = shared + L::state;
  float* fw = shared + L::fw;
  float* skip_in = shared + L::skip_in;
  float* hidden = shared + L::hidden;
  float* skip = shared + L::skip;
  float* skip_glu = shared + L::skip_glu;
  float* out = shared + L::out;
  float* hh = shared + L::hh;
  float* ahead = shared + L::ahead;
  int* ahead_own = reinterpret_cast<int*>(shared + L::ahead_own);
  const bf16* resident = reinterpret_cast<const bf16*>(
      reinterpret_cast<const char*>(shared4) + L::weight_bytes);
  const uint32_t barriers =
      shared_address(reinterpret_cast<char*>(shared4) + L::barrier_bytes);
  // Stage s's barrier; the weights' after the stages'
  auto barrier = [barriers](int s) { return barriers + 8u * s; };

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int unit0 = rank * kUnits;
  // Lane l takes unit 2 warp + l / 16 of a stage and sends it to block
  // l % 16
  const int half = lane >> 4, target = lane & 15;
  const int u = 2 * warp + half;
  const bf16* weights = p.weights;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages + kWeightBarriers; ++s) {
      barrier_init(barrier(s));
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // The first tile's vectors
    for (int s = 0; s < kStages; ++s) {
      barrier_expect(barrier(s), stage_bytes(s, R));
    }
  }
  // Group `group` of the resident weights, asked for by one thread of the
  // first tile when the stage before the one that needs it has gone
  auto ask = [&](int group) {
    const uint32_t base = shared_address(resident);
    const uint32_t arrival = barrier(kStages + group);
    auto rows = [&](int at, const bf16* source, int count, int width) {
      copy_in(base + 2 * at, source, 2 * count * width, arrival);
    };
    if (group < 3) {
      barrier_expect(arrival, 2 * (3 * kUnits * kGru + kUnits * kHidden));
      const bf16* gru = weights + kOffGru + group * kGruSize;
      for (int g = 0; g < 3; ++g) {
        rows(kWIh + (3 * group + g) * kUnits * kGru,
             gru + kGruIh + (size_t)(g * kHidden + unit0) * kGru, kUnits,
             kGru);
      }
      rows(kWGlu + group * kUnits * kHidden,
           gru + kGruGlu + (size_t)unit0 * kHidden, kUnits, kHidden);
    } else {
      barrier_expect(arrival, 2 * (kUnits * kSkip + kUnits * kHidden +
                                   kOutUnits * kHidden));
      rows(kWSkip, weights + kOffSkip + (size_t)unit0 * kSkip, kUnits,
           kSkip);
      rows(kWSkipGlu, weights + kOffSkipGlu + (size_t)unit0 * kHidden,
           kUnits, kHidden);
      rows(kWOut, weights + kOffOut + (size_t)kOutUnits * rank * kHidden,
           kOutUnits, kHidden);
    }
  };
  __syncthreads();
  // Every block of the cluster runs and has its barriers ready before any
  // block sends into it
  cluster_arrive();

  // Where this lane sends: each stage's barrier and vector in its target
  uint32_t remote_barrier[kStages];
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    remote_barrier[s] = remote_address(barrier(s), target);
  }
  const uint32_t remote_fw = remote_address(shared_address(fw), target);
  const uint32_t remote_skip_in =
      remote_address(shared_address(skip_in), target);
  const uint32_t remote_hidden =
      remote_address(shared_address(hidden), target);
  const uint32_t remote_skip = remote_address(shared_address(skip), target);
  const uint32_t remote_skip_glu =
      remote_address(shared_address(skip_glu), target);
  const uint32_t remote_out = remote_address(shared_address(out), target);

  // The GRU biases of this lane's unit, for each gate
  float bias_ih[3][3], bias_hh[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      const bf16* bias = weights + kOffBias + 2 * k * kGates;
      bias_ih[k][g] = widen(bias[g * kHidden + unit0 + u]);
      bias_hh[k][g] = widen(bias[kGates + g * kHidden + unit0 + u]);
    }

  // Row r of a warp's two-unit stage: unit 2 warp + r; of a GRU stage: unit
  // 2 warp + r / 3, gate r % 3 (rows 3 half + gate are this lane's)
  auto unit_row = [&](int r) { return unit0 + 2 * warp + r; };
  auto gate_row = [&](int r) {
    return (r % 3) * kHidden + unit0 + 2 * warp + r / 3;
  };
  // Resident rows `first`, `first` + 1, ... of a block of `width`-wide rows
  // at element `at` of the resident weights
  auto resident_rows = [resident](int at, int width, int first) {
    const uint4* rows =
        reinterpret_cast<const uint4*>(resident + at) + first * (width / 8);
    return [rows, width](int r, int, int c) {
      return rows[r * (width / 8) + c];
    };
  };
  // Activations: row b of `width`-wide vectors from `base`
  auto vector = [](const float* base, int width) {
    return [base, width](int b, int c) { return base + b * width + 8 * c; };
  };

  int parity = 0;
  const int clusters = gridDim.x / kCluster;
  for (int tile = blockIdx.x / kCluster; tile * R < p.rows;
       tile += clusters, parity ^= 1) {
    const int row0 = tile * R;
    const bool first_tile = tile == (int)(blockIdx.x / kCluster);

    // The loads of the tile, in the order their values are needed: block
    // 1's indices of the next subframe's lookback (the history's samples
    // there follow them), fwconv's weights, the inputs, fwconv's GLU's and
    // the hidden projections' weights, then the first resident group
    const bool gathers =
        p.index && rank == 1 && threadIdx.x < R * kLookback;
    const int gather_row = row0 + threadIdx.x / kLookback;
    long long at = 0;
    if (gathers && gather_row < p.rows) {
      at = p.index[gather_row * p.index_stride + threadIdx.x % kLookback];
    }
    uint4 wfw[2][3], wfg[2][1], whh[3][6][1];
    load_rows(wfw, weights + kOffFw, kFw / 8, unit_row, lane);
    constexpr int kLoads = (R * kInRow + kThreads - 1) / kThreads;
    float v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      v[i] = e < R * kInRow ? fetch(p, row0, e) : 0.f;
    }
    // What lies in the history at the next lookback, and where this
    // subframe's own samples go
    const int own = (int)(at - (p.history - kSubframe));
    float lying = 0.f;
    if (gathers && gather_row < p.rows && own < 0) {
      lying = p.window[gather_row * p.window_stride + at];
    }
    load_rows(wfg, weights + kOffFwGlu, kHidden / 8, unit_row, lane);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      load_rows(whh[k], weights + kOffGru + k * kGruSize + kGruHh,
                kHidden / 8, gate_row, lane);
    }
    if (first_tile && threadIdx.x == 0) ask(0);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < R * kInRow) put<R>(shared, e, v[i]);
    }
    if (gathers) {
      ahead[threadIdx.x] = lying;
      ahead_own[threadIdx.x] = own;
    }
    __syncthreads();
    if (rank == 0) {
      for (int e = threadIdx.x; e < R * kInput; e += kThreads) {
        const int b = e / kInput, k = e % kInput;
        if (row0 + b < p.rows) {
          p.state_out[3][(long long)(row0 + b) * kInput + k] =
              __float2bfloat16(x[b * kFw + k]);
        }
      }
    }

    // fwconv's Dense and tanh
    {
      float acc[2][R];
      dot_rows<R, 2, 3>([&](int r, int j, int) { return wfw[r][j]; },
                        vector(x, kFw), kFw / 8, lane, acc);
      if (first_tile) cluster_wait();
#pragma unroll
      for (int b = 0; b < R; ++b) {
        send(remote_fw + 4 * (b * kHidden + unit0 + u),
             tanhf(half ? acc[1][b] : acc[0][b]), remote_barrier[kStageFw]);
      }
    }
    if (first_tile && threadIdx.x == 0) ask(1);
    // The GRUs' hidden projections, from the carried states alone, while
    // the vector travels: rows 3 unit + gate of hh
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc[6][R];
      dot_rows<R, 6, 1>([&](int r, int j, int) { return whh[k][r][j]; },
                        vector(state + k * R * kHidden, kHidden),
                        kHidden / 8, lane, acc);
      if (lane == 0) {
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int b = 0; b < R; ++b) {
            hh[(k * 3 * kUnits + 6 * warp + r) * R + b] = acc[r][b];
          }
      }
    }
    __syncwarp();
    barrier_wait(barrier(kStageFw), parity);

    // fwconv's GLU: f, into the skip input (and so the first GRU's input)
    {
      float acc[2][R];
      dot_rows<R, 2, 1>([&](int r, int j, int) { return wfg[r][j]; },
                        vector(fw, kHidden), kHidden / 8, lane, acc);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        const float f = fw[b * kHidden + unit0 + u] *
                        sigmoid(half ? acc[1][b] : acc[0][b]);
        send(remote_skip_in + 4 * (b * kSkip + 3 * kHidden + unit0 + u), f,
             remote_barrier[kStageF]);
      }
    }
    if (first_tile && threadIdx.x == 0) ask(2);
    barrier_wait(barrier(kStageF), parity);

#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (first_tile) barrier_wait(barrier(kStages + k), 0);
      // GRU k: the input projection of the warp's two units over
      // [g_{k-1} (f for the first), the lookback's middle, the previous
      // subframe], then the gates of this lane's unit
      {
        const uint4* rows = reinterpret_cast<const uint4*>(
            resident + kWIh + 3 * k * kUnits * kGru);
        const float* g_in = skip_in + (k == 0 ? 3 : k - 1) * kHidden;
        float acc[6][R];
        dot_rows<R, 6, 2>(
            [&](int r, int, int c) {
              return rows[((r % 3) * kUnits + 2 * warp + r / 3) * (kGru / 8) +
                          c];
            },
            [&](int b, int c) {
              return c < kHidden / 8 ? g_in + b * kSkip + 8 * c
                                     : skip_in + b * kSkip + 4 * kHidden +
                                           8 * (c - kHidden / 8);
            },
            kGru / 8, lane, acc);
        const float* projected = hh + k * 3 * kUnits * R;
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const float ir = half ? acc[3][b] : acc[0][b];
          const float iz = half ? acc[4][b] : acc[1][b];
          const float in = half ? acc[5][b] : acc[2][b];
          const float r = sigmoid(ir + bias_ih[k][0] +
                                  projected[(3 * u) * R + b] + bias_hh[k][0]);
          const float z = sigmoid(iz + bias_ih[k][1] +
                                  projected[(3 * u + 1) * R + b] +
                                  bias_hh[k][1]);
          const float n =
              tanhf(in + bias_ih[k][2] +
                    r * (projected[(3 * u + 2) * R + b] + bias_hh[k][2]));
          const float h = state[(k * R + b) * kHidden + unit0 + u];
          const float next = n + z * (h - n);
          send(remote_hidden + 4 * ((k * R + b) * kHidden + unit0 + u), next,
               remote_barrier[kStageH0 + 2 * k]);
          if (target == 0 && row0 + b < p.rows) {
            p.state_out[k][(long long)(row0 + b) * kHidden + unit0 + u] =
                __float2bfloat16(next);
          }
        }
      }
      if (k == 0 && first_tile && threadIdx.x == 0) ask(3);
      barrier_wait(barrier(kStageH0 + 2 * k), parity);

      // GRU k's GLU: g_k, into the skip input (and the next GRU's input)
      {
        float acc[2][R];
        dot_rows<R, 2, 1>(
            resident_rows(kWGlu + k * kUnits * kHidden, kHidden, 2 * warp),
            vector(hidden + k * R * kHidden, kHidden), kHidden / 8, lane,
            acc);
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const float g = hidden[(k * R + b) * kHidden + unit0 + u] *
                          sigmoid(half ? acc[1][b] : acc[0][b]);
          send(remote_skip_in + 4 * (b * kSkip + k * kHidden + unit0 + u), g,
               remote_barrier[kStageG0 + 2 * k]);
        }
      }
      barrier_wait(barrier(kStageG0 + 2 * k), parity);
    }

    // The skip Dense and tanh
    if (first_tile) barrier_wait(barrier(kStages + 3), 0);
    {
      float acc[2][R];
      dot_rows<R, 2, 5>(resident_rows(kWSkip, kSkip, 2 * warp),
                        vector(skip_in, kSkip), kSkip / 8, lane, acc);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        send(remote_skip + 4 * (b * kHidden + unit0 + u),
             tanhf(half ? acc[1][b] : acc[0][b]), remote_barrier[kStageSkip]);
      }
    }
    barrier_wait(barrier(kStageSkip), parity);

    // The skip GLU
    {
      float acc[2][R];
      dot_rows<R, 2, 1>(resident_rows(kWSkipGlu, kHidden, 2 * warp),
                        vector(skip, kHidden), kHidden / 8, lane, acc);
#pragma unroll
      for (int b = 0; b < R; ++b) {
        send(remote_skip_glu + 4 * (b * kHidden + unit0 + u),
             skip[b * kHidden + unit0 + u] *
                 sigmoid(half ? acc[1][b] : acc[0][b]),
             remote_barrier[kStageSkipGlu]);
      }
    }
    barrier_wait(barrier(kStageSkipGlu), parity);

    // The output Dense and tanh, rounded to bf16: warp w < 4 takes sample
    // 4 rank + w, and its lane l < 16 sends it to block l
    if (warp < kOutUnits) {
      float acc[1][R];
      dot_rows<R, 1, 1>(resident_rows(kWOut, kHidden, warp),
                        vector(skip_glu, kHidden), kHidden / 8, lane, acc);
      const int sample = kOutUnits * rank + warp;
      if (half == 0) {
#pragma unroll
        for (int b = 0; b < R; ++b) {
          const bf16 o = __float2bfloat16(tanhf(acc[0][b]));
          send(remote_out + 4 * (b * kSubframe + sample), widen(o),
               remote_barrier[kStageOut]);
          const long long row = row0 + b;
          if (target == 0 && row < p.rows) {
            p.output[row * kSubframe + sample] = o;
            p.window[row * p.window_stride + p.history - kSubframe +
                     sample] = widen(o);
            if (p.previous_next) {
              p.previous_next[row * kSubframe + sample] = o;
            }
          }
        }
      }
    }

    // The next subframe's pitch lookback, its own samples now at hand
    if (p.index && rank == 1) {
      barrier_wait(barrier(kStageOut), parity);
      for (int e = threadIdx.x; e < R * kLookback; e += kThreads) {
        const int b = e / kLookback;
        const long long row = row0 + b;
        if (row < p.rows) {
          const int own = ahead_own[e];
          const float v = own >= 0 ? out[b * kSubframe + own] : ahead[e];
          p.lookback_next[row * kLookback + e % kLookback] =
              __float2bfloat16(v);
        }
      }
    }
    // Every stage of this tile has completed here once the output has (warp
    // 0 waited on each in turn); the next tile's vectors are expected, and
    // no block sends them before every block is done with this tile
    if (threadIdx.x == 0) {
      barrier_wait(barrier(kStageOut), parity);
      for (int s = 0; s < kStages; ++s) {
        barrier_expect(barrier(s), stage_bytes(s, R));
      }
    }
    __syncthreads();
    cluster_arrive();
    cluster_wait();
  }
}

template <int R>
cudaError_t launch(const Params& params, cudaStream_t stream) {
  const int shared_bytes = Layout<R>::bytes;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeClusterDimension;
  attribute.val.clusterDim.x = kCluster;
  attribute.val.clusterDim.y = 1;
  attribute.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = stream;
  config.attrs = &attribute;
  config.numAttrs = 1;
  // The kernel's attributes, and the clusters the card holds at once,
  // found once on each device
  constexpr int kDevices = 64;
  static int placeable[kDevices];
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return status;
  if (device >= kDevices) return cudaErrorInvalidDevice;
  if (!placeable[device]) {
    status = cudaFuncSetAttribute(fargan_subframe_kernel<R>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  shared_bytes);
    if (status != cudaSuccess) return status;
    // More than eight blocks in a cluster is the non-portable size
    status = cudaFuncSetAttribute(
        fargan_subframe_kernel<R>,
        cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (status != cudaSuccess) return status;
    int clusters = 0;
    status = cudaOccupancyMaxActiveClusters(
        &clusters, (const void*)fargan_subframe_kernel<R>, &config);
    if (status != cudaSuccess) return status;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    placeable[device] = clusters < kMaxClusters ? clusters : kMaxClusters;
  }
  const int tiles = (params.rows + R - 1) / R;
  const int clusters = tiles < placeable[device] ? tiles : placeable[device];
  config.gridDim = dim3(clusters * kCluster);
  status = cudaLaunchKernelEx(&config, fargan_subframe_kernel<R>, params);
  if (status != cudaSuccess) return status;
  return cudaGetLastError();
}

}  // namespace

// One frame loop's buffers (ops/fargan.py::Slots, mirrored there as a
// ctypes Structure): subframe i reads slot i of `features`, `lookback`,
// `previous` and `states` and writes slot i of `outputs`, slot i + 1 of
// `states`, `lookback` and `previous`, and columns history + 64 i onwards
// of `samples`
struct FarganPlan {
  const void* weights;
  const void* features;    // (subframes, rows, 128) bf16, slot stride below
  void* outputs;           // (subframes, rows, 64) bf16
  void* states[4];         // (subframes + 1, rows, width) bf16
  float* samples;          // (rows, history + 64 subframes) float32
  const long long* index;  // (rows, frames, 68) int64
  void* lookback;          // (subframes, rows, 68) bf16
  void* previous;          // (subframes, rows, 64) bf16
  void* stream;            // the stream the loop launches on
  long long features_slot;
  long long features_stride, lookback_stride, previous_stride;
  long long state_stride[4];
  long long samples_stride, index_stride;
  int rows, subframes, per_frame, history;
};

// Subframe `step` of the frame loop `plan`
extern "C" int fargan_subframe_step(const FarganPlan* plan, int step) {
  if (plan->rows < 1 || step < 0 || step >= plan->subframes ||
      plan->history < kSubframe) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = plan->rows;
  const int widths[4] = {kHidden, kHidden, kHidden, kInput};
  Params p;
  p.weights = static_cast<const bf16*>(plan->weights);
  p.features = static_cast<const bf16*>(plan->features) +
               step * plan->features_slot;
  p.lookback = static_cast<const bf16*>(plan->lookback) +
               (long long)step * rows * kLookback;
  p.previous = static_cast<const bf16*>(plan->previous) +
               (long long)step * rows * kSubframe;
  p.features_stride = plan->features_stride;
  p.lookback_stride = plan->lookback_stride;
  p.previous_stride = plan->previous_stride;
  for (int k = 0; k < 4; ++k) {
    p.state[k] = static_cast<const bf16*>(plan->states[k]) +
                 (long long)step * rows * widths[k];
    p.state_stride[k] = plan->state_stride[k];
    p.state_out[k] = static_cast<bf16*>(plan->states[k]) +
                     (long long)(step + 1) * rows * widths[k];
  }
  p.output = static_cast<bf16*>(plan->outputs) +
             (long long)step * rows * kSubframe;
  p.window = plan->samples + (long long)(step + 1) * kSubframe;
  p.window_stride = plan->samples_stride;
  p.history = plan->history;
  p.rows = rows;
  const int next = step + 1;
  if (next < plan->subframes) {
    p.index = plan->index + (long long)(next / plan->per_frame) * kLookback;
    p.index_stride = plan->index_stride;
    p.lookback_next = static_cast<bf16*>(plan->lookback) +
                      (long long)next * rows * kLookback;
    p.previous_next = static_cast<bf16*>(plan->previous) +
                      (long long)next * rows * kSubframe;
  } else {
    p.index = nullptr;
    p.index_stride = 0;
    p.lookback_next = nullptr;
    p.previous_next = nullptr;
  }
  cudaStream_t s = static_cast<cudaStream_t>(plan->stream);
  return (int)(rows == 1 ? launch<1>(p, s) : launch<2>(p, s));
}

// Elements of the packed weights the kernel reads
extern "C" long long fargan_subframe_packed() { return (long long)kPacked; }
