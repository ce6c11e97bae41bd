// Viterbi decode over a dense log transition: max-product forward pass and
// backtrace in one launch, one thread block per sequence.
//
// Replaces the Pallas TPU kernel promonet_tpu/ops/viterbi.py::_decode_kernel
// (pallas_call in _decode_pallas). On the main path it decodes the pitch
// posteriorgram: observation (T, 256) float32 with T the frame bucket
// (64..4096), a (256, 256) log transition (triangular band of half-width 9,
// -1e30 outside) and a (256,) initial distribution.
//
// What bounds it. The bytes moved once (observation, transition, path) and
// the adds and compares this data needs (17 candidates per state and frame
// above the floor) both take microseconds on this card. The decode is a chain
// of T dependent frames inside one SM, so its time is T times the latency of
// one frame, plus the latency of the backtrace's T dependent look-ups.
//
// What the design does about it.
//  * Scan the band, not the column. The caller analyses the transition once
//    (ops/viterbi.py::band_form): `floor` is the matrix's smallest value and
//    for destination j the run [lows[j], lows[j] + length_j) covers every
//    source whose entry differs from it. The runs' values lie in shared
//    memory for the whole decode (17 KB for the pitch transition), and where
//    no run is longer than 32 each thread keeps its own in registers (the
//    scan is unrolled for 8, 16, 24 or 32 entries), so a frame costs a
//    thread about 17 shared loads, adds and compares: with eight warps on
//    four schedulers the frame's time is its instruction count. A
//    matrix whose runs do not fit (a random dense one: every run is the
//    whole column) is scanned over the same runs from the dense matrix in
//    device memory, neighbouring threads on neighbouring addresses.
//  * The floor candidate keeps it exact. Every source outside the run scores
//    alpha[i] + floor, and every entry inside is at least the floor, so the
//    first maximum over ALL i of the sums alpha[i] + floor (the sums, not
//    the alphas: a sum can round two alphas together, and the dense scan
//    then takes the first) stands for all of them. Each warp reduces the
//    sums of the alphas it has just written, so the frame's single
//    __syncthreads also publishes the candidate. The larger value wins,
//    equal values take the smaller index, and a NaN counts as the maximum
//    with the first NaN winning, as torch.max and jnp.argmax do; so -inf
//    observations and NaN frames decode as the dense scan does.
//  * Observation rows arrive by cp.async four frames ahead, each thread
//    copying the elements it will read itself, so no frame waits on device
//    memory.
//  * Predecessors are stored in the narrowest type that holds a state index
//    (one byte at 256 states) and the backtrace streams them back through
//    shared memory in chunks as large as the block's shared memory: every
//    thread copies, then one thread walks the chunk at shared-memory
//    latency instead of following T dependent loads through device memory.
//
// Only adds and compares touch the scores, one add per candidate and one per
// frame as in the plain version, so paths are bit-identical to it. Any
// T >= 1 and any batch are taken; `phases` runs the forward pass (1), the
// backtrace (2) or both (3), so that the two can be timed apart.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRing = 4;         // observation rows in flight
constexpr int kRegisterRun = 32;  // longest run kept in registers
constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;

struct Candidate {
  float value;
  int index;
};

// NaN counts as the maximum; among equals the smaller index wins
__device__ __forceinline__ bool better(Candidate a, Candidate b) {
  const bool a_nan = a.value != a.value;
  const bool b_nan = b.value != b.value;
  if (a_nan || b_nan) return a_nan && (!b_nan || a.index < b.index);
  return a.value > b.value || (a.value == b.value && a.index < b.index);
}

// Unsigned key whose order is the order of `better` on values: NaN above
// +inf, -0 equal to +0
__device__ __forceinline__ uint32_t order_key(float value) {
  if (value != value) return 0xFFFFFFFFu;
  const uint32_t bits = __float_as_uint(value + 0.f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// (key, index) pairs: larger key wins, equal keys take the smaller index.
// Key 0 stands for "no candidate" (no float maps to it).
struct Keyed {
  uint32_t key;
  int index;
};

__device__ __forceinline__ void take_better(Keyed& own, uint32_t key,
                                            int index) {
  if (key > own.key || (key == own.key && index < own.index)) {
    own.key = key;
    own.index = index;
  }
}

// The best pair of the warp, in every lane: two redux instructions
__device__ __forceinline__ Keyed warp_best(Keyed own) {
  Keyed best;
  best.key = __reduce_max_sync(0xffffffffu, own.key);
  best.index = __reduce_min_sync(
      0xffffffffu, own.key == best.key ? own.index : INT_MAX);
  return best;
}

// The best of the pairs that the block's warps left in `slots`
__device__ __forceinline__ Keyed block_best(const Keyed* slots, int warps,
                                            int lane) {
  Keyed own = {0u, INT_MAX};
  if (lane < warps) own = slots[lane];
  return warp_best(own);
}

__device__ __forceinline__ void copy_float_async(float* target,
                                                 const float* source) {
  const uint32_t address =
      static_cast<uint32_t>(__cvta_generic_to_shared(target));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(address),
               "l"(source)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename Entry, int RUN>
__global__ void __launch_bounds__(kMaxThreads) viterbi_kernel(
    const float* __restrict__ observation,  // (B, T, N)
    const float* __restrict__ dense,        // (N, N)
    const float* __restrict__ initial,      // (N,)
    const float* __restrict__ table,        // runs of all columns
    const int* __restrict__ offsets,        // (N + 1,) start of each run
    const int* __restrict__ lows,           // (N,) first source of each run
    Entry* predecessors,                    // (B, T, N)
    int* path,                              // (B, T)
    int frames,
    int states,
    int table_in_shared,  // entries of `table` to keep in shared memory, or 0
    int has_floor,
    float floor_value,
    int phases,
    int shared_bytes) {
  extern __shared__ __align__(16) unsigned char shared[];
  __shared__ Keyed warp_candidates[2][kMaxWarps];
  __shared__ int walk_state;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = (blockDim.x + 31) >> 5;
  const float* obs = observation + (size_t)blockIdx.x * frames * states;
  Entry* pred = predecessors + (size_t)blockIdx.x * frames * states;
  int* out = path + (size_t)blockIdx.x * frames;

  if (phases & 1) {
    float* alpha = reinterpret_cast<float*>(shared);  // 2 * states
    float* rows = alpha + 2 * states;                 // kRing * states
    int* offsets_s = reinterpret_cast<int*>(rows + kRing * states);
    int* lows_s = offsets_s + states + 1;
    float* table_s = reinterpret_cast<float*>(lows_s + states);

    for (int j = threadIdx.x; j <= states; j += blockDim.x) {
      offsets_s[j] = offsets[j];
    }
    for (int j = threadIdx.x; j < states; j += blockDim.x) {
      lows_s[j] = lows[j];
    }
    for (int i = threadIdx.x; i < table_in_shared; i += blockDim.x) {
      table_s[i] = table[i];
    }
    // Rows 1 .. kRing - 1 of the observation; each thread copies, and later
    // reads, only its own states, so its own wait_group is all it needs
    for (int row = 1; row < kRing; ++row) {
      if (row < frames) {
        for (int j = threadIdx.x; j < states; j += blockDim.x) {
          copy_float_async(rows + (row % kRing) * states + j,
                           obs + (size_t)row * states + j);
        }
      }
      commit_copies();
    }

    Keyed floor_own = {0u, INT_MAX};
    for (int j = threadIdx.x; j < states; j += blockDim.x) {
      const float value = initial[j] + obs[j];
      alpha[j] = value;
      take_better(floor_own, order_key(value + floor_value), j);
    }
    if (has_floor) {
      floor_own = warp_best(floor_own);
      if (lane == 0) warp_candidates[0][warp] = floor_own;
    }
    __syncthreads();

    // The first state of each thread keeps its run in registers
    int low0 = 0, begin0 = 0, length0 = 0;
    if (threadIdx.x < states) {
      low0 = lows_s[threadIdx.x];
      begin0 = offsets_s[threadIdx.x];
      length0 = offsets_s[threadIdx.x + 1] - begin0;
    }

    // RUN > 0: every thread has one state and its run, at most RUN long
    // and in shared memory, lies in registers for the whole decode
    float run_values[RUN > 0 ? RUN : 1];
    if (RUN > 0) {
#pragma unroll
      for (int r = 0; r < RUN; ++r) {
        run_values[r] = r < length0 ? table_s[begin0 + r] : -INFINITY;
      }
    }

    // With a floor a NaN in alpha shows in the floor candidate and wins
    // there, so the run scan itself need not look for it
    const bool nan_aware = !has_floor;
    for (int t = 1; t < frames; ++t) {
      const float* previous = alpha + ((t - 1) & 1) * states;
      float* current = alpha + (t & 1) * states;
      const float* row = rows + (t % kRing) * states;
      Entry* pred_row = pred + (size_t)t * states;

      // The first maximum over all sources of alpha + floor; the winner's
      // sum is taken anew, the same add on the same operands
      Candidate floor_best = {-INFINITY, INT_MAX};
      if (has_floor) {
        floor_best.index =
            block_best(warp_candidates[(t - 1) & 1], warps, lane).index;
        floor_best.value = previous[floor_best.index] + floor_value;
      }
      wait_copies<kRing - 2>();

      floor_own.key = 0u;
      floor_own.index = INT_MAX;
      for (int j = threadIdx.x; j < states; j += blockDim.x) {
        const bool first = j == threadIdx.x;
        const int low = first ? low0 : lows_s[j];
        const int begin = first ? begin0 : offsets_s[j];
        const int length = first ? length0 : offsets_s[j + 1] - begin;
        Candidate own = {-INFINITY, INT_MAX};
        if constexpr (RUN > 0) {
          if (length0 > 0) {
            // Every load and add is started at once. A run shorter than
            // RUN is padded with -inf, which never wins a strict '>'
            // (whatever the read past the run finds: it stays inside the
            // block's shared memory). The maximum is taken as a tree, the
            // right half winning only on a strict '>', which keeps the
            // first index: with two warps on a scheduler a frame's time is
            // the length of its chain of dependent instructions
            const float* sources = previous + low0;
            float scores[RUN > 0 ? RUN : 1];
            int indices[RUN > 0 ? RUN : 1];
#pragma unroll
            for (int r = 0; r < RUN; ++r) {
              scores[r] = sources[r] + run_values[r];
              indices[r] = r;
            }
#pragma unroll
            for (int stride = 1; stride < RUN; stride *= 2) {
#pragma unroll
              for (int r = 0; r + stride < RUN; r += 2 * stride) {
                if (scores[r + stride] > scores[r]) {
                  scores[r] = scores[r + stride];
                  indices[r] = indices[r + stride];
                }
              }
            }
            own.value = scores[0];
            own.index = indices[0];
            own.index += low0;
          }
        } else if (length > 0) {
          // The first source opens the scan, so that a column of -inf
          // keeps its first source as the dense scan does
          if (table_in_shared) {
            own.value = previous[low] + table_s[begin];
            own.index = low;
#pragma unroll 4
            for (int r = 1; r < length; ++r) {
              const float score = previous[low + r] + table_s[begin + r];
              if (score > own.value ||
                  (nan_aware && score != score && own.value == own.value)) {
                own.value = score;
                own.index = low + r;
              }
            }
          } else {
            const float* column = dense + (size_t)low * states + j;
            own.value = previous[low] + column[0];
            own.index = low;
            for (int r = 1; r < length; ++r) {
              const float score =
                  previous[low + r] + column[(size_t)r * states];
              if (score > own.value ||
                  (nan_aware && score != score && own.value == own.value)) {
                own.value = score;
                own.index = low + r;
              }
            }
          }
        }
        if (has_floor && better(floor_best, own)) own = floor_best;
        pred_row[j] = (Entry)own.index;
        const float value = own.value + row[j];
        current[j] = value;
        take_better(floor_own, order_key(value + floor_value), j);
      }
      if (has_floor) {
        floor_own = warp_best(floor_own);
        if (lane == 0) warp_candidates[t & 1][warp] = floor_own;
      }
      // Row t + kRing - 1 goes where row t - 1 lay, which this thread alone
      // read, one frame ago
      const int ahead = t + kRing - 1;
      if (ahead < frames) {
        for (int j = threadIdx.x; j < states; j += blockDim.x) {
          copy_float_async(rows + (ahead % kRing) * states + j,
                           obs + (size_t)ahead * states + j);
        }
      }
      commit_copies();
      __syncthreads();
    }
    wait_copies<0>();

    // First maximum of the final alpha
    const float* last = alpha + ((frames - 1) & 1) * states;
    Keyed final_own = {0u, INT_MAX};
    for (int j = threadIdx.x; j < states; j += blockDim.x) {
      take_better(final_own, order_key(last[j]), j);
    }
    final_own = warp_best(final_own);
    // Every read of warp_candidates lies before the last frame's barrier
    if (lane == 0) warp_candidates[0][warp] = final_own;
    __syncthreads();
    if (warp == 0) {
      const Keyed best = block_best(warp_candidates[0], warps, lane);
      if (lane == 0) {
        out[frames - 1] = best.index;
        walk_state = best.index;
      }
    }
  } else if (threadIdx.x == 0) {
    walk_state = out[frames - 1];
  }

  if (phases & 2) {
    // Rows hi, hi - 1, ..., 1 of the predecessors, a chunk at a time
    Entry* chunk = reinterpret_cast<Entry*>(shared);
    const size_t row_bytes = (size_t)states * sizeof(Entry);
    const int capacity = (int)((size_t)shared_bytes / row_bytes);
    const bool vector =
        row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(pred) % 16 == 0;
    for (int hi = frames - 1; hi >= 1;) {
      const int lo = hi - capacity + 1 > 1 ? hi - capacity + 1 : 1;
      __syncthreads();
      const Entry* source = pred + (size_t)lo * states;
      const size_t count = (size_t)(hi - lo + 1) * states;
      if (vector) {
        const int4* source16 = reinterpret_cast<const int4*>(source);
        int4* chunk16 = reinterpret_cast<int4*>(chunk);
        const size_t count16 = count * sizeof(Entry) / 16;
        for (size_t i = threadIdx.x; i < count16; i += blockDim.x) {
          chunk16[i] = source16[i];
        }
      } else {
        for (size_t i = threadIdx.x; i < count; i += blockDim.x) {
          chunk[i] = source[i];
        }
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        int state = walk_state;
        for (int t = hi; t >= lo; --t) {
          state = (int)chunk[(size_t)(t - lo) * states + state];
          out[t - 1] = state;
        }
        walk_state = state;
      }
      hi = lo - 1;
    }
  }
}

template <typename Entry, int RUN>
int launch(const float* observation, const float* dense, const float* initial,
           const float* table, const int* offsets, const int* lows,
           void* predecessors, int* path, int batch, int frames, int states,
           int table_in_shared, int has_floor, float floor_value, int phases,
           int shared_bytes, cudaStream_t stream) {
  cudaError_t status = cudaFuncSetAttribute(
      viterbi_kernel<Entry, RUN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shared_bytes);
  if (status != cudaSuccess) return (int)status;
  int threads = ((states + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  viterbi_kernel<Entry, RUN><<<batch, threads, shared_bytes, stream>>>(
      observation, dense, initial, table, offsets, lows,
      static_cast<Entry*>(predecessors), path, frames, states,
      table_in_shared, has_floor, floor_value, phases, shared_bytes);
  return (int)cudaGetLastError();
}

template <typename Entry>
int launch(int register_run, const float* observation,
           const float* dense, const float* initial, const float* table,
           const int* offsets, const int* lows, void* predecessors, int* path,
           int batch, int frames, int states, int table_in_shared,
           int has_floor, float floor_value, int phases, int shared_bytes,
           cudaStream_t stream) {
#define VITERBI_RUN(RUN)                                                     \
  if (register_run == RUN) {                                                 \
    return launch<Entry, RUN>(                                               \
        observation, dense, initial, table, offsets, lows, predecessors,     \
        path, batch, frames, states, table_in_shared, has_floor,             \
        floor_value, phases, shared_bytes, stream);                          \
  }
  VITERBI_RUN(8)
  VITERBI_RUN(16)
  VITERBI_RUN(24)
  VITERBI_RUN(32)
#undef VITERBI_RUN
  return launch<Entry, 0>(
      observation, dense, initial, table, offsets, lows, predecessors, path,
      batch, frames, states, table_in_shared, has_floor, floor_value, phases,
      shared_bytes, stream);
}

}  // namespace

// `entry_bytes` is the width of one predecessor (1, 2 or 4) and must hold a
// state index. `shared_bytes` is the block's dynamic shared memory: at least
// 4 * ((2 + 4) * states + 2 * states + 1 + table_in_shared) for the forward
// pass and one row of predecessors for the backtrace; more makes the
// backtrace's chunks longer. `max_run` is the longest run of the band form.
extern "C" int viterbi_decode(
    const float* observation,
    const float* dense,
    const float* initial,
    const float* table,
    const int* offsets,
    const int* lows,
    void* predecessors,
    int* path,
    int batch,
    int frames,
    int states,
    int table_in_shared,
    int has_floor,
    float floor_value,
    int max_run,
    int entry_bytes,
    int phases,
    int shared_bytes,
    cudaStream_t stream) {
  // Runs in registers: one state per thread, every run short, the table
  // resident, and a floor (whose candidate also carries a NaN in alpha)
  // (0: runs scanned from shared or device memory), in the smallest of
  // 8, 16, 24 and 32 registers that holds the longest run
  const bool fits = table_in_shared > 0 && has_floor && max_run >= 1 &&
                    max_run <= kRegisterRun && states <= kMaxThreads;
  const int fast = fits ? (max_run + 7) / 8 * 8 : 0;
  if (entry_bytes == 1) {
    return launch<uint8_t>(
        fast, observation, dense, initial, table, offsets, lows, predecessors,
        path, batch, frames, states, table_in_shared, has_floor, floor_value,
        phases, shared_bytes, stream);
  }
  if (entry_bytes == 2) {
    return launch<uint16_t>(
        fast, observation, dense, initial, table, offsets, lows, predecessors,
        path, batch, frames, states, table_in_shared, has_floor, floor_value,
        phases, shared_bytes, stream);
  }
  if (entry_bytes == 4) {
    return launch<int>(
        fast, observation, dense, initial, table, offsets, lows, predecessors,
        path, batch, frames, states, table_in_shared, has_floor, floor_value,
        phases, shared_bytes, stream);
  }
  return (int)cudaErrorInvalidValue;
}
