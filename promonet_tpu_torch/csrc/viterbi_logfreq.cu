// Viterbi decode under the log-frequency locality transition: forward pass
// and backtrace in one cooperative launch.
//
// Replaces the Pallas TPU kernel
// promonet_tpu/ops/viterbi.py::_logfreq_forward_kernel (pallas_call in
// _logfreq_forward_pallas, wrapped by decode_logfreq). On the main path it
// decodes the harmonic contours: observation (T, N) float32 with N = 2039
// STFT bins and T = 861 frames for 10 s, three decodes per utterance.
//
// What it computes is the scan over the dense (N, N) log transition
//   log(max(max(0, 1 - locality * |log2 fi - log2 fj|) / rownorm_i, 1e-12)),
// first index on ties. The transition does not depend on the frame, and
// outside a band around the diagonal every entry is the floor log(1e-12).
// The TPU kernel recomputes each tile of it at every frame; here the caller
// builds a band table once per frequency axis: for destination j the entries
// of column j from the first to the last source above the floor, as float32
// values of the dense matrix, columns one after another. So the kernel only
// adds and compares, as the plain version does, and paths are bit-identical.
//
// Per destination j the maximum over all sources is the better of
//   (a) the first maximum of alpha[i] + table[i, j] over the column's run,
//   (b) the floor candidate: the first maximum over ALL i of
//       alpha[i] + floor (the sum, not alpha, is reduced: where the sum
//       rounds two alphas to one value the dense scan takes the first).
// Larger value wins; equal values take the smaller index. Every source
// outside the run scores exactly alpha[i] + floor and every table entry is
// at least the floor, so this is the dense scan's first argmax. A NaN in
// alpha counts as the maximum, the first one wins, and every destination
// then takes it, as jnp.argmax and torch.max do.
//
// Design. The table (3.0 MB at N = 2039) fits neither shared memory nor
// registers of one SM, so the destinations are split over one block per SM
// (contiguous ranges of about equal work, chosen by the caller), and each
// block keeps its slice of the table (about 23 KB) in shared memory for the
// whole decode. One warp scans one destination's run, lanes 32 sources
// apart, and reduces (value, first index) by shuffles. Each frame ends in
// a grid-wide barrier (an atomic counter; the cooperative launch guarantees
// that all blocks are resident), after which every block reloads the whole
// alpha vector (8 KB, double-buffered in device memory, read past L1) and
// reduces the floor candidate itself. After the last frame block 0 takes the
// first argmax of the final alpha and thread 0 follows the predecessors
// back. Any T >= 1 is accepted, and any N whose alpha vector and largest
// slice fit in a block's shared memory; the caller raises beyond that.
//
// Bound. Per frame one add and one compare for each in-band (i, j) pair
// (753,917 at N = 2039): 1.3 GFLOP for 861 frames, 19 us at 67 TFLOP/s; the
// bytes moved once (observation in, predecessors out, table in) are about
// 17 MB, 5 us at 3.35 TB/s. The kernel is bound by neither: it is a chain of
// T dependent steps, each a grid barrier and a reload of alpha from L2.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

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

__device__ __forceinline__ Candidate warp_best(Candidate own) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    Candidate other;
    other.value = __shfl_xor_sync(0xffffffffu, own.value, offset);
    other.index = __shfl_xor_sync(0xffffffffu, own.index, offset);
    if (better(other, own)) own = other;
  }
  return own;
}

// First maximum of values[i] + addend over i < count, for every thread of
// the block. `values` is in shared memory and complete; `scratch` is
// overwritten.
__device__ Candidate block_best(
    const float* values, int count, float addend, Candidate* scratch) {
  Candidate own = {-INFINITY, INT_MAX};
  for (int i = threadIdx.x; i < count; i += kThreads) {
    const Candidate next = {values[i] + addend, i};
    if (better(next, own)) own = next;
  }
  own = warp_best(own);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = own;
  __syncthreads();
  own = scratch[0];
  for (int warp = 1; warp < kWarps; ++warp) {
    if (better(scratch[warp], own)) own = scratch[warp];
  }
  return own;
}

// All blocks of the grid are resident (cooperative launch). `target` is the
// count the barrier's counter reaches once every block has arrived.
__device__ __forceinline__ void grid_barrier(
    unsigned int* counter, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*((volatile unsigned int*)counter) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) viterbi_logfreq_kernel(
    const float* __restrict__ observation,  // (T, N)
    const float* __restrict__ initial,      // (N,)
    const float* __restrict__ table,        // runs of all columns
    const int* __restrict__ offsets,        // (N + 1,) start of each run
    const int* __restrict__ lows,           // (N,) first source of each run
    const int* __restrict__ starts,         // (blocks + 1,) destinations
    float* alpha,                           // (2, N) scratch
    unsigned int* counter,                  // zeroed by the caller
    int* predecessors,                      // (T, N)
    int* path,                              // (T,)
    int frames,
    int states,
    int max_destinations,
    float floor_value) {
  extern __shared__ float shared[];
  __shared__ Candidate scratch[kWarps];
  float* alpha_s = shared;                    // states
  float* obs_s = alpha_s + states;            // max_destinations
  float* table_s = obs_s + max_destinations;  // this block's slice

  const int first = starts[blockIdx.x];
  const int count = starts[blockIdx.x + 1] - first;
  const int base = offsets[first];
  const int size = offsets[first + count] - base;
  for (int k = threadIdx.x; k < size; k += kThreads) {
    table_s[k] = table[base + k];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int k = threadIdx.x; k < count; k += kThreads) {
    const int j = first + k;
    __stcg(alpha + j, initial[j] + observation[j]);
  }
  grid_barrier(counter, gridDim.x);

  for (int t = 1; t < frames; ++t) {
    const float* previous = alpha + ((t - 1) & 1) * states;
    float* current = alpha + (t & 1) * states;
    const float* obs = observation + (size_t)t * states;
    int* pred = predecessors + (size_t)t * states;

    for (int i = threadIdx.x; i < states; i += kThreads) {
      alpha_s[i] = __ldcg(previous + i);
    }
    for (int k = threadIdx.x; k < count; k += kThreads) {
      obs_s[k] = obs[first + k];
    }
    __syncthreads();
    const Candidate floor_best =
        block_best(alpha_s, states, floor_value, scratch);

    if (floor_best.value != floor_best.value) {
      // A NaN in alpha is every destination's maximum
      for (int k = threadIdx.x; k < count; k += kThreads) {
        pred[first + k] = floor_best.index;
        __stcg(current + first + k, floor_best.value + obs_s[k]);
      }
    } else {
      for (int k = warp; k < count; k += kWarps) {
        const int j = first + k;
        const int low = lows[j];
        const int begin = offsets[j] - base;
        const int length = offsets[j + 1] - base - begin;
        Candidate own = {-INFINITY, INT_MAX};
        for (int r = lane; r < length; r += 32) {
          const float score = alpha_s[low + r] + table_s[begin + r];
          if (score > own.value) {
            own.value = score;
            own.index = low + r;
          }
        }
        own = warp_best(own);
        if (lane == 0) {
          if (better(floor_best, own)) own = floor_best;
          pred[j] = own.index;
          __stcg(current + j, own.value + obs_s[k]);
        }
      }
    }
    grid_barrier(counter, (unsigned int)(t + 1) * gridDim.x);
  }

  if (blockIdx.x == 0) {
    const float* last = alpha + ((frames - 1) & 1) * states;
    for (int i = threadIdx.x; i < states; i += kThreads) {
      alpha_s[i] = __ldcg(last + i);
    }
    __syncthreads();
    const Candidate final_best = block_best(alpha_s, states, 0.f, scratch);
    if (threadIdx.x == 0) {
      int state = final_best.index;
      path[frames - 1] = state;
      for (int t = frames - 1; t > 0; --t) {
        state = __ldcg(predecessors + (size_t)t * states + state);
        path[t - 1] = state;
      }
    }
  }
}

}  // namespace

extern "C" int viterbi_logfreq_decode(
    const float* observation,
    const float* initial,
    const float* table,
    const int* offsets,
    const int* lows,
    const int* starts,
    float* alpha,
    unsigned int* counter,
    int* predecessors,
    int* path,
    int frames,
    int states,
    int blocks,
    int max_destinations,
    int max_slice,
    float floor_value,
    cudaStream_t stream) {
  size_t shared =
      sizeof(float) * ((size_t)states + max_destinations + max_slice);
  cudaError_t status = cudaFuncSetAttribute(
      viterbi_logfreq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)shared);
  if (status != cudaSuccess) return (int)status;
  void* arguments[] = {
      &observation, &initial, &table, &offsets, &lows, &starts, &alpha,
      &counter, &predecessors, &path, &frames, &states, &max_destinations,
      &floor_value};
  status = cudaLaunchCooperativeKernel(
      (const void*)viterbi_logfreq_kernel, dim3(blocks), dim3(kThreads),
      arguments, shared, stream);
  if (status != cudaSuccess) return (int)status;
  return (int)cudaGetLastError();
}
