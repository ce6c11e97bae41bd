// Viterbi decode: max-product forward pass and backtrace in one launch.
//
// Replaces the Pallas TPU kernel promonet_tpu/ops/viterbi.py::_decode_kernel
// (pallas_call in _decode_pallas). On the main path it decodes the pitch
// posteriorgram: observation (T, 256) float32 with T the frame bucket
// (64..4096), a dense (256, 256) log transition (triangular band of
// half-width 9, -1e30 outside) and a (256,) initial distribution.
//
// Design. One thread block per sequence, one thread per destination state
// (a thread walks states j, j + blockDim.x, ... when N exceeds the block).
// The alpha vector lives in shared memory, double-buffered so that frame t
// reads one buffer while it writes the other, with one __syncthreads per
// frame. The transition is 256 KB at N = 256, more than a block's shared
// memory, so each thread reads its column from device memory: for a fixed
// source state i the threads of a warp read neighbouring addresses, and
// the whole matrix stays in L2 across frames. Each thread scans i upward
// and takes a new maximum only on a strict '>', so ties keep the first
// index, as jnp.argmax does. Predecessors go to a (T, N) int32 buffer in
// device memory that the caller allocates; after the forward pass thread 0
// takes the argmax of the final alpha and follows the predecessors back.
// The arithmetic is the plain version's, one float add per candidate and
// one per frame, so the path is bit-identical to it.
//
// Bound. This kernel does T * N * N adds and compares (1.2e8 at T = 896,
// N = 256), but the pitch transition's band holds only 17 entries per
// column above the -1e30 floor, so the data needs 17 / 256 of that on the
// float32 units; the bytes moved once are the observation, the transition
// and the path (about 1.2 MB). Both bounds are well under a millisecond;
// the kernel is latency-bound instead: T dependent
// steps, each reading 256 KB of transition from L2 into one SM. A faster
// kernel would keep the band of the transition in shared memory or
// registers and split the states over a cluster.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void viterbi_kernel(
    const float* __restrict__ observation,  // (B, T, N)
    const float* __restrict__ transition,   // (N, N)
    const float* __restrict__ initial,      // (N,)
    int* __restrict__ predecessors,         // (B, T, N)
    int* __restrict__ path,                 // (B, T)
    int frames,
    int states) {
  extern __shared__ float alpha[];  // 2 * states
  const int b = blockIdx.x;
  const float* obs = observation + (size_t)b * frames * states;
  int* pred = predecessors + (size_t)b * frames * states;

  for (int j = threadIdx.x; j < states; j += blockDim.x) {
    alpha[j] = initial[j] + obs[j];
  }
  __syncthreads();

  for (int t = 1; t < frames; ++t) {
    const float* previous = alpha + ((t - 1) & 1) * states;
    float* current = alpha + (t & 1) * states;
    for (int j = threadIdx.x; j < states; j += blockDim.x) {
      float best = -INFINITY;
      int arg = 0;
      for (int i = 0; i < states; ++i) {
        const float score = previous[i] + transition[(size_t)i * states + j];
        if (score > best) {
          best = score;
          arg = i;
        }
      }
      pred[(size_t)t * states + j] = arg;
      current[j] = best + obs[(size_t)t * states + j];
    }
    __syncthreads();
  }

  if (threadIdx.x == 0) {
    const float* last = alpha + ((frames - 1) & 1) * states;
    float best = -INFINITY;
    int state = 0;
    for (int i = 0; i < states; ++i) {
      if (last[i] > best) {
        best = last[i];
        state = i;
      }
    }
    int* out = path + (size_t)b * frames;
    out[frames - 1] = state;
    for (int t = frames - 1; t > 0; --t) {
      state = pred[(size_t)t * states + state];
      out[t - 1] = state;
    }
  }
}

}  // namespace

extern "C" int viterbi_decode(
    const float* observation,
    const float* transition,
    const float* initial,
    int* predecessors,
    int* path,
    int batch,
    int frames,
    int states,
    cudaStream_t stream) {
  int threads = states < 1024 ? ((states + 31) / 32) * 32 : 1024;
  size_t shared = 2 * (size_t)states * sizeof(float);
  if (shared > 48 * 1024) {
    cudaError_t status = cudaFuncSetAttribute(
        viterbi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shared);
    if (status != cudaSuccess) return (int)status;
  }
  viterbi_kernel<<<batch, threads, shared, stream>>>(
      observation, transition, initial, predecessors, path, frames, states);
  return (int)cudaGetLastError();
}
