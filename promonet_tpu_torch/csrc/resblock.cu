// One stage of the HiFi-GAN dilated residual block, for Hopper.
//
// Replaces the Pallas TPU kernel promonet_tpu/ops/resblock.py::_kernel
// (pallas_call in _pallas_forward). That kernel runs the block's whole
// six-conv chain per time tile with all six weight tensors resident in
// VMEM. At full width on this card it cannot: the weights of one block are
// 6 * 11 * 256 * 256 * 2 B = 8.7 MB and the exact halo at C = 256, k = 11
// is 60 rows per side, against 227 KB of shared memory per block. So the
// chain is split at each convolution: the wrapper
// (promonet_tpu_torch/ops/resblock.py::fused_block) launches this kernel
// six times per Block, for each dilation d
//     t = conv_d(lrelu(x)) + b         (into a bf16 buffer in device memory)
//     x = x + conv_1(lrelu(t)) + b     (residual added in the epilogue)
// The largest intermediate is (229376, 32) bf16 = 15 MB at the 896-frame
// bucket, which stays in the 50 MB L2.
//
// One launch computes out[b, t, co] for a tile of 64 time rows by 32 output
// channels per thread block (128 threads, four warps of 16 rows each):
//   prologue  - stage the input rows [t0 - pad, t0 + 64 + pad) of a 32-wide
//               input-channel slice in shared memory, leaky ReLU applied and
//               zeros outside the sequence ('same' zero padding; every conv
//               pads on its own, as the reference does), plus the k taps of
//               the matching 32 x 32 weight slice;
//   main loop - for each tap j, bf16 tensor-core products (WMMA 16x16x16)
//               of the rows shifted by j * d, accumulated in float32;
//   epilogue  - round to bf16, add the bias in bf16, round, add the residual
//               in bf16, round; rows past the sequence are never written.
// These are the rounding points of conv1d_shifted_dots and reference_block
// (fp32 accumulate, cast, bias add in the compute dtype), so the kernel
// differs from the plain chain only by the order of the float32 sums.
//
// Bound. The twelve Blocks of one utterance do
// 2 * sum(T * C^2) * (3 + 7 + 11) * 6 flop: 5.3e11 at the 896-frame bucket
// (0.54 ms at 989 TF/s bf16) and 7.6e11 at the 1280-frame bucket (0.77 ms).
// The bytes each Block must move (input, output, weights) are far below
// that, so the bound is the tensor cores. This first version is simple
// rather than fast: scalar loads into shared memory, no TMA, no wgmma,
// weights re-read from L2 by every time tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int BM = 64;        // time rows per thread block
constexpr int BN = 32;        // output channels per thread block
constexpr int BK = 32;        // input channels per step of the main loop
constexpr int LDA = BK + 16;  // shared row strides: 96 bytes, a multiple of
constexpr int LDB = BN + 16;  // the 32 bytes WMMA needs
constexpr int LDC = BN + 4;
constexpr int THREADS = 128;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(THREADS) conv_kernel(
    const __nv_bfloat16* __restrict__ input,     // (B, T, C)
    const __nv_bfloat16* __restrict__ weight,    // (k, C, C) [tap][in][out]
    const __nv_bfloat16* __restrict__ bias,      // (C,)
    const __nv_bfloat16* residual,               // (B, T, C) or null
    __nv_bfloat16* output,                       // (B, T, C)
    int frames,
    int channels,
    int kernel_size,
    int dilation,
    float slope) {
  extern __shared__ __align__(128) unsigned char shared[];
  const int pad = (kernel_size - 1) / 2 * dilation;
  const int rows = BM + (kernel_size - 1) * dilation;
  __nv_bfloat16* a_tile = reinterpret_cast<__nv_bfloat16*>(shared);
  __nv_bfloat16* b_tile = a_tile + rows * LDA;
  float* c_tile = reinterpret_cast<float*>(shared);

  const int t0 = blockIdx.x * BM;
  const int co0 = blockIdx.y * BN;
  const size_t offset = (size_t)blockIdx.z * frames * channels;
  const __nv_bfloat16* x = input + offset;
  const int warp = threadIdx.x / 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BN / 16];
#pragma unroll
  for (int n = 0; n < BN / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  for (int ci0 = 0; ci0 < channels; ci0 += BK) {
    for (int i = threadIdx.x; i < rows * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int t = t0 - pad + r, ci = ci0 + c;
      float v = 0.f;
      if (t >= 0 && t < frames && ci < channels) {
        v = __bfloat162float(x[(size_t)t * channels + ci]);
        if (v < 0.f) v = round_bf16(v * slope);
      }
      a_tile[r * LDA + c] = __float2bfloat16_rn(v);
    }
    for (int i = threadIdx.x; i < kernel_size * BK * BN; i += THREADS) {
      const int j = i / (BK * BN), c = (i / BN) % BK, n = i % BN;
      const int ci = ci0 + c, co = co0 + n;
      b_tile[(j * BK + c) * LDB + n] =
          (ci < channels && co < channels)
              ? weight[((size_t)j * channels + ci) * channels + co]
              : __float2bfloat16_rn(0.f);
    }
    __syncthreads();
    for (int j = 0; j < kernel_size; ++j) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(
            a, a_tile + (warp * 16 + j * dilation) * LDA + kk, LDA);
#pragma unroll
        for (int n = 0; n < BN / 16; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(
              b, b_tile + (j * BK + kk) * LDB + n * 16, LDB);
          wmma::mma_sync(acc[n], a, b, acc[n]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int n = 0; n < BN / 16; ++n) {
    wmma::store_matrix_sync(
        c_tile + warp * 16 * LDC + n * 16, acc[n], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < BM * BN; i += THREADS) {
    const int r = i / BN, n = i % BN;
    const int t = t0 + r, co = co0 + n;
    if (t >= frames || co >= channels) continue;
    const size_t index = offset + (size_t)t * channels + co;
    float v = round_bf16(c_tile[r * LDC + n]);
    v = round_bf16(v + __bfloat162float(bias[co]));
    if (residual != nullptr) {
      v = round_bf16(__bfloat162float(residual[index]) + v);
    }
    output[index] = __float2bfloat16_rn(v);
  }
}

}  // namespace

// out = [residual +] conv_{k, dilation}(lrelu(input)) + bias, 'same' zero
// padding, bf16 in and out. `residual` may alias `output`: each element is
// read and then written by the same thread.
extern "C" int resblock_conv(
    const void* input,
    const void* weight,
    const void* bias,
    const void* residual,
    void* output,
    int batch,
    int frames,
    int channels,
    int kernel_size,
    int dilation,
    float slope,
    cudaStream_t stream) {
  const int rows = BM + (kernel_size - 1) * dilation;
  size_t a_bytes = (size_t)rows * LDA * sizeof(__nv_bfloat16);
  size_t b_bytes = (size_t)kernel_size * BK * LDB * sizeof(__nv_bfloat16);
  size_t c_bytes = (size_t)BM * LDC * sizeof(float);
  size_t bytes = a_bytes + b_bytes > c_bytes ? a_bytes + b_bytes : c_bytes;
  if (bytes > 48 * 1024) {
    cudaError_t status = cudaFuncSetAttribute(
        conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (status != cudaSuccess) return (int)status;
  }
  dim3 grid((frames + BM - 1) / BM, (channels + BN - 1) / BN, batch);
  conv_kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(input),
      static_cast<const __nv_bfloat16*>(weight),
      static_cast<const __nv_bfloat16*>(bias),
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(output),
      frames, channels, kernel_size, dilation, slope);
  return (int)cudaGetLastError();
}
