// The HiFi-GAN dilated residual block for Hopper: the two convolutions of one
// dilation in one launch, or one convolution per launch at wide blocks.
//
// Replaces the Pallas TPU kernel promonet_tpu/ops/resblock.py::_kernel
// (pallas_call in _pallas_forward). That kernel runs the block's six-conv
// chain per time tile with all six weight tensors resident in VMEM; at full
// width the weights of one block are 6 * 11 * 256 * 256 * 2 B = 8.7 MB
// against 227 KB of shared memory, so here the chain is split. One call of
// the C entry below (from promonet_tpu_torch/ops/resblock.py::fused_block)
// runs, for each dilation d,
//     t = conv_d(lrelu(x)) + b,   x = x + conv_1(lrelu(t)) + b
// up to 128 channels as ONE launch per dilation (three per Block) in which t
// never leaves the SM: a block computes BM rows of t, writes them activated
// into shared memory where the input lay, and the second convolution reads
// them there; its halo of (k - 1) / 2 rows a side is recomputed, so a block
// keeps BM - (k - 1) output rows. Above 128 channels a block cannot hold all
// of t's channels, and each convolution is its own launch (six per Block)
// with t in a bf16 buffer in device memory (5 MB at C = 256, in L2).
//
// What bounds it. The twelve Blocks of one utterance do
// 2 * sum(T * C^2) * (3 + 7 + 11) * 6 flop, 7.6e11 at the 1280-frame bucket
// (0.77 ms at 989 TF/s bf16), two thirds of it at C >= 128; the bytes that
// must move are far below that at C >= 128, so the bound is the tensor cores
// there. At C = 32 and 64 a convolution does about as little arithmetic per
// byte as the card's ratio, so bytes and launches set the time.
//
// What the design does about it.
//  * A convolution is k shifted products over one staged input tile. A block
//    is one warpgroup that computes MT tiles of 64 time rows (MT chosen by
//    the wrapper from measurements) by BN output channels: all of them for
//    C <= 128, 128 of them above. Every weight tile a block fetches from L2
//    feeds all its MT row tiles. The reduction runs over steps (slice of KC
//    input channels, tap); each step is KC / 16 wgmma.m64nBNk16 instructions
//    per row tile, bf16 in, float32 accumulators in registers.
//  * The weights are packed once by the wrapper into the tiles the steps
//    read, [n tile][slice][tap][BN x KC], each already in the swizzled
//    K-major image that wgmma's shared-memory descriptor wants (128-byte
//    swizzle at KC = 64, 64-byte at KC = 32). A step's tile is one contiguous
//    run of bytes, so one thread hands it to the copy engine as one bulk copy
//    (cp.async.bulk with an mbarrier) into a ring of kStages buffers, two
//    steps ahead: as 16-byte cp.async copies by all threads the same bytes
//    held the warps for a large part of a block's time, because the
//    instruction waits where the path from L2 is full.
//  * The input rows [t0 - pad, t0 + BM + pad) of one slice are staged once
//    per slice by 16-byte cp.async copies (zero-filled outside the sequence:
//    'same' zero padding, each conv on its own, as the reference pads),
//    also two steps ahead, into two buffers. The leaky ReLU is applied once
//    per staged element, in shared memory after arrival. Rows are XOR-
//    swizzled by 16-byte chunk so that ldmatrix reads without bank conflicts.
//  * A tap's shift of j * d rows is no multiple of wgmma's 8-row swizzle
//    atom, so A goes through registers: ldmatrix.x4 at row j * d gives each
//    warp its 16 x 16 fragments, and wgmma takes A from registers and B from
//    shared memory. One row tile's fragments are loaded while the previous
//    tile's products run.
//  * Epilogue: round to bf16, add the bias in bf16, round, add the residual
//    in bf16, round; rows past the sequence are never written. These are the
//    rounding points of conv1d_shifted and reference_block, so the kernel
//    differs from the plain chain only by the order of the float32 sums. The
//    tile passes through shared memory, so that the residual is read and the
//    output written in 16-byte pieces with several loads in flight: straight
//    from the accumulator layout a block spent more time waiting on one
//    4-byte residual load after another than on its products.
// The channel count the kernel sees is 32, 64 or a multiple of 128; the
// wrapper zero-pads other widths (exact: padded channels stay zero).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStages = 3;  // weight tiles in the ring; copies run 2 ahead
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 bytes from device to shared memory; zeros where !valid
__device__ __forceinline__ void copy16(uint32_t target, const void* source,
                                       bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(target),
               "l"(source), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A transaction barrier in shared memory: the bulk copy of a weight tile
// reports its bytes to it, and the threads that read the tile wait on it
__device__ __forceinline__ void barrier_init(uint32_t barrier) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(barrier)
               : "memory");
}

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

// One contiguous run of bytes (a multiple of 16) from device to shared
// memory by the copy engine; completion is reported to `barrier`
__device__ __forceinline__ void bulk_copy(uint32_t target, const void* source,
                                          uint32_t bytes, uint32_t barrier) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(target),
      "l"(source), "r"(bytes), "r"(barrier)
      : "memory");
}

// Byte offset inside a tile of ROW_BYTES-wide rows, 16-byte chunks XORed
// with the 128-byte line index: the 128-byte swizzle for 128-byte rows and
// the 64-byte swizzle for 64-byte rows
template <int ROW_BYTES>
__device__ __forceinline__ uint32_t swizzle(uint32_t offset) {
  return offset ^ (((offset >> 7) & (ROW_BYTES / 16 - 1)) << 4);
}

__device__ __forceinline__ void load_fragment(uint32_t (&a)[4],
                                              uint32_t address) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(address)
      : "memory");
}

// Shared-memory descriptor of a K-major tile of ROW_BYTES-wide rows in the
// matching swizzle, 8-row groups one after another
template <int ROW_BYTES>
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t address) {
  uint64_t descriptor = (uint64_t)((address & 0x3FFFF) >> 4);
  descriptor |= (uint64_t)1 << 16;
  descriptor |= (uint64_t)((8 * ROW_BYTES) >> 4) << 32;
  descriptor |= (uint64_t)(ROW_BYTES == 128 ? 1 : 2) << 62;
  return descriptor;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// Keeps a register live, and its uses in order, across asynchronous wgmma
__device__ __forceinline__ void keep(float& value) {
  asm volatile("" : "+f"(value)::"memory");
}

__device__ __forceinline__ void keep(uint32_t& value) {
  asm volatile("" : "+r"(value)::"memory");
}

// acc (64 x BN, float32) += a (64 x 16 bf16, registers) x b (16 x BN bf16,
// shared memory, K-major)
template <int BN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void run(
      float (&acc)[16], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, "
      "%20, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void run(
      float (&acc)[32], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, "
      "%36, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void run(
      float (&acc)[64], const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, "
      "%68, p, 1, 1, 0;\n"
      "}\n"
      :
        "+f"(acc[0]), "+f"(acc[1]), "+f"(acc[2]), "+f"(acc[3]),
        "+f"(acc[4]), "+f"(acc[5]), "+f"(acc[6]), "+f"(acc[7]),
        "+f"(acc[8]), "+f"(acc[9]), "+f"(acc[10]), "+f"(acc[11]),
        "+f"(acc[12]), "+f"(acc[13]), "+f"(acc[14]), "+f"(acc[15]),
        "+f"(acc[16]), "+f"(acc[17]), "+f"(acc[18]), "+f"(acc[19]),
        "+f"(acc[20]), "+f"(acc[21]), "+f"(acc[22]), "+f"(acc[23]),
        "+f"(acc[24]), "+f"(acc[25]), "+f"(acc[26]), "+f"(acc[27]),
        "+f"(acc[28]), "+f"(acc[29]), "+f"(acc[30]), "+f"(acc[31]),
        "+f"(acc[32]), "+f"(acc[33]), "+f"(acc[34]), "+f"(acc[35]),
        "+f"(acc[36]), "+f"(acc[37]), "+f"(acc[38]), "+f"(acc[39]),
        "+f"(acc[40]), "+f"(acc[41]), "+f"(acc[42]), "+f"(acc[43]),
        "+f"(acc[44]), "+f"(acc[45]), "+f"(acc[46]), "+f"(acc[47]),
        "+f"(acc[48]), "+f"(acc[49]), "+f"(acc[50]), "+f"(acc[51]),
        "+f"(acc[52]), "+f"(acc[53]), "+f"(acc[54]), "+f"(acc[55]),
        "+f"(acc[56]), "+f"(acc[57]), "+f"(acc[58]), "+f"(acc[59]),
        "+f"(acc[60]), "+f"(acc[61]), "+f"(acc[62]), "+f"(acc[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

__device__ __forceinline__ uint32_t leaky2(uint32_t pair, float slope) {
  __nv_bfloat162 value = *reinterpret_cast<__nv_bfloat162*>(&pair);
  float low = __bfloat162float(value.x);
  float high = __bfloat162float(value.y);
  if (low < 0.f) low = low * slope;
  if (high < 0.f) high = high * slope;
  value.x = __float2bfloat16_rn(low);
  value.y = __float2bfloat16_rn(high);
  return *reinterpret_cast<uint32_t*>(&value);
}

// residual + value on two bf16 pairs, each sum rounded to bf16
__device__ __forceinline__ uint32_t add2(uint32_t residual, uint32_t value) {
  const __nv_bfloat162 r = *reinterpret_cast<__nv_bfloat162*>(&residual);
  const __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&value);
  __nv_bfloat162 sum;
  sum.x = __float2bfloat16_rn(__bfloat162float(r.x) + __bfloat162float(v.x));
  sum.y = __float2bfloat16_rn(__bfloat162float(r.y) + __bfloat162float(v.y));
  return *reinterpret_cast<uint32_t*>(&sum);
}

// PAIR = false: one convolution, `weight` the packed tiles of that conv,
//   output = [residual +] conv_{k, dilation}(lrelu(input)) + bias.
// PAIR = true (one n tile: C <= 128): both convolutions of one dilation,
//   `weight` and `bias` those of the two convs one after another,
//   output = input + conv_{k, 1}(lrelu(conv_{k, dilation}(lrelu(input)) + b0))
//            + b1,
//   with the intermediate in shared memory only. `output` must not alias
//   `input`: blocks read their neighbours' input rows as halo.
template <int BN, int KC, int MT, bool PAIR>
__global__ void __launch_bounds__(128) block_kernel(
    const __nv_bfloat16* __restrict__ input,   // (B, T, C)
    const __nv_bfloat16* __restrict__ weight,
    const __nv_bfloat16* __restrict__ bias,
    const __nv_bfloat16* residual,             // (B, T, C) or null (!PAIR)
    __nv_bfloat16* output,                     // (B, T, C)
    int frames,
    int channels,
    int kernel_size,
    int dilation,
    float slope,
    int a_buffers) {
  constexpr int ROW_BYTES = KC * 2;
  constexpr int CHUNKS = ROW_BYTES / 16;
  constexpr int BM = MT * 64;
  constexpr int THREADS = 128;
  constexpr int B_BYTES = BN * ROW_BYTES;
  constexpr int KSTEPS = KC / 16;

  extern __shared__ unsigned char raw[];
  const uint32_t raw_address = shared_address(raw);
  const uint32_t base = (raw_address + 1023u) & ~1023u;
  unsigned char* aligned = raw + (base - raw_address);
  // Rows of the staged input; of the intermediate (PAIR), which takes the
  // place of the input buffers once the first convolution is done
  const int rows = BM + (kernel_size - 1) * dilation;
  const int a_bytes = (rows * ROW_BYTES + 1023) / 1024 * 1024;
  const int t_rows = BM + kernel_size - 1;
  const int t_bytes = (t_rows * ROW_BYTES + 1023) / 1024 * 1024;
  // The ring's barriers lie in the 1 KB ahead of the aligned tiles
  const uint32_t barriers = base;
  const uint32_t b_base = base + 1024;
  const uint32_t a_base = b_base + kStages * B_BYTES;
  unsigned char* a_pointer = aligned + 1024 + kStages * B_BYTES;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // A pair block keeps BM - (k - 1) of the BM rows it computes: the second
  // convolution's halo is recomputed by the neighbours
  const int kept = PAIR ? BM - (kernel_size - 1) : BM;
  const int t0 = blockIdx.x * kept;
  const int n0 = blockIdx.y * BN;
  const int pad = (kernel_size - 1) / 2 * dilation;
  const int pad1 = PAIR ? (kernel_size - 1) / 2 : 0;
  const int slices = channels / KC;
  const int conv_steps = slices * kernel_size;
  const int steps = PAIR ? 2 * conv_steps : conv_steps;
  const size_t offset = (size_t)blockIdx.z * frames * channels;
  const __nv_bfloat16* x = input + offset;
  const __nv_bfloat16* tiles =
      weight + (size_t)blockIdx.y * conv_steps * (BN * KC);

  // Copies of step s: its weight tile, one bulk copy by one thread, and, at
  // the first tap of a slice of the first convolution, the slice's input
  // rows by all threads. Always commits, so that group s is step s
  auto start_copies = [&](int s) {
    if (s < steps) {
      const int q = s / kernel_size;
      if (tid == 0) {
        const uint32_t barrier = barriers + (s % kStages) * 8;
        barrier_expect(barrier, B_BYTES);
        bulk_copy(b_base + (s % kStages) * B_BYTES,
                  tiles + (size_t)s * (BN * KC), B_BYTES, barrier);
      }
      if (s < conv_steps && s - q * kernel_size == 0) {
        const uint32_t a_target = a_base + (q % a_buffers) * a_bytes;
        for (int i = tid; i < rows * CHUNKS; i += THREADS) {
          const int r = i / CHUNKS;
          const int c = i % CHUNKS;
          const int t = t0 - pad1 - pad + r;
          const bool valid = t >= 0 && t < frames;
          copy16(a_target + swizzle<ROW_BYTES>(r * ROW_BYTES + c * 16),
                 x + (size_t)(valid ? t : 0) * channels + q * KC + c * 8,
                 valid);
        }
      }
    }
    commit_copies();
  };

  // One accumulator and one set of A fragments per 64-row tile
  float acc[MT][BN / 2];
  uint32_t fragments[MT][KSTEPS][4];
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[m][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int i = 0; i < 4; ++i) fragments[m][ks][i] = 0u;
    }
  }

  // This lane's row (in tile 0) and 16-byte column of the 16 x 16 fragments
  const int fragment_row = warp * 16 + (lane & 15);
  const int fragment_chunk = lane >> 4;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) barrier_init(barriers + i * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < kStages - 1; ++s) start_copies(s);

  int s = 0;
#pragma unroll
  for (int phase = 0; phase < (PAIR ? 2 : 1); ++phase) {
    const int step_rows = phase == 0 ? dilation : 1;
    for (int q = 0; q < slices; ++q) {
      const uint32_t a_tile = phase == 0
                                  ? a_base + (q % a_buffers) * a_bytes
                                  : a_base + q * t_bytes;
      // Fragments of tile m at the tap whose first row is `shift`
      auto load_tile = [&](int m, int shift) {
        const int row = fragment_row + m * 64 + shift;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          load_fragment(
              fragments[m][ks],
              a_tile + swizzle<ROW_BYTES>(
                           row * ROW_BYTES + (ks * 2 + fragment_chunk) * 16));
        }
      };
      for (int j = 0; j < kernel_size; ++j, ++s) {
        // This step's input rows (own copies, then everyone's at the
        // barrier, which also frees the ring slot of step s - 1: its
        // products are complete) and its weight tile
        wait_copies<kStages - 2>();
        __syncthreads();
        barrier_wait(barriers + (s % kStages) * 8, (s / kStages) & 1);

        if (j == 0) {
          if (phase == 0) {
            // The leaky ReLU, once per staged element
            uint4* tile = reinterpret_cast<uint4*>(
                a_pointer + (q % a_buffers) * a_bytes);
            for (int i = tid; i < rows * CHUNKS; i += THREADS) {
              uint4 value = tile[i];
              value.x = leaky2(value.x, slope);
              value.y = leaky2(value.y, slope);
              value.z = leaky2(value.z, slope);
              value.w = leaky2(value.w, slope);
              tile[i] = value;
            }
            __syncthreads();
          }
          load_tile(0, 0);
        }

        // Tile m's products run while tile m + 1's fragments are loaded,
        // and the last tile's while tile 0's fragments of the next tap are
        const uint32_t b_tile = b_base + (s % kStages) * B_BYTES;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m > 0) load_tile(m, j * step_rows);
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) keep(acc[m][i]);
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
            Wgmma<BN>::run(acc[m], fragments[m][ks],
                           tile_descriptor<ROW_BYTES>(b_tile + ks * 32));
          }
          wgmma_commit();
        }
        // The copies of two steps on are handed over while this step's
        // products run (the hand-over itself takes a few hundred cycles);
        // their ring slot was read last by step s - 1, whose products were
        // complete before this step's barrier
        start_copies(s + kStages - 1);
        if (j + 1 < kernel_size) {
          wgmma_wait<MT - 1>();
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
            for (int i = 0; i < 4; ++i) keep(fragments[0][ks][i]);
          }
          load_tile(0, (j + 1) * step_rows);
        }
        wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
            for (int i = 0; i < 4; ++i) keep(fragments[m][ks][i]);
          }
#pragma unroll
          for (int i = 0; i < BN / 2; ++i) keep(acc[m][i]);
        }
      }
    }

    if (PAIR && phase == 0) {
      // The intermediate t = lrelu(conv + b0), rounded as the chain rounds
      // it, zero outside the sequence (the second conv pads on its own),
      // into shared memory where the input lay. Row r is time
      // t0 - pad1 + r; rows BM .. BM + k - 2 only feed discarded outputs.
      __syncthreads();
      for (int i = tid; i < (kernel_size - 1) * CHUNKS * slices;
           i += THREADS) {
        const int q = i / ((kernel_size - 1) * CHUNKS);
        const int rest = i % ((kernel_size - 1) * CHUNKS);
        *reinterpret_cast<uint4*>(a_pointer + q * t_bytes +
                                  BM * ROW_BYTES + rest * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int column = 8 * i + (lane & 3) * 2;
          const __nv_bfloat162 b2 =
              *reinterpret_cast<const __nv_bfloat162*>(bias + column);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m * 64 + warp * 16 + (lane >> 2) + 8 * h;
            const int t = t0 - pad1 + r;
            float low = round_bf16(acc[m][4 * i + 2 * h]);
            float high = round_bf16(acc[m][4 * i + 2 * h + 1]);
            low = round_bf16(low + __bfloat162float(b2.x));
            high = round_bf16(high + __bfloat162float(b2.y));
            if (low < 0.f) low = low * slope;
            if (high < 0.f) high = high * slope;
            if (t < 0 || t >= frames) low = high = 0.f;
            __nv_bfloat162 t2;
            t2.x = __float2bfloat16_rn(low);
            t2.y = __float2bfloat16_rn(high);
            *reinterpret_cast<__nv_bfloat162*>(
                a_pointer + (column / KC) * t_bytes +
                swizzle<ROW_BYTES>(r * ROW_BYTES + (column % KC) * 2)) = t2;
            acc[m][4 * i + 2 * h] = 0.f;
            acc[m][4 * i + 2 * h + 1] = 0.f;
          }
        }
      }
      // The next step's barrier orders these writes before the first
      // ldmatrix of the second convolution
    }
  }

  // Epilogue in two steps, so that device memory sees 16-byte accesses with
  // many loads in flight. First the accumulators, rounded to bf16 and with
  // the bias added in bf16, go to shared memory where the input lay
  // (acc[m][4 i + 2 h + e] is row 64 m + (lane / 4) + 8 h, column
  // 8 i + 2 (lane % 4) + e of this warp's 16 rows); rows are 16 bytes apart
  // from a multiple of 128 so that a warp's eight rows fall in eight banks.
  constexpr int PITCH = BN * 2 + 16;
  constexpr int OUT_CHUNKS = BN / 8;
  constexpr int ROUNDS = BM * OUT_CHUNKS / THREADS;
  constexpr int BATCH = ROUNDS < 4 ? ROUNDS : 4;
  const __nv_bfloat16* last_bias = PAIR ? bias + channels : bias;
  const __nv_bfloat16* add = PAIR ? input : residual;
  unsigned char* stage = a_pointer;
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) {
      const int column = 8 * i + (lane & 3) * 2;
      const __nv_bfloat162 b2 =
          *reinterpret_cast<const __nv_bfloat162*>(last_bias + n0 + column);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m * 64 + warp * 16 + (lane >> 2) + 8 * h;
        float low = round_bf16(acc[m][4 * i + 2 * h]);
        float high = round_bf16(acc[m][4 * i + 2 * h + 1]);
        __nv_bfloat162 out2;
        out2.x = __float2bfloat16_rn(low + __bfloat162float(b2.x));
        out2.y = __float2bfloat16_rn(high + __bfloat162float(b2.y));
        *reinterpret_cast<__nv_bfloat162*>(stage + r * PITCH + column * 2) =
            out2;
      }
    }
  }
  __syncthreads();
  // Then each thread takes 16-byte pieces of rows: residual in, add in bf16,
  // out; rows past the sequence, or past the rows a pair block keeps, are
  // never written
#pragma unroll
  for (int round = 0; round < ROUNDS; round += BATCH) {
    uint4 held[BATCH];
    size_t index[BATCH];
    bool wanted[BATCH];
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int piece = (round + u) * THREADS + tid;
      const int r = piece / OUT_CHUNKS;
      const int c = piece % OUT_CHUNKS;
      const int t = t0 + r;
      wanted[u] = r < kept && t < frames;
      index[u] = offset + (size_t)t * channels + n0 + c * 8;
      held[u] = make_uint4(0u, 0u, 0u, 0u);
      if (wanted[u] && add != nullptr) {
        held[u] = *reinterpret_cast<const uint4*>(add + index[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      if (!wanted[u]) continue;
      const int piece = (round + u) * THREADS + tid;
      uint4 value = *reinterpret_cast<const uint4*>(
          stage + (piece / OUT_CHUNKS) * PITCH + (piece % OUT_CHUNKS) * 16);
      if (add != nullptr) {
        value.x = add2(held[u].x, value.x);
        value.y = add2(held[u].y, value.y);
        value.z = add2(held[u].z, value.z);
        value.w = add2(held[u].w, value.w);
      }
      *reinterpret_cast<uint4*>(output + index[u]) = value;
    }
  }
}

template <int BN, int KC, int MT, bool PAIR>
int launch(const __nv_bfloat16* input, const __nv_bfloat16* weight,
           const __nv_bfloat16* bias, const __nv_bfloat16* residual,
           __nv_bfloat16* output, int batch, int frames, int channels,
           int kernel_size, int dilation, float slope, cudaStream_t stream) {
  constexpr int BM = MT * 64;
  const int kept = PAIR ? BM - (kernel_size - 1) : BM;
  if (kept < 1) return (int)cudaErrorInvalidValue;
  const int rows = BM + (kernel_size - 1) * dilation;
  const int a_bytes = (rows * KC * 2 + 1023) / 1024 * 1024;
  // Input rows are copied kStages - 1 steps ahead: two buffers are enough
  // when a slice lasts at least that many steps
  const int a_buffers = kernel_size >= kStages - 1 ? 2 : 3;
  // The epilogue stages the output tile where the input buffers lay
  const int staging = BM * (BN * 2 + 16);
  const int region = a_buffers * a_bytes > staging ? a_buffers * a_bytes
                                                   : staging;
  const int bytes = 2048 + kStages * BN * KC * 2 + region;
  // The attribute belongs to the function on one device: raise it only
  // when a launch needs more than any before it did there
  static int configured[kMaxDevices] = {};
  int device = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status != cudaSuccess) return (int)status;
  if (device >= kMaxDevices || bytes > configured[device]) {
    status = cudaFuncSetAttribute(
        block_kernel<BN, KC, MT, PAIR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (status != cudaSuccess) return (int)status;
    if (device < kMaxDevices) configured[device] = bytes;
  }
  dim3 grid((frames + kept - 1) / kept, channels / BN, batch);
  block_kernel<BN, KC, MT, PAIR><<<grid, 128, bytes, stream>>>(
      input, weight, bias, residual, output, frames, channels, kernel_size,
      dilation, slope, a_buffers);
  return (int)cudaGetLastError();
}

template <int BN, int KC, bool PAIR>
int launch(int tiles, const __nv_bfloat16* input,
           const __nv_bfloat16* weight, const __nv_bfloat16* bias,
           const __nv_bfloat16* residual, __nv_bfloat16* output, int batch,
           int frames, int channels, int kernel_size, int dilation,
           float slope, cudaStream_t stream) {
  // Row tiles per block are bounded by the accumulators' registers: two at
  // 128 output channels, four below
#define RESBLOCK_TILES(MT)                                                    \
  if (tiles == MT) {                                                          \
    return launch<BN, KC, MT, PAIR>(input, weight, bias, residual, output,    \
                                    batch, frames, channels, kernel_size,     \
                                    dilation, slope, stream);                 \
  }
  RESBLOCK_TILES(1)
  RESBLOCK_TILES(2)
  if constexpr (BN <= 64) {
    RESBLOCK_TILES(4)
  }
#undef RESBLOCK_TILES
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The whole Block in one call: for each of the `count` dilations
//     x = x + conv_1(lrelu(conv_d(lrelu(x)) + b)) + b.
// `channels` is 32, 64 or a multiple of 128; `weights` and `biases` are the
// packed tensors of ops/resblock.py::pack_weights, 2 * count convolutions
// one after another; `hidden` and `output` are (B, T, C) buffers the caller
// allocates, and the result is in `output`. Up to 128 channels each dilation
// is one launch (the pair kernel, which alternates between the two buffers);
// above, two launches with the intermediate in `hidden`. `tiles` sets the
// time rows per thread block, 64 each: 1 or 2, or 4 at 32 and 64 channels.
extern "C" int resblock_block(
    const void* input,
    const void* weights,
    const void* biases,
    void* hidden,
    void* output,
    int batch,
    int frames,
    int channels,
    int kernel_size,
    const int* dilations,
    int count,
    float slope,
    int tiles,
    cudaStream_t stream) {
  if (kernel_size < 1 || kernel_size % 2 == 0 || count < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(weights);
  const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(biases);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(input);
  __nv_bfloat16* t = static_cast<__nv_bfloat16*>(hidden);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(output);
  const size_t conv_weights = (size_t)kernel_size * channels * channels;
  for (int i = 0; i < count; ++i) {
    if (dilations[i] < 1) return (int)cudaErrorInvalidValue;
    const __nv_bfloat16* wi = w + 2 * i * conv_weights;
    const __nv_bfloat16* bi = b + 2 * i * channels;
    int status;
    if (channels <= 128) {
      // The last pair writes `output`, the pairs before it alternate
      __nv_bfloat16* target = (count - 1 - i) % 2 == 0 ? out : t;
      if (channels == 32) {
        status = launch<32, 32, true>(tiles, x, wi, bi, nullptr, target, batch,
                                      frames, channels, kernel_size,
                                      dilations[i], slope, stream);
      } else if (channels == 64) {
        status = launch<64, 64, true>(tiles, x, wi, bi, nullptr, target, batch,
                                      frames, channels, kernel_size,
                                      dilations[i], slope, stream);
      } else if (channels == 128) {
        status = launch<128, 64, true>(tiles, x, wi, bi, nullptr, target,
                                       batch, frames, channels, kernel_size,
                                       dilations[i], slope, stream);
      } else {
        status = (int)cudaErrorInvalidValue;
      }
      if (status != 0) return status;
      x = target;
    } else if (channels % 128 == 0) {
      status = launch<128, 64, false>(tiles, x, wi, bi, nullptr, t, batch,
                                      frames, channels, kernel_size,
                                      dilations[i], slope, stream);
      if (status != 0) return status;
      status = launch<128, 64, false>(tiles, t, wi + conv_weights,
                                      bi + channels, x, out, batch, frames,
                                      channels, kernel_size, 1, slope, stream);
      if (status != 0) return status;
      x = out;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return 0;
}
