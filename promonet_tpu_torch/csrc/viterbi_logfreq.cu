// Viterbi decode under the log-frequency locality transition: forward pass
// and backtrace in one launch, one thread block cluster per sequence.
//
// Replaces the Pallas TPU kernel
// promonet_tpu/ops/viterbi.py::_logfreq_forward_kernel (pallas_call in
// _logfreq_forward_pallas, wrapped by decode_logfreq). On the main path it
// decodes the harmonic contours: observation (T, N) float32 with N = 2039
// STFT bins and T = 861 frames for 10 s, three decodes per utterance, the
// second and third as one batch.
//
// What it computes is the scan over the dense (N, N) log transition
//   log(max(max(0, 1 - locality * |log2 fi - log2 fj|) / rownorm_i, 1e-12)),
// first index on ties. The transition does not depend on the frame, and
// outside a band around the diagonal every entry is the floor log(1e-12).
// The TPU kernel recomputes each tile of it at every frame; here the caller
// packs the band once per frequency axis (ops/viterbi.py::cluster_plan) from
// the float32 values of the dense matrix. So the kernel only adds and
// compares, as the plain version does, and paths are bit-identical.
//
// Per destination j the maximum over all sources is the better of
//   (a) the first maximum of alpha[i] + table[i, j] over the band's rows,
//   (b) the floor candidate: the first maximum over ALL i of
//       alpha[i] + floor (the sum, not alpha, is reduced: where the sum
//       rounds two alphas to one value the dense scan takes the first).
// Larger value wins; equal values take the smaller index. Every source
// outside the rows scores exactly alpha[i] + floor and every table entry is
// at least the floor, so this is the dense scan's first argmax. A NaN in
// alpha counts as the maximum, the first one wins, and every destination
// then takes it, as jnp.argmax and torch.max do.
//
// What bounds it. Per frame one add and one compare for each in-band
// (i, j) pair (753,917 at N = 2039): 1.3 GFLOP for 861 frames, 19 us at
// 67 TFLOP/s; the bytes moved once are about 14 MB, 4 us at 3.35 TB/s. The
// decode is bound by neither: it is a chain of T dependent frames, and a
// frame costs the scan of the part of the table one SM holds (four issued
// instructions per pair: add, compare, two selects) plus what it takes to
// make the new alpha known to every block that scans.
//
// What the design does about it (the cluster route).
//  * One thread block cluster decodes one sequence; a batch is one cluster
//    per sequence in one launch. The table (3.0 MB at N = 2039) lies in the
//    registers and shared memory of the cluster's blocks for the whole
//    decode: sixteen blocks at N = 2039 (the non-portable size), one block
//    for a 200-state axis. Blocks have 512 threads, so that a thread may
//    take up to 128 registers.
//  * Destinations go four at a time (a group): its sources are the union of
//    the four runs, the entries outside a destination's own run are the
//    dense matrix's floor, and one 16-byte load brings a source row of all
//    four while the source's alpha sits in a register. A group's rows are
//    cut into segments of one thread each, of an odd length so that
//    neighbouring threads read neighbouring banks of alpha, laid out in
//    shared memory so that a warp reads consecutive 16-byte words. A thread
//    keeps the first twelve rows of its segment in registers (about half of
//    the table at N = 2039). It scans on a strict '>', so it keeps the first
//    index (phase 1); after a block barrier, a second phase combines a
//    destination's segments (several lanes per destination where a block
//    has few destinations), takes the floor candidate where it is better,
//    adds the observation and stages the new alpha.
//  * Push, not pull, and no fence. After a second block barrier each block
//    sends its staged alphas to every block of the cluster, itself included,
//    with one bulk copy per block (cp.async.bulk from shared memory into
//    distributed shared memory); the bytes' arrival counts on the
//    receiver's transaction barrier (mbarrier), on which its threads wait
//    at the top of the next frame. Alpha and the staging buffer are
//    double-buffered; that a block sends frame t only after it has all of
//    frame t - 1 keeps a fast block from overwriting what a slow one reads.
//    A release at cluster scope (barrier.cluster.arrive.release, or a
//    remote mbarrier arrive) costs about 800 cycles a frame on this card
//    and is used only once, before the backtrace.
//  * The floor candidate rides on phase 1: every thread reduces alpha +
//    floor over a few states of the whole local vector (an order-preserving
//    key packed with the inverted index into one word, two redux
//    instructions per warp), and after the block barrier every warp takes
//    the best of the warps' words.
//  * Observation rows of a block's destinations arrive by cp.async four
//    frames ahead; the segments' descriptors live in registers.
//  * Predecessors are two bytes wide. For the backtrace every block loads
//    chunks of predecessor rows into the shared memory the table occupied,
//    and the state is followed through local shared memory, handed from
//    block to block, one cluster barrier per chunk.
//
// The grid route (one cooperative launch over all SMs, one warp per run, a
// barrier through device memory per frame) decodes the axes whose table
// fits no cluster; ops/viterbi.py holds the rule.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace cluster_route {

constexpr int kGroup = 4;          // destinations per group
constexpr int kRegisterRows = 12;  // rows of a segment kept in registers
constexpr int kRing = 4;           // observation rows in flight
constexpr int kMaxThreads = 512;

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
// +inf, -0 equal to +0. No float maps to 0.
__device__ __forceinline__ uint32_t order_key(float value) {
  if (value != value) return 0xFFFFFFFFu;
  const uint32_t bits = __float_as_uint(value + 0.f);
  return (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
}

// (key, index) in one word: the larger word has the larger key and, among
// equal keys, the smaller index. 0 stands for "no candidate".
__device__ __forceinline__ unsigned long long pack(uint32_t key, int index) {
  return ((unsigned long long)key << 32) | (0xFFFFFFFFu - (uint32_t)index);
}

__device__ __forceinline__ int packed_index(unsigned long long word) {
  return (int)(0xFFFFFFFFu - (uint32_t)word);
}

// The largest word of the warp, in every lane: two redux instructions
__device__ __forceinline__ unsigned long long warp_largest(
    unsigned long long word) {
  const uint32_t key = (uint32_t)(word >> 32);
  const uint32_t best_key = __reduce_max_sync(0xffffffffu, key);
  const int best_index = __reduce_min_sync(
      0xffffffffu,
      (key == best_key && key != 0u) ? packed_index(word) : INT_MAX);
  return best_key == 0u ? 0ull : pack(best_key, best_index);
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* pointer) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(pointer));
}

// The address of the same shared-memory location in block `rank` of the
// cluster
__device__ __forceinline__ uint32_t remote_address(uint32_t local, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"(rank));
  return remote;
}

// A transaction barrier in shared memory: the stores of the new alpha into
// this block report their bytes to it, and the block's threads wait on it
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

// One bulk copy from this block's shared memory into another block's; the
// bytes' arrival counts on that block's transaction barrier. `bytes` is a
// multiple of 16 and both addresses are 16-byte aligned.
__device__ __forceinline__ void copy_remote(uint32_t target, uint32_t source,
                                            uint32_t bytes,
                                            uint32_t barrier) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(target),
      "r"(source), "r"(bytes), "r"(barrier)
      : "memory");
}

// Orders this thread's writes to shared memory before bulk copies that
// another thread starts after a block barrier
__device__ __forceinline__ void fence_bulk_copies() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void copy_float_async(float* target,
                                                 const float* source) {
  const uint32_t address = shared_address(target);
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

// One source row of a group: the source's alpha against four destinations
#define LOGFREQ_SCAN_ROW(entries, source_alpha, row)  \
  {                                                   \
    const float a_ = (source_alpha);                  \
    const float4 e_ = (entries);                      \
    const float s0_ = a_ + e_.x, s1_ = a_ + e_.y;     \
    const float s2_ = a_ + e_.z, s3_ = a_ + e_.w;     \
    if (s0_ > best0) { best0 = s0_; arg0 = (row); }   \
    if (s1_ > best1) { best1 = s1_; arg1 = (row); }   \
    if (s2_ > best2) { best2 = s2_; arg2 = (row); }   \
    if (s3_ > best3) { best3 = s3_; arg3 = (row); }   \
  }

// Sections of a frame whose cycles the kernel can count (kClocks): the wait
// for the frame before's alpha, phase 1, the block barrier after it, phase
// 2, the block barrier after it, the issue of the copies
constexpr int kSections = 6;

template <bool kClocks>
__global__ void __launch_bounds__(kMaxThreads, 1) logfreq_cluster_kernel(
    const float* __restrict__ observation,     // (B, T, N)
    const float* __restrict__ initial,         // (N,)
    const float4* __restrict__ register_rows,  // (C, kRegisterRows, threads)
    const float4* __restrict__ image,          // (C, table_rows)
    const int4* __restrict__ items,            // (C, threads)
    const int2* __restrict__ group_meta,       // (C, max_groups)
    const int4* __restrict__ block_info,       // (C,)
    uint16_t* predecessors,                    // (B, T, predecessor_stride)
    int* path,                                 // (B, T)
    int frames,
    int states,
    int predecessor_stride,
    int table_rows,
    int alpha_stride,
    int ring_stride,
    int max_groups,
    int frame_bytes,
    float floor_value,
    int phases,
    int shared_bytes,
    long long* cycles) {  // (2, kSections): first and last block, or null
  extern __shared__ __align__(16) unsigned char shared[];
  // The best of alpha + floor of each warp's share of the states
  __shared__ unsigned long long warp_words[kMaxThreads / 32];
  // Arrival of the new alpha, for two frames in turn
  __shared__ __align__(8) unsigned long long arrived[2];
  __shared__ int walk_state;

  cg::cluster_group cluster = cg::this_cluster();
  const int blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int sequence = blockIdx.x / blocks;
  const int tid = threadIdx.x;
  const int threads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warps = (threads + 31) >> 5;

  const float* obs = observation + (size_t)sequence * frames * states;
  uint16_t* pred =
      predecessors + (size_t)sequence * frames * predecessor_stride;
  int* out = path + (size_t)sequence * frames;

  if (phases & 1) {
    float4* table_s = reinterpret_cast<float4*>(shared);
    float* alpha_s = reinterpret_cast<float*>(table_s + table_rows);
    float* partial_value = alpha_s + 2 * alpha_stride;
    int* partial_index =
        reinterpret_cast<int*>(partial_value + kGroup * threads);
    float* ring = reinterpret_cast<float*>(partial_index + kGroup * threads);
    // This block's new alphas before they go to every block, for two
    // frames in turn: a copy may still read the frame before
    float* staging = ring + kRing * ring_stride;
    int2* meta_s = reinterpret_cast<int2*>(staging + 2 * ring_stride);

    const int4 info = block_info[rank];
    const int first = info.x;  // first destination of this block
    const int count = info.y;  // its number of destinations
    const int team = info.z;   // lanes that share a destination, 2^k <= 32
    const int team_shift = __ffs(team) - 1;
    const int member = tid & (team - 1);
    const int per_pass = threads >> team_shift;
    const int quads = (count + 3) >> 2;  // 16-byte pieces of its alphas
    // A cluster of one block writes its alphas where it reads them
    const bool alone = blocks == 1;

    for (int i = tid; i < table_rows; i += threads) {
      table_s[i] = image[(size_t)rank * table_rows + i];
    }
    for (int i = tid; i < 2 * alpha_stride; i += threads) alpha_s[i] = 0.f;
    for (int i = tid; i < 2 * ring_stride; i += threads) staging[i] = 0.f;
    for (int g = tid; g < max_groups; g += threads) {
      meta_s[g] = group_meta[(size_t)rank * max_groups + g];
    }
    if (tid == 0) {
      barrier_init(shared_address(&arrived[0]));
      barrier_init(shared_address(&arrived[1]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // src, rows, first row in the image, the image's row stride
    const int4 item = items[(size_t)rank * threads + tid];
    float4 held[kRegisterRows];
#pragma unroll
    for (int q = 0; q < kRegisterRows; ++q) {
      held[q] =
          register_rows[((size_t)rank * kRegisterRows + q) * threads + tid];
    }
    // Rows 0 .. kRing - 2 of this block's observations
    for (int row = 0; row < kRing - 1; ++row) {
      if (row < frames) {
        for (int k = tid; k < count; k += threads) {
          copy_float_async(ring + (row % kRing) * ring_stride + k,
                           obs + (size_t)row * states + first + k);
        }
      }
      commit_copies();
    }
    // Every block of the cluster runs, has cleared its buffers and has its
    // barriers ready
    cluster_arrive();
    cluster_wait();

    // Cycles of thread 0 in each section, summed over the frames after the
    // first
    long long marks[kSections + 1] = {};
    long long spent[kSections] = {};
    for (int t = 0; t < frames; ++t) {
      if (kClocks) marks[0] = clock64();
      const float* previous = alpha_s + ((t + 1) & 1) * alpha_stride;
      const int current = (t & 1) * alpha_stride;
      // This frame's alphas: every block sends its share to this one
      if (tid == 0 && !alone) {
        barrier_expect(shared_address(&arrived[t & 1]), frame_bytes);
      }
      // Row t + kRing - 1 goes where row t - 1 lay, read two block barriers
      // ago
      const int ahead = t + kRing - 1;
      if (ahead < frames) {
        for (int k = tid; k < count; k += threads) {
          copy_float_async(ring + (ahead % kRing) * ring_stride + k,
                           obs + (size_t)ahead * states + first + k);
        }
      }
      commit_copies();

      if (t > 0) {
        // The whole alpha of the frame before has arrived
        if (!alone) {
          barrier_wait(shared_address(&arrived[(t - 1) & 1]),
                       ((t - 1) >> 1) & 1);
        }
        if (kClocks) marks[1] = clock64();
        // Phase 1: this thread's segment against its group's destinations
        if (item.y > 0) {
          float best0 = -INFINITY, best1 = -INFINITY;
          float best2 = -INFINITY, best3 = -INFINITY;
          int arg0 = -1, arg1 = -1, arg2 = -1, arg3 = -1;
          const float* sources = previous + item.x;
#pragma unroll
          for (int q = 0; q < kRegisterRows; ++q) {
            LOGFREQ_SCAN_ROW(held[q], sources[q], q)
          }
          const float4* rows = table_s + item.z;
#pragma unroll 3
          for (int r = kRegisterRows; r < item.y; ++r) {
            LOGFREQ_SCAN_ROW(*rows, sources[r], r)
            rows += item.w;
          }
          reinterpret_cast<float4*>(partial_value)[tid] =
              make_float4(best0, best1, best2, best3);
          reinterpret_cast<int4*>(partial_index)[tid] = make_int4(
              arg0 < 0 ? INT_MAX : item.x + arg0,
              arg1 < 0 ? INT_MAX : item.x + arg1,
              arg2 < 0 ? INT_MAX : item.x + arg2,
              arg3 < 0 ? INT_MAX : item.x + arg3);
        }
        // and its share of the floor candidate: the first maximum over all
        // sources of alpha + floor
        unsigned long long word = 0ull;
        for (int j = tid; j < states; j += threads) {
          const unsigned long long next =
              pack(order_key(previous[j] + floor_value), j);
          if (next > word) word = next;
        }
        word = warp_largest(word);
        if (lane == 0) warp_words[warp] = word;
      }
      if (kClocks) marks[2] = clock64();
      wait_copies<kRing - 1>();
      __syncthreads();
      if (kClocks) marks[3] = clock64();

      // Phase 2: per destination the segments' results, the floor
      // candidate, the observation
      Candidate floor_best = {-INFINITY, INT_MAX};
      if (t > 0) {
        floor_best.index = packed_index(
            warp_largest(lane < warps ? warp_words[lane] : 0ull));
        floor_best.value = previous[floor_best.index] + floor_value;
      }
      const float* row = ring + (t % kRing) * ring_stride;
      float* staged =
          alone ? alpha_s + current : staging + (t & 1) * ring_stride;
      uint16_t* pred_row = pred + (size_t)t * predecessor_stride;
      for (int base = (warp << 5) >> team_shift; base < count;
           base += per_pass) {
        const int slot = base + (lane >> team_shift);
        const bool active = slot < count;
        Candidate own = {-INFINITY, INT_MAX};
        if (active && t > 0) {
          const int2 meta = meta_s[slot / kGroup];
          const int offset = meta.x * kGroup + (slot % kGroup);
          int segment = -1;
          for (int s = member; s < meta.y; s += team) {
            const float value = partial_value[offset + s * kGroup];
            if (value > own.value) {
              own.value = value;
              segment = s;
            }
          }
          if (segment >= 0) {
            own.index = partial_index[offset + segment * kGroup];
          }
        }
        for (int step = team >> 1; step > 0; step >>= 1) {
          Candidate other;
          other.value = __shfl_xor_sync(0xffffffffu, own.value, step);
          other.index = __shfl_xor_sync(0xffffffffu, own.index, step);
          if (other.value > own.value ||
              (other.value == own.value && other.index < own.index)) {
            own = other;
          }
        }
        if (active && member == 0) {
          if (t == 0) {
            staged[slot] = initial[first + slot] + row[slot];
          } else {
            if (better(floor_best, own)) own = floor_best;
            staged[slot] = own.value + row[slot];
            pred_row[first + slot] = (uint16_t)own.index;
          }
        }
      }
      if (kClocks) marks[4] = clock64();
      fence_bulk_copies();
      __syncthreads();
      if (kClocks) marks[5] = clock64();
      // To every block of the cluster, one bulk copy each
      if (tid < blocks && quads > 0 && !alone) {
        copy_remote(
            remote_address(shared_address(alpha_s + current + first), tid),
            shared_address(staged), 16 * quads,
            remote_address(shared_address(&arrived[t & 1]), tid));
      }
      if (kClocks && t > 0) {
        marks[6] = clock64();
        for (int i = 0; i < kSections; ++i) {
          spent[i] += marks[i + 1] - marks[i];
        }
      }
    }
    if (kClocks && tid == 0 && sequence == 0 &&
        (rank == 0 || rank == blocks - 1)) {
      for (int i = 0; i < kSections; ++i) {
        cycles[(rank == 0 ? 0 : kSections) + i] = spent[i];
      }
    }
    wait_copies<0>();
    // The last frame's alpha
    if (!alone) {
      barrier_wait(shared_address(&arrived[(frames - 1) & 1]),
                   ((frames - 1) >> 1) & 1);
    }

    // First maximum of the final alpha
    if (rank == 0) {
      const float* last = alpha_s + ((frames - 1) & 1) * alpha_stride;
      unsigned long long own = 0ull;
      for (int j = tid; j < states; j += threads) {
        const unsigned long long next = pack(order_key(last[j]), j);
        if (next > own) own = next;
      }
      own = warp_largest(own);
      __syncthreads();
      if (lane == 0) warp_words[warp] = own;
      __syncthreads();
      if (warp == 0) {
        own = warp_largest(lane < warps ? warp_words[lane] : 0ull);
        if (lane == 0) {
          out[frames - 1] = packed_index(own);
          walk_state = packed_index(own);
        }
      }
    }
    __syncthreads();
  } else if (rank == 0 && tid == 0) {
    walk_state = out[frames - 1];
  }
  // Every block's predecessors are written and known to the others, and no
  // block overwrites shared memory that another may still store into
  __syncwarp();
  cluster_arrive();
  cluster_wait();

  if (phases & 2) {
    // Chunk k holds rows hi_k down to lo_k of the predecessors, counted
    // from the last frame; block k % blocks walks it and hands the state to
    // the next block. A block loads its next chunk while the others walk.
    uint16_t* chunk = reinterpret_cast<uint16_t*>(shared);
    const size_t row_bytes = (size_t)predecessor_stride * sizeof(uint16_t);
    const int capacity = (int)((size_t)shared_bytes / row_bytes);
    const int chunks = (frames - 1 + capacity - 1) / capacity;
    auto load_chunk = [&](int k) {
      const int hi = frames - 1 - k * capacity;
      const int lo = hi - capacity + 1 > 1 ? hi - capacity + 1 : 1;
      const uint4* source = reinterpret_cast<const uint4*>(
          pred + (size_t)lo * predecessor_stride);
      const int count16 = (int)((size_t)(hi - lo + 1) * row_bytes / 16);
      for (int i = tid; i < count16; i += threads) {
        reinterpret_cast<uint4*>(chunk)[i] = __ldcg(source + i);
      }
      __syncthreads();
    };
    if (rank < chunks) load_chunk(rank);
    for (int k = 0; k < chunks; ++k) {
      const bool mine = k % blocks == rank;
      if (mine) {
        if (tid == 0) {
          const int hi = frames - 1 - k * capacity;
          const int lo = hi - capacity + 1 > 1 ? hi - capacity + 1 : 1;
          int state = walk_state;
          for (int t = hi; t >= lo; --t) {
            state = (int)chunk[(size_t)(t - lo) * predecessor_stride + state];
            out[t - 1] = state;
          }
          *cluster.map_shared_rank(&walk_state, (k + 1) % blocks) = state;
        }
        __syncthreads();
      }
      __syncwarp();
      cluster_arrive();
      if (mine && k + blocks < chunks) load_chunk(k + blocks);
      __syncwarp();
      cluster_wait();
    }
  }
  // No block leaves while another may still store into its shared memory
  cluster_arrive();
  cluster_wait();
}

#undef LOGFREQ_SCAN_ROW

template <bool kClocks>
cudaError_t configure(int blocks, int threads, int shared_bytes,
                      cudaStream_t stream, int batch,
                      cudaLaunchConfig_t* config,
                      cudaLaunchAttribute* attribute) {
  cudaError_t status = cudaFuncSetAttribute(
      logfreq_cluster_kernel<kClocks>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, shared_bytes);
  if (status != cudaSuccess) return status;
  // More than eight blocks in a cluster is the non-portable size
  status = cudaFuncSetAttribute(
      logfreq_cluster_kernel<kClocks>,
      cudaFuncAttributeNonPortableClusterSizeAllowed, blocks > 8 ? 1 : 0);
  if (status != cudaSuccess) return status;
  attribute->id = cudaLaunchAttributeClusterDimension;
  attribute->val.clusterDim.x = blocks;
  attribute->val.clusterDim.y = 1;
  attribute->val.clusterDim.z = 1;
  config->gridDim = dim3(batch * blocks);
  config->blockDim = dim3(threads);
  config->dynamicSmemBytes = shared_bytes;
  config->stream = stream;
  config->attrs = attribute;
  config->numAttrs = 1;
  return cudaSuccess;
}

template <bool kClocks>
cudaError_t launch(const float* observation, const float* initial,
                   const float* register_rows, const float* image,
                   const int* items, const int* group_meta,
                   const int* block_info, void* predecessors, int* path,
                   int batch, int frames, int states, int predecessor_stride,
                   int blocks, int threads, int table_rows, int alpha_stride,
                   int ring_stride, int max_groups, int frame_bytes,
                   float floor_value, int phases, int shared_bytes,
                   long long* cycles, cudaStream_t stream) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute;
  cudaError_t status = configure<kClocks>(
      blocks, threads, shared_bytes, stream, batch, &config, &attribute);
  if (status != cudaSuccess) return status;
  return cudaLaunchKernelEx(
      &config, logfreq_cluster_kernel<kClocks>, observation, initial,
      reinterpret_cast<const float4*>(register_rows),
      reinterpret_cast<const float4*>(image),
      reinterpret_cast<const int4*>(items),
      reinterpret_cast<const int2*>(group_meta),
      reinterpret_cast<const int4*>(block_info),
      static_cast<uint16_t*>(predecessors), path, frames, states,
      predecessor_stride, table_rows, alpha_stride, ring_stride, max_groups,
      frame_bytes, floor_value, phases, shared_bytes, cycles);
}

}  // namespace cluster_route

// The grid route: the destinations are split over one block per SM
// (contiguous ranges of about equal work, chosen by the caller), and each
// block keeps its slice of the band table (runs of the columns, one after
// another) in shared memory for the whole decode. One warp scans one
// destination's run, lanes 32 sources apart, and reduces (value, first
// index) by shuffles. Each frame ends in a grid-wide barrier (an atomic
// counter; the cooperative launch guarantees that all blocks are resident),
// after which every block reloads the whole alpha vector (double-buffered in
// device memory, read past L1) and reduces the floor candidate itself. After
// the last frame block 0 takes the first argmax of the final alpha and
// thread 0 follows the predecessors back. Any T >= 1 is accepted, and any N
// whose alpha vector and largest slice fit in a block's shared memory.
namespace grid_route {

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

}  // namespace grid_route

// The grid route: one sequence, `blocks` resident blocks
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
      grid_route::viterbi_logfreq_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (status != cudaSuccess) return (int)status;
  void* arguments[] = {
      &observation, &initial, &table, &offsets, &lows, &starts, &alpha,
      &counter, &predecessors, &path, &frames, &states, &max_destinations,
      &floor_value};
  status = cudaLaunchCooperativeKernel(
      (const void*)grid_route::viterbi_logfreq_kernel, dim3(blocks),
      dim3(grid_route::kThreads), arguments, shared, stream);
  if (status != cudaSuccess) return (int)status;
  return (int)cudaGetLastError();
}

// How many clusters of `blocks` blocks the card can hold at once (0: it
// cannot place one); minus the cudaError_t where the query itself fails.
extern "C" int viterbi_logfreq_max_clusters(int blocks, int threads,
                                            int shared_bytes) {
  cudaLaunchConfig_t config = {};
  cudaLaunchAttribute attribute;
  cudaError_t status = cluster_route::configure<false>(
      blocks, threads, shared_bytes, 0, 1, &config, &attribute);
  if (status != cudaSuccess) return -(int)status;
  int clusters = 0;
  status = cudaOccupancyMaxActiveClusters(
      &clusters, cluster_route::logfreq_cluster_kernel<false>, &config);
  if (status != cudaSuccess) {
    // A shape the card refuses outright is a shape it cannot place
    cudaGetLastError();
    return 0;
  }
  return clusters;
}

// The cluster route: `batch` sequences, one cluster of `blocks` blocks each.
// The plan's arrays and sizes come from ops/viterbi.py::cluster_plan;
// `phases` runs the forward pass (1), the backtrace (2) or both (3). Where
// `cycles` is not null the kernel also counts thread 0's cycles in each of a
// frame's six sections, summed over the frames after the first, for the
// first and the last block of the first sequence's cluster: (2, 6) int64 in
// device memory.
extern "C" int viterbi_logfreq_cluster_decode(
    const float* observation,
    const float* initial,
    const float* register_rows,
    const float* image,
    const int* items,
    const int* group_meta,
    const int* block_info,
    void* predecessors,
    int* path,
    int batch,
    int frames,
    int states,
    int predecessor_stride,
    int blocks,
    int threads,
    int table_rows,
    int alpha_stride,
    int ring_stride,
    int max_groups,
    int frame_bytes,
    float floor_value,
    int phases,
    int shared_bytes,
    long long* cycles,
    cudaStream_t stream) {
  const cudaError_t status =
      cycles ? cluster_route::launch<true>(
                   observation, initial, register_rows, image, items,
                   group_meta, block_info, predecessors, path, batch, frames,
                   states, predecessor_stride, blocks, threads, table_rows,
                   alpha_stride, ring_stride, max_groups, frame_bytes,
                   floor_value, phases, shared_bytes, cycles, stream)
             : cluster_route::launch<false>(
                   observation, initial, register_rows, image, items,
                   group_meta, block_info, predecessors, path, batch, frames,
                   states, predecessor_stride, blocks, threads, table_rows,
                   alpha_stride, ring_stride, max_groups, frame_bytes,
                   floor_value, phases, shared_bytes, cycles, stream);
  if (status != cudaSuccess) return (int)status;
  return (int)cudaGetLastError();
}
