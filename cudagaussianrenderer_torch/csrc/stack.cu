// Kernel K6: stack k flat columns into one [k, M] row array (stage C,
// banded path).
//
// Replaces ops/banded.py:_stackk_kernel / _stackk of the JAX package
// (launched at banded.py:277 there), which exists because an XLA stack
// writes strided sublanes into (8, 128)-tiled TPU memory.  Device memory
// on this card is linear, so the kernel is a plain copy.
//
// Bound on this card: bytes.  k * M * 4 B are read and as many written:
// with the banded main path's three [16 * NP] prefix columns (NP ~ 1M) that
// is ~193 MB each way, ~115 us at 3.35 TB/s.  A copy that reads and writes
// does not reach that rate: on an NVIDIA H100 80GB HBM3 at 700 W a
// device-to-device memcpy of the same bytes takes 1.11x the bound and one
// torch.stack 1.15x.  A grid of short blocks that each load their share into
// registers and then store it (this kernel's first design, 1.42x) never
// overlaps a block's own loads with its stores, leans on block turnover
// for the overlap, and drags every byte through registers and L1 at the
// default cache priority; streaming loads and stores alone took it to 1.23x.
//
// Design: a persistent copy through Hopper's bulk asynchronous copies.  A
// fixed grid of kBlocksPerSm blocks an SM walks the chunks (column, offset)
// of kStageBytes each, block b taking chunks b, b + grid, ...  Each block
// owns a ring of kStages stages of shared memory; one thread starts
// cp.async.bulk global -> shared for the chunks ahead (completion counted
// in bytes on the stage's mbarrier), waits for the oldest, starts
// cp.async.bulk shared -> global for it, and loads into a stage again only
// after cp.async.bulk.wait_group.read says the store has read it.  No
// thread touches the staged bytes, so no register, no L1 line and no proxy
// fence is spent on them, and loads of the chunks ahead are in flight
// while a chunk is stored.  The loads carry an evict-first hint for L2 (the
// source is read once).  Every ring of three or more stages, 16 to 64 KB a
// stage, one to four blocks an SM, with or without the hint, copies within
// 1% of the others (1.15-1.17x the bound); two stages lose 5%.
//
// Bulk copies need 16-byte aligned addresses and sizes.  When M is no
// multiple of 4 floats or a pointer is not 16-byte aligned, the copy runs
// as stack_kernel<float>: one row of blocks per column, each thread moving
// kPerThread floats, all loads started before the first store.
#include "common.cuh"

namespace {

constexpr int kMaxStack = 8;

struct StackCols {
  const float* p[kMaxStack];
};

// ---- aligned columns: the bulk-copy ring ----------------------------------

constexpr int kStages = 4;
constexpr int kStageBytes = 16 * 1024;
constexpr int kBlocksPerSm = 3;
constexpr int kRingThreads = 32;  // one warp; its first thread starts every copy

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbarrier_init(uint32_t bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(arrivals) : "memory");
}

// One arrival that also announces the bytes the stage's load will deliver.
__device__ __forceinline__ void mbarrier_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// Returns once the barrier's phase of the given parity has completed.  A
// load takes microseconds; a wait of seconds means the byte counts or the
// parity are wrong, and traps rather than hang the card.
__device__ __forceinline__ void mbarrier_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  const long long t0 = clock64();
  do {
    if (clock64() - t0 > (1LL << 33)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The source is read once: its lines are the first that L2 may drop.
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Chunk i of this block: (source, destination, bytes).  The last chunk of a
// column is short; its size is still a multiple of 16 bytes because the
// column's is.
struct Chunk {
  const char* src;
  char* dst;
  uint32_t bytes;
};

__device__ __forceinline__ Chunk chunk_of(const StackCols& cols, char* out, long long col_bytes,
                                          long long chunks_per_col, long long i) {
  const long long c = blockIdx.x + i * gridDim.x;
  const int r = static_cast<int>(c / chunks_per_col);
  const long long off = (c - r * chunks_per_col) * kStageBytes;
  const long long left = col_bytes - off;
  return {reinterpret_cast<const char*>(cols.p[r]) + off, out + r * col_bytes + off,
          static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes)};
}

__global__ void __launch_bounds__(kRingThreads)
stack_bulk_kernel(StackCols cols, int k, long long col_bytes, char* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStages];
  if (threadIdx.x != 0) return;

  const long long chunks_per_col = (col_bytes + kStageBytes - 1) / kStageBytes;
  const long long total = chunks_per_col * k;
  if (blockIdx.x >= total) return;
  const long long mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;

  for (int s = 0; s < kStages; ++s) mbarrier_init(shared_addr(&full[s]), 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  const uint32_t ring0 = shared_addr(ring);
  const uint64_t read_once = evict_first_policy();
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % kStages);
    const Chunk c = chunk_of(cols, out, col_bytes, chunks_per_col, i);
    const uint32_t bar = shared_addr(&full[s]);
    mbarrier_expect(bar, c.bytes);
    bulk_load(ring0 + s * kStageBytes, c.src, c.bytes, bar, read_once);
  };

  // kStages - 1 loads ahead; the remaining stage is the one being stored.
  for (long long i = 0; i < kStages - 1 && i < mine; ++i) load(i);
  for (long long j = 0; j < mine; ++j) {
    const int s = static_cast<int>(j % kStages);
    // Stage s completes one phase per ring turn: turn t has parity t & 1.
    mbarrier_wait(shared_addr(&full[s]), static_cast<uint32_t>((j / kStages) & 1));
    const Chunk c = chunk_of(cols, out, col_bytes, chunks_per_col, j);
    bulk_store(c.dst, ring0 + s * kStageBytes, c.bytes);
    const long long next = j + kStages - 1;
    if (next < mine) {
      // The next load goes into the stage of chunk j - 1: all but the store
      // just started must have read their stage.
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
      load(next);
    }
  }
  // The ring must outlive the stores that read it.
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

int launch_bulk(const StackCols& cols, int k, long long m, void* out, cudaStream_t s) {
  constexpr int kRingBytes = kStages * kStageBytes;
  // The SM count and the leave to use more than 48 KB of dynamic shared
  // memory, asked once for each device.
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stack_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kRingBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  const int sms = sms_of[device];
  stack_bulk_kernel<<<sms * kBlocksPerSm, kRingThreads, kRingBytes, s>>>(
      cols, k, m * static_cast<long long>(sizeof(float)), static_cast<char*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---- any alignment: registers ---------------------------------------------

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

// A block copies kThreads * kPerThread neighbouring elements of column
// blockIdx.y; m counts elements of T per column.
template <typename T>
__global__ void stack_kernel(StackCols cols, long long m, T* __restrict__ out) {
  const int r = blockIdx.y;
  const T* __restrict__ src = reinterpret_cast<const T*>(cols.p[r]);
  T* __restrict__ dst = out + r * m;
  const long long base =
      blockIdx.x * static_cast<long long>(kThreads * kPerThread) + threadIdx.x;
  T v[kPerThread];
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long c = base + u * kThreads;
    if (c < m) v[u] = src[c];
  }
#pragma unroll
  for (int u = 0; u < kPerThread; ++u) {
    const long long c = base + u * kThreads;
    if (c < m) dst[c] = v[u];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

GSR_EXPORT int gsr_stack(const void* const* cols, int k, long long m, void* out,
                         void* stream) {
  if (k < 1 || k > kMaxStack || m < 1) return static_cast<int>(cudaErrorInvalidValue);
  StackCols c = {};
  bool vec = m % 4 == 0 && aligned16(out);
  for (int r = 0; r < k; ++r) {
    c.p[r] = static_cast<const float*>(cols[r]);
    vec = vec && aligned16(cols[r]);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) return launch_bulk(c, k, m, out, s);
  const dim3 grid(gsr::blocks_for(m, kThreads * kPerThread), k);
  stack_kernel<float><<<grid, kThreads, 0, s>>>(c, m, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
