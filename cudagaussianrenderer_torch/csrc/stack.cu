// Kernel K6: stack k flat columns into one [k, M] row array (stage C,
// banded path).
//
// Replaces ops/banded.py:_stackk_kernel / _stackk of the JAX package
// (launched at banded.py:277 there), which exists because an XLA stack
// writes strided sublanes into (8, 128)-tiled TPU memory.  Device memory
// on this card is linear, so the kernel is a plain copy: a 2-D grid with
// one row of blocks per input column, each thread moving kPerThread
// elements of 16 bytes (float4) when M and every pointer allow it, else of
// 4 bytes, all loads started before the first store.
//
// Bound on this card: bytes.  k * M * 4 B are read and as many written:
// with the banded main path's three [16 * NP] prefix columns (NP ~ 1M) that
// is ~193 MB each way, ~115 us at 3.35 TB/s.  Reads and writes of each row
// coalesce across the warp.  Work per thread matters: with one element a
// thread (4 or 16 bytes alike) the blocks are so short that launching them
// bounds the kernel at 2.4x the byte bound, where a device-to-device
// memcpy of the same bytes takes about 1.2x.
#include "common.cuh"

namespace {

constexpr int kMaxStack = 8;

struct StackCols {
  const float* p[kMaxStack];
};

constexpr int kThreads = 256;
constexpr int kPerThread = 8;

// T is float or float4; m counts elements of T per column.  A block copies
// kThreads * kPerThread neighbouring elements of column blockIdx.y.
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
  if (k < 1 || k > kMaxStack) return static_cast<int>(cudaErrorInvalidValue);
  StackCols c = {};
  bool vec = m % 4 == 0 && aligned16(out);
  for (int r = 0; r < k; ++r) {
    c.p[r] = static_cast<const float*>(cols[r]);
    vec = vec && aligned16(cols[r]);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int kPerBlock = kThreads * kPerThread;
  if (vec) {
    const dim3 grid(gsr::blocks_for(m / 4, kPerBlock), k);
    stack_kernel<float4><<<grid, kThreads, 0, s>>>(c, m / 4, static_cast<float4*>(out));
  } else {
    const dim3 grid(gsr::blocks_for(m, kPerBlock), k);
    stack_kernel<float><<<grid, kThreads, 0, s>>>(c, m, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
