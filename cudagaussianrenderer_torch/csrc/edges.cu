// Kernel K1: per-tile edges of the sorted pair list (stage E).
//
// Replaces ops/ranges.py:_hist_kernel of the JAX package (launched by
// _edges_pallas, ranges.py:79 there), which builds a [hi, 64] tile
// histogram with one-hot matmuls and takes its cumsum.
//
// edges[t] = #keys whose (key >> shift) < t, for t < num_probes; keys
// whose bin is num_probes - 1 or more never count (sentinels drop out).
// With the keys sorted this is boundary detection: thread i (0 <= i <= n)
// compares the bins of keys i-1 and i and writes edges[t] = i for every
// probe t in (bin(i-1), bin(i)] — each probe exactly once, no atomics, no
// scan.  Bins are clamped to num_probes - 1, which leaves every edge below
// it unchanged.
//
// A band-segmented list (ops/banded.py) is sorted only within each of its
// G equal segments, with a run of sentinels between one band's pairs and
// the next band's.  Neighbours across a segment border are then out of
// order, so the kernel takes the segment length and treats every segment
// as a list of its own (blockIdx.y = segment): row s of the [G, num_probes]
// output holds the edges of segment s alone.  The flat list is the case of
// one segment.
//
// Bound on this card: bytes.  The keys are read once (4 B a key; 15 MB at
// the main path's 3.8M slots, ~4.5 us at 3.35 TB/s) and 4 B a probe is
// written.  Neighbouring threads read neighbouring keys, so the loads
// coalesce; the second read of each key hits L1.
#include "common.cuh"

namespace {

__global__ void edges_kernel(const uint32_t* __restrict__ keys, long long n,
                             int shift, int num_probes,
                             int* __restrict__ edges) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i > n) return;
  keys += blockIdx.y * n;
  edges += blockIdx.y * static_cast<long long>(num_probes);
  const uint32_t last = static_cast<uint32_t>(num_probes - 1);
  uint32_t lo = 0;
  uint32_t hi = last;
  if (i > 0) lo = min(keys[i - 1] >> shift, last) + 1u;
  if (i < n) hi = min(keys[i] >> shift, last);
  for (uint32_t t = lo; t <= hi; ++t) edges[t] = static_cast<int>(i);
}

}  // namespace

// keys: ``segments`` runs of n keys each, every run sorted on its own;
// edges: [segments, num_probes].
GSR_EXPORT int gsr_edges(const void* keys, long long n, int segments, int shift,
                         int num_probes, void* edges, void* stream) {
  constexpr int kThreads = 256;
  const dim3 grid(gsr::blocks_for(n + 1, kThreads), segments);
  edges_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(keys), n, shift, num_probes,
      static_cast<int*>(edges));
  return static_cast<int>(cudaGetLastError());
}
