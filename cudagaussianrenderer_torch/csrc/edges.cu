// Kernel K1: per-tile edges of the sorted pair list (stage E).
//
// Replaces ops/ranges.py:_hist_kernel of the JAX package (launched by
// _edges_pallas, ranges.py:79 there), which builds a [hi, 64] tile
// histogram with one-hot matmuls and takes its cumsum.
//
// edges[t] = #keys whose (key >> shift) < t, for t < num_probes; keys
// whose bin is num_probes - 1 or more never count (sentinels drop out).
// With the keys sorted this is boundary detection: position i (0 <= i <=
// n) compares the bins of keys i-1 and i and writes edges[t] = i for every
// probe t in (bin(i-1), bin(i)] — each probe exactly once, no atomics, no
// scan.  Bins are clamped to num_probes - 1, which leaves every edge below
// it unchanged; position n, past the last key, takes the bin
// num_probes - 1 and so closes the probe range.
//
// A band-segmented list (ops/banded.py) is sorted only within each of its
// G equal segments, with a run of sentinels between one band's pairs and
// the next band's.  Neighbours across a segment border are then out of
// order, so the kernel takes the segment length and treats every segment
// as a list of its own: row s of the [G, num_probes] output holds the
// edges of segment s alone.  The flat list is the case of one segment.
//
// Bound on this card: bytes.  A scan reads the keys once (4 B a key;
// 15.7 MB at the main path's 3.9M slots, 4.7 us at 3.35 TB/s; 22 MB, 6.6
// us, for the banded path's 16 segments) and writes 4 B a probe.  What the
// scan does about the two things that kept the first version (a thread a
// key) at 39% and 19% of that bound:
//   * Block launches.  A fixed grid of kBlocksPerSm blocks an SM strides
//     over tiles of kTileKeys positions.  A thread reads kVecs runs of four
//     neighbouring keys, each with one 16-byte load that a warp makes into
//     512 contiguous bytes.  The key before a run comes from the next lane
//     down (__shfl_up_sync); lane 0 loads it.  A segment length that is no
//     multiple of 4, or keys that do not start on 16 bytes (a view such as
//     keys[1:]), take the same kernel with four 4-byte loads.
//   * Long runs of probes.  Most positions write nothing and a few write
//     one probe, but the first key of a segment writes every probe up to
//     its bin, the first sentinel every probe past the last live bin, and
//     an empty stretch of tiles one probe per tile: thousands of stores in
//     one thread, which the old kernel waited on.  Here a run longer than
//     kLongRun probes goes to the warp: __ballot_sync finds the lanes that
//     hold one, and all 32 lanes store it, 32 neighbouring probes a step,
//     one lane's run after the other.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // runs of four keys a thread
constexpr int kRunKeys = kThreads * 4;
constexpr int kTileKeys = kRunKeys * kVecs;
constexpr int kBlocksPerSm = 8;
constexpr int kLongRun = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct EdgesArgs {
  const uint32_t* keys;
  long long n;  // keys a segment
  long long tiles_per_segment;
  long long tiles;
  int shift;
  int last;  // num_probes - 1
  long long num_probes;
  int* edges;
};

__device__ __forceinline__ int bin_of(uint32_t key, const EdgesArgs& a) {
  return static_cast<int>(min(key >> a.shift, static_cast<uint32_t>(a.last)));
}

// Store edges[t] = value for t in [lo, hi]: short runs by the thread that
// found them, long ones by the whole warp.  Every lane of the warp calls
// this at the same time.
__device__ __forceinline__ void write_run(int* __restrict__ edges, int lo, int hi, int value,
                                          int lane) {
  const bool long_run = hi - lo >= kLongRun;
  if (!long_run)
    for (int t = lo; t <= hi; ++t) edges[t] = value;
  unsigned queue = __ballot_sync(kFull, long_run);
  while (queue) {
    const int src = __ffs(queue) - 1;
    queue &= queue - 1;
    const int qlo = __shfl_sync(kFull, lo, src);
    const int qhi = __shfl_sync(kFull, hi, src);
    const int qval = __shfl_sync(kFull, value, src);
    for (int t = qlo + lane; t <= qhi; t += 32) edges[t] = qval;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) edges_kernel(EdgesArgs a) {
  const int lane = threadIdx.x & 31;
  for (long long b = blockIdx.x; b < a.tiles; b += gridDim.x) {
    const long long s = b / a.tiles_per_segment;
    const long long tile = b - s * a.tiles_per_segment;
    const uint32_t* __restrict__ keys = a.keys + s * a.n;
    int* __restrict__ edges = a.edges + s * a.num_probes;
    // Bins of this thread's keys; a position at or past n takes the last
    // bin, so position n closes the range and later ones write nothing.
    int bins[kVecs][4];
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long p0 = tile * kTileKeys + v * kRunKeys + threadIdx.x * 4;
      if (kVec && p0 + 4 <= a.n) {
        const uint4 q = *reinterpret_cast<const uint4*>(keys + p0);
        bins[v][0] = bin_of(q.x, a);
        bins[v][1] = bin_of(q.y, a);
        bins[v][2] = bin_of(q.z, a);
        bins[v][3] = bin_of(q.w, a);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bins[v][j] = p0 + j < a.n ? bin_of(keys[p0 + j], a) : a.last;
      }
    }
#pragma unroll
    for (int v = 0; v < kVecs; ++v) {
      const long long p0 = tile * kTileKeys + v * kRunKeys + threadIdx.x * 4;
      int prev = __shfl_up_sync(kFull, bins[v][3], 1);
      if (lane == 0) prev = p0 == 0 ? -1 : (p0 - 1 < a.n ? bin_of(keys[p0 - 1], a) : a.last);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        write_run(edges, prev + 1, bins[v][j], static_cast<int>(p0 + j), lane);
        prev = bins[v][j];
      }
    }
  }
}

}  // namespace

// keys: ``segments`` runs of n keys each, every run sorted on its own;
// edges: [segments, num_probes].
GSR_EXPORT int gsr_edges(const void* keys, long long n, int segments, int shift,
                         int num_probes, void* edges, void* stream) {
  if (n < 0 || segments < 1 || num_probes < 1) return static_cast<int>(cudaErrorInvalidValue);
  // The SM count, asked once for each device.
  constexpr int kMaxDevices = 64;
  static int sms_of[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long sms = sms_of[device];
  EdgesArgs a;
  a.keys = static_cast<const uint32_t*>(keys);
  a.n = n;
  a.tiles_per_segment = (n + 1 + kTileKeys - 1) / kTileKeys;
  a.tiles = a.tiles_per_segment * segments;
  a.shift = shift;
  a.last = num_probes - 1;
  a.num_probes = num_probes;
  a.edges = static_cast<int*>(edges);
  const auto s = static_cast<cudaStream_t>(stream);
  const long long fill = sms * kBlocksPerSm;
  const unsigned grid = static_cast<unsigned>(a.tiles < fill ? a.tiles : fill);
  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0)
    edges_kernel<true><<<grid, kThreads, 0, s>>>(a);
  else
    edges_kernel<false><<<grid, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

