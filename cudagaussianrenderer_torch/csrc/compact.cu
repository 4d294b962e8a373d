// Kernel K7: band compaction of the splat rows (stage C, banded path).
//
// Replaces ops/banded.py:_compact_kernel of the JAX package (launched at
// banded.py:440 there).  A TPU cannot scatter, so that kernel selects, for
// every compact slot, the one source column whose c_incl - 1 equals the
// slot with a one-hot matmul over DMA'd windows of the source rows, fed by
// per-block first owners from the histogram kernel.  A GPU can scatter, so
// no owner search, no window walk and no trailing slack for window overrun
// exist here.
//
// Output [16, CC], CC = G * MC compact slots, slot for slot the JAX
// kernel's first CC columns:
//   * slot g * MC + j (j below the band's kept-splat count) holds band g's
//     j-th kept splat: rows 0-1 its band-offset clamped pair prefixes
//     (p_excl, p_incl), rows 2-15 its attribute rows;
//   * every other slot of band g holds the band's pair end in rows 0-1
//     (excl == incl: it owns no pair, and the p_incl row stays monotone) and
//     zeros in rows 2-15.
// A column is kept iff p_excl != p_incl, exactly the JAX kernel's has-pairs
// mask: pair-dry and compact-saturated splats have equal prefixes.
//
// Bound on this card: bytes.  The two pair-prefix rows of G * NP * 4 B are
// read whole (~129 MB at G = 16, NP ~ 1M), the 14 attribute rows for kept
// columns only (~1.3M of 16M there), and 16 * CC * 4 B are written (~260 MB
// at CC = 4M): ~0.14 ms at 3.35 TB/s.  What kept the first design (a fill
// of every slot, then a thread per source column scattering through the 16
// bands) at a third of that: the kept slots were written twice, by two
// launches; at 8% of the (band, column) pairs kept, two or three lanes of a
// warp stored 4 bytes each to 16 rows, never a whole sector; and the same
// few lanes started the 14 gathers one row after another.
//
// Design: one launch, and arithmetic decides who writes a slot.  The kept
// columns of a band own a prefix of its slots in source order (c_incl is
// the band offset plus the running count of selected columns, and a column
// is kept only while that count is at most MC), so
//   * kept_g = c_incl[g, NP - 1] - g * MC slots of band g belong to kept
//     columns and the other MC - kept_g to the fill, and
//   * the kept columns of any tile of neighbouring source columns own one
//     contiguous run of slots, which starts at c_incl of the column before
//     the tile.
// A scatter block takes (band g, tile of kTile source columns): it loads
// the tile's two pair-prefix rows as float4, coalesced, flags the kept
// columns, ranks them with one packed block scan, stages column index and
// prefixes in shared memory in slot order, and then thread t stores slot
// s0 + t of all 16 rows -- a warp writes whole 128-byte runs -- after
// issuing its column's 14 gathers together.  Blocks are numbered tile-major:
// the 16 blocks of a tile run side by side and share its attribute rows in
// L2.  Fill blocks (same launch, the block indices after the scatter
// blocks) write only slots [g * MC + kept_g, (g + 1) * MC), 16 bytes a
// store behind a scalar head and tail, as streaming stores that do not
// push the attribute rows out of L2.  No slot is written twice, so the two
// roles need no order.
//
// The prefix rows hold integers below 2^24 as floats (the wrapper checks
// the capacities), so reading a count from them is exact.
#include "common.cuh"

namespace {

constexpr int kRows = 16;
constexpr int kThreads = 256;
// float4 loads a thread makes of each prefix row: a tile is 4096 columns.
constexpr int kSlabs = 4;
constexpr int kTile = kThreads * 4 * kSlabs;
// Kept columns staged at a time.  A tile of this scene keeps ~330; a tile of
// a scene sorted by tile row may keep all kTile, and takes several turns.
constexpr int kStage = 1024;
// Slots of one band a fill block writes, in all 16 rows.
constexpr int kFillSlots = 2048;
// The 16-bit fields of the packed scan hold counts up to a slab's columns.
static_assert(kSlabs <= 4 && kThreads * 4 < 65536 && kThreads % 32 == 0, "packed scan");

struct CompactArgs {
  const float* full;    // [16, np]
  const float* pfx;     // [3, n_bands * np]: c_incl, p_excl, p_incl
  const int* pair_end;  // [n_bands]
  long long np;
  int n_bands;
  long long mc;
  long long n_tiles;      // scatter blocks: n_tiles * n_bands
  long long fill_chunks;  // fill blocks: fill_chunks * n_bands
  float* out;             // [16, n_bands * mc]
};

__device__ __forceinline__ void store_fill(float4* p, float4 v) { __stcs(p, v); }
__device__ __forceinline__ void store_fill(float* p, float v) { __stcs(p, v); }

// Columns c .. c + 3 of one band's row p (np columns long).  Columns past
// the row read as zero: equal in both prefix rows, so they are not kept.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* __restrict__ p, long long c, long long np) {
  if (kVec) {
    return c < np ? __ldg(reinterpret_cast<const float4*>(p + c)) : float4{0.0f, 0.0f, 0.0f, 0.0f};
  }
  float4 v;
  v.x = c + 0 < np ? __ldg(p + c + 0) : 0.0f;
  v.y = c + 1 < np ? __ldg(p + c + 1) : 0.0f;
  v.z = c + 2 < np ? __ldg(p + c + 2) : 0.0f;
  v.w = c + 3 < np ? __ldg(p + c + 3) : 0.0f;
  return v;
}

// Slots [lo, hi) of every row: the band's pair end in rows 0-1, zero below.
__device__ void fill_slots(float* __restrict__ out, long long cc, long long lo, long long hi,
                           float pair_end) {
#pragma unroll 4
  for (int r = 0; r < kRows; ++r) {
    const float v = r < 2 ? pair_end : 0.0f;
    float* row = out + r * cc;
    // [a0, a1): the part of [lo, hi) made of whole 16-byte groups.
    const long long head = (4 - ((reinterpret_cast<uintptr_t>(row + lo) >> 2) & 3)) & 3;
    const long long a0 = lo + head < hi ? lo + head : hi;
    const long long a1 = a0 + ((hi - a0) & ~3LL);
    const float4 v4 = {v, v, v, v};
    for (long long j = a0 + 4 * threadIdx.x; j < a1; j += 4 * kThreads)
      store_fill(reinterpret_cast<float4*>(row + j), v4);
    if (threadIdx.x < a0 - lo) store_fill(row + lo + threadIdx.x, v);
    if (threadIdx.x < hi - a1) store_fill(row + a1 + threadIdx.x, v);
  }
}

template <bool kVec>
__device__ void scatter_tile(const CompactArgs& a, int g, long long tile) {
  __shared__ int s_col[kStage];
  __shared__ float s_excl[kStage];
  __shared__ float s_incl[kStage];
  __shared__ unsigned long long s_warp[kThreads / 32];

  const long long total = a.np * a.n_bands;
  const long long cc = a.mc * a.n_bands;
  const float* __restrict__ c_incl = a.pfx + g * a.np;
  const float* __restrict__ p_excl = c_incl + total;
  const float* __restrict__ p_incl = p_excl + total;
  const long long col0 = tile * kTile;

  // Thread t holds columns col0 + 4 * (t + j * kThreads) .. + 3 of slab j.
  float ex[kSlabs][4], in[kSlabs][4];
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
    const long long c = col0 + 4 * (threadIdx.x + j * kThreads);
    const float4 e = load4<kVec>(p_excl, c, a.np);
    const float4 i = load4<kVec>(p_incl, c, a.np);
    ex[j][0] = e.x, ex[j][1] = e.y, ex[j][2] = e.z, ex[j][3] = e.w;
    in[j][0] = i.x, in[j][1] = i.y, in[j][2] = i.z, in[j][3] = i.w;
  }
  // First slot of the tile's run: the slots used up to the column before it.
  const long long s0 = col0 > 0 ? static_cast<long long>(__ldg(c_incl + col0 - 1)) : g * a.mc;

  // Kept flags, 4 bits a slab, and the kept counts of the slabs packed into
  // 16-bit fields, so that one scan ranks all slabs.
  unsigned kept = 0;
  unsigned long long packed = 0;
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
    unsigned m = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) m |= (ex[j][i] != in[j][i] ? 1u : 0u) << i;
    kept |= m << (4 * j);
    packed |= static_cast<unsigned long long>(__popc(m)) << (16 * j);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long incl = packed;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long up = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  unsigned long long before = incl - packed, all = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const unsigned long long v = s_warp[w];
    all += v;
    if (w < warp) before += v;
  }
  // Source order is slab-major: the rank of a slab's first kept column is
  // the kept count of the slabs before it.
  int rank[kSlabs], n_kept = 0;
#pragma unroll
  for (int j = 0; j < kSlabs; ++j) {
    rank[j] = n_kept + static_cast<int>((before >> (16 * j)) & 0xFFFF);
    n_kept += static_cast<int>((all >> (16 * j)) & 0xFFFF);
  }

  for (int base = 0; base < n_kept; base += kStage) {
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) {
      int r = rank[j] - base;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (!(kept >> (4 * j + i) & 1)) continue;
        if (r >= 0 && r < kStage) {
          s_col[r] = 4 * (threadIdx.x + j * kThreads) + i;  // column within the tile
          s_excl[r] = ex[j][i];
          s_incl[r] = in[j][i];
        }
        ++r;
      }
    }
    __syncthreads();
    const int count = n_kept - base < kStage ? n_kept - base : kStage;
    for (int t = threadIdx.x; t < count; t += kThreads) {
      const long long slot = s0 + base + t;
      if (slot < 0 || slot >= cc) continue;
      const float* __restrict__ src = a.full + col0 + s_col[t];
      float v[kRows - 2];
#pragma unroll
      for (int r = 2; r < kRows; ++r) v[r - 2] = __ldg(src + r * a.np);
      float* __restrict__ dst = a.out + slot;
      dst[0] = s_excl[t];
      dst[cc] = s_incl[t];
#pragma unroll
      for (int r = 2; r < kRows; ++r) dst[r * cc] = v[r - 2];
    }
    __syncthreads();
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) compact_kernel(CompactArgs a) {
  const long long b = blockIdx.x;
  const long long n_scatter = a.n_tiles * a.n_bands;
  if (b < n_scatter) {
    scatter_tile<kVec>(a, static_cast<int>(b % a.n_bands), b / a.n_bands);
    return;
  }
  const int g = static_cast<int>((b - n_scatter) / a.fill_chunks);
  const long long chunk = (b - n_scatter) % a.fill_chunks;
  long long kept_g = static_cast<long long>(a.pfx[g * a.np + a.np - 1]) - g * a.mc;
  kept_g = kept_g < 0 ? 0 : (kept_g > a.mc ? a.mc : kept_g);
  const long long lo = kept_g > chunk * kFillSlots ? kept_g : chunk * kFillSlots;
  const long long hi = a.mc < (chunk + 1) * kFillSlots ? a.mc : (chunk + 1) * kFillSlots;
  if (lo < hi)
    fill_slots(a.out, a.mc * a.n_bands, g * a.mc + lo, g * a.mc + hi,
               static_cast<float>(a.pair_end[g]));
}

}  // namespace

GSR_EXPORT int gsr_compact(const void* full, const void* pfx,
                           const void* pair_end, long long np, int n_bands,
                           long long mc, void* out, void* stream) {
  if (np < 1 || n_bands < 1 || mc < 1) return static_cast<int>(cudaErrorInvalidValue);
  CompactArgs a = {};
  a.full = static_cast<const float*>(full);
  a.pfx = static_cast<const float*>(pfx);
  a.pair_end = static_cast<const int*>(pair_end);
  a.np = np;
  a.n_bands = n_bands;
  a.mc = mc;
  a.n_tiles = (np + kTile - 1) / kTile;
  a.fill_chunks = (mc + kFillSlots - 1) / kFillSlots;
  a.out = static_cast<float*>(out);
  const long long blocks = (a.n_tiles + a.fill_chunks) * n_bands;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  // float4 loads of the prefix rows need every band's row 16-byte aligned.
  const bool vec = np % 4 == 0 && reinterpret_cast<uintptr_t>(pfx) % 16 == 0;
  const auto grid = static_cast<unsigned int>(blocks);
  if (vec) {
    compact_kernel<true><<<grid, kThreads, 0, s>>>(a);
  } else {
    compact_kernel<false><<<grid, kThreads, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
