// Kernel K7: band compaction of the splat rows (stage C, banded path).
//
// Replaces ops/banded.py:_compact_kernel of the JAX package (launched at
// banded.py:440 there).  A TPU cannot scatter, so that kernel selects, for
// every compact slot, the one source column whose c_incl - 1 equals the
// slot with a one-hot matmul over DMA'd windows of the source rows, fed by
// per-block first owners from the histogram kernel.  A GPU can scatter:
// here source column (g, i) writes its 16 values straight into slot
// c_incl[g, i] - 1, so no owner search, no window walk and no trailing
// slack for window overrun exist.  One thread takes splat column i through
// all G bands: a thread per (g, i) would read 12 bytes and retire, and
// launching such short threads costs more than their loads.
//
// Output [16, CC], CC = G * MC compact slots, slot for slot the JAX
// kernel's first CC columns:
//   * slot g * MC + j (j below the band's kept-splat count) holds band g's
//     j-th kept splat: rows 0-1 its band-offset clamped pair prefixes
//     (p_excl, p_incl), rows 2-15 its attribute rows;
//   * every other slot of band g = min(slot / MC, G - 1) holds the band's
//     pair end in rows 0-1 (excl == incl: it owns no pair, and the p_incl
//     row stays monotone) and zeros in rows 2-15.
// Two launches on one stream: a fill of every slot, then the scatter.  A
// column writes iff p_excl != p_incl, exactly the JAX kernel's has-pairs
// mask: only kept splats have distinct prefixes, so pair-dry and
// compact-saturated splats, which share a neighbour's c_incl, never write
// and no two threads write one slot.
//
// Bound on this card: bytes.  The two pair-prefix rows of G * NP * 4 B
// are read whole (~128 MB at G = 16, NP ~ 1M); c_incl and the 14 attribute
// rows are read for kept columns only (~1.2M of 16M there), and
// 16 * CC * 4 B are written (~128 MB at CC = 2M): ~0.1 ms at 3.35 TB/s.
// The prefix reads coalesce; a band's kept splats are neighbours in the source
// and land in neighbouring slots, so the scattered stores of a warp fall
// into a few contiguous runs.
#include "common.cuh"

namespace {

constexpr int kRows = 16;

__global__ void compact_fill_kernel(const int* __restrict__ pair_end,
                                    int n_bands, long long mc, long long cc,
                                    float* __restrict__ out) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= cc) return;
  const long long g = min(j / mc, static_cast<long long>(n_bands - 1));
  const float pe = static_cast<float>(pair_end[g]);
  out[j] = pe;
  out[cc + j] = pe;
#pragma unroll
  for (int r = 2; r < kRows; ++r) out[r * cc + j] = 0.0f;
}

// pfx rows: [0] c_incl, [1] p_excl, [2] p_incl, each G * NP long.
__global__ void compact_scatter_kernel(const float* __restrict__ full,
                                       const float* __restrict__ pfx,
                                       long long np, int n_bands, long long cc,
                                       float* __restrict__ out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= np) return;
  const long long total = np * n_bands;
#pragma unroll 4
  for (int g = 0; g < n_bands; ++g) {
    const long long v = g * np + i;
    const float p_excl = pfx[total + v];
    const float p_incl = pfx[2 * total + v];
    if (p_excl == p_incl) continue;
    const long long slot = static_cast<long long>(pfx[v]) - 1;
    if (slot < 0 || slot >= cc) continue;
    out[slot] = p_excl;
    out[cc + slot] = p_incl;
#pragma unroll
    for (int r = 2; r < kRows; ++r) out[r * cc + slot] = full[r * np + i];
  }
}

}  // namespace

GSR_EXPORT int gsr_compact(const void* full, const void* pfx,
                           const void* pair_end, long long np, int n_bands,
                           long long mc, void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const long long cc = mc * n_bands;
  auto* o = static_cast<float*>(out);
  constexpr int kThreads = 256;
  compact_fill_kernel<<<gsr::blocks_for(cc, kThreads), kThreads, 0, s>>>(
      static_cast<const int*>(pair_end), n_bands, mc, cc, o);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  compact_scatter_kernel<<<gsr::blocks_for(np, kThreads), kThreads, 0, s>>>(
      static_cast<const float*>(full), static_cast<const float*>(pfx), np,
      n_bands, cc, o);
  return static_cast<int>(cudaGetLastError());
}
