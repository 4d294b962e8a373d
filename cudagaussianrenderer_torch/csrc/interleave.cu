// Kernel K2: the [16, NP] rows array of the emit stage (stage C).
//
// Replaces the inner kernel of ops/expand.py:_interleave_rows of the JAX
// package (launched at expand.py:184 there).  That kernel derives the
// exclusive prefix row by rotating each block's inclusive row and carrying
// the previous block's last value through SMEM across a grid that runs in
// order on one core.  Here every column is independent: column c's
// exclusive prefix is simply incl[c - 1] (0 at c = 0), so one thread per
// column writes all 16 rows of it and nothing carries between blocks.
//
// Output, bit for bit the JAX function's: for columns c < n_live (n
// rounded up to 4096) row 0 = min(excl, clamp), row 1 = min(incl, clamp),
// row 4 = c, rows 2..15 otherwise the 13 input columns (zero past n, where
// the prefix repeats incl[n-1]); the final 4096 columns hold
// min(incl[n-1], clamp) in rows 0-1 and zeros elsewhere.
//
// Bound on this card: bytes.  14 columns of 4 B are read and 16 rows of
// 4 B written per splat: ~56 MB in and ~64 MB out at the main path's 1M
// splats, ~36 us at 3.35 TB/s.  Each row's reads and writes coalesce
// across the warp.
#include "common.cuh"

namespace {

constexpr int kNumCols = 13;
constexpr int kNumAttrRows = 14;
constexpr int kRowIdx = 2;  // R_IDX: the splat-id row, generated here

struct Cols {
  const float* p[kNumCols];
};

__global__ void interleave_kernel(const int* __restrict__ incl, Cols cols,
                                  long long n, long long n_live,
                                  long long np, int clamp,
                                  float* __restrict__ out) {
  const long long c = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (c >= np) return;
  const bool live = c < n_live;
  int e, v;
  if (live) {
    e = c == 0 ? 0 : incl[min(c - 1, n - 1)];
    v = incl[min(c, n - 1)];
  } else {
    e = v = incl[n - 1];
  }
  out[c] = static_cast<float>(min(e, clamp));
  out[np + c] = static_cast<float>(min(v, clamp));
  int k = 0;
#pragma unroll
  for (int r = 0; r < kNumAttrRows; ++r) {
    float x = 0.0f;
    if (r == kRowIdx) {
      if (live) x = static_cast<float>(c);
    } else {
      if (c < n) x = cols.p[k][c];
      ++k;
    }
    out[(2 + r) * np + c] = x;
  }
}

}  // namespace

GSR_EXPORT int gsr_interleave(const void* incl, const void* const* cols,
                              long long n, long long np, int clamp, void* out,
                              void* stream) {
  Cols c;
  for (int k = 0; k < kNumCols; ++k) c.p[k] = static_cast<const float*>(cols[k]);
  const long long n_live = np - 4096;
  constexpr int kThreads = 256;
  interleave_kernel<<<gsr::blocks_for(np, kThreads), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(incl), c, n, n_live, np, clamp,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
