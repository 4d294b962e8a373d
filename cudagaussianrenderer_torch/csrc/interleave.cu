// Kernels K2 and K5: the [16, NP] rows arrays of the emit stage (stage C).
//
// K2 (flat path)
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
//
// K5 (banded path)
//
// Replaces ops/banded.py:_interleave_rows_padded of the JAX package
// (launched at banded.py:73 there): 15 columns (two prefix rows supplied by
// the caller, then the 13 attribute columns) become rows of one [16, NP]
// array, with the splat-id row (row 4) generated as the column index over
// ALL NP columns.  The JAX caller pads every column to NP with zeros before
// the kernel; here the kernel reads the n real values and writes zeros past
// them, so no padded copies exist.  One thread per column, as K2.
//
// Bound on this card: bytes.  15 columns of 4 B are read and 16 rows of
// 4 B written per splat: ~60 MB in and ~64 MB out at 1M splats, ~37 us at
// 3.35 TB/s.
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

constexpr int kNumPaddedCols = 15;

struct PaddedCols {
  const float* p[kNumPaddedCols];
};

__global__ void interleave_padded_kernel(PaddedCols cols, long long n,
                                         long long np,
                                         float* __restrict__ out) {
  const long long c = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (c >= np) return;
  int k = 0;
#pragma unroll
  for (int r = 0; r < 2 + kNumAttrRows; ++r) {
    float x = 0.0f;
    if (r == 2 + kRowIdx) {
      x = static_cast<float>(c);
    } else {
      if (c < n) x = cols.p[k][c];
      ++k;
    }
    out[r * np + c] = x;
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

GSR_EXPORT int gsr_interleave_padded(const void* const* cols, long long n,
                                     long long np, void* out, void* stream) {
  PaddedCols c;
  for (int k = 0; k < kNumPaddedCols; ++k) c.p[k] = static_cast<const float*>(cols[k]);
  constexpr int kThreads = 256;
  interleave_padded_kernel<<<gsr::blocks_for(np, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      c, n, np, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
