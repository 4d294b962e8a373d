// Kernels K3 and K8: emit the fixed-capacity (tile, splat) pair list
// (stage C), flat and band-segmented.
//
// Replaces ops/expand.py:_emit_kernel of the JAX package (with
// _emit_block, _emit_payload and _store_sentinels; launched at
// expand.py:754 there).  A TPU cannot scatter, so that kernel recovers the
// owner of every slot with one-hot matmuls over DMA'd splat windows, fed
// by per-block first owners from the histogram kernel.  A GPU can
// scatter: here splat i (one thread) writes its own slots
// [excl_i, min(incl_i, capacity)) directly, walking its 8 packed
// (dx, w) row runs and then the full-rect fallthrough rows, so no owner
// search and no block-start table exist.  A second, slot-parallel pass
// fills the slots past the candidate total (_store_sentinels).
//
// The six outputs equal the JAX kernel's slot for slot:
//   * keys tile << 19 | depth19 (or tile, depth24 << 8), value = splat id;
//   * the packed attribute words round every float op separately, as the
//     JAX kernel and the plain PyTorch version do (this file is built with
//     --fmad=false, and the rounding-sensitive lines spell out _rn ops);
//   * the mf12 rounding is integer math on the f32 bits;
//   * the fallthrough decode divides exact small integers with integer
//     '/' and '%' (the JAX kernel's f32 divide needed a one-step fix);
//   * past the total, slots in a 1024-slot block (the JAX block, halved
//     while it does not divide the capacity) that still holds pairs get
//     the packing of an all-zero row, later blocks zeros.
//
// Bound on this card: bytes.  16 rows of 4 B are read per splat (64 MB
// at 1M splats) and six 4 B words written per slot (~91 MB at the main
// path's 3.8M slots): ~46 us at 3.35 TB/s.  One thread per splat keeps
// the row reads coalesced; a splat's slots are contiguous, so a warp's
// stores land in a few contiguous runs.  Work per thread follows the
// splat's pair count (~4 on the main path), so warps stay balanced there;
// a scene of huge splats makes the widest splat in a warp set its time.
//
// K8, the banded mode (the JAX kernel with bpb > 0, launched at
// ops/banded.py:517 there): the rows are the band-compacted array of K7,
// column c belongs to band g = c / MC, and its prefix rows are already
// offset into band g's slot segment [g * CG, (g + 1) * CG).  Two things
// change in the walk: a packed run of row r counts only if the tile row
// y0 + r lies in the band's rows [lo_g, hi_g), and the full-rect
// fallthrough starts at the first in-band row, max(base_row, lo_g - y0).
// Past band g's pair end the slots of its segment carry sentinels, with
// the JAX block layout applied per band.  Same bound: 16 rows of 4 B per
// compact column in, six words per slot out.
#include "common.cuh"

namespace {

constexpr int kRowExcl = 0, kRowIncl = 1, kRowGeom = 2, kRowDepth = 3,
              kRowIdx = 4, kRowCx = 5, kRowCy = 6, kRowCa = 7, kRowCb = 8,
              kRowCc = 9, kRowRgb = 10, kRowAlpha = 11, kRowPack0 = 12;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kDepthShift = 19;

__device__ __forceinline__ uint32_t trunc_u32(float x) {
  return static_cast<uint32_t>(static_cast<int>(x));
}

__device__ __forceinline__ float clamp01(float x) {
  return fminf(fmaxf(x, 0.0f), 1.0f);
}

// clip((x + 1) * 0.5, 0, 1) * 65535 + 0.5, truncated.
__device__ __forceinline__ uint32_t q16(float x) {
  const float v = clamp01(__fmul_rn(__fadd_rn(x, 1.0f), 0.5f));
  return trunc_u32(__fadd_rn(__fmul_rn(v, 65535.0f), 0.5f));
}

// Round-to-nearest-even bf16 bits, re-biased into a 12-bit minifloat.
__device__ __forceinline__ uint32_t mf12(float x) {
  const uint32_t bits = __float_as_uint(x);
  const uint32_t b16 = (bits + 0x7FFFu + ((bits >> 16) & 1u)) >> 16;
  const int v = static_cast<int>(b16) - static_cast<int>(gsr::MF12_K);
  return static_cast<uint32_t>(min(max(v, 0), 4095));
}

__device__ __forceinline__ float mf12_dec(uint32_t q) {
  return __uint_as_float((q + gsr::MF12_K) << 16);
}

struct Payload {
  uint32_t cxcy, conic, rgba;
};

__device__ Payload pack_payload(float cx, float cy, float ca, float cb,
                                float cc, float rgb, float alpha) {
  Payload p;
  p.cxcy = (q16(cx) << 16) | q16(cy);
  const uint32_t qa = mf12(ca);
  const uint32_t qc = mf12(cc);
  const float denom =
      fmaxf(__fsqrt_rn(__fmul_rn(mf12_dec(qa), mf12_dec(qc))), 1e-30f);
  const float rho = __fdiv_rn(cb, denom);
  const float qr = fminf(
      fmaxf(__fadd_rn(__fmul_rn(__fadd_rn(rho, 1.0f), 127.5f), 0.5f), 0.0f),
      255.0f);
  p.conic = (qa << 20) | (qc << 8) | trunc_u32(qr);
  p.rgba = (trunc_u32(rgb) << 8) |
           trunc_u32(__fadd_rn(__fmul_rn(clamp01(alpha), 255.0f), 0.5f));
  return p;
}

struct Outs {
  uint32_t* key0;
  uint32_t* key1;
  int* values;
  uint32_t* cxcy;
  uint32_t* conic;
  uint32_t* rgba;
};

// Banded mode only: G bands of MC compact columns and CG slots each, the
// [G] pair end slots and the [G + 1] tile-row boundaries (device arrays).
struct Bands {
  int n_bands;
  long long mc;
  int cg;
  const int* pair_end;
  const int* band_rows;
};

template <bool kBanded>
__global__ void emit_kernel(const float* __restrict__ rows, long long np,
                            int capacity, int packed, int tiles_x, Bands bands,
                            Outs out) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= np) return;
  const int excl = static_cast<int>(rows[kRowExcl * np + i]);
  const int end = min(static_cast<int>(rows[kRowIncl * np + i]), capacity);
  if (excl >= end) return;
  int band_lo = 0, band_hi = 0;
  if (kBanded) {
    const int g = static_cast<int>(
        min(i / bands.mc, static_cast<long long>(bands.n_bands - 1)));
    band_lo = bands.band_rows[g];
    band_hi = bands.band_rows[g + 1];
  }

  const auto row = [&](int r) { return rows[r * np + i]; };
  const uint32_t geom = static_cast<uint32_t>(row(kRowGeom));
  const int w_raw = static_cast<int>(geom & 255u);
  const int y0 = static_cast<int>((geom >> 8) & 255u);
  const int x0 = static_cast<int>(geom >> 16);
  const uint32_t q = static_cast<uint32_t>(row(kRowDepth));
  const int value = static_cast<int>(row(kRowIdx));
  const Payload pay = pack_payload(row(kRowCx), row(kRowCy), row(kRowCa),
                                   row(kRowCb), row(kRowCc), row(kRowRgb),
                                   row(kRowAlpha));
  uint32_t packs[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) packs[p] = static_cast<uint32_t>(row(kRowPack0 + p));

  int j = excl;
  const auto emit = [&](int tile) {
    const uint32_t t = static_cast<uint32_t>(tile);
    if (packed) {
      out.key0[j] = (t << kDepthShift) | q;
      out.key1[j] = 0u;
    } else {
      out.key0[j] = t;
      out.key1[j] = q << 8;
    }
    out.values[j] = value;
    out.cxcy[j] = pay.cxcy;
    out.conic[j] = pay.conic;
    out.rgba[j] = pay.rgba;
    ++j;
  };

  // The 8 packed row runs, in row order: ordinal o of row r sits at tile
  // (x0 + dx_r + o - cum_r, y0 + r).
  for (int r = 0; r < 8 && j < end; ++r) {
    const uint32_t half = (r & 1) ? (packs[r >> 1] & 4095u) : (packs[r >> 1] >> 12);
    const int dx = static_cast<int>(half >> 6);
    int w = static_cast<int>(half & 63u);
    if (kBanded && (y0 + r < band_lo || y0 + r >= band_hi)) w = 0;
    const int base = (y0 + r) * tiles_x + x0 + dx;
    for (int x = 0; x < w && j < end; ++x) emit(base + x);
  }
  // Full-rect fallthrough: rows 8+ of tall splats, or the whole rect of
  // splats wider than 63 tiles (whose runs are all empty).
  const int wf = max(w_raw, 1);
  int base_row = w_raw > 63 ? 0 : 8;
  if (kBanded) base_row = max(base_row, band_lo - y0);
  for (int extra = 0; j < end; ++extra) {
    const int ly = extra / wf;
    const int lx = extra % wf;
    emit((y0 + base_row + ly) * tiles_x + x0 + lx);
  }
}

template <bool kBanded>
__global__ void sentinel_kernel(const float* __restrict__ rows, long long np,
                                int capacity, int block, int packed,
                                uint32_t sentinel_tile, Bands bands, Outs out) {
  const long long j = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (j >= capacity) return;
  int total;
  if (kBanded) {
    // The slot's band ends at its own pair end; emit blocks divide CG, so
    // the block layout below never crosses into the next band.
    const int g = min(static_cast<int>(j / bands.cg), bands.n_bands - 1);
    total = min(bands.pair_end[g], capacity);
  } else {
    // The pad block's inclusive prefix is min(total, capacity + 1).
    total = min(static_cast<int>(rows[kRowIncl * np + np - 1]), capacity);
  }
  if (j < total) return;
  const long long live_end =
      min(static_cast<long long>(capacity),
          (static_cast<long long>(total) + block - 1) / block * block);
  out.key0[j] = packed ? kSentinel : sentinel_tile;
  out.key1[j] = packed ? 0u : kSentinel;
  out.values[j] = -1;
  Payload pay = {0u, 0u, 0u};
  if (j < live_end) pay = pack_payload(0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  out.cxcy[j] = pay.cxcy;
  out.conic[j] = pay.conic;
  out.rgba[j] = pay.rgba;
}

template <bool kBanded>
int launch_emit(const float* rows, long long np, int capacity, int block,
                int packed, int tiles_x, int sentinel_tile, Bands bands,
                Outs out, cudaStream_t s) {
  constexpr int kThreads = 256;
  emit_kernel<kBanded><<<gsr::blocks_for(np, kThreads), kThreads, 0, s>>>(
      rows, np, capacity, packed, tiles_x, bands, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sentinel_kernel<kBanded><<<gsr::blocks_for(capacity, kThreads), kThreads, 0, s>>>(
      rows, np, capacity, block, packed, static_cast<uint32_t>(sentinel_tile),
      bands, out);
  return static_cast<int>(cudaGetLastError());
}

Outs make_outs(void* key0, void* key1, void* values, void* cxcy, void* conic,
               void* rgba) {
  return {static_cast<uint32_t*>(key0), static_cast<uint32_t*>(key1),
          static_cast<int*>(values),    static_cast<uint32_t*>(cxcy),
          static_cast<uint32_t*>(conic), static_cast<uint32_t*>(rgba)};
}

}  // namespace

GSR_EXPORT int gsr_emit(const void* rows, long long np, int capacity,
                        int block, int packed, int tiles_x, int sentinel_tile,
                        void* key0, void* key1, void* values, void* cxcy,
                        void* conic, void* rgba, void* stream) {
  return launch_emit<false>(static_cast<const float*>(rows), np, capacity, block,
                            packed, tiles_x, sentinel_tile, Bands{},
                            make_outs(key0, key1, values, cxcy, conic, rgba),
                            static_cast<cudaStream_t>(stream));
}

// rows: the [16, G * mc] band-compacted array; capacity = G * cg slots.
GSR_EXPORT int gsr_emit_banded(const void* rows, int n_bands, long long mc,
                               int cg, int block, int packed, int tiles_x,
                               int sentinel_tile, const void* pair_end,
                               const void* band_rows, void* key0, void* key1,
                               void* values, void* cxcy, void* conic,
                               void* rgba, void* stream) {
  const Bands bands = {n_bands, mc, cg, static_cast<const int*>(pair_end),
                       static_cast<const int*>(band_rows)};
  return launch_emit<true>(static_cast<const float*>(rows), mc * n_bands,
                           cg * n_bands, block, packed, tiles_x, sentinel_tile,
                           bands,
                           make_outs(key0, key1, values, cxcy, conic, rgba),
                           static_cast<cudaStream_t>(stream));
}
