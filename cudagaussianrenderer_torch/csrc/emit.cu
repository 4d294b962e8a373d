// Kernels K3 and K8: emit the fixed-capacity (tile, splat) pair list
// (stage C), flat and band-segmented.
//
// Replaces ops/expand.py:_emit_kernel of the JAX package (with
// _emit_block, _emit_payload and _store_sentinels; launched at
// expand.py:754 there).  That kernel gives each grid step one block of
// slots and recovers every slot's owner with one-hot matmuls over DMA'd
// splat windows, fed by per-block first owners from the histogram kernel.
// This one keeps the slot-parallel shape and drops the rest: one launch,
// one thread block per emit block of slots (the JAX block: 1024, halved
// while it does not divide the capacity), neighbouring threads on
// neighbouring slots.
//   * The block finds the first column whose inclusive prefix exceeds its
//     first slot with a cooperative 256-ary search of the prefix row:
//     three rounds of one load and one counting barrier at a million
//     columns, no block-start table.
//   * From there it walks the columns 256 at a time.  Thread t reads
//     column i0 + t's prefixes, coalesced; only a column that owns a slot
//     of this block has its other 14 rows read and its payload packed,
//     once, into shared memory.  A batch that owns nothing (a run of
//     culled splats) is skipped by searching again.
//   * Every slot the batch covers is then written by its own thread: the
//     owner is the first staged column with incl > j (8 steps of binary
//     search in shared memory), the ordinal o = j - excl_owner, the tile
//     comes from the owner's 8 packed (dx, w) row runs or the full-rect
//     fallthrough, in the integer arithmetic of the plain version.  A
//     warp's store covers 128 contiguous bytes of each output array, and
//     a splat of any size is spread over as many threads and blocks as it
//     has slots.
//   * Slots past the candidate total are filled by the same block.
//
// The six outputs equal the JAX kernel's slot for slot:
//   * keys tile << 19 | depth19 (or tile, depth24 << 8), value = splat id;
//   * the packed attribute words round every float op separately, as the
//     JAX kernel and the plain PyTorch version do (this file is built with
//     --fmad=false, and the rounding-sensitive lines spell out _rn ops);
//   * the mf12 rounding is integer math on the f32 bits;
//   * the fallthrough decode divides exact small integers with integer
//     '/' and '%' (the JAX kernel's f32 divide needed a one-step fix);
//   * past the total, slots in a block that still holds pairs get the
//     packing of an all-zero row, later blocks zeros.
//
// Bound on this card: bytes.  16 rows of 4 B are read per splat (64 MB
// at 1M splats) and six 4 B words written per slot (~94 MB at the main
// path's 3.9M slots): ~47 us at 3.35 TB/s.  Reads and writes are both
// coalesced; what the design pays beyond the bytes is latency, some eight
// dependent loads in a block's life (total, three search rounds, two
// batches of prefixes and rows), which the resident blocks of an SM hide
// from one another.
//
// K8, the banded mode (the JAX kernel with bpb > 0, launched at
// ops/banded.py:517 there): the rows are the band-compacted array of K7,
// band g owns the columns [g * MC, (g + 1) * MC) and the slot segment
// [g * CG, (g + 1) * CG), and its prefix rows are already offset into
// that segment.  Emit blocks divide CG, so a block lies in one band: it
// searches and walks that band's columns only, its total is the band's
// pair end, and the sentinel layout applies per band.  Two things change
// in the tile decode: a packed run of row r counts only if the tile row
// y0 + r lies in the band's rows [lo_g, hi_g), and the full-rect
// fallthrough starts at the first in-band row, max(base_row, lo_g - y0).
// Same bound, bytes: 16 rows of 4 B per kept compact column in (the fill
// columns behind a band's kept ones own no slot and are never read), six
// words per slot out.
#include <climits>

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

constexpr int kThreads = 256;  // threads a block = columns staged a batch
// Blocks an SM should hold (40 registers a thread): a block's life is a
// chain of dependent loads, and its neighbours' stores fill the waits.
constexpr int kBlocksPerSm = 6;

// The first column in [lo, hi) whose inclusive prefix exceeds slot j; the
// caller guarantees there is one.  Called by the whole block: every round
// probes kThreads evenly spaced columns and counts those still at or below
// j, which narrows the range kThreads-fold.
__device__ long long first_owner(const float* __restrict__ incl_row,
                                 long long lo, long long hi, int j) {
  for (;;) {
    const long long step = (hi - lo + kThreads - 1) / kThreads;
    const long long p = lo + threadIdx.x * step;
    const int below = p < hi && static_cast<int>(incl_row[p]) <= j;
    const int n_below = __syncthreads_count(below);
    if (step <= 1) return lo + n_below;
    // incl[lo + (n_below - 1) * step] <= j < incl[lo + n_below * step].
    hi = min(hi, lo + n_below * step + 1);
    if (n_below > 0) lo += (n_below - 1) * step + 1;
  }
}

template <bool kBanded>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    emit_kernel(const float* __restrict__ rows, long long np, int capacity,
                int block, int packed, int tiles_x, uint32_t sentinel_tile,
                Bands bands, Outs out) {
  // One batch of owner columns: prefixes, rect, splat id, the four run
  // words, and {cxcy, conic, rgba, depth}.
  __shared__ int s_incl[kThreads], s_excl[kThreads], s_value[kThreads];
  __shared__ uint32_t s_geom[kThreads];
  __shared__ uint4 s_runs[kThreads], s_words[kThreads];

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * block;
  const int j1 = j0 + block;
  const float* __restrict__ incl_row = rows + kRowIncl * np;
  long long lo_col = 0, hi_col = np;
  int total, band_lo = 0, band_hi = 0;
  if (kBanded) {
    const int g = min(j0 / bands.cg, bands.n_bands - 1);
    lo_col = g * bands.mc;
    hi_col = lo_col + bands.mc;
    total = min(bands.pair_end[g], capacity);
    band_lo = bands.band_rows[g];
    band_hi = bands.band_rows[g + 1];
  } else {
    // The pad block's inclusive prefix is min(total, capacity + 1).
    total = min(static_cast<int>(incl_row[np - 1]), capacity);
  }
  const int live = min(j1, total);  // slots [j0, live) hold pairs

  const auto store = [&](int j, uint32_t key0, uint32_t key1, int value,
                         uint32_t cxcy, uint32_t conic, uint32_t rgba) {
    out.key0[j] = key0;
    out.key1[j] = key1;
    out.values[j] = value;
    out.cxcy[j] = cxcy;
    out.conic[j] = conic;
    out.rgba[j] = rgba;
  };

  // Slots [next, live) still wait for their owners; the columns before i0
  // own none of them.
  int next = j0;
  long long i0 = 0;
  if (next < live) i0 = first_owner(incl_row, lo_col, hi_col, next);
  while (next < live) {
    // The batch [i0, i0 + kThreads) covers the slots below its last
    // inclusive prefix; past the last column nothing is left to cover.
    const int covered = i0 + kThreads <= hi_col
                            ? static_cast<int>(incl_row[i0 + kThreads - 1])
                            : INT_MAX;
    if (covered <= next) {
      i0 = first_owner(incl_row, i0 + kThreads, hi_col, next);
      continue;
    }
    const int upto = min(covered, live);
    const long long i = i0 + tid;
    const int incl = i < hi_col ? static_cast<int>(incl_row[i]) : INT_MAX;
    __syncthreads();  // the batch before is read out
    s_incl[tid] = incl;
    if (i < hi_col) {
      const auto row = [&](int r) { return rows[r * np + i]; };
      const int excl = static_cast<int>(row(kRowExcl));
      if (max(excl, next) < min(incl, upto)) {
        s_excl[tid] = excl;
        s_geom[tid] = static_cast<uint32_t>(row(kRowGeom));
        s_value[tid] = static_cast<int>(row(kRowIdx));
        s_runs[tid] = make_uint4(static_cast<uint32_t>(row(kRowPack0)),
                                 static_cast<uint32_t>(row(kRowPack0 + 1)),
                                 static_cast<uint32_t>(row(kRowPack0 + 2)),
                                 static_cast<uint32_t>(row(kRowPack0 + 3)));
        const Payload pay = pack_payload(row(kRowCx), row(kRowCy), row(kRowCa),
                                         row(kRowCb), row(kRowCc), row(kRowRgb),
                                         row(kRowAlpha));
        s_words[tid] = make_uint4(pay.cxcy, pay.conic, pay.rgba,
                                  static_cast<uint32_t>(row(kRowDepth)));
      }
    }
    __syncthreads();

    // This thread's slots are j0 + tid + m * kThreads; start at the first
    // one not yet written.
    const int skip = max(next - j0 - tid + kThreads - 1, 0) / kThreads;
    for (int j = j0 + tid + skip * kThreads; j < upto; j += kThreads) {
      // Owner: the first staged column with incl > j.
      int k = 0;
#pragma unroll
      for (int half = kThreads / 2; half > 0; half >>= 1)
        if (s_incl[k + half - 1] <= j) k += half;
      const int o = j - s_excl[k];
      const uint32_t geom = s_geom[k];
      const int w_raw = static_cast<int>(geom & 255u);
      const int y0 = static_cast<int>((geom >> 8) & 255u);
      const int x0 = static_cast<int>(geom >> 16);
      const uint4 runs = s_runs[k];
      const uint32_t run_words[4] = {runs.x, runs.y, runs.z, runs.w};
      // The 8 packed row runs, in row order: ordinal o of row r sits at
      // tile (x0 + dx_r + o - cum_r, y0 + r).
      int tile = -1;
      int cum = 0;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const uint32_t run =
            (r & 1) ? (run_words[r >> 1] & 4095u) : (run_words[r >> 1] >> 12);
        int w = static_cast<int>(run & 63u);
        if (kBanded && (y0 + r < band_lo || y0 + r >= band_hi)) w = 0;
        if (tile < 0 && o < cum + w)
          tile = (y0 + r) * tiles_x + x0 + static_cast<int>(run >> 6) + (o - cum);
        cum += w;
      }
      if (tile < 0) {
        // Full-rect fallthrough: rows 8+ of tall splats, or the whole rect
        // of splats wider than 63 tiles (whose runs are all empty).
        const int wf = max(w_raw, 1);
        int base_row = w_raw > 63 ? 0 : 8;
        if (kBanded) base_row = max(base_row, band_lo - y0);
        const int extra = o - cum;
        tile = (y0 + base_row + extra / wf) * tiles_x + x0 + extra % wf;
      }
      const uint4 words = s_words[k];
      const uint32_t t = static_cast<uint32_t>(tile);
      store(j, packed ? (t << kDepthShift) | words.w : t,
            packed ? 0u : words.w << 8, s_value[k], words.x, words.y, words.z);
    }
    next = upto;
    i0 += kThreads;
  }

  // Past the total: sentinel keys; a block that still holds pairs packs an
  // all-zero row, later blocks carry zeros.
  Payload fill = {0u, 0u, 0u};
  if (j0 < total) fill = pack_payload(0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f);
  for (int j = max(live, j0) + tid; j < j1; j += kThreads)
    store(j, packed ? kSentinel : sentinel_tile, packed ? 0u : kSentinel, -1,
          fill.cxcy, fill.conic, fill.rgba);
}

template <bool kBanded>
int launch_emit(const float* rows, long long np, int capacity, int block,
                int packed, int tiles_x, int sentinel_tile, Bands bands,
                Outs out, cudaStream_t s) {
  if (block <= 0 || capacity % block) return static_cast<int>(cudaErrorInvalidValue);
  if (capacity == 0) return 0;
  emit_kernel<kBanded><<<capacity / block, kThreads, 0, s>>>(
      rows, np, capacity, block, packed, tiles_x,
      static_cast<uint32_t>(sentinel_tile), bands, out);
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
