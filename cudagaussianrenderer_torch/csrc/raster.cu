// Kernel K4: blend each tile's sorted pairs into its pixels (stage F).
//
// Replaces ops/raster.py:_raster_kernel of the JAX package (launched by
// rasterize_tiles, raster.py:510 there).  That kernel DMAs 128-lane chunks
// from the aligned floor of each tile's segment and blends a whole
// [256 pixels, chunk] block at once: the transmittance recurrence becomes
// a log-domain exclusive scan on the MXU and the colour sum a matmul.  A
// GPU thread can run the recurrence itself, front to back in f32, so the
// kernel is the reference renderer's (rasterizeTilesKernel,
// GaussianRender.cu:908-1034): one block per tile, the tile's pairs staged
// through shared memory, a block vote for the early exit.  The recurrence
// is not a matrix product here, so no tensor-core instruction is used.
//
// Bound on this card: operations.  The early exit leaves 185.0 M (pixel,
// pair) evaluations on the main path (722,592 of 3.6 M sorted pairs, ~176
// a tile) against ~12 B read per pair; the floor is the larger of their
// f32 operations at the card's f32 rate and one ex2 per evaluation on the
// special-function units (16 a clock and SM).  The first version read
// nine 4-byte shared-memory words per evaluation and was bound by the
// shared-memory return path, not by arithmetic.  This design spends its
// instruction slots on the arithmetic: per evaluation eight f32 instructions,
// one min and one ex2, plus a quarter of the five f32 instructions and
// three loads a thread shares among its pixels.
//   * a pair is decoded once per tile into two float4 and one float of
//     shared memory (centre and the conic's two dx terms; the dy^2 term,
//     log2 opacity, red, green; blue), so a thread fetches it with three
//     broadcast loads instead of nine;
//   * a thread blends kPx = 4 neighbouring pixels of one tile row (one
//     pixel when the tile edge is no multiple of 4): the three loads and
//     the two dy terms of the quadratic form are shared by four
//     evaluations, and four independent recurrences hide the latency of
//     each other's ex2;
//   * log2(e) is folded into the three conic coefficients at decode time
//     and log2(opacity) is added into the exponent with the dy^2 term, so
//     alpha is one ex2.approx of min(m, log2 opacity) and no multiply; the
//     transmittance update is one fused multiply-add, T - T * alpha;
//   * batches of kBatch pairs are double-buffered: the raw words of batch
//     i + 1 travel global -> shared with cp.async while batch i blends, and
//     each thread decodes the words it fetched itself, so a batch costs one
//     barrier, which also carries the vote;
//   * a tile of more pixel groups than a block has threads (above 64x64
//     pixels at four a group, 32x32 at one) takes 1,024 threads or fewer,
//     each looping over several groups whose state waits in `out` between
//     batches (raster_tile's kLooped), still one block and one vote a tile.
// The pairs blended are the JAX kernel's: batches are the kBatch-aligned
// windows of the list clipped to [start, start + count), raster_chunk is a
// multiple of kBatch, and the block stops only where a whole raster_chunk
// has ended and no pixel has T > eps.  No pair is skipped for a small
// alpha.  Channel 3 is tile coverage, or T when a background is set.
#include "common.cuh"

namespace {

constexpr int kBatch = 128;  // pairs per staged batch; divides raster_chunk
constexpr int kMaxThreads = 1024;  // the card's limit for one block

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// An integer below 2^23 as a float, exactly, without the conversion unit
// (which shares its pipe with ex2): the integer becomes the mantissa of 2^23.
__device__ __forceinline__ float small_uint_as_float(uint32_t v) {
  return __uint_as_float(0x4B000000u | v) - 8388608.0f;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// kDevOffset: the band's first tile row comes from device memory (a band
// chosen on the device, as the JAX kernel's SMEM scalar), else from the
// launch argument; a template argument, so the flat frame's kernel has no
// extra load.
//
// kLooped: the tile has more groups of kPx pixels than a block may have
// threads (a 64-pixel edge is the largest whose groups all fit, at four
// pixels a thread).  Thread tid then takes groups tid, tid + blockDim.x,
// ..., each kPx pixels of one tile row with its own row and first column,
// and a group's r, g, b and T wait in the tile's own rows of `out` between
// batches: a tile of 128x128 pixels holds 64 K floats of that state, more
// than a block's registers or shared memory.  Per batch a group loads its
// state, blends the batch exactly as a resident group does, stores it, and
// ORs its T > eps into the thread's vote, so a tile still stops only where
// all of its pixels are opaque: the JAX kernel's rule, whatever the size.
// The pixels are the same, so is every operation on them: a pixel comes out
// of both forms bit for bit alike.
#define GSR_RASTER_ARGS                                                                 \
  const uint32_t *__restrict__ pairs, long long stride, const int *__restrict__ starts, \
      const int *__restrict__ counts, int tiles_x, int tile_size, int row_offset,        \
      const int *__restrict__ row_offset_dev, float pix_to_clip_x, float pix_to_clip_y,  \
      int chunk, float eps, int background, float4 *__restrict__ out
#define GSR_RASTER_PASS                                                                  \
  pairs, stride, starts, counts, tiles_x, tile_size, row_offset, row_offset_dev,         \
      pix_to_clip_x, pix_to_clip_y, chunk, eps, background, out

template <int kPx, bool kGaussian, bool kDevOffset, bool kLooped>
__device__ __forceinline__ void raster_tile(GSR_RASTER_ARGS) {
  __shared__ uint32_t s_raw[3][kBatch];
  // {cx, cy, na, nb2}, {nc, opacity, red, green}, blue.  Under the Gaussian
  // falloff na, nb2 and nc carry log2(e) and the opacity is its log2.
  __shared__ float4 s_geo[2][kBatch];
  __shared__ float4 s_col[2][kBatch];
  __shared__ float s_blue[2][kBatch];

  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int npix = tile_size * tile_size;
  const int groups = npix / kPx;
  const int start = starts[tile];
  const int count = counts[tile];
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + (kDevOffset ? *row_offset_dev : row_offset);
  float4* const tile_out = out + static_cast<long long>(tile) * npix;
  // One group of pixels: kPx neighbours on one row of the tile.
  float pcy, pcx[kPx], r[kPx], g[kPx], b[kPx], trans[kPx];
  const auto place = [&](int group) {
    const int pix0 = group * kPx;
    const int col0 = tx * tile_size + pix0 % tile_size;
    pcy = static_cast<float>(ty * tile_size + pix0 / tile_size) * pix_to_clip_y - 1.0f;
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      pcx[p] = static_cast<float>(col0 + p) * pix_to_clip_x - 1.0f;
  };
  if constexpr (kLooped) {
    for (int group = tid; group < groups; group += nthreads) {
#pragma unroll
      for (int p = 0; p < kPx; ++p)
        tile_out[group * kPx + p] = make_float4(0.0f, 0.0f, 0.0f, 1.0f);
    }
  } else {
    place(tid);
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      r[p] = g[p] = b[p] = 0.0f;
      trans[p] = 1.0f;
    }
  }

  const float center_inv = static_cast<float>(2.0 / 65535.0);
  const float rho_scale = static_cast<float>(1.0 / 127.5);
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const float epan_scale = static_cast<float>(2.0 / 7.0);
  const float fold = kGaussian ? 1.4426950408889634f : 1.0f;  // log2(e)

  if (count > 0) {
    const int end = start + count;
    // Pair k of the window at b0 is always thread k % nthreads's: it
    // fetches the raw words and later decodes them, so the raw buffer
    // needs no barrier and can be refilled right after the decode.
    const auto fetch = [&](int b0) {
      const int lo = max(b0, start) - b0;
      const int hi = min(b0 + kBatch, end) - b0;
      for (int k = tid; k < hi; k += nthreads) {
        if (k < lo) continue;
        const long long p = b0 + k;
        cp_async4(&s_raw[0][k], pairs + p);
        cp_async4(&s_raw[1][k], pairs + stride + p);
        cp_async4(&s_raw[2][k], pairs + 2 * stride + p);
      }
      cp_async_commit();
    };
    // The group's pixels over the batch's pairs [lo, hi), front to back.
    const auto blend = [&](int buf, int lo, int hi) {
#pragma unroll 4
      for (int k = lo; k < hi; ++k) {
        const float4 ge = s_geo[buf][k];
        const float4 co = s_col[buf][k];
        const float blue = s_blue[buf][k];
        const float dy = pcy - ge.y;
        const float t1 = ge.w * dy;
        // Gaussian: co.y is log2(opacity), added into the exponent here, so
        // alpha = 2^min(m, log2 opacity) needs no multiply per pixel.
        const float t2 = kGaussian ? fmaf(co.x * dy, dy, co.y) : (co.x * dy) * dy;
#pragma unroll
        for (int p = 0; p < kPx; ++p) {
          const float dx = pcx[p] - ge.x;
          const float m = fmaf(fmaf(ge.z, dx, t1), dx, t2);
          const float alpha = kGaussian
                                  ? ex2_approx(fminf(m, co.y))
                                  : co.y * __saturatef(fmaf(m, epan_scale, 1.0f));
          const float w = trans[p] * alpha;
          r[p] = fmaf(w, co.z, r[p]);
          g[p] = fmaf(w, co.w, g[p]);
          b[p] = fmaf(w, blue, b[p]);
          trans[p] = fmaf(-trans[p], alpha, trans[p]);
        }
      }
    };

    // Looped: whether one of the thread's pixels had T > eps after the
    // last batch it blended (the vote's first turn cannot end the tile).
    bool looped_alive = false;
    int b0 = start / kBatch * kBatch;
    fetch(b0);
    for (int it = 0;; ++it) {
      const int buf = it & 1;
      const int lo = max(b0, start) - b0;
      const int hi = min(b0 + kBatch, end) - b0;
      cp_async_wait_all();
      for (int k = tid; k < hi; k += nthreads) {
        if (k < lo) continue;
        const uint32_t cxcy = s_raw[0][k];
        const uint32_t con = s_raw[1][k];
        const uint32_t rgba = s_raw[2][k];
        const float ca = __uint_as_float(((con >> 20) + gsr::MF12_K) << 16);
        const float cc = __uint_as_float((((con >> 8) & 0xFFFu) + gsr::MF12_K) << 16);
        const float rho = small_uint_as_float(con & 0xFFu) * rho_scale - 1.0f;
        s_geo[buf][k] = make_float4(
            small_uint_as_float(cxcy >> 16) * center_inv - 1.0f,
            small_uint_as_float(cxcy & 0xFFFFu) * center_inv - 1.0f,
            ca * (-0.5f * fold), -(rho * sqrtf(ca * cc)) * fold);
        const float opacity = small_uint_as_float(rgba & 0xFFu) * inv255;
        s_col[buf][k] = make_float4(
            cc * (-0.5f * fold), kGaussian ? log2f(opacity) : opacity,
            small_uint_as_float(rgba >> 24) * inv255,
            small_uint_as_float((rgba >> 16) & 0xFFu) * inv255);
        s_blue[buf][k] = small_uint_as_float((rgba >> 8) & 0xFFu) * inv255;
      }
      const int next = b0 + kBatch;
      if (next < end) fetch(next);

      // The batch's one barrier: it publishes this decode, ends the reads
      // of the buffer the next decode overwrites, and carries the vote on
      // everything blended so far.
      bool alive = looped_alive;
      if constexpr (!kLooped) {
#pragma unroll
        for (int p = 0; p < kPx; ++p) alive |= trans[p] > eps;
      }
      const int any_alive = __syncthreads_or(alive);
      // A whole raster_chunk has ended where this batch begins one.
      if (it > 0 && b0 % chunk == 0 && !any_alive) break;

      if constexpr (kLooped) {
        looped_alive = false;
        for (int group = tid; group < groups; group += nthreads) {
          float4* const state = tile_out + group * kPx;
          place(group);
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            const float4 v = state[p];
            r[p] = v.x;
            g[p] = v.y;
            b[p] = v.z;
            trans[p] = v.w;
          }
          blend(buf, lo, hi);
#pragma unroll
          for (int p = 0; p < kPx; ++p) {
            state[p] = make_float4(r[p], g[p], b[p], trans[p]);
            looped_alive |= trans[p] > eps;
          }
        }
      } else {
        blend(buf, lo, hi);
      }
      if (next >= end) break;
      b0 = next;
    }
    cp_async_wait_all();  // a fetch may be in flight when the vote ends the tile
  }

  const float covered = count > 0 ? 1.0f : 0.0f;
  if constexpr (kLooped) {
    // The state's w is T, which is channel 3 only under a background.  Each
    // thread rewrites its own groups, which it stored last.
    if (!background) {
      float* const w = reinterpret_cast<float*>(tile_out) + 3;
      for (int group = tid; group < groups; group += nthreads) {
#pragma unroll
        for (int p = 0; p < kPx; ++p) w[4 * (group * kPx + p)] = covered;
      }
    }
  } else {
    float4* dst = tile_out + tid * kPx;
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      dst[p] = make_float4(r[p], g[p], b[p], background ? trans[p] : covered);
  }
}

// A tile whose groups all fit in one block: a thread a group, in registers.
template <int kPx, bool kGaussian, bool kDevOffset>
__global__ void raster_kernel(GSR_RASTER_ARGS) {
  raster_tile<kPx, kGaussian, kDevOffset, false>(GSR_RASTER_PASS);
}

// A larger tile: kMaxThreads threads at most, looping over the groups.
template <int kPx, bool kGaussian, bool kDevOffset>
__global__ void __launch_bounds__(kMaxThreads) raster_looped_kernel(GSR_RASTER_ARGS) {
  raster_tile<kPx, kGaussian, kDevOffset, true>(GSR_RASTER_PASS);
}

using RasterKernel = void (*)(GSR_RASTER_ARGS);

template <int kPx, bool kGaussian>
RasterKernel pick(bool dev_offset, bool looped) {
  if (looped)
    return dev_offset ? raster_looped_kernel<kPx, kGaussian, true>
                      : raster_looped_kernel<kPx, kGaussian, false>;
  return dev_offset ? raster_kernel<kPx, kGaussian, true> : raster_kernel<kPx, kGaussian, false>;
}

}  // namespace

GSR_EXPORT int gsr_raster(const void* pairs, long long stride,
                          const void* starts, const void* counts,
                          int num_tiles, int tiles_x, int tile_size,
                          int row_offset, const void* row_offset_dev,
                          float pix_to_clip_x,
                          float pix_to_clip_y, int chunk, float eps,
                          int gaussian, int background, void* out,
                          void* stream) {
  if (chunk % kBatch || tile_size < 1) return static_cast<int>(cudaErrorInvalidValue);
  // Four pixels of one row per group need a tile edge that 4 divides.
  const bool wide = tile_size % 4 == 0;
  const int groups = tile_size * tile_size / (wide ? 4 : 1);
  // Groups a thread: one while they all fit in a block, else as few as do,
  // spread evenly over the threads.
  const int per_thread = (groups + kMaxThreads - 1) / kMaxThreads;
  const int threads = (groups + per_thread - 1) / per_thread;
  const bool looped = per_thread > 1;
  const bool dev = row_offset_dev != nullptr;
  auto kernel = wide ? (gaussian ? pick<4, true>(dev, looped) : pick<4, false>(dev, looped))
                     : (gaussian ? pick<1, true>(dev, looped) : pick<1, false>(dev, looped));
  kernel<<<num_tiles, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pairs), stride,
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      tiles_x, tile_size, row_offset, static_cast<const int*>(row_offset_dev),
      pix_to_clip_x, pix_to_clip_y, chunk,
      eps, background, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
