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
//     barrier, which also carries the vote.
// A tile of more than 1,024 pixels (an edge above 32) is a thread-block
// cluster of Hopper (raster_cluster_kernel): block r of the cluster takes
// the tile's rows [r * band_rows, (r + 1) * band_rows), the last band
// shorter where the edge asks for it, and keeps its groups in registers.
// The blocks are small (3 to 8 warps), so several share an SM, hide each
// other's barriers, and give every SM work even at 64 tiles of 128x128
// pixels; a block's state never leaves its registers (a one-block design
// held a 128x128 tile's state in `out` between batches, at 2.7x the time,
// PERF.md section 6).  The clusters take the tiles longest list first (an
// order the wrapper sorts), so that a long list does not run alone at the
// end of the grid.  Each block stages and decodes the tile's
// batches itself, from L2 after the first block's read.  The early exit
// stays the tile's: where a raster_chunk ends, each warp that still has a
// pixel with T > eps stores a 1 into a vote word of every block of the
// cluster (distributed shared memory), and one cluster barrier publishes
// the words.  The barrier is split: a block arrives right after its blend,
// decodes the next batch, and waits only before that batch's blend, so the
// decode hides the barrier's latency.  Three vote words take turns: a word
// is cleared by its block before the arrive that precedes its next use,
// two votes after its last read.  The geometry (pixels a group, blocks a
// cluster, rows a block, threads a block) is ops/raster.py's
// raster_geometry; the launch checks it and computes nothing else from the
// tile size.  Where a block's band has more groups than 1,024 threads
// (edges above 256 at four pixels a group, above 128 at one, with 16-block
// clusters), each thread loops over several groups whose state waits in
// `out` between batches (kLooped).
// The pairs blended are the JAX kernel's: batches are the kBatch-aligned
// windows of the list clipped to [start, start + count), raster_chunk is a
// multiple of kBatch, and a tile stops only where a whole raster_chunk has
// ended and no pixel of the tile has T > eps.  No pair is skipped for a
// small alpha.  Channel 3 is tile coverage, or T when a background is set.
// Where `blended` is not null, each tile adds the pairs it blended before
// its exit to it: every thread of the tile blends the same batches (the
// vote is the tile's, a cluster's blocks included), so thread 0 of the
// block or of the cluster's first block adds the tile's count with one
// atomic and no reduction.
#include "common.cuh"

namespace {

constexpr int kBatch = 128;  // pairs per staged batch; divides raster_chunk
constexpr int kMaxThreads = 1024;  // the card's limit for one block
constexpr int kMaxCluster = 16;  // Hopper's largest (non-portable) cluster
constexpr int kPortableCluster = 8;

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

// The block's rank in its cluster, the cluster's blocks, and the cluster's
// index in the grid (a launch without clusters has clusters of one block).
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

__device__ __forceinline__ unsigned cluster_index() {
  unsigned c;
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(c));
  return c;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");  // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");  // acquire
}

// Store v into `word` of the cluster's block `rank` (distributed shared memory).
__device__ __forceinline__ void cluster_store(uint32_t* word, unsigned rank, uint32_t v) {
  const unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(word));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(remote), "r"(v) : "memory");
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
// kCluster: the block is one of a cluster that shares the tile (see the
// header); band_rows is its rows, and cluster c takes tile tile_order[c]
// (the tiles by falling list length, so that the longest lists start
// first and no long list is left to run alone at the end).  Without it
// block b takes the whole of tile b, a thread a group.
//
// kLooped: the block's band has more groups of kPx pixels than the block
// has threads.  Thread tid then takes groups tid, tid + blockDim.x, ...,
// each kPx pixels of one tile row with its own row and first column, and a
// group's r, g, b and T wait in the tile's own rows of `out` between
// batches.  Per batch a group loads its state, blends the batch exactly as
// a resident group does, stores it, and ORs its T > eps into the thread's
// vote.  The pixels are the same, so is every operation on them: a pixel
// comes out of every form bit for bit alike.
#define GSR_RASTER_ARGS                                                                 \
  const uint32_t *__restrict__ pairs, long long stride, const int *__restrict__ starts, \
      const int *__restrict__ counts, const int *__restrict__ tile_order, int tiles_x,   \
      int tile_size, int band_rows, int row_offset, const int *__restrict__ row_offset_dev, \
      float pix_to_clip_x, float pix_to_clip_y, int chunk, float eps, int background,    \
      float4 *__restrict__ out, int *__restrict__ blended
#define GSR_RASTER_PASS                                                                  \
  pairs, stride, starts, counts, tile_order, tiles_x, tile_size, band_rows, row_offset,  \
      row_offset_dev, pix_to_clip_x, pix_to_clip_y, chunk, eps, background, out, blended

template <int kPx, bool kGaussian, bool kDevOffset, bool kCluster, bool kLooped>
__device__ __forceinline__ void raster_tile(GSR_RASTER_ARGS) {
  __shared__ uint32_t s_raw[3][kBatch];
  // {cx, cy, na, nb2}, {nc, opacity, red, green}, blue.  Under the Gaussian
  // falloff na, nb2 and nc carry log2(e) and the opacity is its log2.
  __shared__ float4 s_geo[2][kBatch];
  __shared__ float4 s_col[2][kBatch];
  __shared__ float s_blue[2][kBatch];
  // The cluster's votes: word v % 3 is nonzero after vote v where a pixel
  // of some block of the tile had T > eps.
  __shared__ uint32_t s_vote[3];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int npix = tile_size * tile_size;
  // The tile and the block's band of its rows: all of them, or band r of a
  // cluster, which may be short at the tile's last row.
  const int tile = kCluster ? tile_order[cluster_index()] : blockIdx.x;
  const int row0 = kCluster ? static_cast<int>(cluster_rank()) * band_rows : 0;
  const int groups = kCluster ? min(band_rows, tile_size - row0) * (tile_size / kPx)
                              : npix / kPx;
  const int start = starts[tile];
  const int count = counts[tile];
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + (kDevOffset ? *row_offset_dev : row_offset);
  float4* const tile_out = out + static_cast<long long>(tile) * npix + row0 * tile_size;
  // One group of pixels: kPx neighbours on one row of the band.
  float pcy, pcx[kPx], r[kPx], g[kPx], b[kPx], trans[kPx];
  const auto place = [&](int group) {
    const int pix0 = group * kPx;
    const int col0 = tx * tile_size + pix0 % tile_size;
    pcy = static_cast<float>(ty * tile_size + row0 + pix0 / tile_size) * pix_to_clip_y - 1.0f;
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
    // A thread past a short band's groups blends pixels it never writes;
    // its T starts at 0, so it never keeps the tile alive.
    const float t0 = !kCluster || tid < groups ? 1.0f : 0.0f;
#pragma unroll
    for (int p = 0; p < kPx; ++p) {
      r[p] = g[p] = b[p] = 0.0f;
      trans[p] = t0;
    }
  }

  const float center_inv = static_cast<float>(2.0 / 65535.0);
  const float rho_scale = static_cast<float>(1.0 / 127.5);
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const float epan_scale = static_cast<float>(2.0 / 7.0);
  const float fold = kGaussian ? 1.4426950408889634f : 1.0f;  // log2(e)
  int pairs_blended = 0;

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
    // Whether one of the thread's pixels has T > eps after what it has
    // blended so far.
    const auto alive_now = [&](bool looped_alive) {
      bool alive = looped_alive;
      if constexpr (!kLooped) {
#pragma unroll
        for (int p = 0; p < kPx; ++p) alive |= trans[p] > eps;
      }
      return alive;
    };

    // Looped: whether one of the thread's pixels had T > eps after the
    // last batch it blended (the vote's first turn cannot end the tile).
    bool looped_alive = false;
    // Cluster: the votes arrived at so far (0: the start's barrier, which
    // every block passes with its words cleared before any block writes
    // into another's), and whether the block has yet to wait for the last.
    int votes = 0;
    bool waiting = false;
    if constexpr (kCluster) {
      if (tid < 3) s_vote[tid] = 0;
      cluster_arrive();
      waiting = true;
    }
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

      if constexpr (kCluster) {
        // Publishes this decode and ends the reads of the buffer the next
        // decode overwrites; then the cluster's vote, arrived at after the
        // last blend, on everything blended so far.
        __syncthreads();
        if (waiting) {
          cluster_wait();
          waiting = false;
          if (votes > 0 && s_vote[votes % 3] == 0) break;
        }
      } else {
        // The batch's one barrier: it publishes this decode, ends the reads
        // of the buffer the next decode overwrites, and carries the vote on
        // everything blended so far.
        const int any_alive = __syncthreads_or(alive_now(looped_alive));
        // A whole raster_chunk has ended where this batch begins one.
        if (it > 0 && b0 % chunk == 0 && !any_alive) break;
      }

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
      pairs_blended += hi - lo;
      if (next >= end) break;
      if constexpr (kCluster) {
        // A whole raster_chunk ends where the next batch begins: vote.
        if (next % chunk == 0) {
          ++votes;
          if (tid == 0) s_vote[(votes + 1) % 3] = 0;  // the next vote's word
          const unsigned lanes = min(nthreads - (tid & ~31), 32);
          const unsigned mask = lanes == 32 ? 0xFFFFFFFFu : (1u << lanes) - 1u;
          if (__any_sync(mask, alive_now(looped_alive)) && (tid & 31) == 0) {
            const unsigned blocks = cluster_blocks();
            for (unsigned rank = 0; rank < blocks; ++rank)
              cluster_store(&s_vote[votes % 3], rank, 1u);
          }
          cluster_arrive();
          waiting = true;
        }
      }
      b0 = next;
    }
    cp_async_wait_all();  // a fetch may be in flight when the vote ends the tile
  }
  if (blended != nullptr && tid == 0 && pairs_blended > 0 && (!kCluster || cluster_rank() == 0))
    atomicAdd(blended, pairs_blended);

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
  } else if (!kCluster || tid < groups) {
    float4* dst = tile_out + tid * kPx;
#pragma unroll
    for (int p = 0; p < kPx; ++p)
      dst[p] = make_float4(r[p], g[p], b[p], background ? trans[p] : covered);
  }
}

// A tile of 1,024 pixels or fewer: one block, a thread a group, in registers.
template <int kPx, bool kGaussian, bool kDevOffset>
__global__ void raster_kernel(GSR_RASTER_ARGS) {
  raster_tile<kPx, kGaussian, kDevOffset, false, false>(GSR_RASTER_PASS);
}

// A larger tile: a cluster of blocks, a band of rows each.
template <int kPx, bool kGaussian, bool kDevOffset, bool kLooped>
__global__ void __launch_bounds__(kMaxThreads) raster_cluster_kernel(GSR_RASTER_ARGS) {
  raster_tile<kPx, kGaussian, kDevOffset, true, kLooped>(GSR_RASTER_PASS);
}

using RasterKernel = void (*)(GSR_RASTER_ARGS);

template <int kPx, bool kGaussian>
RasterKernel pick(bool dev_offset, bool cluster, bool looped) {
  if (!cluster)
    return dev_offset ? raster_kernel<kPx, kGaussian, true> : raster_kernel<kPx, kGaussian, false>;
  if (looped)
    return dev_offset ? raster_cluster_kernel<kPx, kGaussian, true, true>
                      : raster_cluster_kernel<kPx, kGaussian, false, true>;
  return dev_offset ? raster_cluster_kernel<kPx, kGaussian, true, false>
                    : raster_cluster_kernel<kPx, kGaussian, false, false>;
}

RasterKernel pick_kernel(int px, bool gaussian, bool dev_offset, bool cluster, bool looped) {
  if (px == 4)
    return gaussian ? pick<4, true>(dev_offset, cluster, looped)
                    : pick<4, false>(dev_offset, cluster, looped);
  return gaussian ? pick<1, true>(dev_offset, cluster, looped)
                  : pick<1, false>(dev_offset, cluster, looped);
}

// Clusters above kPortableCluster blocks need a flag on each kernel, set once.
cudaError_t allow_large_clusters() {
  static cudaError_t done = [] {
    for (int px : {1, 4})
      for (int i = 0; i < 8; ++i) {
        const cudaError_t e = cudaFuncSetAttribute(
            pick_kernel(px, i & 1, i & 2, true, i & 4),
            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
      }
    return cudaSuccess;
  }();
  return done;
}

cudaLaunchConfig_t cluster_config(int blocks, int threads, int cluster, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(threads));
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// The largest cluster the raster may launch on the current card: kMaxCluster
// where a cluster of that many 1,024-thread blocks of every cluster kernel
// fits, else kPortableCluster.  A negative value is a CUDA error, negated.
GSR_EXPORT int gsr_raster_max_cluster() {
  cudaError_t e = allow_large_clusters();
  if (e != cudaSuccess) return -static_cast<int>(e);
  for (int px : {1, 4})
    for (int i = 0; i < 8; ++i) {
      cudaLaunchAttribute attr;
      const cudaLaunchConfig_t cfg =
          cluster_config(kMaxCluster, kMaxThreads, kMaxCluster, nullptr, &attr);
      int clusters = 0;
      e = cudaOccupancyMaxActiveClusters(&clusters, pick_kernel(px, i & 1, i & 2, true, i & 4),
                                         &cfg);
      if (e != cudaSuccess) return -static_cast<int>(e);
      if (clusters < 1) return kPortableCluster;
    }
  return kMaxCluster;
}

// px, cluster, band_rows and threads are ops/raster.py:raster_geometry's;
// tile_order (the tiles by falling count, num_tiles of them) is read by the
// cluster form only and may be null for the one-block form; blended (one
// int32, or null) gains the pairs the tiles blended before their exits.
GSR_EXPORT int gsr_raster(const void* pairs, long long stride,
                          const void* starts, const void* counts,
                          const void* tile_order, int num_tiles,
                          int tiles_x, int tile_size,
                          int row_offset, const void* row_offset_dev,
                          float pix_to_clip_x,
                          float pix_to_clip_y, int chunk, float eps,
                          int gaussian, int background, int px, int cluster,
                          int band_rows, int threads, void* out,
                          void* blended, void* stream) {
  const bool geometry_ok =
      tile_size >= 1 && (px == 4 || px == 1) && tile_size % px == 0 && cluster >= 1 &&
      cluster <= kMaxCluster && band_rows >= 1 && (cluster - 1) * band_rows < tile_size &&
      cluster * band_rows >= tile_size && threads >= 1 && threads <= kMaxThreads;
  if (chunk % kBatch || !geometry_ok) return static_cast<int>(cudaErrorInvalidValue);
  const long long band_groups = static_cast<long long>(band_rows) * (tile_size / px);
  const bool looped = threads < band_groups;
  // A tile in one block has a thread a group.
  if (cluster == 1 && !looped && threads != band_groups)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool dev = row_offset_dev != nullptr;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto kernel = pick_kernel(px, gaussian, dev, cluster > 1 || looped, looped);
  const auto* p = static_cast<const uint32_t*>(pairs);
  const auto* st = static_cast<const int*>(starts);
  const auto* ct = static_cast<const int*>(counts);
  const auto* order = static_cast<const int*>(tile_order);
  const auto* rod = static_cast<const int*>(row_offset_dev);
  auto* o = static_cast<float4*>(out);
  auto* bl = static_cast<int*>(blended);
  if (cluster == 1 && !looped) {
    kernel<<<num_tiles, threads, 0, s>>>(p, stride, st, ct, order, tiles_x, tile_size,
                                         band_rows, row_offset, rod, pix_to_clip_x,
                                         pix_to_clip_y, chunk, eps, background, o, bl);
    return static_cast<int>(cudaGetLastError());
  }
  if (order == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (cluster > kPortableCluster) {
    const cudaError_t e = allow_large_clusters();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(num_tiles * cluster, threads, cluster, s, &attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p, stride, st, ct, order, tiles_x,
                                           tile_size, band_rows, row_offset, rod, pix_to_clip_x,
                                           pix_to_clip_y, chunk, eps, background, o, bl);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
