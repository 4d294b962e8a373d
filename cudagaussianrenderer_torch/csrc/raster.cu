// Kernel K4: blend each tile's sorted pairs into its pixels (stage F).
//
// Replaces ops/raster.py:_raster_kernel of the JAX package (launched by
// rasterize_tiles, raster.py:510 there).  That kernel DMAs 128-lane chunks
// from the aligned floor of each tile's segment and blends a whole
// [256 pixels, chunk] block at once: the transmittance recurrence becomes
// a log-domain exclusive scan on the MXU and the colour sum a matmul.
// A GPU thread can run the recurrence itself, so this is the reference
// renderer's shape (rasterizeTilesKernel, GaussianRender.cu:908-1034):
//   * one block per tile, one thread per pixel;
//   * the block reads the tile's pairs [start, start + count) straight
//     from the sorted list, up to 256 at a time, decodes each pair once
//     into shared memory (centre, -conic/2, opacity, rgb), and every pixel
//     blends them front to back: w = T * alpha, rgb += w * c,
//     T *= 1 - alpha;
//   * after each whole raster_chunk of the list (chunks aligned to
//     multiples of raster_chunk, the JAX kernel's boundaries) the block
//     votes with __syncthreads_or(T > eps) and stops once every pixel is
//     opaque — the same pairs as the JAX kernel's exit;
//   * channel 3 is tile coverage, or T when a background is set.
//
// Bound on this card: operations.  Each (pixel, pair) costs ~15 f32 ops
// and one exp (~0.95 G evaluations at the main path before the early
// exit, 3.7M pairs x 256 pixels), against only ~16 B read per pair.  The
// shared-memory staging makes each pair's decode and global read happen
// once per tile instead of once per pixel; the per-pixel loop reads
// shared memory as broadcasts.
#include "common.cuh"

namespace {

constexpr int kBatch = 256;  // pairs staged in shared memory at a time

__global__ void raster_kernel(const uint32_t* __restrict__ pairs,
                              long long stride,
                              const int* __restrict__ starts,
                              const int* __restrict__ counts, int tiles_x,
                              int tile_size, int row_offset,
                              float pix_to_clip_x, float pix_to_clip_y,
                              int chunk, float eps, int gaussian,
                              int background, float4* __restrict__ out) {
  __shared__ float s_cx[kBatch], s_cy[kBatch], s_na[kBatch], s_nb2[kBatch],
      s_nc[kBatch], s_a[kBatch], s_r[kBatch], s_g[kBatch], s_b[kBatch];

  const int tile = blockIdx.x;
  const int pix = threadIdx.x;
  const int npix = blockDim.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + row_offset;
  const float pcx = static_cast<float>(tx * tile_size + pix % tile_size) * pix_to_clip_x - 1.0f;
  const float pcy = static_cast<float>(ty * tile_size + pix / tile_size) * pix_to_clip_y - 1.0f;

  const float center_inv = static_cast<float>(2.0 / 65535.0);
  const float rho_scale = static_cast<float>(1.0 / 127.5);
  const float inv255 = static_cast<float>(1.0 / 255.0);
  const float epan_scale = static_cast<float>(2.0 / 7.0);

  float r = 0.0f, g = 0.0f, b = 0.0f, trans = 1.0f;
  if (count > 0) {
    const int end = start + count;
    for (int c0 = (start / chunk) * chunk; c0 < end; c0 += chunk) {
      const int lo = max(c0, start);
      const int hi = min(c0 + chunk, end);
      for (int b0 = lo; b0 < hi; b0 += kBatch) {
        const int nb = min(kBatch, hi - b0);
        __syncthreads();  // the previous batch is consumed
        for (int k = pix; k < nb; k += npix) {
          const long long p = b0 + k;
          const uint32_t cxcy = pairs[p];
          const uint32_t con = pairs[stride + p];
          const uint32_t rgba = pairs[2 * stride + p];
          s_cx[k] = static_cast<float>(cxcy >> 16) * center_inv - 1.0f;
          s_cy[k] = static_cast<float>(cxcy & 0xFFFFu) * center_inv - 1.0f;
          const float ca = __uint_as_float(((con >> 20) + gsr::MF12_K) << 16);
          const float cc = __uint_as_float((((con >> 8) & 0xFFFu) + gsr::MF12_K) << 16);
          const float rho = static_cast<float>(con & 0xFFu) * rho_scale - 1.0f;
          s_na[k] = ca * -0.5f;
          s_nb2[k] = -(rho * sqrtf(ca * cc));
          s_nc[k] = cc * -0.5f;
          s_a[k] = static_cast<float>(rgba & 0xFFu) * inv255;
          s_r[k] = static_cast<float>(rgba >> 24) * inv255;
          s_g[k] = static_cast<float>((rgba >> 16) & 0xFFu) * inv255;
          s_b[k] = static_cast<float>((rgba >> 8) & 0xFFu) * inv255;
        }
        __syncthreads();
        for (int k = 0; k < nb; ++k) {
          const float dx = pcx - s_cx[k];
          const float dy = pcy - s_cy[k];
          const float m = (s_na[k] * dx + s_nb2[k] * dy) * dx + (s_nc[k] * dy) * dy;
          const float density = gaussian
                                    ? expf(fminf(m, 0.0f))
                                    : fminf(fmaxf(1.0f + m * epan_scale, 0.0f), 1.0f);
          const float alpha = s_a[k] * density;
          const float w = trans * alpha;
          r += w * s_r[k];
          g += w * s_g[k];
          b += w * s_b[k];
          trans *= 1.0f - alpha;
        }
      }
      if (!__syncthreads_or(trans > eps)) break;
    }
  }
  const float ch3 = background ? trans : (count > 0 ? 1.0f : 0.0f);
  out[static_cast<long long>(tile) * npix + pix] = make_float4(r, g, b, ch3);
}

}  // namespace

GSR_EXPORT int gsr_raster(const void* pairs, long long stride,
                          const void* starts, const void* counts,
                          int num_tiles, int tiles_x, int tile_size,
                          int row_offset, float pix_to_clip_x,
                          float pix_to_clip_y, int chunk, float eps,
                          int gaussian, int background, void* out,
                          void* stream) {
  raster_kernel<<<num_tiles, tile_size * tile_size, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(pairs), stride,
      static_cast<const int*>(starts), static_cast<const int*>(counts),
      tiles_x, tile_size, row_offset, pix_to_clip_x, pix_to_clip_y, chunk,
      eps, gaussian, background, static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
