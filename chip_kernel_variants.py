#!/usr/bin/env python3
"""Time the edges (K1), emit (K3), raster (K4), stack (K6) and compact (K7)
kernels alone on one GPU, and the design variants that were tried for them.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_kernel_variants.py              # the kernels as committed
    python3 chip_kernel_variants.py --variants   # and the variants below
    python3 chip_kernel_variants.py --kernels stack-compact [--variants]
    python3 chip_kernel_variants.py --kernels edges [--variants]

Every time is device time from a torch.profiler trace (the kernels alone,
back to back in a queue the host filled ahead), at the main path's shapes (1M splats
SH-3, 1024x1024, camera 0 of chip_smoke.py) and on the huge-splat
1024x1024 scene, and at 8x8 and 32x32 tiles of the main path's scene; with
--variants also at the tiles above 32x32 of K4_TILES.  K4 is also timed
with the early exit disabled
(transmittance_eps = -1): every sorted pair is then blended, lists are
~890 pairs deep, and the rate is the inner loop's own, free of per-tile
set-up; with that the tiles are also run heaviest first and lightest first.
K6 and K7 are timed on the banded emission's arrays (sort_bands=16, camera
0) at a fresh Renderer's capacities and uniform band rows, and at the
capacities and band rows its warm-up frames settle at, with one
torch.stack and one device-to-device copy of K6's bytes beside them.
K1 is timed on the sorted keys of camera 0's flat list and of its banded
list (sort_bands=16) at the capacities and band rows a Renderer's warm-up
frames settle at, beside its plain version and torch.bincount + cumsum.

The first part uses only the package's public wrappers, so a copy of this
file placed in a checkout of an earlier commit times that commit's kernels
(the baseline of a comparison).  A
variant is the committed source with a few lines replaced, built into a
temporary directory and called through ctypes; each is held against the
plain PyTorch version beside its time.  The replacements follow the inner
loops as committed: one whose old text is no longer in the source raises,
and is then brought up to date or dropped.
"""

import argparse
import ctypes
import statistics
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Cycles the card spins ahead of a traced run (about 20 ms), so that every
# launch is queued before the first runs and the kernels run back to back.
HEAD_START_CYCLES = 40_000_000


def _k4_pixels(px):
    """Groups of ``px`` pixels where the committed kernel takes 4."""
    return [("(px == 4 || px == 1)", f"(px == {px} || px == 1)"),
            ("  if (px == 4)\n", f"  if (px == {px})\n"),
            ("pick<4, true>", f"pick<{px}, true>"), ("pick<4, false>", f"pick<{px}, false>")]


# K4's design before thread-block clusters: a tile in one block, whose
# threads loop over the groups, their state in `out`, where a tile has more
# groups than 1,024 (a 128x128 tile), launched with one block a tile
# (k4_geometry).
K4_ONE_BLOCK = "one block a tile (before clusters)"
_K4_ONE_BLOCK = [
    ("// A larger tile: a cluster of blocks, a band of rows each.",
     "template <int kPx, bool kGaussian, bool kDevOffset>\n"
     "__global__ void __launch_bounds__(kMaxThreads) raster_looped_kernel(GSR_RASTER_ARGS) {\n"
     "  raster_tile<kPx, kGaussian, kDevOffset, false, true>(GSR_RASTER_PASS);\n"
     "}\n\n"
     "// A larger tile: a cluster of blocks, a band of rows each."),
    ("  if (!cluster)\n    return dev_offset ? raster_kernel",
     "  if (!cluster && looped)\n"
     "    return dev_offset ? raster_looped_kernel<kPx, kGaussian, true>\n"
     "                      : raster_looped_kernel<kPx, kGaussian, false>;\n"
     "  if (!cluster)\n    return dev_offset ? raster_kernel"),
    ("pick_kernel(px, gaussian, dev, cluster > 1 || looped, looped)",
     "pick_kernel(px, gaussian, dev, cluster > 1, looped)"),
    ("  if (cluster == 1 && !looped) {\n    kernel<<<", "  if (cluster == 1) {\n    kernel<<<"),
]
# The cluster's barrier in one piece, after the decode (which it then
# publishes), instead of arriving after the blend and waiting after the decode.
_K4_UNSPLIT = [
    ("      if (tid < 3) s_vote[tid] = 0;\n      cluster_arrive();\n",
     "      if (tid < 3) s_vote[tid] = 0;\n"),
    ("        __syncthreads();\n        if (waiting) {\n          cluster_wait();",
     "        if (!waiting) __syncthreads();\n"
     "        if (waiting) {\n          cluster_arrive();\n          cluster_wait();"),
    ("          cluster_arrive();\n          waiting = true;\n        }\n      }\n      b0 = next;",
     "          waiting = true;\n        }\n      }\n      b0 = next;"),
]
# Variants whose launch differs: name -> {"pixels": a group's pixels at the
# main path's 16x16 tiles; "cap": the largest cluster; "block_threads": the
# threads a cluster's block aims at (as many blocks as give each about that
# many); "rows": the rows a band aims at (at four pixels a group, or at one
# too with "one_pixel_too")}.
K4_LAUNCH = {
    "8 pixels a thread": {"pixels": 8},
    "2 pixels a thread": {"pixels": 2},
    K4_ONE_BLOCK: {"cap": 1},
    "clusters of 8 blocks at most": {"cap": 8},
    "128 threads a cluster block": {"block_threads": 128},
    "512 threads a cluster block": {"block_threads": 512},
    "256 threads a cluster block (this design's first rule)": {"block_threads": 256},
    "96 threads a cluster block": {"block_threads": 96},
    "cluster barrier unsplit, 128 threads a cluster block": {"block_threads": 128},
    "bands of 8 rows at 4 pixels a group": {"rows": 8},
    "bands of 8 rows": {"rows": 8, "one_pixel_too": True},
}
# The variants timed at the tiles above 32x32 (emit_raster's second part).
K4_TILE_VARIANTS = ("committed", K4_ONE_BLOCK, "clusters of 8 blocks at most",
                    "256 threads a cluster block (this design's first rule)",
                    "96 threads a cluster block", "128 threads a cluster block",
                    "512 threads a cluster block", "cluster barrier unsplit",
                    "cluster barrier unsplit, 128 threads a cluster block",
                    "bands of 8 rows at 4 pixels a group", "bands of 8 rows",
                    "clusters in tile order", "committed, timed again")
# (tile edge, screen edge) of those, on the main path's scene and camera 0.
K4_TILES = ((36, 1008), (40, 1000), (48, 1008), (56, 1008), (64, 1024), (80, 960), (96, 960),
            (128, 1024), (256, 1024), (30, 990), (34, 1020), (50, 1000))

# name -> [(old text, new text), ...] applied to csrc/raster.cu
K4_VARIANTS = {
    "committed": [],
    "8 pixels a thread": _k4_pixels(8),
    "2 pixels a thread": _k4_pixels(2),
    K4_ONE_BLOCK: _K4_ONE_BLOCK,
    "clusters of 8 blocks at most": [],
    "128 threads a cluster block": [],
    "512 threads a cluster block": [],
    "cluster barrier unsplit": _K4_UNSPLIT,
    "256 threads a cluster block (this design's first rule)": [],
    "96 threads a cluster block": [],
    "cluster barrier unsplit, 128 threads a cluster block": _K4_UNSPLIT,
    "bands of 8 rows at 4 pixels a group": [],
    "bands of 8 rows": [],
    "pair loop unrolled 2": [("#pragma unroll 4\n      for (int k = lo;",
                              "#pragma unroll 2\n      for (int k = lo;")],
    "pair loop not unrolled": [("#pragma unroll 4\n      for (int k = lo;",
                                "#pragma unroll 1\n      for (int k = lo;")],
    "opacity multiplied, not folded": [
        ("kGaussian ? log2f(opacity) : opacity", "opacity"),
        ("kGaussian ? fmaf(co.x * dy, dy, co.y) : (co.x * dy) * dy", "(co.x * dy) * dy"),
        ("? ex2_approx(fminf(m, co.y))", "? co.y * ex2_approx(fminf(m, 0.0f))"),
    ],
    # The clamp as a free saturation of the last multiply-add instead of a
    # min on the half-rate pipe: the conic carries -log2(e)/128, so
    # sat(m) covers exponents 0 .. -128, and one more FMA scales it back
    # and adds log2(opacity).
    "clamp by saturation": [
        ("const float fold = kGaussian ? 1.4426950408889634f : 1.0f;",
         "const float fold = kGaussian ? -1.4426950408889634f / 128.0f : 1.0f;"),
        ("kGaussian ? fmaf(co.x * dy, dy, co.y) : (co.x * dy) * dy", "(co.x * dy) * dy"),
        ("const float m = fmaf(fmaf(ge.z, dx, t1), dx, t2);",
         "const float m = kGaussian ? __saturatef(fmaf(fmaf(ge.z, dx, t1), dx, t2))\n"
         "                                    : fmaf(fmaf(ge.z, dx, t1), dx, t2);"),
        ("? ex2_approx(fminf(m, co.y))", "? ex2_approx(fmaf(m, -128.0f, co.y))"),
    ],
    # Block b of a tile of up to 32x32 pixels takes tile order[b] too, as
    # the clusters do: what starting the long lists first is worth there.
    "longest lists first": [
        ("tile_order[cluster_index()] : blockIdx.x;",
         "tile_order[cluster_index()] : tile_order[blockIdx.x];"),
    ],
    # The clusters in the order of their tiles, as this design began: a few
    # long lists left last make a tail.
    "clusters in tile order": [
        ("tile_order[cluster_index()] : blockIdx.x;",
         "static_cast<int>(cluster_index()) : blockIdx.x;"),
    ],
    # Wrong pictures, timing only: what the special-function unit costs.
    "no ex2 (timing only)": [("? ex2_approx(fminf(m, co.y))", "? fminf(m, co.y)")],
    # 2^x on the FMA pipe for the first of a thread's four pixels.
    "polynomial ex2 for 1 pixel of 4": [
        ("template <int kPx, bool kGaussian, bool kDevOffset, bool kCluster, bool kLooped>\n"
         "__device__",
         "__device__ __forceinline__ float ex2_poly(float x) {\n"
         "  x = fmaxf(x, -126.0f);\n"
         "  const float t = x + 12582912.0f;\n"
         "  const float f = x - (t - 12582912.0f);\n"
         "  float p = 1.3333558146e-3f;\n"
         "  p = fmaf(p, f, 9.6181291076e-3f);\n"
         "  p = fmaf(p, f, 5.5504108665e-2f);\n"
         "  p = fmaf(p, f, 2.4022650696e-1f);\n"
         "  p = fmaf(p, f, 6.9314718056e-1f);\n"
         "  p = fmaf(p, f, 1.0f);\n"
         "  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));\n"
         "}\n\n"
         "template <int kPx, bool kGaussian, bool kDevOffset, bool kCluster, bool kLooped>\n"
         "__device__"),
        ("? ex2_approx(fminf(m, co.y))",
         "? (p < 1 ? ex2_poly(fminf(m, co.y)) : ex2_approx(fminf(m, co.y)))"),
    ],
    # The committed kernel once more, after the others: the spread of a reading.
    "committed, timed again": [],
}

# name -> replacements applied to csrc/emit.cu
K3_VARIANTS = {
    "committed": [],
    "no occupancy hint": [("__launch_bounds__(kThreads, kBlocksPerSm)",
                           "__launch_bounds__(kThreads)")],
    "8 blocks an SM": [("constexpr int kBlocksPerSm = 6;", "constexpr int kBlocksPerSm = 8;")],
    "128 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "512 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
                            ("constexpr int kBlocksPerSm = 6;", "constexpr int kBlocksPerSm = 2;")],
}

# The aligned path of csrc/stack.cu sent through stack_kernel<float4>: K6's
# first design, a short block per 32 KB.
_K6_FIRST = [
    ("  if (vec) return launch_bulk(c, k, m, out, s);",
     "  if (vec) {\n"
     "    const dim3 grid4(gsr::blocks_for(m / 4, kThreads * kPerThread), k);\n"
     "    stack_kernel<float4><<<grid4, kThreads, 0, s>>>(c, m / 4, static_cast<float4*>(out));\n"
     "    return static_cast<int>(cudaGetLastError());\n"
     "  }"),
]
# A persistent grid of 256-thread blocks that walks 32 KB chunks through
# float4 registers, the next chunk's loads started before this chunk's stores.
_K6_WALK_KERNEL = (
    "constexpr int kWalkBlocksPerSm = 4;\n"
    "__global__ void __launch_bounds__(kThreads)\n"
    "stack_walk_kernel(StackCols cols, int k, long long m4, float4* __restrict__ out) {\n"
    "  const long long per_col = (m4 + kThreads * kPerThread - 1) / (kThreads * kPerThread);\n"
    "  const long long total = per_col * k;\n"
    "  float4 cur[kPerThread], nxt[kPerThread];\n"
    "  auto fetch = [&](long long c, float4* v) {\n"
    "    const int r = static_cast<int>(c / per_col);\n"
    "    const float4* src = reinterpret_cast<const float4*>(cols.p[r]);\n"
    "    const long long base = (c - r * per_col) * kThreads * kPerThread + threadIdx.x;\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kPerThread; ++u)\n"
    "      if (base + u * kThreads < m4) v[u] = __ldcs(src + base + u * kThreads);\n"
    "  };\n"
    "  long long c = blockIdx.x;\n"
    "  if (c >= total) return;\n"
    "  fetch(c, cur);\n"
    "  for (; c < total; c += gridDim.x) {\n"
    "    if (c + gridDim.x < total) fetch(c + gridDim.x, nxt);\n"
    "    const int r = static_cast<int>(c / per_col);\n"
    "    const long long base = (c - r * per_col) * kThreads * kPerThread + threadIdx.x;\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kPerThread; ++u)\n"
    "      if (base + u * kThreads < m4) __stcs(out + r * m4 + base + u * kThreads, cur[u]);\n"
    "#pragma unroll\n"
    "    for (int u = 0; u < kPerThread; ++u) cur[u] = nxt[u];\n"
    "  }\n"
    "}\n\n"
    "bool aligned16(const void* p) {"
)
_K6_WALK = [
    ("bool aligned16(const void* p) {", _K6_WALK_KERNEL),
    ("  if (vec) return launch_bulk(c, k, m, out, s);",
     "  if (vec) {\n"
     "    int sms = 0;\n"
     "    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);\n"
     "    stack_walk_kernel<<<sms * kWalkBlocksPerSm, kThreads, 0, s>>>(\n"
     "        c, k, m / 4, static_cast<float4*>(out));\n"
     "    return static_cast<int>(cudaGetLastError());\n"
     "  }"),
]

# The evict-first L2 policy as the 64-bit word that createpolicy makes for a
# fraction of 1.0; the hint is one more operand of the bulk copy.
_EVICT_FIRST = "0x12F0000000000000ULL"
_K6_NO_LOAD_HINT = [
    ("complete_tx::bytes.L2::cache_hint \"\n"
     "      \"[%0], [%1], %2, [%3], %4;\\n\" ::\"r\"(dst), \"l\"(src), \"r\"(bytes), \"r\"(bar), "
     "\"l\"(policy)",
     "complete_tx::bytes \"\n"
     "      \"[%0], [%1], %2, [%3];\\n\" ::\"r\"(dst), \"l\"(src), \"r\"(bytes), \"r\"(bar)"),
]
_K6_STORE_HINT = [
    ("bulk_group [%0], [%1], %2;\\n\" ::\"l\"(dst),\n"
     "               \"r\"(src), \"r\"(bytes)",
     "bulk_group.L2::cache_hint [%0], [%1], %2, %3;\\n\" ::\"l\"(dst),\n"
     "               \"r\"(src), \"r\"(bytes), \"l\"(" + _EVICT_FIRST + ")"),
]
# chunk_of learns the column count, for another order of the chunks.
_K6_CHUNK_K = [
    ("long long chunks_per_col, long long i) {", "long long chunks_per_col, long long i, int k) {"),
    ("chunk_of(cols, out, col_bytes, chunks_per_col, i);",
     "chunk_of(cols, out, col_bytes, chunks_per_col, i, k);"),
    ("chunk_of(cols, out, col_bytes, chunks_per_col, j);",
     "chunk_of(cols, out, col_bytes, chunks_per_col, j, k);"),
]


# The committed launch: the scan, with 16-byte loads where it can.
_K1_LAUNCH = "  if (n % 4 == 0 && reinterpret_cast<uintptr_t>(keys) % 16 == 0)"
_K1_END = "}  // namespace\n"


def _k1_instead(kernel, launch, cond="true"):
    """Add ``kernel`` to csrc/edges.cu and launch it in place of the scan
    where ``cond`` holds."""
    return [(_K1_END, kernel + "\n" + _K1_END),
            (_K1_LAUNCH, f"  if ({cond})\n    {launch};\n  else " + _K1_LAUNCH[2:])]


# K1's first design, a thread a key.
_K1_FIRST = _k1_instead(
    "__global__ void first_kernel(const uint32_t* __restrict__ keys, long long n, int shift,\n"
    "                             int num_probes, int* __restrict__ edges) {\n"
    "  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;\n"
    "  if (i > n) return;\n"
    "  keys += blockIdx.y * n;\n"
    "  edges += blockIdx.y * static_cast<long long>(num_probes);\n"
    "  const uint32_t last = static_cast<uint32_t>(num_probes - 1);\n"
    "  uint32_t lo = 0;\n"
    "  uint32_t hi = last;\n"
    "  if (i > 0) lo = min(keys[i - 1] >> shift, last) + 1u;\n"
    "  if (i < n) hi = min(keys[i] >> shift, last);\n"
    "  for (uint32_t t = lo; t <= hi; ++t) edges[t] = static_cast<int>(i);\n"
    "}\n",
    "first_kernel<<<dim3(gsr::blocks_for(n + 1, kThreads), segments), kThreads, 0, s>>>(\n"
    "        a.keys, n, shift, num_probes, a.edges)")
# The search: the warp of probe t of segment s finds edges[s, t], the first
# position of bin >= t, by 32 probes of the keys a round (five dependent
# 128-byte reads at 3.9M keys).
_K1_SEARCH_KERNEL = (
    "__global__ void __launch_bounds__(kThreads) search_kernel(EdgesArgs a) {\n"
    "  const int lane = threadIdx.x & 31;\n"
    "  const long long w = (blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x) >> 5;\n"
    "  if (w >= a.num_probes * (a.tiles / a.tiles_per_segment)) return;  // a whole warp\n"
    "  const long long s = w / a.num_probes;\n"
    "  const int t = static_cast<int>(w - s * a.num_probes);\n"
    "  const uint32_t* __restrict__ keys = a.keys + s * a.n;\n"
    "  long long lo = 0, hi = a.n;\n"
    "  while (lo < hi) {\n"
    "    const long long step = (hi - lo + 31) / 32;\n"
    "    const long long q = lo + (lane + 1) * step - 1;\n"
    "    const bool below = q < hi && bin_of(keys[q], a) < t;\n"
    "    lo += __popc(__ballot_sync(kFull, below)) * step;\n"
    "    hi = min(hi, lo + step - 1);\n"
    "  }\n"
    "  if (lane == 0) a.edges[s * a.num_probes + t] = static_cast<int>(lo);\n"
    "}\n")


def _k1_search(threads=256, cond="true"):
    return _k1_instead(
        _K1_SEARCH_KERNEL,
        f"search_kernel<<<gsr::blocks_for(num_probes * static_cast<long long>(segments), "
        f"{threads // 32}), {threads}, 0, s>>>(a)", cond)


# (b): the head run [0, bin(key 0)] and the tail run past the last live bin
# of every segment are written by one extra block a segment, at the end of
# the scan's grid; it finds the first key of the last bin by a 256-ary
# search.
_K1_ENDS_BLOCK = (
    "__device__ void ends_block(const EdgesArgs& a, long long s) {\n"
    "  const uint32_t* keys = a.keys + s * a.n;\n"
    "  int* edges = a.edges + s * a.num_probes;\n"
    "  long long lo = 0, hi = a.n;  // the first position of the last bin lies in [lo, hi]\n"
    "  while (lo < hi) {\n"
    "    const long long step = (hi - lo + kThreads - 1) / kThreads;\n"
    "    const long long q = lo + (threadIdx.x + 1) * step - 1;\n"
    "    const int c = __syncthreads_count(q < hi && bin_of(keys[q], a) < a.last);\n"
    "    lo += c * step;\n"
    "    hi = min(hi, lo + step - 1);\n"
    "  }\n"
    "  const int b0 = a.n > 0 ? bin_of(keys[0], a) : a.last;\n"
    "  for (int t = threadIdx.x; t <= b0; t += kThreads) edges[t] = 0;\n"
    "  if (lo > 0)\n"
    "    for (int t = bin_of(keys[lo - 1], a) + 1 + threadIdx.x; t <= a.last; t += kThreads)\n"
    "      edges[t] = static_cast<int>(lo);\n"
    "}\n\n"
    "template <bool kVec>\n__global__")
_K1_GRID = "  const unsigned grid = static_cast<unsigned>(a.tiles < fill ? a.tiles : fill);"
_K1_ENDS = [
    ("template <bool kVec>\n__global__", _K1_ENDS_BLOCK),
    ("  for (long long b = blockIdx.x; b < a.tiles; b += gridDim.x) {",
     "  const unsigned main_blocks = gridDim.x - a.tiles / a.tiles_per_segment;\n"
     "  if (blockIdx.x >= main_blocks) {\n"
     "    ends_block(a, blockIdx.x - main_blocks);\n"
     "    return;\n"
     "  }\n"
     "  for (long long b = blockIdx.x; b < a.tiles; b += main_blocks) {"),
    ("        write_run(edges, prev + 1, bins[v][j], static_cast<int>(p0 + j), lane);",
     "        const bool end = p0 + j == 0 || (bins[v][j] == a.last && prev < a.last);\n"
     "        write_run(edges, prev + 1, end ? prev : bins[v][j], static_cast<int>(p0 + j), lane);"),
    (_K1_GRID, _K1_GRID[:-1] + " + segments;"),
]

# name -> replacements applied to csrc/edges.cu
K1_VARIANTS = {
    "committed": [],
    "first design: a thread a key": _K1_FIRST,
    "scan, (b) head and tail runs by a block a segment": _K1_ENDS,
    "scan, streaming loads": [
        ("*reinterpret_cast<const uint4*>(keys + p0)", "__ldcs(reinterpret_cast<const uint4*>(keys + p0))"),
        ("bin_of(keys[p0 + j], a)", "bin_of(__ldcs(keys + p0 + j), a)")],
    "scan, 4 keys a thread": [("constexpr int kVecs = 2;", "constexpr int kVecs = 1;")],
    "scan, 16 keys a thread": [("constexpr int kVecs = 2;", "constexpr int kVecs = 4;")],
    "scan, 4 blocks an SM": [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 4;")],
    "scan, 16 blocks an SM": [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 16;")],
    "scan, a block a tile": [(_K1_GRID, "  const unsigned grid = static_cast<unsigned>(a.tiles);")],
    "scan, warp writes runs from 8 probes": [("constexpr int kLongRun = 32;", "constexpr int kLongRun = 8;")],
    "scan, warp writes runs from 128 probes": [("constexpr int kLongRun = 32;",
                                                "constexpr int kLongRun = 128;")],
    "search everywhere": _k1_search(),
    "search, 128 threads a block": _k1_search(128),
    "search where its warps fit in one wave (132 SMs x 64), scan elsewhere": _k1_search(
        cond="num_probes * static_cast<long long>(segments) <= sms * 64"),
}


def _ring(stages, kib, blocks):
    """The committed ring (4 stages of 16 KB, 3 blocks an SM) with other numbers."""
    repl = [("constexpr int kStages = 4;", f"constexpr int kStages = {stages};"),
            ("constexpr int kStageBytes = 16 * 1024;", f"constexpr int kStageBytes = {kib} * 1024;"),
            ("constexpr int kBlocksPerSm = 3;", f"constexpr int kBlocksPerSm = {blocks};")]
    return [(old, new) for old, new in repl if old != new]


# name -> replacements applied to csrc/stack.cu
K6_VARIANTS = {
    "committed": [],
    "first design: float4 registers, a short block per 32 KB": _K6_FIRST,
    "first design with __ldcs/__stcs": _K6_FIRST + [
        ("if (c < m) v[u] = src[c];", "if (c < m) v[u] = __ldcs(src + c);"),
        ("if (c < m) dst[c] = v[u];", "if (c < m) __stcs(dst + c, v[u]);"),
    ],
    "persistent float4 walk, 4 blocks an SM": _K6_WALK,
    "persistent float4 walk, 8 blocks an SM": _K6_WALK + [
        ("constexpr int kWalkBlocksPerSm = 4;", "constexpr int kWalkBlocksPerSm = 8;")],
    "ring 2 x 32 KB, 1 block an SM": _ring(2, 32, 1),
    "ring 3 x 32 KB, 1 block an SM": _ring(3, 32, 1),
    "ring 3 x 32 KB, 2 blocks an SM": _ring(3, 32, 2),
    "ring 6 x 32 KB, 1 block an SM": _ring(6, 32, 1),
    "ring 2 x 16 KB, 4 blocks an SM": _ring(2, 16, 4),
    "ring 3 x 16 KB, 4 blocks an SM": _ring(3, 16, 4),
    "ring 4 x 16 KB, 2 blocks an SM": _ring(4, 16, 2),
    "ring 4 x 32 KB, 1 block an SM": _ring(4, 32, 1),
    "ring 3 x 64 KB, 1 block an SM": _ring(3, 64, 1),
    # Chunks a little under a stage, cut so that every block takes the same
    # number; they no longer start on 128-byte lines.
    "ring, chunks cut evenly among the blocks": [
        ("  const long long chunks_per_col = (col_bytes + kStageBytes - 1) / kStageBytes;",
         "  long long n_even = (col_bytes + kStageBytes - 1) / kStageBytes;\n"
         "  while (n_even * k % gridDim.x) ++n_even;\n"
         "  const long long chunk_even = ((col_bytes + n_even - 1) / n_even + 15) / 16 * 16;\n"
         "  const long long chunks_per_col = (col_bytes + chunk_even - 1) / chunk_even;"),
        ("  const long long off = (c - r * chunks_per_col) * kStageBytes;",
         "  const long long chunk_even = (col_bytes / chunks_per_col + 15) / 16 * 16;\n"
         "  const long long off = (c - r * chunks_per_col) * chunk_even;"),
        ("static_cast<uint32_t>(left < kStageBytes ? left : kStageBytes)};",
         "static_cast<uint32_t>(left < chunk_even ? left : chunk_even)};"),
    ],
    "ring, the last wait for the stores' writes, not their reads": [
        ("cp.async.bulk.wait_group.read 0;", "cp.async.bulk.wait_group 0;")],
    "ring, loads without the L2 hint": _K6_NO_LOAD_HINT,
    "ring, stores evict-first in L2 too": _K6_STORE_HINT,
    # Neighbouring chunks alternate between the columns instead of the grid
    # working through one column after the other.
    "ring, chunks interleave the columns": _K6_CHUNK_K + [
        ("  const int r = static_cast<int>(c / chunks_per_col);\n"
         "  const long long off = (c - r * chunks_per_col) * kStageBytes;",
         "  const int r = static_cast<int>(c % k);\n"
         "  const long long off = (c / k) * kStageBytes;")],
    # A block takes one run of neighbouring chunks instead of every grid-th.
    "ring, a run of neighbouring chunks a block": _K6_CHUNK_K + [
        ("  const long long c = blockIdx.x + i * gridDim.x;",
         "  const long long c = blockIdx.x * ((chunks_per_col * k + gridDim.x - 1) / gridDim.x) + i;"),
        ("  const long long mine = (total - blockIdx.x + gridDim.x - 1) / gridDim.x;",
         "  const long long run = (total + gridDim.x - 1) / gridDim.x;\n"
         "  const long long left = total - blockIdx.x * run;\n"
         "  const long long mine = left < run ? left : run;")],
}

_K7_PLAIN_FILL = [
    ("store_fill(float4* p, float4 v) { __stcs(p, v); }", "store_fill(float4* p, float4 v) { *p = v; }"),
    ("store_fill(float* p, float v) { __stcs(p, v); }", "store_fill(float* p, float v) { *p = v; }"),
]
# name -> replacements applied to csrc/compact.cu
K7_VARIANTS = {
    "committed": [],
    "tile of 2048 columns": [("constexpr int kSlabs = 4;", "constexpr int kSlabs = 2;")],
    "tile of 1024 columns": [("constexpr int kSlabs = 4;", "constexpr int kSlabs = 1;")],
    "128 threads, tile of 2048": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "512 threads, tile of 8192": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;")],
    "fill with plain stores": _K7_PLAIN_FILL,
    "streaming stores in the scatter too": [
        ("      dst[0] = s_excl[t];\n      dst[cc] = s_incl[t];",
         "      __stcs(dst, s_excl[t]);\n      __stcs(dst + cc, s_incl[t]);"),
        ("for (int r = 2; r < kRows; ++r) dst[r * cc] = v[r - 2];",
         "for (int r = 2; r < kRows; ++r) __stcs(dst + r * cc, v[r - 2]);"),
    ],
    "band-major block order": [
        ("scatter_tile<kVec>(a, static_cast<int>(b % a.n_bands), b / a.n_bands);",
         "scatter_tile<kVec>(a, static_cast<int>(b / a.n_tiles), b % a.n_tiles);")],
    "fill blocks first": [
        ("  const long long b = blockIdx.x;\n  const long long n_scatter = a.n_tiles * a.n_bands;",
         "  const long long n_scatter = a.n_tiles * a.n_bands;\n"
         "  const long long b = (blockIdx.x + n_scatter) % (n_scatter + a.fill_chunks * a.n_bands);")],
    "fill 1024 slots a block": [("constexpr int kFillSlots = 2048;", "constexpr int kFillSlots = 1024;")],
    "fill 8192 slots a block": [("constexpr int kFillSlots = 2048;", "constexpr int kFillSlots = 8192;")],
    # Every scatter block also fills its share of the band's free slots
    # before it looks at its prefixes; no block has the fill role.
    "fill fused into the scatter blocks": [
        ("    scatter_tile<kVec>(a, static_cast<int>(b % a.n_bands), b / a.n_bands);\n",
         "    {\n"
         "      const int g = static_cast<int>(b % a.n_bands);\n"
         "      const long long tile = b / a.n_bands;\n"
         "      long long kept_g = static_cast<long long>(a.pfx[g * a.np + a.np - 1]) - g * a.mc;\n"
         "      kept_g = kept_g < 0 ? 0 : (kept_g > a.mc ? a.mc : kept_g);\n"
         "      const long long lo = kept_g + (a.mc - kept_g) * tile / a.n_tiles;\n"
         "      const long long hi = kept_g + (a.mc - kept_g) * (tile + 1) / a.n_tiles;\n"
         "      if (lo < hi)\n"
         "        fill_slots(a.out, a.mc * a.n_bands, g * a.mc + lo, g * a.mc + hi,\n"
         "                   static_cast<float>(a.pair_end[g]));\n"
         "    }\n"
         "    scatter_tile<kVec>(a, static_cast<int>(b % a.n_bands), b / a.n_bands);\n"),
        ("  a.fill_chunks = (mc + kFillSlots - 1) / kFillSlots;", "  a.fill_chunks = 0;"),
    ],
    # A thread per (row, slot) instead of a thread per slot with 16 rows.
    "stores spread over (row, slot)": [
        ("    for (int t = threadIdx.x; t < count; t += kThreads) {\n"
         "      const long long slot = s0 + base + t;\n"
         "      if (slot < 0 || slot >= cc) continue;\n",
         "    for (int e = threadIdx.x; e < count * kRows; e += kThreads) {\n"
         "      const int r = e / count, t = e - r * count;\n"
         "      const long long slot = s0 + base + t;\n"
         "      if (slot < 0 || slot >= cc) continue;\n"
         "      a.out[r * cc + slot] = r == 0 ? s_excl[t] : r == 1 ? s_incl[t]\n"
         "          : __ldg(a.full + r * a.np + col0 + s_col[t]);\n"
         "      continue;\n"),
    ],
}


def build_variant(scratch, source, tag, replacements, symbol, argtypes):
    """csrc/<source>.cu with ``replacements`` applied, built into directory
    ``scratch`` with the committed flags: (the C function ``symbol`` with
    ``argtypes``, the registers ptxas reports a kernel, ptxas's lines)."""
    from cudagaussianrenderer_torch.utils import cuda_build as cb

    text = (cb.CSRC / f"{source}.cu").read_text()
    for old, new in replacements:
        if old not in text:
            raise RuntimeError(f"variant {tag!r}: {old!r} is not in csrc/{source}.cu")
        text = text.replace(old, new)
    src = Path(scratch) / f"{source}_{len(list(Path(scratch).iterdir()))}.cu"
    src.write_text(text)
    lib = src.with_suffix(".so")
    proc = subprocess.run(
        [cb.nvcc_path(), *cb.flags(source), f"-I{cb.CSRC}", "-o", str(lib), str(src)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"variant {tag!r} does not build:\n{proc.stdout}{proc.stderr}")
    lines = (proc.stdout + proc.stderr).splitlines()
    regs = [line.split("Used ")[1].split(" registers")[0] for line in lines if "registers" in line]
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn, regs, [line.strip() for line in lines if "ptxas info" in line or "spill" in line]


def k4_geometry(tag, tile_size, cap):
    """The launch geometry (ops/raster.py:RasterGeometry) K4 variant ``tag``
    takes at ``tile_size``, on a card whose largest cluster is ``cap``."""
    from cudagaussianrenderer_torch.ops.raster import MAX_THREADS, RasterGeometry, raster_geometry

    launch = K4_LAUNCH.get(tag, {})
    if "pixels" in launch:
        px = launch["pixels"] if tile_size % launch["pixels"] == 0 else 1
        return RasterGeometry(px, 1, tile_size, tile_size * tile_size // px)
    px = 4 if tile_size % 4 == 0 else 1
    per_row = tile_size // px
    if tile_size * tile_size <= MAX_THREADS or not ({"rows", "block_threads"} & set(launch)):
        return raster_geometry(tile_size, min(cap, launch.get("cap", cap)))
    if "rows" in launch and (px == 4 or launch.get("one_pixel_too")):
        cluster = -(-tile_size // launch["rows"])
    else:  # as many blocks as give each about block_threads threads
        cluster = -(-tile_size * per_row // launch.get("block_threads", 256))
    cluster = min(cap, max(2, cluster))
    band_rows = -(-tile_size // cluster)
    groups = band_rows * per_row
    turns = -(-groups // MAX_THREADS)
    return RasterGeometry(px, -(-tile_size // band_rows), band_rows, -(-groups // turns))


def k4_call(fn, pair_data, starts, counts, cfg, geometry, out, eps=None):
    """A K4 launch of library function ``fn`` (gsr_raster) with ``geometry``,
    the tiles longest list first where a variant reads the order."""
    import torch

    order = torch.argsort(counts, descending=True).to(torch.int32)

    def call():
        code = fn(pair_data.data_ptr(), pair_data.shape[1], starts.data_ptr(), counts.data_ptr(),
                  order.data_ptr(), cfg.total_tiles, cfg.tiles_x, cfg.tile_size, 0, None,
                  2.0 / cfg.screen_w, 2.0 / cfg.screen_h, cfg.raster_chunk, cfg.transmittance_eps if eps is None else eps,
                  int(cfg.falloff == "gaussian"), int(cfg.background is not None), *geometry,
                  out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")
    return call


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the design variants")
    parser.add_argument("--kernels", choices=("all", "emit-raster", "stack-compact", "edges"),
                        default="all", help="which kernels to time (default: all five)")
    parser.add_argument("--match", default="",
                        help="of the variants, only 'committed' and those whose name holds "
                             "this (or one of several texts separated by '|')")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_variants: no CUDA device", file=sys.stderr)
        return 1

    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.utils import cuda_build as cb

    dev = torch.device("cuda")
    print(ROOT, flush=True)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    def device_ms(call, reps=30, apart=False):
        """Traced time of one call's kernels, from ``reps`` calls: back
        to back behind a head start that lets the host queue them all or,
        with ``apart``, each synchronised before the next starts.  Summed
        here and not by chip_smoke.py, so that a copy of this file in an
        older checkout measures in the same way."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        call()
        torch.cuda.synchronize()
        # A trace may come back without one device record: trace again.
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                if not apart:
                    torch.cuda._sleep(HEAD_START_CYCLES)
                for _ in range(reps):
                    call()  # results are dropped: no allocation grows while the trace runs
                    if apart:
                        torch.cuda.synchronize()
                torch.cuda.synchronize()
            # A trace may hold fewer records of a kernel than it was launched,
            # and single records that are too short: each kernel's median
            # record, times its launches a call.
            records = {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key:
                    records.setdefault(e.key, []).append(e.self_device_time_total)
            us = 0.0
            for key, times in records.items():
                per_call = max(1, round(len(times) / reps))
                if len(times) < 0.9 * reps * per_call:
                    print(f"    (the trace holds {len(times)} records of {key[:40]} "
                          f"for {reps} calls)", flush=True)
                us += statistics.median(times) * per_call
            if us > 0:
                return us / 1e3
            print("    (a trace held no device time: traced again)", flush=True)
        raise RuntimeError("three profiler traces held no device time")

    # Removed at the end, or by its finalizer when a variant raises.
    tmp = tempfile.TemporaryDirectory(prefix="gsr_variants_")
    scratch = Path(tmp.name)

    def build(source, tag, replacements, symbol, argtypes):
        fn, regs, _ = build_variant(scratch, source, tag, replacements, symbol, argtypes)
        return fn, regs

    cfg = RenderConfig()
    raw_scene = random_scene(1_000_000, seed=0, min_scale=0.002, max_scale=0.053,
                             extent=4.0, sh_degree=3, device=dev)
    scene = Renderer(raw_scene, cfg).scene
    cam0 = orbit_cameras(scene.bounds_min, scene.bounds_max, 8)[0]
    def chosen(variants):
        return {tag: repl for tag, repl in variants.items()
                if tag == "committed" or any(m in tag for m in args.match.split("|"))}

    tools = dict(torch=torch, dev=dev, cb=cb, device_ms=device_ms, build=build,
                 variants=args.variants, chosen=chosen)
    if args.kernels in ("all", "emit-raster"):
        emit_raster(tools, scene, cam0, cfg)
    if args.kernels in ("all", "stack-compact"):
        stack_compact(tools, raw_scene, scene, cam0)
    if args.kernels in ("all", "edges"):
        edges(tools, raw_scene, scene, cam0)
    tmp.cleanup()
    return 0


def k4_tile_case(scene, cam, cfg):
    """K4's inputs for ``cfg`` on ``scene`` from camera ``cam`` (a Camera), at
    the capacity a Renderer would bucket the candidates into."""
    import torch

    from cudagaussianrenderer_torch import Renderer
    from cudagaussianrenderer_torch.ops import raster
    from cudagaussianrenderer_torch.ops.binning import emit_columns
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import (
        _frame_pairs, camera_tensors, round_capacity,
    )

    c = camera_tensors(cam.camera_data(), scene.means.device)
    clip = project_splats(scene.means, scene.scales, scene.quats, c, cfg, opacities=scene.opacities)
    _, incl = emit_columns(clip, splat_colors(scene, c), scene.opacities, cfg)
    total = int(incl[-1])
    cap = round_capacity(Renderer._bucket(total), scene.means.device)
    _, attrs, starts, counts = _frame_pairs(scene, c, cfg, cap)
    torch.cuda.synchronize()
    return dict(cfg=cfg, pairs=min(total, cap), starts=starts, counts=counts,
                pair_data=raster.pack_pair_data(attrs, cfg.raster_chunk))


def emit_raster(tools, scene, cam0, cfg):
    """K3 and K4 through their wrappers and, with --variants, their variants."""
    torch, dev, cb = tools["torch"], tools["dev"], tools["cb"]
    device_ms, build = tools["device_ms"], tools["build"]
    from cudagaussianrenderer_torch import RenderConfig, Renderer, random_scene
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.ops import expand, raster
    from cudagaussianrenderer_torch.ops.binning import emit_columns
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import (
        _frame_pairs, camera_tensors, round_capacity,
    )

    def setup(scene_, cam, cfg_, cap=None):
        c = camera_tensors(cam.camera_data(), dev)
        clip = project_splats(scene_.means, scene_.scales, scene_.quats, c, cfg_,
                              opacities=scene_.opacities)
        cols, incl = emit_columns(clip, splat_colors(scene_, c), scene_.opacities, cfg_)
        if cap is None:  # as Renderer buckets the candidates
            cap = round_capacity(Renderer._bucket(int(incl[-1])), dev)
        rows = expand.interleave_rows(incl, tuple(x.contiguous() for x in cols), cap + 1)
        _, attrs, starts, counts = _frame_pairs(scene_, c, cfg_, cap)
        return dict(cfg=cfg_, cap=cap, rows=rows, starts=starts.contiguous(),
                    counts=counts.contiguous(),
                    pair_data=raster.pack_pair_data(attrs, cfg_.raster_chunk))

    hcfg = RenderConfig(screen_size=1024)
    hscene = random_scene(192, seed=9, min_scale=0.3, max_scale=1.6, extent=3.0,
                          device=dev).pad_to_multiple(256)
    cases = {
        "main path": setup(scene, cam0, cfg, 3932160),
        "huge splats": setup(hscene, Camera(aspect=1.0).framed(hscene.bounds_min,
                                                                hscene.bounds_max),
                             hcfg, 524288),
        "8x8 tiles": setup(scene, cam0, RenderConfig(tile_size=8)),
        "32x32 tiles": setup(scene, cam0, RenderConfig(tile_size=32)),
    }

    print("== K3, K4 of this checkout, through their wrappers (device ms)")
    for name, c in cases.items():
        for _ in range(2):
            k3 = device_ms(lambda: expand.emit_slots(c["rows"], c["cap"], c["cfg"]))
            k4 = device_ms(lambda: raster.rasterize_tiles(
                c["pair_data"], c["starts"], c["counts"], c["cfg"]))
            print(f"  {name}: K3 emit {k3:.4f}, K4 raster {k4:.4f}", flush=True)
    if not tools["variants"]:
        return

    for c in cases.values():
        blended = torch.zeros(1, dtype=torch.int32, device=c["pair_data"].device)
        c["tiles"] = raster._raster_torch(c["pair_data"], c["starts"], c["counts"], c["cfg"],
                                          c["cfg"].total_tiles, 0, blended)
        c["evals"] = int(blended) * c["cfg"].pixels_per_tile
        c["words"] = expand._emit_torch(c["rows"], c["cap"], c["cfg"])

    def raster_call(fn, c, out, tag, eps=None, order=None):
        starts, counts = c["starts"], c["counts"]
        if order is not None:
            starts, counts = starts[order].contiguous(), counts[order].contiguous()
        geometry = k4_geometry(tag, c["cfg"].tile_size, cap)
        return k4_call(fn, c["pair_data"], starts, counts, c["cfg"], geometry, out, eps)

    print("== K4 variants (device ms; 'no exit' blends every sorted pair)")
    cap = raster.max_cluster(torch.cuda.current_device())
    m = cases["main path"]
    all_evals = int(m["counts"].sum()) * m["cfg"].pixels_per_tile
    heavy = torch.argsort(m["counts"], descending=True)
    libs = {}
    for tag, repl in tools["chosen"](K4_VARIANTS).items():
        fn, regs = libs[tag] = build("raster", tag, repl, "gsr_raster", raster.RASTER_ARGTYPES)
        line = f"  {tag}: registers {'/'.join(regs)}"
        for name, c in cases.items():
            out = torch.empty_like(c["tiles"])
            ms = device_ms(raster_call(fn, c, out, tag))
            err = float((out - c["tiles"]).abs().max())
            line += (f"; {name} {ms:.4f} ({c['evals'] / ms / 1e9:.3f} G evaluations/ms, "
                     f"max err {err:.1e})")
        out = torch.empty_like(m["tiles"])
        no_exit = device_ms(raster_call(fn, m, out, tag, eps=-1.0), 10)
        first = device_ms(raster_call(fn, m, out, tag, eps=-1.0, order=heavy), 10)
        last = device_ms(raster_call(fn, m, out, tag, eps=-1.0, order=heavy.flip(0)), 10)
        line += (f"; no exit {no_exit:.4f} ({all_evals / no_exit / 1e9:.3f} G evaluations/ms), "
                 f"heaviest tiles first {first:.4f}, lightest first {last:.4f}")
        print(line, flush=True)

    def event_ms(call, reps=20):
        """Mean ms of ``reps`` back-to-back calls between CUDA events: the
        kernels' own time where each runs far longer than its launch."""
        call()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    print(f"== K4 variants at tiles above 32x32 (device ms from a trace, and between events; "
          f"largest cluster {cap}; each against its plain version in output levels)")
    for ts, size in K4_TILES:
        cfg_t = RenderConfig(screen_size=size, tile_size=ts)
        c = k4_tile_case(scene, cam0, cfg_t)
        blended = torch.zeros(1, dtype=torch.int32, device=c["pair_data"].device)
        plain = raster._raster_torch(c["pair_data"], c["starts"], c["counts"], cfg_t,
                                     cfg_t.total_tiles, 0, blended)
        line = (f"  {ts}x{ts} at {size}x{size}, {cfg_t.total_tiles} tiles, "
                f"{int(blended) * cfg_t.pixels_per_tile} evaluations:")
        for tag in K4_TILE_VARIANTS:
            if tag not in libs:
                continue
            out = torch.empty_like(plain)
            call = raster_call(libs[tag][0], c, out, tag)
            call()
            lsb = int((raster.tiles_to_image(out, cfg_t).int()
                       - raster.tiles_to_image(plain, cfg_t).int()).abs().max())
            geometry = k4_geometry(tag, ts, cap)
            line += (f" {tag} {device_ms(call, 10):.4f}, events {event_ms(call):.4f} ({lsb} LSB, "
                     f"cluster {geometry.cluster}, {geometry.threads} threads);")
        if "committed" in libs:  # every listed pair blended: the inner loop's own rate
            out = torch.empty_like(plain)
            no_exit = device_ms(raster_call(libs["committed"][0], c, out, "committed", eps=-1.0), 5)
            evals = int(c["counts"].sum()) * cfg_t.pixels_per_tile
            exit_evals = int(blended) * cfg_t.pixels_per_tile
            line += (f" committed with no exit {no_exit:.4f} ({evals / no_exit / 1e9:.3f} G "
                     f"evaluations/ms against {exit_evals / 1e9:.3f} G in the exit's time);")
        print(line, flush=True)

    print("== K3 variants (device ms)")
    k3_args = [cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32] + [cb.P] * 7
    for tag, repl in tools["chosen"](K3_VARIANTS).items():
        fn, regs = build("emit", tag, repl, "gsr_emit", k3_args)
        line = f"  {tag}: registers {regs[-1]}"
        for name, c in cases.items():
            outs = [torch.empty(c["cap"], dtype=torch.int32, device=dev) for _ in range(6)]

            def call():
                code = fn(c["rows"].data_ptr(), c["rows"].shape[1], c["cap"],
                          expand.emit_block(c["cap"]), 1, c["cfg"].tiles_x,
                          c["cfg"].sentinel_tile, *[o.data_ptr() for o in outs],
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            ms = device_ms(call)
            equal = all(torch.equal(a, b) for a, b in zip(outs, c["words"]))
            line += f"; {name} {ms:.4f} (six words equal: {equal})"
        print(line, flush=True)


def stack_compact(tools, raw_scene, scene, cam0):
    """K6 and K7 through their wrappers and, with --variants, their variants,
    on the banded emission's arrays at the fresh and the settled shapes."""
    torch, dev, cb = tools["torch"], tools["dev"], tools["cb"]
    device_ms, build = tools["device_ms"], tools["build"]
    from cudagaussianrenderer_torch import RenderConfig, Renderer
    from cudagaussianrenderer_torch.ops import banded
    from cudagaussianrenderer_torch.ops.binning import (
        emit_columns, splat_row_packs, splat_tile_rects,
    )
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import _band_rows_tensor, camera_tensors

    G = 16
    bcfg = RenderConfig(sort_bands=G)
    cam = camera_tensors(cam0.camera_data(), dev)
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, bcfg,
                          opacities=scene.opacities)
    cols, _ = emit_columns(clip, splat_colors(scene, cam), scene.opacities, bcfg)
    cols = tuple(c.contiguous() for c in cols)
    rects = splat_tile_rects(clip, bcfg)
    packs = splat_row_packs(clip, rects, bcfg)

    def inputs(rows, cap, ccap):
        """The arrays K6 and K7 read in one banded emission."""
        counts = banded.band_counts(rects, packs, rows)
        n = counts.shape[1]
        pre = banded.band_prefixes(counts, cap // G, ccap // G)
        np_ = banded.padded_width(n)
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        k6_in = banded.band_prefix_columns(pre, np_)
        full = banded.interleave_rows_padded((zeros, zeros) + cols, np_)
        pfx = banded.stack_rows(k6_in)
        kept = int((pfx[1] != pfx[2]).sum())
        return dict(k6_in=k6_in, full=full, pfx=pfx, pair_end=pre.pair_end, ccap=ccap, np=np_,
                    kept=kept, rows=rows.tolist(),
                    k6_bytes=2 * 4 * len(k6_in) * G * np_,
                    k7_bytes=4 * 2 * G * np_ + 4 * kept + 4 * 14 * kept + 4 * 16 * ccap)

    r = Renderer(raw_scene, bcfg)
    cases = {"fresh": inputs(_band_rows_tensor(None, bcfg, dev), r.capacity, r.compact_capacity)}
    for _ in range(3):  # as chip_smoke.py phase 7 settles them
        before = (r.capacity, r.compact_capacity)
        r.render(cam0)
        if (r.capacity, r.compact_capacity) == before:
            break
    cases["settled"] = inputs(_band_rows_tensor(r.band_rows, bcfg, dev), r.capacity,
                              r.compact_capacity)
    del r
    hbm = 3.35e12  # H100 SXM data sheet, bytes a second

    def event_ms(call, reps=20):
        call()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(reps):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    print("== K6, K7 of this checkout, through their wrappers (device ms; bound by bytes)")
    for name, c in cases.items():
        print(f"  {name}: NP {c['np']}, compact capacity {c['ccap']}, {c['kept']} kept columns, "
              f"band rows {c['rows']}", flush=True)
        dst = torch.empty_like(c["pfx"])
        src = torch.stack(c["k6_in"])
        for _ in range(2):
            k6 = device_ms(lambda: banded.stack_rows(c["k6_in"]))
            lib = device_ms(lambda: torch.stack(c["k6_in"]))
            copy = device_ms(lambda: dst.copy_(src))
            k7 = device_ms(lambda: banded.compact_rows(c["full"], c["pfx"], c["pair_end"],
                                                       c["ccap"]))
            print(f"  {name}: K6 stack {k6:.4f} (bound {c['k6_bytes'] / hbm * 1e3:.4f}; "
                  f"torch.stack {lib:.4f}, one device-to-device copy {copy:.4f}), "
                  f"K7 compact {k7:.4f} (bound {c['k7_bytes'] / hbm * 1e3:.4f})", flush=True)
        # Does a kernel that starts on an idle card read another time than in
        # a full queue?  And what do events around the calls add to it?
        calls = (lambda: banded.stack_rows(c["k6_in"]), lambda: torch.stack(c["k6_in"]),
                 lambda: banded.compact_rows(c["full"], c["pfx"], c["pair_end"], c["ccap"]))
        apart = [device_ms(fn, apart=True) for fn in calls]
        events = [event_ms(fn) for fn in calls]
        print(f"  {name}, each launch synchronised before the next: K6 stack {apart[0]:.4f}, "
              f"torch.stack {apart[1]:.4f}, K7 compact {apart[2]:.4f}; between events around 20 "
              f"calls: {events[0]:.4f}, {events[1]:.4f}, {events[2]:.4f}", flush=True)
        del dst, src
    if not tools["variants"]:
        return

    for c in cases.values():
        c["k6_plain"] = banded._stack_rows_torch(c["k6_in"])
        c["k7_plain"] = banded._compact_rows_torch(c["full"], c["pfx"], c["pair_end"], c["ccap"])

    def bits(t):
        return t.view(torch.int32)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    print("== K6 variants (device ms; ms between events around 20 launches)")
    for tag, repl in tools["chosen"](K6_VARIANTS).items():
        fn, regs = build("stack", tag, repl, "gsr_stack", [cb.P, cb.I32, cb.I64, cb.P, cb.P])
        line = f"  {tag}: registers {'/'.join(regs)}"
        for name, c in cases.items():
            out = torch.empty_like(c["k6_plain"])
            ptrs = (cb.P * len(c["k6_in"]))(*[x.data_ptr() for x in c["k6_in"]])

            def call():
                code = fn(ptrs, len(c["k6_in"]), c["k6_in"][0].shape[0], out.data_ptr(), stream())
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            call()
            torch.cuda.synchronize()
            equal = torch.equal(bits(out), bits(c["k6_plain"]))
            line += (f"; {name} {device_ms(call):.4f} (between events {event_ms(call):.4f}, "
                     f"bit-equal: {equal})")
        print(line, flush=True)

    print("== K7 variants (device ms)")
    k7_args = [cb.P, cb.P, cb.P, cb.I64, cb.I32, cb.I64, cb.P, cb.P]
    for tag, repl in tools["chosen"](K7_VARIANTS).items():
        fn, regs = build("compact", tag, repl, "gsr_compact", k7_args)
        line = f"  {tag}: registers {'/'.join(regs)}"
        for name, c in cases.items():
            out = torch.empty_like(c["k7_plain"])

            def call():
                code = fn(c["full"].data_ptr(), c["pfx"].data_ptr(), c["pair_end"].data_ptr(),
                          c["np"], G, c["ccap"] // G, out.data_ptr(), stream())
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            out.fill_(float("nan"))
            call()
            torch.cuda.synchronize()
            equal = torch.equal(bits(out), bits(c["k7_plain"]))
            line += f"; {name} {device_ms(call):.4f} (bit-equal: {equal})"
        print(line, flush=True)


def edges(tools, raw_scene, scene, cam0):
    """K1 through its wrapper and, with --variants, its variants, on the
    sorted keys of camera 0's flat list and of its settled banded list."""
    torch, dev, cb = tools["torch"], tools["dev"], tools["cb"]
    device_ms, build = tools["device_ms"], tools["build"]
    from cudagaussianrenderer_torch import RenderConfig, Renderer
    from cudagaussianrenderer_torch.ops import ranges
    from cudagaussianrenderer_torch.ops.banded import build_tile_pairs_banded, sort_pairs_banded
    from cudagaussianrenderer_torch.ops.binning import build_tile_pairs
    from cudagaussianrenderer_torch.ops.geometry import as_u32_i64
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.sorting import sort_pairs
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import _band_rows_tensor, camera_tensors

    G = 16
    cfg, bcfg = RenderConfig(), RenderConfig(sort_bands=G)
    cam = camera_tensors(cam0.camera_data(), dev)
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                          opacities=scene.opacities)
    colors = splat_colors(scene, cam)
    keys, _, _ = sort_pairs(build_tile_pairs(clip, colors, scene.opacities, cfg, 3932160))
    r = Renderer(raw_scene, bcfg)
    for _ in range(3):  # as chip_smoke.py phase 7 settles them
        before = (r.capacity, r.compact_capacity)
        r.render(cam0)
        if (r.capacity, r.compact_capacity) == before:
            break
    bpairs, _, _ = build_tile_pairs_banded(
        clip, colors, scene.opacities, bcfg, r.capacity,
        _band_rows_tensor(r.band_rows, bcfg, dev), compact_capacity=r.compact_capacity)
    bkeys, _, _ = sort_pairs_banded(bpairs, G)
    del r, bpairs
    probes = cfg.total_tiles + 1
    hbm = 3.35e12  # H100 SXM data sheet, bytes a second
    cases = {"flat": (keys[0], 1), "segmented": (bkeys[0], G)}

    print("== K1 of this checkout, through its wrapper (device ms; bound by bytes)")
    for name, (k, segs) in cases.items():
        bins = torch.clamp(as_u32_i64(k) >> 19, max=probes - 1)
        bins = bins + (torch.arange(k.shape[0], device=dev) // (k.shape[0] // segs)) * probes
        bound = (4 * k.shape[0] + 4 * segs * probes) / hbm * 1e3
        for _ in range(2):
            k1 = device_ms(lambda: ranges.tile_edges(k, probes, 19, segments=segs))
            plain = device_ms(lambda: ranges._edges_torch(k, probes, 19, segments=segs), 10)
            lib = device_ms(lambda: torch.cumsum(
                torch.bincount(bins, minlength=segs * probes).view(segs, probes), 1), 10)
            print(f"  {name}: {segs} x {k.shape[0] // segs} keys, {probes} probes: K1 {k1:.4f} "
                  f"(bound {bound:.4f}, {bound / k1:.0%}); plain {plain:.4f}; "
                  f"bincount + cumsum {lib:.4f}", flush=True)
    if not tools["variants"]:
        return

    print("== K1 variants (device ms; bit-equal to the plain version)")
    for tag, repl in tools["chosen"](K1_VARIANTS).items():
        fn, regs = build("edges", tag, repl, "gsr_edges",
                         [cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.P, cb.P])
        line = f"  {tag}: registers {'/'.join(regs)}"
        for name, (k, segs) in cases.items():
            out = torch.empty((segs, probes), dtype=torch.int32, device=dev)
            stream = torch.cuda.current_stream().cuda_stream

            def call():
                code = fn(k.data_ptr(), k.shape[0] // segs, segs, 19, probes, out.data_ptr(),
                          stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            out.fill_(-1)
            call()
            torch.cuda.synchronize()
            equal = torch.equal(out, ranges._edges_torch(k, probes, 19, segs).view(segs, probes))
            line += f"; {name} {device_ms(call):.4f} (bit-equal: {equal})"
        print(line, flush=True)


if __name__ == "__main__":
    sys.exit(main())
