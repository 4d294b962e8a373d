#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cudagaussianrenderer_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (nvcc, at first use), then:

  1. card and build: the card's name and power limit, torch and CUDA
     versions, the build time, TF32 off;
  2. kernel parity at the main path's shapes: the per-splat kernel of
     stages A-C (ops.splat.splat_columns) at the benchmark's mip360 shape
     (2.96 M splats, SH 3, 1248x832) against its plain version (columns
     exact, rgb within a level), with its times and byte bound; stage D
     (ops.sorting.sort_words, csrc/sort.cu) at that shape against the
     stable int64 torch.sort (bit for bit), with its parts' times and
     bounds and the int64 and sign-flipped int32 torch.sort beside it; each
     of K1-K4 against its plain PyTorch version on the same inputs (K1-K3
     exact, K4 within K4_LSB_BOUND output levels), with per-kernel times;
     K3 and K4 also on the huge-splat 1024x1024 scene, parity and time;
     K4 at the tiles
     of K4_TILE_SIZES (30x30 to 256x256, the edges 30 and 50 no multiple of
     4) on the main path's scene and camera, each within K4_TILE_LSB of its
     plain version, with device time and bound, in turns with the design
     before thread-block clusters (chip_kernel_variants.py's one-block
     variant, held to the same rule), the cluster size and the registers;
     a frame of 64x64 tiles at 1024x1024 through Renderer.render (eager,
     captured and replayed, byte-equal) against golden.py; and the main
     path's scene and cameras through Renderer.render at TILE_FRAME_EDGES
     tiles (the counts of K1-K4 set to 0 before each and read after;
     ms/frame replayed, device busy ms, pairs a frame);
  3. golden scenes: the non-banded scenes of tools/tpu_selfcheck.py
     through the port, each against the port's golden.py oracle, and its
     balanced-bands case (two bands of parallel.render_band, summed);
  4. the main path at full width: Renderer on the 1M-splat SH-3 scene at
     1024x1024 over 8 orbit cameras, ORBIT_PASSES passes through
     Renderer.render (a key's first frame eager, its second captured as a
     CUDA graph, later ones replayed), with the launch counts of the
     per-splat kernel, stage D and K1-K4 over those passes; then a traced pass of
     replays, in which each of those kernels must appear once a frame;
     every frame, the traced ones too, byte-equal to render_frame at its
     key, the renderer's state to the eager controller's, and that eager
     loop timed beside it; the keys, the hit rate and memory_reserved;
  5. banded kernel parity at full-width shapes: the same scene and camera
     under sort_bands=16: each of K5-K8 against its plain PyTorch version
     (exact), K1 in its segmented mode on the per-band-sorted keys, the
     banded tile ranges, and K7+K8 on the huge-splat scene roomy,
     pair-saturated and compact-saturated;
  6. banded golden scenes: the two banded scenes of tools/tpu_selfcheck.py
     against golden.py;
  7. the banded main path at full width: Renderer with sort_bands=16 on
     the same scene and cameras: after its warm-up frames the parity of
     phase 5 once more, at the capacities and band rows the timed frames
     start from (the K5-K8 times and bounds of the per-kernel line are
     taken there); then the passes of phase 4, with K5-K8, K1 and K4;
     then replayed passes of the flat and the banded Renderer in turns,
     and each path's device busy time and idle share;
  8. scene IO on the card: the scene of phase 4 written as raw values to a
     .ply, loaded by the native and by the Python importer (held to
     tests/test_native.py's rule against each other), rendered against
     phase 4's frame; round-tripped through .splat and rendered against
     the degree-0 scene; a frame written as PNG and read back bit-equal;
  9. the bench (cudagaussianrenderer_torch.bench) at 1M splats over 8
     orbit frames, stage times on: its headline from replays of one frame
     captured as a CUDA graph (after an eager frame under the sync debug
     mode "error"), every graphed frame byte-equal to the eager frame of its
     camera, beside the eager figure and the device-busy time of a traced
     graphed orbit; its JSON lines come before the per-kernel line;
 10. the CLI and the viewer at full width, in this process through
     cudagaussianrenderer_torch.cli.main: render of the 1M-splat procedural
     scene (SH 3) against Renderer.render, byte-equal; then phase 4's scene
     as a .ply: render against Renderer.render (byte-equal), render --bands
     16 against the flat frame, orbit -n 4 --transforms --colmap read back
     by load_posed, eval of the scene written back by the CLI's scene writer
     against that dataset, compare of two of its frames, serve on a free
     port (GET /, /frame.png, /stats, a drag by POST /input), with the
     launch counts of K1-K4 (K5-K8 for --bands); and diff.ssim on the card
     with TF32 allowed against the CPU;
 11. the differentiable path and fitting: at 128x128 (350 splats, SH 3)
     build_structure on the card equal to the CPU's, and render_diff's
     image, depth and gradients (every DiffSplats leaf, CameraDeltas,
     Exposure) within DIFF_IMG_TOL and DIFF_GRAD_RTOL of the CPU's; then
     through cli.main at 1024x1024 on phase 10's files: render --depth of
     the scene's .ply (and render_diff's RGB of that view against
     Renderer.render, the image rule), fit --dataset of the COLMAP
     workspace from its 100,000 SfM points (SH 3, --optimizer 3dgs,
     densify, --holdout 2, checkpoints; FIT_STEPS steps), --resume to
     FIT_STEPS + FIT_RESUME_STEPS, and --refine-poses --refine-exposure
     --export-poses; the fitted .ply loaded and rendered; seconds a step,
     peak memory, k_max, capacity, candidates, remat and the K1-K3 launches
     a step, beside the card's name and power limit;
 12. multi-device (cudagaussianrenderer_torch.parallel) on phase 4's scene
     and cameras: (a) every band of 2, 4 and 8 balanced bands: the band's
     device part (bounds, binning and K4's row offset on the device) eager
     under the sync debug mode "error", captured as a CUDA graph over a
     static camera and replayed for every camera, the bands' pairs summing
     to the flat frame's and the summed frame against phase 4's (the image
     rule); (b) through parallel.launch.spawn, a world-size-1 NCCL group:
     ORBIT_PASSES passes of DistributedRenderer.render over the cameras (a
     key's first frame eager, its second captured with its collectives as
     one CUDA graph, later ones replayed), every frame byte-equal to
     Renderer.render through ops.splat's plain version of the per-splat
     kernel (as the sharded path runs stages A-C), and Renderer.render
     within SHARDED_LEVELS of those frames, ms/frame by how it ran beside
     the eager frame loop at the same key, keys, hit rate and
     memory_reserved, a traced pass of replays (K1-K4 and the collectives
     once a frame) and its idle share, render_batch and a 1x1
     render_frames_sharded equal to those frames too, the K1-K4
     launches of the eager and captured frames, the loopback time of the
     frame's two collectives, and DP_STEPS fit_dp steps on phase 10's
     COLMAP views against the same steps by hand (every leaf within
     DIFF_GRAD_RTOL of its largest value); (c) the projected N-card frame
     for 2, 4 and 8 cards: the largest band's render_band device time (the
     sum of a trace's records) plus the all-gather of the clip buffer and
     the frame's all-reduce bounded at NVLink's 450 GB/s, labelled a
     projection.  Its JSON line ``{"multi_device": ...}`` prints before the
     per-kernel line;
 13. the measurement tools (cudagaussianrenderer_torch.tools): bench_suite
     configs 1 and 2 at full size and configs 3, 4, 5 and 6 at 1M splats
     over half their frames (each graphed frame byte-equal to its eager
     frame, K1-K4 launched in each config, config 5's pairs and capacity
     equal to phase 9's, config 6's two lines different in pairs);
     fit_artifact at its defaults cut to FIT_ARTIFACT_STEPS steps (PSNR must
     rise); make_artifact over 4 frames (1M splats SH 3 through a .ply and
     the native importer); sh_basis on the card against the CPU.  Its
     numbers go to ``phase 13 numbers [card]:`` lines of the log.
 14. the measurement harness (cudagaussianrenderer_torch.tools.measure, the
     JAX repository's tools/measure.py): its eleven subcommands in this
     process at their default, full-width sizes (1M splats, 1024x1024,
     capacity 4,587,520), each line a CUDA graph of REPS calls replayed
     (reorder_scene_by_tile_row by events; trainscale and dpstep on the
     host clock), no line failed, K1-K8 launched where the subcommand runs
     them and present by name in the traces of emit (K2, K3), raster (K4)
     and bandsort's G=16 frame (K5-K8, the segmented K1); then
     tools/selfcheck.py.  Its numbers go to ``phase 14 numbers [card]:``
     lines of the log.
 15. the graft entry (cudagaussianrenderer_torch.graft_entry, the JAX
     repository's __graft_entry__.py): entry()'s frame eager under the sync
     debug mode "error", captured as a CUDA graph and replayed byte-equal,
     the per-splat kernel and K1-K4 launched once each by the eager frame,
     the warm-up and the capture, the frame against the CPU's and, with
     room for every candidate, against golden.py (the image rule); ms a
     frame eager and replayed, and a traced pass of replays (each of those
     kernels once a frame) with its device busy time; then
     dryrun_multichip over NCCL at the visible card count, every check
     passing with K1-K4 launched on rank 0 (K1-K3 in the training step,
     the per-splat kernel in check 3's single-device frame),
     its seconds by check.  Its numbers go to a ``phase 15 numbers
     [card]:`` line.

Phases 3 and 6 take their scenes from tools/selfcheck.py's case list.

Phases 2 and 5 also hold K1 on the corner cases of tests/torch_port_cases.py
(flat, then segmented; aligned keys and a view 4 bytes off).

Every entry of the per-kernel line carries ``ms`` (CUDA events around
back-to-back wrapper calls, which for a kernel shorter than a wrapper call
is the host's time) and ``device_ms`` (the kernel's own time from a
torch.profiler trace of the same calls; null if the trace holds none).

Any failure raises and exits non-zero.  The last line of stdout is one
JSON object naming the device; the line before it is the card's
``nvidia-smi`` name and power limit, before that the per-kernel JSON line,
and before that phase 12's.  Without a CUDA device the script exits
non-zero and prints no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# f32 operations per (pixel, pair) evaluation of the raster kernel's inner
# loop, counted from csrc/raster.cu: dx (1); two multiply-adds of the
# quadratic form (4); min, ex2 (2); the weight (1); three colour
# multiply-adds (6); the transmittance multiply-add (2); and a quarter of
# the five operations a thread shares among its four pixels (dy, nb2 * dy,
# nc * dy, its multiply-add with dy and log2 opacity).  The ex2 is counted
# as one.
K4_OPS_PER_EVAL = 17.25
# The special-function units take that ex2: 16 results a clock and SM.
SFU_PER_CLOCK_PER_SM = 16
# K4 against its plain version, after tiles_to_image: the two blend the
# same pairs in the same order and differ by the kernel's ex2.approx of a
# conic that carries log2(e), and by fused multiply-adds.
K4_LSB_BOUND = 4
# K4 at tiles other than the main path's 16x16 (phase 2): (tile edge,
# screen edge) on phase 4's scene and camera 0; each within K4_TILE_LSB
# output levels of its plain version.  Above 32x32 a tile is a cluster of
# blocks; 30 and 50 are no multiple of 4 (a pixel a group: 900 groups, one
# block; 2,500 groups, a cluster).
K4_TILE_SIZES = ((36, 1008), (48, 1008), (64, 1024), (128, 1024), (256, 1024), (30, 990),
                 (50, 1000))
K4_TILE_LSB = 1
# Device ms a trace of one K4 design at one tile size may take (at most 20
# calls, at least 3).
K4_TILE_TRACE_MS = 300
# Phase 2's per-splat kernel (stages A-C, csrc/splat.cu) at the benchmark's
# mip360 cell: its scene size (2.96 M splats, SH 3) and screen (1248x832).
SPLAT_KERNEL_SPLATS = 2_960_000
SPLAT_KERNEL_SCREEN = (1248, 832)
# Bytes the per-splat kernel moves a splat at SH 3: means, scales, the
# packed rotation, the opacity and 16 coefficients a channel in (224 B), 12
# f32 columns and a count out (52 B).
SPLAT_BYTES = 224 + 52
# Stage D's parts (csrc/sort.cu) in a trace, each with the bytes it moves a
# slot: the slot index and the record written, 3 attribute words read (32
# B); cub's 4 radix passes, each reading and writing a 4-B key and a 4-B
# slot index (64 B), and its memsets; the sorted index and a 16-B record
# read, 3 words written (32 B).
SORT_PARTS = {
    "records": (r"gsr_sort_slots_index_elementwise_kernel", 32),
    "radix sort": (r"DeviceRadixSort|^Memset", 64),
    "gather": (r"gsr_sort_index_elementwise_kernel", 32),
}
# Phase 2's frames of the main path's scene and cameras through
# Renderer.render at these tile edges (1024x1024).
TILE_FRAME_EDGES = (16, 32, 64)
# The 64x64-tile frame of phase 2 through Renderer.render against golden.py:
# a scene golden.py renders in seconds (~27,800 candidate pairs at 1024x1024).
TILE_FRAME_SPLATS = 20_000
# Cycles the card spins ahead of a traced run of launches (torch.cuda._sleep,
# traced as spin_kernel): about 20 ms, enough for the host to queue 50
# wrapper calls under the profiler.
HEAD_START_CYCLES = 40_000_000
# One unit in the last place of 0.5: how far the native .ply importer's
# fused colour f_dc * SH_C0 + 0.5 may lie from the Python importer's.
COLOR_ULP = 2.0 ** -24
# Main-path frame against the plain-version frame, and the golden scenes:
# the repo's rule (tests/test_pipeline.py:20-27).
PIX_TOL, BAD_FRAC = 8, 0.02
# Phase 12: Renderer.render (the per-splat kernel) against the frames that
# the sharded path (parallel.distributed, stages A-C in plain torch) is held
# byte-equal to: a Renderer's through the per-splat kernel's plain version.
# Their splat colours differ by up to one level a channel (cuBLAS sums the
# plain SH contraction in its own order); measured on the card: 1.
SHARDED_LEVELS = 1
# Phase 11, the differentiable path on the card against the CPU on the same
# inputs and structure: render_diff's image and depth (absolute), and each
# gradient's max |diff| against its leaf's max |grad| (the card sums a
# pair's gradient into its splat by atomics, in another order).
DIFF_IMG_TOL, DIFF_GRAD_RTOL = 1e-5, 1e-4
# Phase 11's fit at full width: steps, densify and checkpoint period, the
# steps a resume adds, and the steps of the pose and exposure refinement;
# the pair-list capacity (the CLI's default, 16 slots a splat, is below the
# ~2.3M candidates of a view of the 100,000 SfM points).
FIT_STEPS, FIT_DENSIFY_EVERY, FIT_RESUME_STEPS, FIT_REFINE_STEPS = 30, 5, 15, 3
FIT_CAPACITY = 4 << 20
# Phase 11's graphed fit step against its eager twin on the fit's first view:
# the steps compared (a key's first eager, its second captured, the rest
# replayed), the steady steps timed of each, and the tolerance: the same
# kernels on the same inputs in the same order, pair gradients summed in
# float64, so bit-equality (0).
GRAPH_CHECK_STEPS, GRAPH_TIMED_STEPS, GRAPHED_STEP_TOL = 6, 5, 0.0
# Steps of each before the timed ones, for the graphed step's keys to settle.
GRAPH_WARM_STEPS = 2
# Phase 12: the band counts of render_band and of the projected N-card
# frame; the data-parallel steps held against the hand steps; the H100 SXM
# data sheet's NVLink rate, each way between a card and the others of its
# host (900 GB/s both ways together), that bounds the projection's
# collectives.
BAND_COUNTS = (2, 4, 8)
DP_STEPS = 3
NVLINK_BYTES_PER_S = 450e9
# Phase 13: the fit artifact's steps (its default is 600).
FIT_ARTIFACT_STEPS = 200


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def sfu_results_per_s() -> float:
    """ex2 results a second of the whole card at its highest SM clock."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return SFU_PER_CLOCK_PER_SM * sms * mhz * 1e6


def check(name, got, want, *, pix_tol=PIX_TOL, frac=BAD_FRAC):
    import numpy as np

    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    bad = float((diff > pix_tol).any(axis=-1).mean())
    log(f"  {name:34s} bad_px={bad:.4f} max_diff={int(diff.max()):3d}")
    if bad > frac:
        raise AssertionError(f"{name}: {bad:.4f} of pixels differ by more than {pix_tol}")


def cuda_ms(fn, reps, warmup=1):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def trace_ms(fn, reps):
    """Device time (ms) of what one ``fn()`` enqueues, from a profiler trace
    of ``reps`` calls: the kernels alone, without the host's enqueue gaps.
    The card first spins for HEAD_START_CYCLES, so that the host has queued
    every call before the first runs and the kernels run back to back, as
    they do between events.  A trace may hold fewer records of a kernel than
    it was launched (15 to 19 of 20 were seen, fewer the longer the process
    has run) and single records that are too short, so the time is each
    kernel's median record times its launches a call, not the records' sum
    over ``reps``.  None when the trace holds no device time."""
    busy = sum(trace_kernels(fn, reps).values())
    return busy if busy > 0 else None


def trace_kernels(fn, reps):
    """trace_ms by kernel: {record name: device ms a call}."""
    import statistics

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(HEAD_START_CYCLES)
        for _ in range(reps):
            fn()  # the result is dropped, so the allocator hands out one block again
        torch.cuda.synchronize()
    records = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key:
            records.setdefault(e.key, []).append(e.self_device_time_total)
    out = {}
    for key, times in records.items():
        per_call = max(1, round(len(times) / reps))
        if len(times) != reps * per_call:
            log(f"    (the trace holds {len(times)} records of {key[:48]} for {reps} calls)")
        out[key] = statistics.median(times) * per_call / 1e3
    return out


def device_ms(fn, reps):
    """Mean time of one ``fn()`` over ``reps`` calls, as text with the method
    that gave it: "x ms of device time" from a profiler trace (the kernels
    alone, where the host cannot enqueue as fast as the card runs them), or
    "x ms between events" where the trace holds no device time, which
    includes the host's enqueue gaps and is too high for a short kernel."""
    busy = trace_ms(fn, reps)
    if busy is None:
        return f"{cuda_ms(fn, reps):.4f} ms between events"
    return f"{busy:.4f} ms of device time"


def require(ok, what):
    if not ok:
        raise AssertionError(what)


def bits_equal(a, b) -> bool:
    import torch

    a = a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
    b = b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b
    return a.shape == b.shape and bool(torch.equal(a, b))


def ptxas_kernels(log):
    """{kernel's mangled name: (registers, spill stores in bytes)} from an
    nvcc -Xptxas=-v log."""
    import re

    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = [None, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name][1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def k4_registers(kernels, tile_size, geometry):
    """(registers, spill bytes) of the Gaussian K4 kernel that ``geometry``
    launches at ``tile_size`` with the row offset as an argument, from
    ``kernels`` (ptxas_kernels of the committed source or of the one-block
    variant, whose looped kernel is raster_looped_kernel)."""
    px = geometry.pixels
    looped = geometry.threads < geometry.band_rows * (tile_size // px)
    if geometry.cluster > 1 or looped:
        wanted = (f"raster_cluster_kernelILi{px}ELb1ELb0ELb{int(looped)}E",
                  f"raster_looped_kernelILi{px}ELb1ELb0EE")
    else:
        wanted = (f"raster_kernelILi{px}ELb1ELb0EE",)
    for name, regs in kernels.items():
        if any(w in name for w in wanted):
            return regs
    return None


def mip360_shape(dev):
    """The mip360 cell's shape (SPLAT_KERNEL_SPLATS, SH 3,
    SPLAT_KERNEL_SCREEN) from camera 0 of an orbit: (scene, camera tensors,
    config)."""
    from cudagaussianrenderer_torch import RenderConfig, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.render import camera_tensors

    width, height = SPLAT_KERNEL_SCREEN
    config = RenderConfig(screen_size=width, screen_height=height)
    scene = random_scene(SPLAT_KERNEL_SPLATS, seed=0, min_scale=0.002, max_scale=0.053,
                         extent=4.0, sh_degree=3, device=dev)
    cam = camera_tensors(orbit_cameras(scene.bounds_min, scene.bounds_max, 8,
                                       aspect=config.aspect)[0].camera_data(), dev)
    return scene, cam, config


def splat_kernel(scene, cam, config):
    """Phase 2's per-splat kernel (ops.splat.splat_columns, csrc/splat.cu)
    at the mip360 cell's shape (mip360_shape): against its plain version on
    the card (the counts and every column but rgb bit for bit, rgb within
    one level a channel), its time between events and its device time, the
    plain version's time, and its byte bound (SPLAT_BYTES a splat).
    Returns the kernels line's record."""
    import torch

    from cudagaussianrenderer_torch.ops import splat

    def bits(t):
        return torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t).view(torch.int32)

    width, height = config.screen_w, config.screen_h
    cols, counts = splat.splat_columns(scene, cam, config)
    want_cols, want_counts = splat._splat_columns_torch(scene, cam, config, None)
    torch.cuda.synchronize()
    equal = bool(torch.equal(counts, want_counts)) and all(
        torch.equal(bits(got), bits(want))
        for i, (got, want) in enumerate(zip(cols, want_cols)) if i != splat.RGB_COLUMN)
    got_rgb = cols[splat.RGB_COLUMN].to(torch.int64)
    want_rgb = want_cols[splat.RGB_COLUMN].to(torch.int64)
    levels = max(int((((got_rgb >> s) & 255) - ((want_rgb >> s) & 255)).abs().max())
                 for s in (16, 8, 0))
    n = scene.padded_count
    log(f"  per-splat kernel at {n} splats SH 3, {width}x{height}: counts and columns "
        f"bit-equal={equal}, rgb within {levels} level(s); {int(counts.sum())} candidates")
    require(equal and levels <= 1, "the per-splat kernel differs from its plain version")
    del want_cols, want_counts

    def run():
        return splat.splat_columns(scene, cam, config)

    record = dict(
        ms=cuda_ms(run, 20),
        device_ms=trace_ms(run, 20),
        plain_ms=cuda_ms(lambda: splat._splat_columns_torch(scene, cam, config, None), 3),
        library_ms=None,
        bytes=n * SPLAT_BYTES,
        max_abs_err=levels,
    )
    bound = record["bytes"] / HBM_BYTES_PER_S * 1e3
    log(f"  per-splat kernel: byte bound {bound:.4f} ms, device {record['device_ms']} ms = "
        f"{100 * bound / (record['device_ms'] or record['ms']):.1f}% of it; between events "
        f"{record['ms']:.4f} ms; plain version {record['plain_ms']:.3f} ms")
    return record


def sort_kernel(scene, cam, config, build_seconds):
    """Phase 2's stage D (ops.sorting.sort_pairs' kernel path, sort_words,
    csrc/sort.cu) on the pair list of the mip360 cell's shape
    (mip360_shape) at the capacity Renderer would give it: keys, values and
    attribute words bit-equal to the stable int64 torch.sort and its
    gathers (the parent's path); its device time, and that of each of its
    parts against its bound (SORT_PARTS: the slot indices and records, the
    radix sort, the gather), its time between events, and the library
    yardsticks: the int64 torch.sort with its three gathers, and torch.sort
    of the sign-flipped int32 key (ordered as the uint32 key, the other way
    to sort at the key's width) with the same three gathers.  Returns the
    kernels line's record."""
    import re

    import torch

    from cudagaussianrenderer_torch import Renderer
    from cudagaussianrenderer_torch.ops import sorting, splat
    from cudagaussianrenderer_torch.ops.binning import build_tile_pairs_from_columns
    from cudagaussianrenderer_torch.render import round_capacity

    cols, counts = splat.splat_columns(scene, cam, config)
    total = int(counts.sum())
    capacity = round_capacity(Renderer._bucket(total), scene.means.device)
    pairs = build_tile_pairs_from_columns(cols, counts, capacity, config)
    del cols, counts
    key, attrs = pairs.keys[0], pairs.attrs
    sign = torch.iinfo(torch.int32).min

    def words(result):
        keys, values, attrs_ = result
        return list(keys) + ([] if values is None else [values]) + list(attrs_)

    def flipped_sort():
        return torch.sort(key ^ sign, stable=True)

    def flipped():
        sorted_key, perm = flipped_sort()
        return sorted_key ^ sign, [a[perm] for a in attrs]

    equal = all(
        bits_equal(g, w)
        for v in (False, True)
        for g, w in zip(words(sorting.sort_pairs(pairs, with_values=v)),
                        words(sorting._sort_pairs_torch(pairs, with_values=v, stable=True))))
    want = sorting._sort_pairs_torch(pairs, stable=True)
    fk, fw = flipped()
    equal_flipped = bits_equal(fk, want[0][0]) and all(
        bits_equal(fw[i], want[2][i]) for i in range(3))
    del want, fk, fw
    log(f"  sort at {total} candidates, capacity {capacity}: kernel path bit-equal to the "
        f"stable int64 torch.sort={equal}; the flipped int32 torch.sort={equal_flipped}")
    require(equal and equal_flipped, "stage D's kernel path differs from the int64 torch.sort")

    peaks = {}
    for name, fn in (("kernel", lambda: sorting.sort_pairs(pairs)),
                     ("int64", lambda: sorting._sort_pairs_torch(pairs)), ("flipped", flipped)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fn()
        torch.cuda.synchronize()
        peaks[name] = torch.cuda.max_memory_allocated() - base
    kernels = trace_kernels(lambda: sorting.sort_pairs(pairs), 20) or {}
    parts = {name: sum(ms for k, ms in kernels.items() if re.search(pattern, k))
             for name, (pattern, _) in SORT_PARTS.items()}
    bounds = {name: b * capacity / HBM_BYTES_PER_S * 1e3 for name, (_, b) in SORT_PARTS.items()}
    record = dict(
        ms=cuda_ms(lambda: sorting.sort_pairs(pairs), 20),
        device_ms=sum(kernels.values()) or None,
        plain_ms=None,
        library_ms=cuda_ms(lambda: sorting._sort_pairs_torch(pairs), 20),
        library_device_ms=trace_ms(lambda: sorting._sort_pairs_torch(pairs), 20),
        flipped_ms=cuda_ms(flipped, 20),
        flipped_device_ms=trace_ms(flipped, 20),
        flipped_sort_device_ms=trace_ms(flipped_sort, 20),
        part_device_ms=parts,
        part_bound_ms=bounds,
        bytes=sum(b for _, b in SORT_PARTS.values()) * capacity,
        slots=capacity, candidates=total, peak_bytes=peaks,
        build_s=build_seconds,
        max_abs_err=0,
    )
    log(f"  stage D at {capacity} slots: device {record['device_ms']} ms by part "
        + ", ".join(f"{k} {parts[k]:.4f} (bound {bounds[k]:.4f})" for k in SORT_PARTS)
        + f"; between events {record['ms']:.4f}; int64 torch.sort and gathers "
        f"{record['library_device_ms']} device, {record['library_ms']:.4f} between events; "
        f"flipped int32 torch.sort {record['flipped_sort_device_ms']} device, with the gathers "
        f"{record['flipped_device_ms']}, {record['flipped_ms']:.4f} between events; peak bytes "
        f"{peaks}; build {build_seconds:.1f} s")
    log(f"  stage D's kernels, ms a call: "
        + ", ".join(f"{k[:72]} {ms:.4f}" for k, ms in kernels.items()))
    return record


def k4_tile_sizes(dev, scene, cam, sfu_rate, builds):
    """Phase 2's K4 at the tile sizes of K4_TILE_SIZES: each against its
    plain version on ``scene`` (phase 4's, padded) from camera tensors
    ``cam``, at the capacity Renderer would bucket its candidates into,
    with its device time and bound, in turns with the design before
    clusters (chip_kernel_variants.py's K4_ONE_BLOCK, built here, held to
    the same rule), the cluster size and the registers of each (from
    ``builds``, cuda_build.build_all's result); then one frame of 64x64
    tiles at 1024x1024 through Renderer.render (a warm-up frame, then its
    settled key's eager, captured and replayed frames, byte-equal) against
    golden.py.  Returns a record a tile size."""
    import tempfile

    import numpy as np
    import torch

    import chip_kernel_variants as variants
    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
    from cudagaussianrenderer_torch.ops import raster
    from cudagaussianrenderer_torch.ops.binning import emit_columns
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import _frame_pairs, round_capacity

    largest = raster.max_cluster(torch.cuda.current_device())
    with tempfile.TemporaryDirectory(prefix="gsr_k4_") as scratch:
        old_fn, _, old_log = variants.build_variant(
            scratch, "raster", variants.K4_ONE_BLOCK,
            variants.K4_VARIANTS[variants.K4_ONE_BLOCK], "gsr_raster", raster.RASTER_ARGTYPES)
    regs_new = ptxas_kernels(builds["raster"]["log"])
    regs_old = ptxas_kernels("\n".join(old_log))
    log(f"  K4: the largest cluster this card runs: {largest} blocks; the one-block design "
        f"built from chip_kernel_variants.py")
    records = []
    for ts, size in K4_TILE_SIZES:
        cfg = RenderConfig(screen_size=size, tile_size=ts)
        clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                              opacities=scene.opacities)
        _, incl = emit_columns(clip, splat_colors(scene, cam), scene.opacities, cfg)
        total = int(incl[-1])
        cap = round_capacity(Renderer._bucket(total), dev)
        _, attrs, starts, counts = _frame_pairs(scene, cam, cfg, cap)
        pair_data = raster.pack_pair_data(attrs, cfg.raster_chunk)

        def call():
            return raster.rasterize_tiles(pair_data, starts, counts, cfg)

        geometry = raster.raster_geometry(ts, largest)
        old_geometry = variants.k4_geometry(variants.K4_ONE_BLOCK, ts, largest)
        old_tiles = torch.empty((cfg.total_tiles, cfg.pixels_per_tile, 4), device=dev)
        old_call = variants.k4_call(old_fn, pair_data, starts, counts, cfg, old_geometry,
                                    old_tiles)
        tiles = call()
        old_call()
        blended = torch.zeros(1, dtype=torch.int32, device=dev)
        plain = raster._raster_torch(pair_data, starts, counts, cfg, cfg.total_tiles, 0, blended)
        img_plain = raster.tiles_to_image(plain, cfg).int()
        lsb = int((raster.tiles_to_image(tiles, cfg).int() - img_plain).abs().max())
        old_lsb = int((raster.tiles_to_image(old_tiles, cfg).int() - img_plain).abs().max())
        evals = int(blended) * cfg.pixels_per_tile
        nbytes = (4 * 3 * min(total, cap) + 8 * cfg.total_tiles
                  + 16 * cfg.total_tiles * cfg.pixels_per_tile)
        floors = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                  "operations": max(K4_OPS_PER_EVAL * evals / F32_OPS_PER_S,
                                    evals / sfu_rate) * 1e3}
        bound_by = max(floors, key=floors.get)
        # In turns: new, old, old, new; 20 calls a trace, fewer of a long kernel,
        # whose trace may hold no record: then CUDA events (exact enough there).
        reps = {f: max(3, min(20, int(K4_TILE_TRACE_MS / cuda_ms(f, 1)))) for f in (call, old_call)}
        timed_by = []

        def k4_ms(f):
            ms = trace_ms(f, reps[f])
            timed_by.append("trace" if ms is not None else "events")
            return ms if ms is not None else cuda_ms(f, reps[f])

        new_ms, old_ms = [k4_ms(call)], [k4_ms(old_call)]
        old_ms.append(k4_ms(old_call))
        new_ms.append(k4_ms(call))
        bound = floors[bound_by]
        rec = dict(tile_size=ts, screen=size, tiles=cfg.total_tiles, pairs=min(total, cap),
                   pairs_blended=int(blended), evaluations=evals, max_lsb=lsb,
                   max_abs_err=float((tiles - plain).abs().max()), old_max_lsb=old_lsb,
                   geometry=geometry._asdict(), old_geometry=old_geometry._asdict(),
                   registers=k4_registers(regs_new, ts, geometry),
                   old_registers=k4_registers(regs_old, ts, old_geometry),
                   device_ms=new_ms, old_device_ms=old_ms, timed_by=timed_by,
                   bound_ms=bound, bound_by=bound_by,
                   share=bound / float(np.mean(new_ms)), old_share=bound / float(np.mean(old_ms)))
        records.append(rec)
        log(f"  K4 at {ts}x{ts} tiles, {size}x{size}: {rec['tiles']} tiles, "
            f"{rec['pairs_blended']} of {rec['pairs']} pairs blended = {evals} evaluations, "
            f"max diff {lsb} LSB (one-block design {old_lsb}; bound {K4_TILE_LSB}); cluster "
            f"{geometry.cluster} x {geometry.threads} threads, registers {rec['registers']}: "
            f"device {new_ms} ms; one block: {old_geometry.threads} threads, registers "
            f"{rec['old_registers']}: {old_ms} ms; bound {bound:.4f} ms ({bound_by}), share "
            f"{rec['share']:.3f} (one block {rec['old_share']:.3f})")
        require(lsb <= K4_TILE_LSB and old_lsb <= K4_TILE_LSB,
                f"K4 at {ts}x{ts} tiles differs by {lsb} LSB (one-block design {old_lsb}) from "
                f"its plain version")
        require(geometry.cluster > 1 or ts * ts <= raster.MAX_THREADS,
                f"K4 at {ts}x{ts} tiles launches no cluster")

    fscene = random_scene(TILE_FRAME_SPLATS, seed=0, min_scale=0.002, max_scale=0.053,
                          extent=4.0, sh_degree=3, device=dev)
    fcfg = RenderConfig(screen_size=1024, tile_size=64)
    fcam = orbit_cameras(fscene.bounds_min, fscene.bounds_max, 8)[0]
    r = Renderer(fscene, fcfg, device=dev)
    r.render(fcam)  # warm-up: settles the capacity
    before = raster.rasterize_tiles.launches
    frames, methods = [], []
    for _ in range(3):
        frames.append(r.render(fcam))
        methods.append(r.last_method)
    launched = raster.rasterize_tiles.launches - before
    log(f"  Renderer.render at 64x64 tiles, 1024x1024, {TILE_FRAME_SPLATS} splats SH 3: "
        f"{methods}, key {r._key()}, {r.last_candidates} candidates, K4 launched {launched}")
    require(methods == ["eager", "capture", "replay"],
            f"the 64x64-tile frames ran {methods}, not eager, capture, replay")
    require(launched > 0, "the 64x64-tile frames did not launch K4")
    for i in (1, 2):
        require(np.array_equal(frames[i], frames[0]),
                f"the {methods[i]} 64x64-tile frame differs from the eager one")
    check("64x64 tiles vs golden.py", frames[0],
          golden_render(scene_to_numpy(fscene), fcam.camera_data(), fcfg))
    return records


def tile_size_frames(dev, scene, cams):
    """Phase 2's frames of ``scene`` (phase 4's) over ``cams`` through
    Renderer.render at each edge of TILE_FRAME_EDGES (1024x1024): a warm-up
    frame, then ORBIT_PASSES passes (a key's first frame eager, its second
    captured, later ones replayed) with the counts of K1-K4 set to 0 just
    before and read just after, each at least 1; then a traced pass of
    replays, K1-K4 once a frame.  Returns a record an edge: ms a replayed
    frame on the host clock, device busy ms a frame, pairs a frame."""
    import numpy as np
    import torch

    from cudagaussianrenderer_torch import RenderConfig, Renderer
    from cudagaussianrenderer_torch.ops import expand, ranges, raster

    counted = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    largest = raster.max_cluster(torch.cuda.current_device())
    records = []
    for ts in TILE_FRAME_EDGES:
        r = Renderer(scene, RenderConfig(tile_size=ts))
        r.render(cams[0])  # warm-up: sizes the capacity from its candidates
        for fn in counted:
            fn.launches = 0
        recs, _ = orbit_passes(r, cams, ORBIT_PASSES)
        launches = {fn.__name__: fn.launches for fn in counted}
        for name, count in launches.items():
            require(count >= 1, f"{name} never launched in the frames of {ts}x{ts} tiles")
        _, busy, traced_ms = traced_pass(r, cams, [fn.__name__ for fn in counted])
        replay = [rec["ms"] for rec in recs if rec["method"] == "replay"]
        pairs = [min(rec["after"][4], rec["after"][0]) for rec in recs]
        rec = dict(tile_size=ts, tiles=r.config.total_tiles,
                   geometry=raster.raster_geometry(ts, largest)._asdict(),
                   replay_ms=float(np.mean(replay)), replay_ms_min=min(replay),
                   busy_ms=busy, traced_ms=traced_ms, pairs=float(np.mean(pairs)),
                   capacity=r.capacity, launches=launches,
                   methods=[rec["method"][0] for rec in recs])
        records.append(rec)
        log(f"  Renderer.render at {ts}x{ts} tiles: replayed {rec['replay_ms']:.3f} ms/frame "
            f"(min {rec['replay_ms_min']:.3f}), device busy {busy:.3f} ms/frame, "
            f"{rec['pairs']:.0f} pairs/frame, launches {launches}")
        del r, recs
        torch.cuda.empty_cache()
    return records


def edge_corner_parity(segmented):
    """K1 on the corner cases of tests/torch_port_cases.py, each against
    _edges_torch bit for bit, from aligned keys and from a view 4 bytes
    off a 16-byte boundary: each case whole in the segmented mode, or
    each of its segments alone as a flat list."""
    import numpy as np
    import torch

    from cudagaussianrenderer_torch.ops import ranges

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import EDGE_CORNER_CASES, edge_corner_keys

    lists = 0
    for name in EDGE_CORNER_CASES:
        keys, segments, num_probes, shift = edge_corner_keys(name)
        n = keys.shape[0] // segments
        parts = [(keys, segments)] if segmented else [
            (keys[s_ * n:(s_ + 1) * n], 1) for s_ in range(segments)]
        for part, segs in parts:
            for offset in (0, 1):
                buf = np.concatenate([np.zeros(offset, np.uint32), part]).view(np.int32)
                k = torch.from_numpy(buf).cuda()[offset:]
                got = ranges.tile_edges(k, num_probes, shift, segments=segs)
                want = ranges._edges_torch(k, num_probes, shift, segments=segs)
                require(bits_equal(got, want),
                        f"K1 differs from its plain version on corner case {name} "
                        f"({'segmented' if segmented else 'flat'}, offset {4 * offset} B)")
                lists += 1
    log(f"  K1 corner cases, {'segmented' if segmented else 'flat'}: "
        f"{len(EDGE_CORNER_CASES)} cases, {lists} lists (aligned and 4 bytes off): exact")


def scene_io(scene, cams, direct_frame, config, dev):
    """Phase 8.  ``scene`` is phase 4's scene (built directly from the
    seed's arrays), ``direct_frame`` its frame of camera 0."""
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from cudagaussianrenderer_torch import Renderer, load_gaussian_ply, write_gaussian_ply
    from cudagaussianrenderer_torch.models.scene import random_scene_arrays
    from cudagaussianrenderer_torch.splatfile import load_splat, write_splat
    from cudagaussianrenderer_torch.utils.native import native_available
    from cudagaussianrenderer_torch.utils.png import read_png, write_png

    def frame0(s):
        """Camera 0 with a Renderer, after a frame that sizes its capacity."""
        r = Renderer(s, config)
        r.render(cams[0])
        img = r.render(cams[0])
        require(r.last_candidates <= r.capacity, "the loaded scene's frame saturated")
        return img

    a = random_scene_arrays(scene.count, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                            sh_degree=3)
    with tempfile.TemporaryDirectory(prefix="gsr_scene_io_") as tmp:
        ply = Path(tmp) / "scene.ply"
        t0 = time.perf_counter()
        with np.errstate(divide="ignore"):  # an opacity of 0 or 1 in f32 has an infinite logit
            write_gaussian_ply(
                ply, a["means"], np.log(a["scales"]), a["quats_xyzw"][:, [3, 0, 1, 2]],
                np.log(a["opacities"]) - np.log1p(-a["opacities"]), a["sh"][:, 0, :],
                np.transpose(a["sh"][:, 1:, :], (0, 2, 1)))
        log(f"  wrote {ply.stat().st_size / 1e6:.1f} MB of raw values in "
            f"{time.perf_counter() - t0:.2f} s")
        loaded = {}
        importers = (("native", True), ("Python", False)) if native_available() else (
            ("Python", False),)
        if len(importers) == 1:
            log("  the native loader is not available on this machine (make -C native "
                "failed): the Python importer only")
        for name, native in importers:
            t0 = time.perf_counter()
            loaded[name] = load_gaussian_ply(ply, use_native=native, device=dev)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            log(f"  {name} importer: {loaded[name].count} splats, SH degree "
                f"{loaded[name].sh_degree}, loaded onto the card in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        py = loaded["Python"]
        if "native" in loaded:
            nat = loaded["native"]
            require(nat.count == py.count and nat.sh_degree == py.sh_degree == 3,
                    "the two importers load different counts or SH degrees")
            require(torch.equal(nat.quats, py.quats), "the importers' quaternions differ")
            for f in ("means", "scales", "opacities", "sh"):
                torch.testing.assert_close(getattr(nat, f), getattr(py, f), rtol=1e-6, atol=0)
            # The native build fuses f_dc * SH_C0 + 0.5 into one multiply-add,
            # NumPy rounds twice: the two differ by up to one unit in the last
            # place of the addend 0.5, which is no small relative error for a
            # colour near 0 (the scene's colours are uniform in [0, 1]).
            torch.testing.assert_close(nat.colors, py.colors, rtol=1e-6, atol=COLOR_ULP)
            np.testing.assert_allclose(nat.bounds_min, py.bounds_min, rtol=1e-5)
            np.testing.assert_allclose(nat.bounds_max, py.bounds_max, rtol=1e-5)
            log("  native vs Python: quaternions and counts exact, float fields within "
                f"rtol 1e-6 (colours also within {COLOR_ULP:.3g} absolute), bounds within 1e-5")
        img = frame0(py)
        check("loaded .ply frame vs phase 4 frame", img, direct_frame)
        splat = Path(tmp) / "scene.splat"
        t0 = time.perf_counter()
        write_splat(splat, py)
        back = load_splat(splat, device=dev)
        log(f"  .splat round trip: {splat.stat().st_size / 1e6:.1f} MB in "
            f"{time.perf_counter() - t0:.2f} s; the format keeps no SH, so its frame is held "
            "against the scene's own at SH degree 0")
        flat = dataclasses.replace(scene, sh=None, sh_degree=0)
        check(".splat frame vs degree-0 frame", frame0(back), frame0(flat))
        png = Path(tmp) / "frame.png"
        t0 = time.perf_counter()
        write_png(png, img)
        again = read_png(png)
        require(again.shape == img.shape and np.array_equal(again, img),
                "the PNG read back differs from the frame written")
        log(f"  PNG round trip of the loaded frame: bit-equal, {png.stat().st_size / 1e6:.2f} MB, "
            f"{time.perf_counter() - t0:.2f} s")


def sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize()


# Each kernel's name in a profiler trace, by its wrapper (every kernel sits
# in an anonymous namespace of its csrc/ file).
TRACE_NAMES = {
    "splat_columns": r"::splat_columns_kernel<",
    "sort_words": r"DeviceRadixSortHistogramKernel",
    "tile_edges": r"::edges_kernel<",
    "interleave_rows": r"::interleave_kernel\(",
    "emit_slots": r"::emit_kernel<false>",
    "rasterize_tiles": r"::raster(_cluster)?_kernel<",
    "interleave_rows_padded": r"::interleave_padded_kernel\(",
    "stack_rows": r"::stack(_bulk)?_kernel[<(]",
    "compact_rows": r"::compact_kernel<",
    "emit_slots_banded": r"::emit_kernel<true>",
}
# The range of a profiler trace whose device records count.  A trace's first
# graph launch loses the records of the kernels that run in about its first
# 0.35 ms (in phase 4: that frame's stamps and per-splat kernel; the rest of
# the frame and every later frame keep all theirs), whatever the time since
# the trace began; so a trace replays once before this range opens.
COUNTED_RANGE = "chip_smoke.counted"
# Passes of phases 4 and 7 over the orbit through Renderer.render: a key's
# first frame runs eager, its second captures the frame, later ones replay.
ORBIT_PASSES = 3
# The collectives of a rank's frame in a profiler trace (phase 12): NCCL's
# kernels, and the device-to-device copies that NCCL runs instead of a
# kernel for each all-gather of a one-rank group (whose in-place
# all-reduce runs nothing).
COLLECTIVE_TRACE_NAMES = {"nccl": r"(?i)nccl", "device copies": r"^memcpy|Memcpy DtoD"}


def orbit_passes(r, cams, passes):
    """``passes`` passes of Renderer ``r`` over ``cams``, each frame on the
    host clock (render reads the frame back, so the clock holds the card's
    work).  Returns a record a frame (pass, camera, how it ran, ms, its key
    and band rows, a copy of the renderer before it, the state after it,
    the image) and torch.cuda.memory_reserved() before the first pass and
    after each.  The images go into host memory touched beforehand, so that
    keeping them costs no frame a page fault."""
    import numpy as np
    import torch

    store = np.ones((passes * len(cams), r.config.screen_h, r.config.screen_w, 4), np.uint8)
    recs, reserved = [], [torch.cuda.memory_reserved()]
    for p in range(passes):
        for i, c in enumerate(cams):
            require(not r.saturated, "an adaptive Renderer saturated")
            img, rec = recorded_frame(r, c, p, i)
            store[len(recs)] = img
            recs.append(dict(rec, image=store[len(recs)]))
            del img
        reserved.append(torch.cuda.memory_reserved())
    return recs, reserved


def recorded_frame(r, c, p, i):
    """One frame of Renderer ``r`` from camera ``c`` (camera ``i`` of pass
    ``p``).  Returns (the image, a record of what eager_twins needs: how it
    ran, its host ms, its key and band rows, a copy of the renderer before
    it and the state after it)."""
    import copy

    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import renderer_state

    before = copy.copy(r)
    t0 = time.perf_counter()
    img = r.render(c)
    ms = (time.perf_counter() - t0) * 1e3
    return img, dict(
        p=p, i=i, method=r.last_method, ms=ms, key=before._key(),
        rows=None if before.band_rows is None else before.band_rows.copy(),
        before=before, after=renderer_state(r))


def eager_twins(recs, cams):
    """Every recorded frame again as the eager renderer made it
    (tests/torch_port_cases.py:eager_render): each image must equal the
    recorded one byte for byte, and the state after it the recorded state.
    Returns the eager frames' ms on the host clock (render_frame, one
    readback of the counts, the image)."""
    import numpy as np

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import eager_render, renderer_state

    ms = []
    for n, rec in enumerate(recs):
        t0 = time.perf_counter()
        img = eager_render(rec["before"], cams[rec["i"]], rec["key"], rec["rows"])
        ms.append((time.perf_counter() - t0) * 1e3)
        require(np.array_equal(img, rec["image"]),
                f"frame {n} ({rec['method']}, pass {rec['p']}, camera {rec['i']}) differs from "
                f"render_frame at key {rec['key']}")
        require(renderer_state(rec["before"]) == rec["after"],
                f"frame {n} ({rec['method']}) leaves {rec['after']}, the eager frame "
                f"{renderer_state(rec['before'])}")
    return ms


def traced_pass(r, cams, wrappers, report=None, frames=None):
    """One more pass of ``r`` over ``cams`` in a profiler trace, after one
    replay of the last camera in the same trace that is not counted
    (COUNTED_RANGE).  Every frame must replay its graph, and every kernel of
    ``wrappers`` must appear once a frame; the records of ``report`` (name
    -> regular expression) are counted too.  Where ``frames`` is a list,
    each counted frame's record (recorded_frame, with its image) is
    appended to it, for eager_twins.  Returns (records of each, device busy
    ms a frame: the sum of the counted kernel and copy records, host ms a
    frame)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    methods = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        r.render(cams[-1])
        methods.append(r.last_method)
        torch.cuda.synchronize()
        with record_function(COUNTED_RANGE):
            t0 = time.perf_counter()
            for i, c in enumerate(cams):
                if frames is None:
                    r.render(c)
                else:
                    img, rec = recorded_frame(r, c, "traced", i)
                    frames.append(dict(rec, image=img))
                methods.append(r.last_method)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / len(cams)
    require(methods == ["replay"] * (len(cams) + 1),
            f"the traced pass did not only replay: {methods}")
    device, launches = counted_records(prof)
    patterns = {**{w: TRACE_NAMES[w] for w in wrappers}, **(report or {})}
    records = {name: sum(1 for e in device if re.search(p, e.key)) for name, p in patterns.items()}
    busy = sum(e.self_device_time_total for e in device) / 1e3 / len(cams)
    if any(records[w] != len(cams) for w in wrappers):
        for name in sorted({e.key for e in device}):
            log(f"    traced: {name[:120]}")
        for w in wrappers:
            starts = [e.time_range.start for e in device if re.search(TRACE_NAMES[w], e.key)]
            log(f"    {w}: records at {starts} us")
        log(f"    graph launches at {launches} us")
        raise AssertionError(f"kernel records in a trace of {len(cams)} replayed frames: {records}")
    return records, busy, wall


def counted_records(prof):
    """The device records of a trace that start inside its COUNTED_RANGE
    (not the range's own record on the device), and the host start of each
    graph launch there (µs)."""
    from torch.autograd import DeviceType

    events = prof.events()
    opened = min(e.time_range.start for e in events if e.key == COUNTED_RANGE)
    device = [e for e in events if e.device_type == DeviceType.CUDA
              and e.key != COUNTED_RANGE and e.time_range.start >= opened]
    launches = [e.time_range.start for e in events if e.device_type == DeviceType.CPU
                and e.key == "cudaGraphLaunch" and e.time_range.start >= opened]
    return device, launches


def graphed_orbit(label, r, cams, counted):
    """Phases 4 and 7: ORBIT_PASSES passes of Renderer ``r`` over ``cams``,
    the counts of the wrappers ``counted`` set to 0 just before and read
    just after (eager frames and captures count; replays call no wrapper);
    a traced pass of replays; every frame, the traced ones too, against its
    eager twin.  Returns (records, launches, trace records, numbers for the
    log and PERF.md)."""
    import numpy as np

    for fn in counted:
        fn.launches = 0
    seen_before = set(r._visited)
    recs, reserved = orbit_passes(r, cams, ORBIT_PASSES)
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"  launches in {len(recs)} {label} frames through Renderer.render: {launches}")
    for name, count in launches.items():
        require(count >= 1, f"{name} never launched in the {label} main path")
    traced = []
    trace, busy, traced_ms = traced_pass(r, cams, [fn.__name__ for fn in counted],
                                         frames=traced)
    log(f"  traced pass of {len(cams)} replayed frames: kernel records {trace} (one a frame), "
        f"device busy {busy:.3f} ms/frame of {traced_ms:.3f} ms/frame traced")
    eager_ms = eager_twins(recs + traced, cams)[:len(recs)]
    log(f"  every graphed frame and every traced replay byte-equal to render_frame at its key "
        f"and band rows, the renderer's state equal to the eager controller's")
    two = recs[:2 * len(cams)]
    keys = [rec["key"] for rec in two]
    hits = sum(k in seen_before or k in keys[:n] for n, k in enumerate(keys))

    def mean(values):
        return float(np.mean(values)) if values else None

    by_method = {m: [rec["ms"] for rec in recs if rec["method"] == m]
                 for m in ("eager", "capture", "replay")}
    out = dict(
        ms={m: mean(v) for m, v in by_method.items()},
        frames={m: len(v) for m, v in by_method.items()},
        eager_loop_ms=mean(eager_ms), busy_ms=busy, keys=len(set(keys)),
        hit_rate=hits / len(keys), reserved_gib=[b / 2**30 for b in reserved],
        by_frame=[[rec["method"][0] + str(rec["p"]), round(rec["ms"], 3)] for rec in recs])
    log(f"  {label} Renderer.render ms/frame: first visits (eager) {out['ms']['eager']}, second "
        f"visits (capture) {out['ms']['capture']}, replays {out['ms']['replay']} "
        f"({out['frames']}); the eager render_frame loop at the same keys "
        f"{out['eager_loop_ms']:.3f}; by frame (e/c/r and pass, ms) {out['by_frame']}")
    log(f"  {label}: {out['keys']} distinct keys over two passes, hit rate {out['hit_rate']:.3f}; "
        f"memory_reserved before and after each pass "
        f"{[round(g, 3) for g in out['reserved_gib']]} GiB")
    return recs, launches, trace, out


def run_cli(dev, argv, counted):
    """cli.main(argv) with the counts of the wrappers ``counted`` set to 0
    just before; returns (the counts just after, stdout, stderr, seconds).
    On the card every counted kernel must have launched."""
    import contextlib
    import io

    from cudagaussianrenderer_torch import cli

    for fn in counted:
        fn.launches = 0
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli.main([str(a) for a in argv])
    seconds = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    log(f"  cli {' '.join(str(a) for a in argv[:2])} ...: {seconds:.1f} s, launches {launches}")
    for line in err.getvalue().splitlines():
        if "truncated" in line:
            log(f"    it said: {line}")
    # (The wrappers count launches of their kernels: none on the CPU.)
    require(dev.type != "cuda" or all(n >= 1 for n in launches.values()),
            f"cli {argv[0]}: a kernel of its path never launched: {launches}")
    return launches, out.getvalue(), err.getvalue(), seconds


def http(url, data=None, timeout=120):
    import urllib.request

    req = urllib.request.Request(url, data=data)
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def cli_and_viewer(dev, tmp, n_splats=1_000_000, size=1024):
    """Phase 10, on ``dev`` (the card; the CPU only to rehearse it small),
    its files in the directory ``tmp``: phase 11 reuses the scene's .ply and
    the COLMAP workspace.

    The CLI's own procedural scene (default scales 0.01-0.5) at 1M splats
    has about 126M candidate pairs a frame, far past the pair-list ceiling,
    so every frame of it renders truncated: it is rendered once, against
    Renderer.render.  The other checks run on phase 4's scene (the bench's
    scales, SH 3), written as a .ply as phase 8 writes it."""
    import re
    import threading
    import warnings

    import numpy as np
    import torch

    from cudagaussianrenderer_torch import RenderConfig, Renderer, cli, load_posed, random_scene
    from cudagaussianrenderer_torch.diff import ssim
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.models.scene import random_scene_arrays
    from cudagaussianrenderer_torch.ops import banded, expand, ranges, raster
    from cudagaussianrenderer_torch.ply import write_gaussian_ply
    from cudagaussianrenderer_torch.splatfile import load_scene
    from cudagaussianrenderer_torch.utils.png import read_png

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import free_port

    flat_k = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots, raster.rasterize_tiles)
    band_k = (banded.interleave_rows_padded, banded.stack_rows, banded.compact_rows,
              expand.emit_slots_banded, ranges.tile_edges, raster.rasterize_tiles)

    def run(argv, counted=flat_k):
        launches, out, err, _ = run_cli(dev, [*argv, *common(argv[0])], counted)
        return launches, out, err

    def common(command):
        flags = ["--device", dev.type]
        return flags if command == "compare" else flags + ["--size", str(size)]

    config = RenderConfig(screen_size=size)
    # The CLI's procedural scene: its first frame overflows the fresh
    # Renderer's list, so the CLI renders again at the grown capacity,
    # as a Renderer's second frame does.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(["render", "--procedural", n_splats, "--sh-degree", 3, "-o", tmp / "proc.png"])
        pscene = random_scene(n_splats, seed=0, sh_degree=3, device=dev)
        r = Renderer(pscene, config, device=dev)
        pcam = Camera(aspect=1.0).framed(pscene.bounds_min, pscene.bounds_max)
        r.render(pcam)
        want = r.render(pcam)
    del pscene, r
    got = read_png(tmp / "proc.png")
    require(np.array_equal(got, want),
            "cli render --procedural differs from Renderer.render of the same scene")
    ceiling = sum("capacity ceiling" in str(w.message) for w in caught)
    log(f"  render --procedural {n_splats} --sh-degree 3: byte-equal to a Renderer's second "
        f"frame ({ceiling} ceiling warnings)")

    # Phase 4's scene as a .ply of raw values, and written back by the
    # CLI's scene writer (activations inverted) for eval.
    a = random_scene_arrays(n_splats, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                            sh_degree=3)
    ply = tmp / "scene.ply"
    with np.errstate(divide="ignore"):
        write_gaussian_ply(
            ply, a["means"], np.log(a["scales"]), a["quats_xyzw"][:, [3, 0, 1, 2]],
            np.log(a["opacities"]) - np.log1p(-a["opacities"]), a["sh"][:, 0, :],
            np.transpose(a["sh"][:, 1:, :], (0, 2, 1)))
    del a
    scene = load_scene(ply, device=dev)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)

    run(["render", ply, "-o", tmp / "flat.png"])
    flat = read_png(tmp / "flat.png")
    want = Renderer(scene, config, device=dev).render(cam)
    require(np.array_equal(flat, want), "cli render differs from Renderer.render")
    log("  render scene.ply: byte-equal to Renderer.render of the loaded scene")
    run(["render", ply, "--bands", 16, "-o", tmp / "banded.png"], counted=band_k)
    check("render --bands 16 vs render", read_png(tmp / "banded.png"), flat)

    ws = tmp / "ws"
    run(["orbit", ply, "-n", 4, "--transforms", "--colmap", "-o", ws])
    ds = load_posed(ws)
    from cudagaussianrenderer_torch.models.camera import orbit_cameras
    ocams = orbit_cameras(scene.bounds_min, scene.bounds_max, 4)
    require(len(ds.cameras) == 4 and ds.images.shape == (4, size, size, 3),
            f"load_posed: {len(ds.cameras)} cameras, images {ds.images.shape}")
    for got_c, want_c in zip(ds.cameras, ocams):
        gd, wd = got_c.camera_data(), want_c.camera_data()
        require(all(np.allclose(gd[k], wd[k], rtol=1e-5, atol=1e-5) for k in gd),
                "a camera of the COLMAP workspace differs from the orbit's")
    log(f"  orbit -n 4 --transforms --colmap: load_posed gives 4 cameras equal to the "
        f"orbit's (within 1e-5), {ds.points_xyz.shape[0]} SfM points")
    from cudagaussianrenderer_torch import dataset
    tcams, _ = dataset.load_dataset(ws)
    for got_c, want_c in zip(tcams, ocams):
        gd, wd = got_c.camera_data(), want_c.camera_data()
        require(all(np.allclose(gd[k], wd[k], rtol=1e-5, atol=1e-5) for k in gd),
                "a camera of transforms.json differs from the orbit's")
    del ds

    gt = tmp / "written.ply"
    cli._write_scene(scene, gt)
    _, _, err = run(["eval", gt, "--dataset", ws])
    m = re.search(r"PSNR ([0-9.]+|inf) dB, SSIM ([0-9.]+)", err)
    require(m is not None, f"eval printed no scores: {err}")
    psnr, ss = float(m.group(1)), float(m.group(2))
    log(f"  eval of the written-back scene against the orbit: PSNR {psnr} dB, SSIM {ss}")
    require(psnr > 40 and ss > 0.99, f"eval: PSNR {psnr}, SSIM {ss}")

    f0, f1 = ws / "images" / "frame_0000.png", ws / "images" / "frame_0001.png"
    _, out, _ = run(["compare", f0, f0], counted=())
    same = json.loads(out)
    require(same["max_delta"] == 0 and same["ssim"] == 1.0, f"compare of a frame: {same}")
    _, out, _ = run(["compare", f0, f1], counted=())
    diff = json.loads(out)
    log(f"  compare frame 0 with itself: {same}; with frame 1: {diff}")
    try:
        run(["compare", f0, f1, "--max-delta", diff["max_delta"] - 1], counted=())
        raise AssertionError("compare did not exit past --max-delta")
    except SystemExit as e:
        require("exceeds" in str(e), f"compare exited with {e}")

    port = free_port()
    base = f"http://127.0.0.1:{port}"
    for fn in flat_k:
        fn.launches = 0
    server = threading.Thread(
        target=cli.main, daemon=True,
        args=(["serve", str(ply), "--port", str(port), "--fps-cap", "1000"]
              + common("serve"),))
    t0 = time.perf_counter()
    server.start()
    for _ in range(600):
        try:
            page = http(base + "/", timeout=5).decode()
            break
        except OSError:
            server.join(0.1)
    try:
        require("/stream" in page, "GET / is not the viewer page")
        img0 = read_png(http(base + "/frame.png"))
        stats0 = json.loads(http(base + "/stats"))

        def wait_frames(n):
            target = json.loads(http(base + "/stats"))["frame"] + n
            deadline = time.monotonic() + 60
            while json.loads(http(base + "/stats"))["frame"] < target:
                require(time.monotonic() < deadline, "the viewer's loop stalled")
                time.sleep(0.01)

        for pointer, buttons in (([size // 10, size // 2], "left"),
                                 ([size * 9 // 10, size // 2], "left"),
                                 ([size * 9 // 10, size // 2], "none")):
            http(base + "/input", json.dumps({"pointer": pointer, "buttons": buttons}).encode())
            wait_frames(2)
        img1 = read_png(http(base + "/frame.png"))
        stats1 = json.loads(http(base + "/stats"))
    finally:
        http(base + "/quit", b"{}")
    server.join(120)
    require(not server.is_alive(), "serve did not stop on /quit")
    moved = float((np.abs(img0.astype(int) - img1.astype(int)) > 4).any(axis=-1).mean())
    launches = {fn.__name__: fn.launches for fn in flat_k}
    log(f"  serve: {stats1['frame'] + 1} frames in {time.perf_counter() - t0:.1f} s, stats "
        f"{stats1}; first frame {img0.shape}, {moved:.3f} of pixels moved after a drag; "
        f"launches {launches}")
    require(img0.shape == (size, size, 4) and img0[..., 3].max() == 255,
            "the viewer's frame is blank or misshapen")
    require(stats0["capacity"] > 0 and stats1["pairs"] > 0, f"viewer stats {stats1}")
    require(moved > 0.01, "the drag did not move the view")
    require(dev.type != "cuda" or all(n >= 1 for n in launches.values()),
            f"serve launches {launches}")

    # diff.ssim with TF32 allowed (phase 1 turned it off): float32 on the card.
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    rng = np.random.default_rng(0)
    x = torch.from_numpy(flat[..., :3].astype(np.float32) / 255.0)
    y = torch.from_numpy(np.clip(flat[..., :3] / 255.0 + rng.normal(0, 0.02, flat[..., :3].shape),
                                 0, 1).astype(np.float32))
    half = torch.full((size, size, 3), 0.5)
    worst = 0.0
    for u, v in ((x, y), (x, x), (half, half), (half, y)):
        got_s = float(ssim(u.to(dev), v.to(dev)))
        worst = max(worst, abs(got_s - float(ssim(u, v))))
        require(-1.0 <= got_s <= 1.0, f"ssim {got_s} outside [-1, 1]")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  ssim on the card with TF32 allowed vs the CPU: max |diff| {worst:.2e} (bound 1e-5)")
    require(worst <= 1e-5, f"ssim on the card differs from the CPU by {worst}")


def diff_card_vs_cpu(dev):
    """Phase 11, part 1: the differentiable path on ``dev`` against the same
    functions on the CPU, at the selfcheck's scale (128x128, 350 splats,
    SH 3): build_structure exactly; render_diff's image and depth, and the
    gradient of every DiffSplats leaf and of the CameraDeltas and Exposure
    of a fit step's loss, within DIFF_IMG_TOL and DIFF_GRAD_RTOL."""
    import numpy as np
    import torch

    from cudagaussianrenderer_torch import RenderConfig, diff, random_scene
    from cudagaussianrenderer_torch.models.camera import Camera

    config = RenderConfig(screen_size=128)
    scene = random_scene(350, seed=3, sh_degree=3, device="cpu")
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max).camera_data()
    cpu = torch.device("cpu")
    # A capacity that is a whole number of emit grains on both devices, so
    # that the two pair lists have the same length.
    capacity = 16 * 4096
    params = diff.from_scene(scene)
    got = diff.build_structure(diff.tree_map(lambda a: a.to(dev), params), cam, config, capacity,
                               device=dev)
    want = diff.build_structure(params, cam, config, capacity, device=cpu)
    for name, g, w in zip(want._fields, got, want):
        require(torch.equal(g.cpu(), w),
                f"build_structure on the card: {name} differs from the CPU")
    k_max = max(8, diff.max_tile_count(want))
    log(f"  build_structure, card vs CPU: sids, starts, counts and num_candidates equal "
        f"({int(want.num_candidates)} candidates, k_max {k_max})")

    rng = np.random.default_rng(0)
    weights = torch.from_numpy(rng.normal(size=(128, 128, 3)).astype(np.float32))
    extras = (diff.CameraDeltas(dr=torch.tensor([0.01, -0.02, 0.015]),
                                dt=torch.tensor([0.05, 0.02, -0.03])),
              diff.Exposure(gain=torch.tensor([1.1, 0.9, 1.0]),
                            bias=torch.tensor([0.01, 0.0, -0.02])))

    def grads(d):
        p = diff.tree_map(lambda a: a.detach().to(d).requires_grad_(True), params)
        ex = diff.tree_map(lambda a: a.detach().to(d).requires_grad_(True), extras)
        c = diff.apply_camera_delta(diff._camera(cam, d), ex[0].dr, ex[0].dt)
        st = diff.tree_map(lambda a: a.to(d), want)
        image, depth, _ = diff.render_diff(p, c, config, capacity, k_max, structure=st,
                                           return_depth=True, device=d)
        rgb = image[..., :3] * ex[1].gain + ex[1].bias
        loss = torch.sum(rgb * weights.to(d)) + torch.sum(depth)
        leaves = diff.tree_leaves(p) + diff.tree_leaves(ex)
        g = torch.autograd.grad(loss, leaves, allow_unused=True)
        g = [torch.zeros_like(x) if gi is None else gi for gi, x in zip(g, leaves)]
        return image.detach().cpu(), depth.detach().cpu(), [gi.cpu() for gi in g]

    img_d, dep_d, g_d = grads(dev)
    img_c, dep_c, g_c = grads(cpu)
    err_img = float((img_d - img_c).abs().max())
    err_dep = float((dep_d - dep_c).abs().max())
    log(f"  render_diff, card vs CPU on the CPU's structure: image max |diff| {err_img:.2e}, depth "
        f"{err_dep:.2e} (bound {DIFF_IMG_TOL:g})")
    require(err_img <= DIFF_IMG_TOL and err_dep <= DIFF_IMG_TOL, "render_diff on the card differs")
    names = [f for f in params._fields if getattr(params, f) is not None] + ["dr", "dt", "gain",
                                                                             "bias"]
    worst = []
    for name, a, b in zip(names, g_d, g_c):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        worst.append(f"{name} {err / max(scale, 1e-30):.1e}")
        require(err <= DIFF_GRAD_RTOL * scale, f"gradient of {name} on the card: max |diff| {err} "
                f"against max |grad| {scale}")
    log(f"  gradients, card vs CPU, max |diff| / max |grad| (bound {DIFF_GRAD_RTOL:g}): "
        + ", ".join(worst))


def diff_and_fit(dev, tmp, size=1024, fit_steps=FIT_STEPS, densify_every=FIT_DENSIFY_EVERY,
                 resume_steps=FIT_RESUME_STEPS, refine_steps=FIT_REFINE_STEPS,
                 capacity=FIT_CAPACITY):
    """Phase 11, parts 2-4, on ``dev`` (the card; the CPU only to rehearse it
    small), on phase 10's files in ``tmp``: render --depth of the scene's
    .ply with render_diff's RGB against Renderer.render; fit of the COLMAP
    workspace from its SfM points (the 3DGS recipe), resumed from its
    checkpoint, then with pose and exposure refinement; the numbers."""
    import re

    import numpy as np
    import torch

    from cudagaussianrenderer_torch import RenderConfig, Renderer, diff, load_posed
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.ops import expand, ranges, raster
    from cudagaussianrenderer_torch.render import round_capacity
    from cudagaussianrenderer_torch.splatfile import load_scene
    from cudagaussianrenderer_torch.utils.png import read_png

    card = card_line() if dev.type == "cuda" else "cpu"
    flags = ["--device", dev.type]
    struct_k = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots)
    flat_k = struct_k + (raster.rasterize_tiles,)
    ply, ws = tmp / "scene.ply", tmp / "ws"

    # render --depth at full width, and render_diff's RGB of that view.
    run_cli(dev, ["render", ply, "-o", tmp / "c.png", "--depth", tmp / "d.png", "--size", size,
                  *flags], flat_k)
    dimg = read_png(tmp / "d.png")
    require(dimg.shape == (size, size, 3) and (dimg[..., 0] == dimg[..., 1]).all()
            and (dimg[..., 0] == dimg[..., 2]).all() and dimg.min() != dimg.max(),
            f"the depth PNG is misshapen, not grey or constant: {dimg.shape}")
    log(f"  render --depth: {dimg.shape} grey, levels {int(dimg.min())}..{int(dimg.max())}")
    scene = load_scene(ply, device=dev)
    config = RenderConfig(screen_size=size)
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    renderer = Renderer(scene, config, device=dev)
    frame = renderer.render(cam)
    t0 = time.perf_counter()
    with torch.no_grad():
        params = diff.from_scene(scene)
        cap = round_capacity(renderer.capacity, dev)
        st = diff.build_structure(params, cam.camera_data(), config, cap, device=dev)
        k_max = diff.max_tile_count(st)
        image, _ = diff.render_diff(params, cam.camera_data(), config, cap, k_max, structure=st,
                                    device=dev)
        rgb = (image[..., :3] * 255.0 + 0.5).to(torch.uint8).cpu().numpy()
    log(f"  render_diff at {size}x{size}, {scene.count} splats: k_max {k_max}, "
        f"{int(st.num_candidates)} candidates, {time.perf_counter() - t0:.2f} s")
    check("render_diff rgb vs Renderer.render", rgb, frame[..., :3])
    del params, st, image, scene, renderer

    # fit: the 3DGS recipe from the SfM points, with densify and holdout.
    ck = tmp / "fit.npz"
    fit_args = ["fit", "--dataset", ws, "--init", "points", "--sh-degree", 3, "--optimizer",
                "3dgs", "--densify-every", densify_every, "--holdout", 2, "--checkpoint", ck,
                "--checkpoint-every", densify_every, "--capacity", capacity, *flags]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    launches, _, err, secs = run_cli(
        dev, [*fit_args, "--steps", fit_steps, "-o", tmp / "fitted.ply"], flat_k)
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    for line in err.splitlines():
        if line.startswith(("dataset:", "holdout", "init:", "fitting", "density", "fit:", "step")):
            log(f"    {line}")
    require("exceed the structure capacity" not in err, "fit: the pair list saturated")
    m = re.search(r"fitting (\d+) splats, capacity (\d+), k_max (\d+)", err)
    n0, capacity, fit_kmax = (int(x) for x in m.groups())
    m = re.search(r"fit: loss ([0-9.]+) -> ([0-9.]+)", err)
    first, last = float(m.group(1)), float(m.group(2))
    require(last < first, f"fit: the loss rose from {first} to {last}")
    m = re.search(r"density control: (\d+) -> (\d+) splats", err)
    require(m is not None and m.group(1) != m.group(2), "fit: densify left the count unchanged")
    n1 = int(m.group(2))
    m = re.search(r"holdout eval \(every 2th view\) \((\d+) views\): PSNR ([0-9.]+|inf) dB, "
                  r"SSIM ([0-9.-]+)", err)
    require(m is not None, "fit: no holdout PSNR/SSIM printed")
    log(f"  holdout ({m.group(1)} views): PSNR {m.group(2)} dB, SSIM {m.group(3)}")
    fitted = load_scene(tmp / "fitted.ply", device=dev)
    fimg = Renderer(fitted, config, device=dev).render(cam)
    require(fitted.count == n1 and fitted.sh_degree == 3 and fimg[..., 3].max() == 255
            and fimg[..., :3].max() > 0, "the fitted .ply does not render")
    log(f"  fitted .ply: {fitted.count} splats, SH {fitted.sh_degree}, renders through Renderer")
    del fitted
    ds = load_posed(ws)
    init = diff.init_from_points(ds.points_xyz, ds.points_rgb, sh_degree=3, device=dev)
    view = ds.cameras[1].camera_data()
    st = diff.build_structure(init, view, config, capacity, device=dev)
    candidates = int(st.num_candidates)
    # Where a fit step's time goes, on that view (the loss's L1 term alone):
    # the structure, render_diff's forward, the backward and tx_3dgs's
    # update, each between synchronises (the last of 3 runs), and the
    # forward and backward at the JAX package's block of 64 tiles, which the
    # default block of tiles was chosen against; then the kernels and copies
    # of one forward and backward in a profiler trace.
    from cudagaussianrenderer_torch.bench import device_busy_ms

    target = torch.from_numpy(ds.images[1]).to(dev)
    tx = diff.tx_3dgs(8.0, 100)
    opt = tx.init(init)

    def render_and_backward(tile_batch=None):
        p = diff.tree_map(lambda a: a.detach().requires_grad_(True), init)
        image, _ = diff.render_diff(p, view, config, capacity, fit_kmax, structure=st,
                                    tile_batch=tile_batch, device=dev)
        loss = torch.abs(image[..., :3] - target).mean()
        sync(dev)
        t1 = time.perf_counter()
        loss.backward()
        sync(dev)
        return p, time.perf_counter() - t1

    for tile_batch in (diff.TILE_BATCH_CPU, None):
        for _ in range(3):
            sync(dev)
            t0 = time.perf_counter()
            st = diff.build_structure(init, view, config, capacity, device=dev)
            sync(dev)
            t1 = time.perf_counter()
            p, t_bwd = render_and_backward(tile_batch)
            t2 = time.perf_counter()
            grads = diff.tree_map(lambda a: torch.zeros_like(a) if a.grad is None else a.grad, p)
            upd, _ = tx.update(grads, opt, init)
            diff.apply_updates(init, upd)
            sync(dev)
            t3 = time.perf_counter()
        log(f"  fit step on the first view, tile_batch {tile_batch or diff.TILE_BATCH_CUDA} "
            f"[{card}]: build_structure {1e3 * (t1 - t0):.1f} ms, render_diff "
            f"{1e3 * (t2 - t1 - t_bwd):.1f} ms, backward {1e3 * t_bwd:.1f} ms, tx_3dgs "
            f"{1e3 * (t3 - t2):.1f} ms; {1e3 * (t3 - t0):.1f} ms in all")
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sync(dev)
        t0 = time.perf_counter()
        render_and_backward()
        wall = time.perf_counter() - t0
        busy = device_busy_ms(render_and_backward)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            render_and_backward()
        kernels = sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        log(f"  render_diff + backward [{card}]: {1e3 * wall:.1f} ms between synchronises, "
            f"device busy {busy} ms in a trace, idle share "
            + ("not measured" if busy is None else f"{1 - busy / (1e3 * wall):.3f}")
            + f"; {kernels} kernel and copy records in a trace")
    del grads, upd, opt
    graphed = graphed_steps(dev, card, init, view, ds.images[1], config, capacity, fit_kmax)
    del ds, init, st, p, target
    m = re.search(r"in [0-9.]+s \(([0-9.]+) ms/step", err)
    fit_ms = float(m.group(1))
    per_step = {k: v / fit_steps for k, v in launches.items()}
    fit_graphs = graph_report(dev, err, "fit")
    # K1-K3 run in every eager structure graph body and twice in a captured
    # one (the warm-up and the capture); a replay calls no wrapper.
    s_runs = fit_graphs["structure"]
    require(dev.type != "cuda" or all(
        launches[fn.__name__] >= s_runs.get("eager", 0) + 2 * s_runs.get("capture", 0)
        for fn in struct_k), f"K1-K3 were not launched by every structure body: {launches}")

    # Resume to a later step: it starts at the checkpoint's step.
    _, _, err, _ = run_cli(dev, [*fit_args, "--resume", "--steps", fit_steps + resume_steps,
                                     "-o", tmp / "resumed.ply"], flat_k)
    require(f"at step {fit_steps}" in err, f"resume did not start at step {fit_steps}: {err[:400]}")
    m = re.search(r"in [0-9.]+s \(([0-9.]+) ms/step", err)
    resume_ms = float(m.group(1))
    resume_graphs = graph_report(dev, err, "resume")
    log(f"  resumed at step {fit_steps}, {resume_steps} steps: {resume_ms} ms/step")

    # Pose and exposure refinement with an export of the refined poses.
    _, _, err, _ = run_cli(dev, [
        "fit", "--dataset", ws, "--init", "points", "--sh-degree", 3, "--steps", refine_steps,
        "--refine-poses", "--refine-exposure", "--export-poses", tmp / "poses.json",
        "--capacity", capacity, "-o", tmp / "refined.ply", *flags], struct_k)
    require("pose refinement:" in err and "exposure:" in err, "no refinement report")
    frames = json.loads((tmp / "poses.json").read_text())["frames"]
    require(len(frames) == 4, f"export-poses wrote {len(frames)} frames")
    for line in err.splitlines():
        if line.startswith(("pose refinement", "exposure", "fit:")):
            log(f"    {line}")

    remat = size * size * fit_kmax * 16 > 2 << 30
    log(f"  fit numbers [{card}]: {fit_ms} ms/step over the first {fit_steps} steps (densify "
        f"and checkpoints included; the command {secs:.1f} s with loading and holdout eval), "
        f"{resume_ms} ms/step resumed; peak memory {peak / 2**30:.2f} GiB; {n0} -> {n1} "
        f"splats, capacity {capacity}, {candidates} candidates on the first step's view, "
        f"k_max {fit_kmax}, remat {remat}")
    log(f"  fit graphs [{card}]: fit {json.dumps(fit_graphs)}; resumed "
        f"{json.dumps(resume_graphs)}; graphed step on the view {json.dumps(graphed)}")
    log(f"  launches per fit step [{card}]: " + ", ".join(
        f"{k} {v:.2f}" for k, v in per_step.items() if k != "rasterize_tiles")
        + f" (of {fit_steps} steps, with the k_max structure and the holdout frames); "
        f"rasterize_tiles {launches['rasterize_tiles']} for the 2 holdout frames")


def graph_report(dev, err, what):
    """The CLI fit's "fit graphs:" line as a dict.  On the card its step and
    structure graphs must have replayed."""
    import re

    m = re.search(r"fit graphs: (\d+) keys, (\d+) graphs held, structure \(([^)]*)\), step "
                  r"\(([^)]*)\), (\d+) cache drops, chunk-tiles (\d+) run / (\d+) exact"
                  r"(?:, memory_reserved (\d+) MiB)?", err)
    require(m is not None, f"{what}: no graph report")
    log(f"    {m.group(0)}")

    def runs(text):
        return {k: int(v) for k, v in (x.split() for x in text.split(", ") if x)}

    out = dict(keys=int(m.group(1)), graphs=int(m.group(2)), structure=runs(m.group(3)),
               step=runs(m.group(4)), resets=int(m.group(5)), chunk_tiles_run=int(m.group(6)),
               chunk_tiles_exact=int(m.group(7)),
               memory_reserved_mib=None if m.group(8) is None else int(m.group(8)))
    require(dev.type != "cuda" or (out["structure"].get("replay", 0) >= 1
                                   and out["step"].get("replay", 0) >= 1),
            f"{what}: its steps never replayed a graph: {out}")
    return out


def graphed_steps(dev, card, init, view, target, config, capacity, k_max):
    """Phase 11: the fit's step as CUDA graphs (diff.FitStepGraphs) against
    its eager twin on the fit's first view from the same state (tx_3dgs,
    the 3DGS loss, pose and exposure refinement, the SH warm-up):
    GRAPH_CHECK_STEPS steps each (eager, capture, replays), every loss,
    candidate count, gradient norm and state leaf within GRAPHED_STEP_TOL;
    then GRAPH_WARM_STEPS more and GRAPH_TIMED_STEPS steady steps of each
    on the host clock, two traced (device busy, idle share) and one more
    (kernel and copy records a step), and
    the graphed step's keys, captures and memory_reserved."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import fit_step_pair, run_step_pair

    from cudagaussianrenderer_torch.tools.measure import method_of, step_methods, timed_steps

    graphed, eager, inputs = fit_step_pair(init, [view], [target], config, capacity, k_max, dev)
    t0 = time.perf_counter()
    records, diffs = run_step_pair(graphed, eager, inputs, GRAPH_CHECK_STEPS)
    check_s = time.perf_counter() - t0
    for i, (method, lg, le, cg, ce, dn) in enumerate(records):
        require(abs(lg - le) <= GRAPHED_STEP_TOL and cg == ce and dn <= GRAPHED_STEP_TOL,
                f"graphed fit step {i} ({method}): loss {lg} against {le}, candidates {cg} "
                f"against {ce}, gradient norms off by {dn}")
    require(max(diffs) <= GRAPHED_STEP_TOL, f"graphed fit state off the eager: {diffs}")
    methods = [r[0] for r in records]
    require(dev.type != "cuda" or methods.count("replay") >= 1,
            f"the graphed fit step never replayed: {methods}")
    log(f"  graphed fit step vs eager, {GRAPH_CHECK_STEPS} steps ({', '.join(methods)}) in "
        f"{check_s:.1f} s: losses, candidates, gradient norms and {len(diffs)} state leaves "
        f"equal (max |diff| {max(diffs):g}, bound {GRAPHED_STEP_TOL:g})")
    rows, tgts = inputs
    out = dict(check_methods=methods, remat=config.screen_w * config.screen_h * k_max * 16
               > 2 << 30)
    for name, step in (("eager", eager), ("graphed", graphed)):
        def run(i, step=step):
            return step.step(rows[0], tgts[0], None, 0, 127)[0]

        for i in range(GRAPH_WARM_STEPS):
            float(run(i))
        before = dict(step.methods["step"])
        timing = timed_steps(dev, run, GRAPH_TIMED_STEPS)
        ran = step_methods(step, before)
        if dev.type == "cuda":
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                float(run(0))
            timing["records"] = sum(e.count for e in prof.key_averages()
                                    if e.device_type == DeviceType.CUDA)
        out[name] = dict(timing, method=method_of(ran))
    rep = graphed.report()
    out.update(keys=rep["keys"], captures=rep["step"].get("capture", 0) + rep["structure"].get(
        "capture", 0), memory_reserved=rep.get("memory_reserved"))
    log(f"  graphed fit step [{card}]: " + json.dumps(out))
    require(dev.type != "cuda" or ran.get("replay", 0) >= 1,
            f"the timed graphed steps never replayed: {out['graphed']}")
    return out


def multi_device_rank(ws, n_splats, size, dp_capacity):
    """Phase 12(b): the one rank of a world-size-1 NCCL group that
    parallel.launch.spawn starts (gloo on the CPU, to rehearse it small).
    On phase 4's scene (``n_splats``, SH 3, ``size``²) and cameras:
    ORBIT_PASSES passes of DistributedRenderer.render over the cameras (a
    key's first frame eager under the sync debug mode "error", its second
    captured as one CUDA graph with its collectives, later ones replayed;
    K1-K4 counted), every frame against Renderer.render through the plain
    version of the per-splat kernel, and Renderer.render itself within
    SHARDED_LEVELS of that; the eager frame
    loop at the same key; a traced pass of replays (K1-K4 and the
    collectives' records); render_batch and render_frames_sharded on a 1x1
    mesh; the loopback times of the frame's two collectives; then DP_STEPS
    fit_dp steps on phase 10's COLMAP views (``ws``) against the same steps
    by hand.  Returns the numbers, for phase 12 to check and print."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cudagaussianrenderer_torch import RenderConfig, Renderer, diff, load_posed
    from cudagaussianrenderer_torch import orbit_cameras, random_scene
    from cudagaussianrenderer_torch import render as render_module
    from cudagaussianrenderer_torch.ops import expand, ranges, raster, splat
    from cudagaussianrenderer_torch.parallel import (
        DistributedRenderer, fit_dp, make_mesh, make_mesh_2d, render_frames_sharded,
        stack_cameras,
    )
    from cudagaussianrenderer_torch.parallel.distributed import GATHER_ROWS, _gather_tiled
    from cudagaussianrenderer_torch.render import camera_array

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_cases import anisotropic, hand_steps, leaf_rel_diffs

    mesh = make_mesh()
    dev = mesh.device
    cuda = dev.type == "cuda"
    out = {"device": str(dev), "backend": str(dist.get_backend()),
           "world": dist.get_world_size()}
    scene = random_scene(n_splats, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                         sh_degree=3, device=dev)
    config = RenderConfig(screen_size=size)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 8)

    def frames_of(columns):
        # Renderer.render over the cameras with render's per-splat stage set
        # to ``columns``.
        kernel = render_module.splat_columns
        render_module.splat_columns = columns
        try:
            ref = Renderer(scene, config, device=dev)
            ref.render(cams[0])
            return [ref.render(c) for c in cams]
        finally:
            render_module.splat_columns = kernel

    want = frames_of(lambda s, cam, cfg, row_band=None:
                     splat._splat_columns_torch(s, cam, cfg, row_band))
    out["levels"] = max(int(np.abs(got.astype(np.int16) - w).max())
                        for got, w in zip(frames_of(splat.splat_columns), want))
    dr = DistributedRenderer(scene, config, mesh=mesh)
    dr.render(cams[0])  # warm-up: sizes the per-rank capacity from its candidates
    counted = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    sync(dev)
    seen_before = set(dr._visited)
    for fn in counted:
        fn.launches = 0
    reserved = [torch.cuda.memory_reserved() if cuda else 0]
    recs = []
    for p in range(ORBIT_PASSES):
        for i, c in enumerate(cams):
            key = dr._key()
            t0 = time.perf_counter()
            img = dr.render(c)
            ms = (time.perf_counter() - t0) * 1e3
            recs.append(dict(p=p, i=i, method=dr.last_method, ms=ms, key=key,
                             equal=bool(np.array_equal(img, want[i]))))
        reserved.append(torch.cuda.memory_reserved() if cuda else 0)
    out["launches"] = {fn.__name__: fn.launches for fn in counted}
    out["capacity"] = dr.capacity
    out["frames_equal"] = sum(rec["equal"] for rec in recs)
    out["frames"] = len(recs)
    by_method = {m: [rec["ms"] for rec in recs if rec["method"] == m]
                 for m in ("eager", "capture", "replay")}
    out["ms"] = {m: float(np.mean(v)) if v else None for m, v in by_method.items()}
    out["by_method"] = {m: len(v) for m, v in by_method.items()}
    out["by_frame"] = [[rec["method"][0] + str(rec["p"]), round(rec["ms"], 3)] for rec in recs]
    keys = [rec["key"] for rec in recs[:2 * len(cams)]]
    out["keys"] = len(set(keys))
    out["hit_rate"] = sum(k in seen_before or k in keys[:n] for n, k in enumerate(keys)) / len(keys)
    out["reserved_gib"] = [b / 2**30 for b in reserved]

    # The eager frame loop at the same key: the rank's frame from Python,
    # the counts and the frame read back, as render does.
    key, eager_ms = dr._key(), []
    for c in cams:
        t0 = time.perf_counter()
        dr._camera.copy_(torch.from_numpy(camera_array(c.camera_data())))
        img, counts = dr._frame(key)
        counts.cpu()
        img.cpu().numpy()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    out["eager_loop_ms"] = float(np.mean(eager_ms))
    if cuda:
        trace, busy, traced_ms = traced_pass(
            dr, cams, [fn.__name__ for fn in counted], report=COLLECTIVE_TRACE_NAMES)
        out.update(trace=trace, busy_ms=busy, traced_ms=traced_ms,
                   idle_share_replayed=1 - busy / out["ms"]["replay"],
                   idle_share_eager_loop=1 - busy / out["eager_loop_ms"])
    batch = dr.render_batch(cams)
    out["batch_equal"] = sum(bool(np.array_equal(batch[i], w)) for i, w in enumerate(want))
    imgs, _ = render_frames_sharded(dr.scene, stack_cameras(cams), config, dr.capacity,
                                    make_mesh_2d(1, 1))
    imgs = imgs.cpu().numpy()
    out["mesh_1x1_equal"] = sum(bool(np.array_equal(imgs[i], w)) for i, w in enumerate(want))
    padded = dr.scene.padded_count
    del dr, batch, imgs, scene

    # The frame's collectives at their sizes: the all-gather of the packed
    # clip buffer and the all-reduce of a frame; on one rank a loopback.
    packed = torch.zeros((GATHER_ROWS, padded), device=dev)
    frame = torch.zeros((config.screen_h, config.screen_w, 4), dtype=torch.uint8, device=dev)
    for key, fn in (("loopback_all_gather_ms", lambda: _gather_tiled(packed, mesh, "tiles", 1)),
                    ("loopback_all_reduce_ms", lambda: dist.all_reduce(frame))):
        out[key] = cuda_ms(fn, 20) if dev.type == "cuda" else None
    del packed, frame
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # fit_dp against the same steps by hand, on phase 10's views.
    ds = load_posed(ws)
    fcfg = RenderConfig(screen_size=ds.images.shape[2], screen_height=ds.images.shape[1])
    init = anisotropic(diff.init_from_points(ds.points_xyz, ds.points_rgb, sh_degree=3,
                                             device=dev))
    views = [c.camera_data() for c in ds.cameras]
    targets = list(ds.images)
    k_max = max(128, 2 * max(diff.max_tile_count(
        diff.build_structure(init, v, fcfg, dp_capacity, device=dev)) for v in views))
    hand_steps(init, views, targets, fcfg, dp_capacity, k_max, 1, dev)  # warm-up
    sync(dev)
    t0 = time.perf_counter()
    hand, hand_losses = hand_steps(init, views, targets, fcfg, dp_capacity, k_max, DP_STEPS, dev)
    sync(dev)
    t1 = time.perf_counter()
    fitted, dp_losses = fit_dp(init, views, targets, fcfg, capacity=dp_capacity, k_max=k_max,
                               mesh=make_mesh(axis="dp"), steps=DP_STEPS)
    sync(dev)
    out["hand_s_per_step"] = (t1 - t0) / DP_STEPS
    out["fit_dp_s_per_step"] = (time.perf_counter() - t1) / DP_STEPS
    out["fit_dp"] = dict(splats=int(init.means.shape[-1]), k_max=k_max, views=len(views),
                         size=[fcfg.screen_w, fcfg.screen_h],
                         losses=[float(x) for x in dp_losses], hand_losses=hand_losses,
                         leaf_rel=leaf_rel_diffs(fitted, hand))
    return out


def multi_device(dev, scene, cams, frames, config, capacity, tmp, card):
    """Phase 12, on ``dev`` (the card; the CPU only to rehearse it small, without
    (c)).  ``scene``, ``cams``, ``frames`` and ``capacity`` are phase 4's
    (its padded scene, cameras, Renderer frames and settled capacity); ``tmp``
    holds phase 10's files.  (a) render_band of every
    band of BAND_COUNTS balanced bands on every camera: the bands' pairs sum
    to the flat frame's, and the summed frame meets the image rule against
    phase 4's; (b) multi_device_rank in a world-size-1 NCCL group; (c) the
    projected N-card frame.  Returns the multi_device JSON object."""
    import dataclasses
    import functools

    import numpy as np
    import torch

    from cudagaussianrenderer_torch.parallel import launch, render_band
    from cudagaussianrenderer_torch.parallel.distributed import GATHER_ROWS, render_band_tensors
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import (
        CAMERA_FLOATS, camera_array, camera_tensors, camera_views, capture_frame,
        render_frame, round_capacity, run_sync_free,
    )
    from cudagaussianrenderer_torch.ops.projection import project_splats

    bcfg = dataclasses.replace(config, balanced_bands=True)
    cds = [c.camera_data() for c in cams]
    flat_pairs = [int(render_frame(scene, cd, config, capacity, device=dev)[1]["num_pairs"])
                  for cd in cds]
    result = {"card": card, "scene": f"{scene.count} splats SH {scene.sh_degree} (padded "
              f"{scene.padded_count}), {config.screen_w}x{config.screen_h}, {len(cams)} cameras"}

    # (a) every band of every band count: the band's device part
    # (render_band_tensors over a static camera) eager under the sync debug
    # mode "error" on camera 0, captured as a CUDA graph, and replayed for
    # every camera (on the CPU, to rehearse it, eager for every camera).
    cuda = dev.type == "cuda"
    t0 = time.perf_counter()
    table = torch.from_numpy(np.stack([camera_array(cd) for cd in cds])).to(dev)
    camera = torch.zeros(CAMERA_FLOATS, dtype=torch.float32, device=dev)
    views = camera_views(camera)
    pool = torch.cuda.graph_pool_handle() if cuda else None
    bands = {}
    for n in BAND_COUNTS:
        totals = [torch.zeros(f.shape, dtype=torch.int32, device=dev) for f in frames]
        pairs = [0] * len(cams)
        worst = None
        for d in range(n):
            frame = functools.partial(render_band_tensors, scene, views, bcfg, capacity, n, d)
            camera.copy_(table[0])
            if cuda:
                eager, _ = run_sync_free(frame)
                graph, (image, aux) = capture_frame(frame, dev, pool=pool, checked=True)
            for ci in range(len(cams)):
                camera.copy_(table[ci])
                if cuda:
                    graph.replay()
                    full = image
                else:
                    full, aux = frame()
                if ci == 0 and cuda:
                    require(torch.equal(full, eager), f"band {d} of {n}: the replay differs from "
                            "the sync-free eager band")
                totals[ci] += full.to(torch.int32)
                counts = [int(aux[k]) for k in ("num_pairs", "num_candidates", "band_lo",
                                                "band_hi")]
                pairs[ci] += counts[0]
                require(counts[1] <= capacity, f"band {d} of {n} saturated on camera {ci}")
                if worst is None or counts[1] > worst[0]:
                    worst = (counts[1], ci, d, counts[2], counts[3])
        bad = 0.0
        for ci in range(len(cams)):
            require(pairs[ci] == flat_pairs[ci], f"{n} bands of camera {ci} hold {pairs[ci]} "
                    f"pairs, the flat frame {flat_pairs[ci]}")
            require(int(totals[ci].max()) <= 255, f"{n} bands of camera {ci} overlap")
            img = totals[ci].to(torch.uint8).cpu().numpy()
            diff = np.abs(img.astype(np.int32) - frames[ci].astype(np.int32))
            bad = max(bad, float((diff > PIX_TOL).any(axis=-1).mean()))
            require(bad <= BAD_FRAC, f"{n} bands of camera {ci} against Renderer.render: {bad} "
                    f"of pixels off by more than {PIX_TOL}")
        bands[n] = dict(worst_candidates=worst[0], worst_camera=worst[1], worst_band=worst[2],
                        worst_rows=[worst[3], worst[4]], bad_px_max=bad)
        log(f"  render_band, {n} bands x {len(cams)} cameras "
            + ("(each band eager under the sync debug mode on camera 0, captured and replayed "
               "for every camera; camera 0's replay byte-equal to the eager band)" if cuda else
               "(eager)")
            + f": pairs sum to the flat frame's (mean {sum(flat_pairs) / len(cams):.0f}); "
            f"summed frames vs Renderer.render, bad_px at most {bad:.4f}; largest band: camera "
            f"{worst[1]} band {worst[2]} rows {worst[3]}-{worst[4]}, {worst[0]} candidates")
    if cuda:
        del graph, image, aux, eager
    del totals, pool
    result["render_band"] = {str(n): b for n, b in bands.items()}
    log(f"  (a) in {time.perf_counter() - t0:.1f} s")

    # (b) the sharded path in a world-size-1 NCCL group.
    t0 = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    rank = launch.spawn(multi_device_rank, 1, dev.type, str(tmp / "ws"), scene.count,
                        config.screen_w, FIT_CAPACITY)[0]
    log(f"  world-size-1 group ({rank['backend']}, {rank['device']}) [{card}]: "
        f"DistributedRenderer.render ms/frame (host clock, readback included): first visits "
        f"(eager) {rank['ms']['eager']}, second visits (capture) {rank['ms']['capture']}, "
        f"replays {rank['ms']['replay']} ({rank['by_method']}); the eager frame loop at the "
        f"same key {rank['eager_loop_ms']:.3f}; by frame (e/c/r and pass, ms) "
        f"{rank['by_frame']}")
    log(f"  {rank['frames_equal']} of {rank['frames']} frames byte-equal to Renderer.render "
        f"through the per-splat kernel's plain version, Renderer.render within "
        f"{rank['levels']} level(s) of those; "
        f"render_batch equal {rank['batch_equal']}, 1x1 render_frames_sharded equal "
        f"{rank['mesh_1x1_equal']}; per-rank capacity {rank['capacity']}; {rank['keys']} "
        f"distinct keys over two passes, hit rate {rank['hit_rate']:.3f}; memory_reserved before "
        f"and after each pass {[round(g, 3) for g in rank['reserved_gib']]} GiB; launches "
        f"{rank['launches']}")
    if "trace" in rank:
        log(f"  traced pass of {len(cams)} replayed frames: records {rank['trace']} (K1-K4 "
            f"one a frame), device busy {rank['busy_ms']:.3f} ms/frame of {rank['traced_ms']:.3f} "
            f"traced; idle share replayed {rank['idle_share_replayed']:.3f}, eager loop "
            f"{rank['idle_share_eager_loop']:.3f}")
    require(rank["frames_equal"] == rank["frames"],
            f"{rank['frames'] - rank['frames_equal']} sharded frames differ from Renderer.render "
            "through the plain per-splat stage")
    require(rank["levels"] <= SHARDED_LEVELS,
            f"Renderer.render {rank['levels']} levels from its frames through the plain "
            "per-splat stage")
    require(rank["batch_equal"] == len(cams) and rank["mesh_1x1_equal"] == len(cams),
            "render_batch or the 1x1 mesh differ from Renderer.render through the plain "
            "per-splat stage")
    if dev.type == "cuda":
        require(rank["by_method"]["replay"] >= len(cams) and rank["by_method"]["capture"] >= 1,
                f"the sharded frames did not capture and replay: {rank['by_method']}")
        for name, count in rank["launches"].items():
            # Eager and captured frames call the wrappers; replays call none.
            require(count >= rank["by_method"]["eager"] + rank["by_method"]["capture"],
                    f"{name} launched {count} times in the eager and captured sharded frames")
    f = rank["fit_dp"]
    log(f"  fit_dp, {DP_STEPS} steps on {f['views']} COLMAP views at {f['size']} ({f['splats']} "
        f"splats, k_max {f['k_max']}): {rank['fit_dp_s_per_step']:.3f} s/step (by hand "
        f"{rank['hand_s_per_step']:.3f}, after a warm-up step), losses "
        f"{f['losses']} vs by hand {f['hand_losses']}; parameter leaves off by at most "
        f"{max(f['leaf_rel']):.2e} of their largest value")
    require(max(f["leaf_rel"]) <= DIFF_GRAD_RTOL, f"fit_dp against the hand steps: {f['leaf_rel']}")
    require(np.allclose(f["losses"], f["hand_losses"], rtol=1e-6, atol=0),
            f"fit_dp losses {f['losses']} against {f['hand_losses']}")
    log(f"  loopback (one rank, NCCL on one card, no NVLink) [{card}]: all-gather of the "
        f"[{GATHER_ROWS}, {scene.padded_count}] clip buffer {rank['loopback_all_gather_ms']} ms, "
        f"all-reduce of a frame {rank['loopback_all_reduce_ms']} ms (between events)")
    log(f"  (b) in {time.perf_counter() - t0:.1f} s")
    result["world_size_1"] = rank
    if dev.type != "cuda":
        return result

    # (c) the projected N-card frame (tools/measure.py:273-365's method): the
    # device time of the largest band's render_band (the whole scene's stages
    # A-B; a rank runs them on its 1/n), plus the all-gather of the clip
    # buffer and the frame's all-reduce bounded at the NVLink rate.  Device
    # time of a whole program: the plain sum of a trace's kernel and copy
    # records over its calls (a lower bound where the trace drops records).
    from cudagaussianrenderer_torch.bench import device_busy_ms

    def busy_ms(fn, reps=4):
        fn()
        ms = device_busy_ms(lambda: [fn() for _ in range(reps)])
        return None if ms is None else ms / reps

    t0 = time.perf_counter()
    flat_ms = busy_ms(lambda: render_frame(scene, cds[0], config, capacity, device=dev))

    def stages_ab(s, cam):
        return splat_colors(s, cam), project_splats(s.means, s.scales, s.quats, cam, config,
                                                      opacities=s.opacities)

    cam0 = camera_tensors(cds[0], dev)
    ab_full = busy_ms(lambda: stages_ab(scene, cam0))
    frame_bytes = config.screen_h * config.screen_w * 4
    proj = {}
    for n, b in bands.items():
        cap = round_capacity(int(b["worst_candidates"] * 1.02), dev)
        cd = cds[b["worst_camera"]]
        band_ms = busy_ms(lambda: render_band(scene, cd, bcfg, cap, n, b["worst_band"],
                                              device=dev))
        shard = dataclasses.replace(scene, **{
            k: getattr(scene, k)[..., :scene.padded_count // n]
            for k in ("means", "scales", "quats", "opacities", "colors", "sh")
            if getattr(scene, k) is not None})
        ab_shard = busy_ms(lambda: stages_ab(shard, cam0))
        gather_ms = scene.padded_count * GATHER_ROWS * 4 * (n - 1) / n / NVLINK_BYTES_PER_S * 1e3
        reduce_ms = 2 * (n - 1) / n * frame_bytes / NVLINK_BYTES_PER_S * 1e3
        p = dict(band_device_ms=band_ms, capacity=cap, stages_ab_shard_ms=ab_shard,
                 gather_bound_ms=gather_ms, all_reduce_bound_ms=reduce_ms)
        if band_ms is not None:
            p["projected_ms"] = band_ms + gather_ms + reduce_ms
            if ab_full is not None and ab_shard is not None:
                p["projected_shard_ab_ms"] = p["projected_ms"] - ab_full + ab_shard
        proj[n] = p
        log(f"  projection, {n} cards [{card}]: largest band {band_ms} ms of device time "
            f"(capacity {cap}) + all-gather bound {gather_ms:.4f} + all-reduce bound "
            f"{reduce_ms:.4f} = {p.get('projected_ms')} ms/frame, a projection; with stages "
            f"A-B on the rank's 1/{n} ({ab_shard} ms against {ab_full} ms for every splat): "
            f"{p.get('projected_shard_ab_ms')} ms/frame; one card's flat frame {flat_ms} ms "
            f"of device time")
    result["projection"] = dict(
        label="projection from one card, not a measurement of N cards",
        link="NVLink 450 GB/s each way (H100 SXM data sheet)", flat_frame_device_ms=flat_ms,
        stages_ab_device_ms=ab_full, **{str(n): p for n, p in proj.items()})
    log(f"  (c) in {time.perf_counter() - t0:.1f} s")
    return result


def measurement_tools(dev, tmp, card, head):
    """Phase 13: the port's measurement tools (cudagaussianrenderer_torch.tools)
    on the card, each through its ``main``, its printed lines sent to stderr:
    (a) bench_suite configs 1 and 2 at full size and configs 3, 4, 5 and 6
    at 1M splats over half their frames (4; config 5 over phase 9's 8
    cameras), the counts of K1-K4 set to 0 before each config and read
    after; every graphed frame byte-equal to its eager frame (the suite
    raises otherwise), config 5's pairs and capacity equal to phase 9's
    headline ``head`` and its camera 0's pairs to config 4's (the same
    scene and camera), config 6's two lines different in pairs; (b)
    fit_artifact at its defaults cut to FIT_ARTIFACT_STEPS steps,
    psnr_fit_db above psnr_init_db; (c) make_artifact over 4 frames (the
    1M-splat SH-3 .ply through the native importer); (d) sh_basis on the
    card against the CPU within 1e-6.  Writes under ``tmp`` only.  Returns
    the numbers it logged.  Rehearse it on the CPU small by wrapping each
    tool's ``main`` to add ``--device cpu`` and small sizes."""
    import contextlib

    import numpy as np
    import torch

    from cudagaussianrenderer_torch.ops import expand, ranges, raster
    from cudagaussianrenderer_torch.ops.sh import sh_basis
    from cudagaussianrenderer_torch.tools import bench_suite, fit_artifact, make_artifact

    counted = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    # On the CPU (a rehearsal at small sizes) the frames are eager and the
    # wrappers launch no kernel.
    cuda = dev.type == "cuda"
    numbers = {}

    # (a) the suite
    lines = {}
    for config, argv in ((1, []), (2, []), (3, ["--frames-scale", "0.5"]),
                         (4, ["--frames-scale", "0.5"]), (5, ["--frames-scale", "0.5"]),
                         (6, ["--frames-scale", "0.5"])):
        for fn in counted:
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            out = bench_suite.main([str(config), *argv])
        launches = {fn.__name__: fn.launches for fn in counted}
        for line, m in out:
            require(not cuda or (line["method"] == "cuda_graph"
                                 and line["graph_frames_equal"] == line["frames"]),
                    f"{line['config']}: not every graphed frame equals its eager frame")
            require(not line["saturated"] and line["pairs_per_frame"] > 0,
                    f"{line['config']}: not a clean measurement: {line}")
            lines[line["config"]] = dict(line, camera0_pairs=m["frame_pairs"][0])
        require(not cuda or all(n >= 1 for n in launches.values()),
                f"config {config}: a kernel of the flat path never launched: {launches}")
        log(f"  suite config {config} in {time.perf_counter() - t0:.1f} s, launches {launches}: "
            + "; ".join(f"{ln['config']} {ln['ms_per_frame']} ms/frame graphed, eager "
                        f"{ln['eager_ms_per_frame']}, busy {ln['device_busy_ms']}, "
                        f"{ln['pairs_per_frame']} pairs, capacity {ln['capacity']}"
                        for ln, _ in out))
    c5 = lines["5_flythrough_1m_1024px"]
    require(c5["frames"] == 8 and (c5["pairs_per_frame"], c5["capacity"])
            == (head["pairs_per_frame"], head["capacity"]),
            f"config 5's pairs and capacity {c5['pairs_per_frame']}, {c5['capacity']} differ "
            f"from the bench headline's {head['pairs_per_frame']}, {head['capacity']}")
    require(c5["camera0_pairs"] == lines["4_falloff_gaussian_1m_1024px"]["camera0_pairs"],
            "config 5's camera 0 differs in pairs from config 4's")
    exact = lines["6_realistic_alpha_exact3sigma_1m"]["pairs_per_frame"]
    aware = lines["6_realistic_alpha_aware_1m"]["pairs_per_frame"]
    require(aware < exact, f"config 6: aware extents {aware} pairs, exact {exact}")
    log(f"  config 6: opacity-aware extents {aware} pairs/frame against {exact} "
        f"({1 - aware / exact:.3f} fewer)")
    numbers["suite"] = lines

    # (b) the fit artifact
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        fit = fit_artifact.main(["--steps", str(FIT_ARTIFACT_STEPS), "--out", str(tmp / "fit")])
    require(fit["psnr_fit_db"] > fit["psnr_init_db"],
            f"the fit did not converge: {fit['psnr_init_db']} -> {fit['psnr_fit_db']} dB")
    log(f"  fit_artifact, {FIT_ARTIFACT_STEPS} steps: PSNR {fit['psnr_init_db']} -> "
        f"{fit['psnr_fit_db']} dB, loss {fit['loss_first']} -> {fit['loss_last']}, "
        f"{fit['ms_per_step']} ms/step, in {time.perf_counter() - t0:.1f} s")
    numbers["fit"] = fit

    # (c) the 1M-splat artifact
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        art = make_artifact.main(["--frames", "4", "--out", str(tmp / "artifact")])
    require(art["importer"] == "native" and not art["saturated"]
            and (not cuda or art["graph_frames_equal"] == 4), f"the 1M-splat artifact: {art}")
    for i in (0, 2):
        require((tmp / "artifact" / f"artifact_1m_sh3_frame{i}.png").stat().st_size > 0,
                f"frame {i} of the artifact was not written")
    log(f"  make_artifact, 4 frames: {art['ply_mb']} MB .ply, native import "
        f"{art['native_import_s']} s, {art['ms_per_frame']} ms/frame graphed, "
        f"{art['pairs_per_frame']} pairs, in {time.perf_counter() - t0:.1f} s")
    numbers["artifact"] = art

    # (d) sh_basis
    rng = np.random.default_rng(42)
    d = rng.normal(size=(1 << 16, 3))
    d = torch.from_numpy((d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32))
    err = max(float((sh_basis(d.to(dev), k).cpu() - sh_basis(d, k)).abs().max()) for k in range(5))
    require(err <= 1e-6, f"sh_basis on the card is {err} from the CPU's")
    log(f"  sh_basis, degrees 0-4 over {d.shape[0]} directions: card within {err:.3g} of the CPU")
    numbers["sh_basis_max_abs_err"] = err
    log(f"  phase 13 numbers [{card}]: {json.dumps(numbers)}")
    return numbers


# Phase 14: the kernels each measure subcommand must launch (by wrapper), and
# the timed lines whose profiler trace must hold those kernels by name.
# dpstep runs in a process of its own, so its launches are not counted here.
MEASURE_LAUNCHES = {
    "extents": ("tile_edges", "interleave_rows", "emit_slots", "rasterize_tiles"),
    "emit": ("interleave_rows", "emit_slots"),
    "raster": ("rasterize_tiles",),
    "bandsort": ("tile_edges", "interleave_rows", "emit_slots", "rasterize_tiles",
                 "interleave_rows_padded", "stack_rows", "compact_rows", "emit_slots_banded"),
    "shardsim": ("tile_edges", "interleave_rows", "emit_slots", "rasterize_tiles"),
    "shardbal": ("tile_edges", "interleave_rows", "emit_slots", "rasterize_tiles"),
    "trainscale": ("tile_edges", "interleave_rows", "emit_slots"),
}
MEASURE_TRACED = {
    "emit": {"emit kernels K2+K3 (committed)": ("interleave_rows", "emit_slots")},
    "raster": {"chunk=128 (prod)": ("rasterize_tiles",), "chunk=256": ("rasterize_tiles",)},
    "bandsort": {"frame banded G=16": ("interleave_rows_padded", "stack_rows", "compact_rows",
                                       "emit_slots_banded", "tile_edges", "rasterize_tiles")},
}


def measure_harness(dev, card, goldens=None):
    """Phase 14: every subcommand of cudagaussianrenderer_torch.tools.measure
    in this process at its default, full-width sizes (1M splats at 1024²,
    capacity 4,587,520, REPS 8, trainscale's three rows), its
    printed lines sent to stderr: no line may fail; every capturable line
    replays a CUDA graph (only bandsort's reorder_scene_by_tile_row is timed
    by events); the counts of K1-K8 set to 0 before each subcommand and read
    after, each kernel of MEASURE_LAUNCHES launched at least once; the
    profiler traces of the lines of MEASURE_TRACED holding their kernels
    under the names of TRACE_NAMES (the hand-written kernels ran, not their
    plain versions).  Then tools/selfcheck.py's cases, which must pass (the
    golden frames ``goldens`` kept from phases 3 and 6).  Each
    subcommand's JSON object goes to a ``phase 14 numbers [card]:`` line.
    Rehearse it on the CPU with ``python -m cudagaussianrenderer_torch.tools.
    smoke_batch --device cpu`` (the same entry points at smoke sizes)."""
    import contextlib
    import re

    import torch

    from cudagaussianrenderer_torch.ops import banded, expand, ranges, raster
    from cudagaussianrenderer_torch.tools import measure, selfcheck

    wrappers = {fn.__name__: fn for fn in (
        ranges.tile_edges, expand.interleave_rows, expand.emit_slots, raster.rasterize_tiles,
        banded.interleave_rows_padded, banded.stack_rows, banded.compact_rows,
        expand.emit_slots_banded)}
    seconds = {}
    for cmd in measure.COMMANDS:
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(sys.stderr):
            res = measure.run(cmd, dev)
        seconds[cmd] = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in wrappers.items() if fn.launches}
        require(not res["failed"], f"measure {cmd}: lines failed: {res['failed']}")
        missing = [w for w in MEASURE_LAUNCHES.get(cmd, ()) if wrappers[w].launches < 1]
        require(not missing, f"measure {cmd} never launched {missing}: {launches}")
        for line in res["lines"]:
            want = "events" if line["name"].startswith("reorder_scene_by_tile_row") else (
                "cuda_graph")
            if cmd in ("trainscale", "dpstep") and line["name"].endswith(" eager"):
                want = "eager"
            require(line["method"] == want or cmd in ("trainscale", "dpstep") and want ==
                    "cuda_graph" and line["step_methods"].get("replay", 0) >= 1,
                    f"measure {cmd}: {line['name']} ran by {line['method']}")
        for name, kernels in MEASURE_TRACED.get(cmd, {}).items():
            trace = next(ln for ln in res["lines"] if ln["name"] == name)["trace"] or {}
            absent = [k for k in kernels
                      if not any(re.search(TRACE_NAMES[k], key) for key in trace)]
            if absent:
                for key in sorted(trace):
                    log(f"    traced: {key[:120]}")
            require(not absent, f"measure {cmd}: the trace of {name!r} lacks {absent}")
        printed = dict(res, lines=[{k: v for k, v in ln.items() if k != "trace"}
                                   for ln in res["lines"]])
        log(f"  measure {cmd} in {seconds[cmd]:.1f} s, launches {launches}: "
            + "; ".join(f"{ln['name']} {ln['ms_per_rep']:.3f} ms ({ln['method']}, device "
                        f"{ln.get('device_ms')})" for ln in res["lines"]))
        log(f"  phase 14 numbers [{card}]: {json.dumps(printed)}")
        del res, printed
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        drifted = selfcheck.run(dev, goldens)
    seconds["selfcheck"] = time.perf_counter() - t0
    require(not drifted, f"tools/selfcheck.py drifted on the card: {drifted}")
    log(f"  selfcheck: all {len(selfcheck.CASES) + 1} cases pass; seconds "
        + json.dumps({k: round(v, 1) for k, v in seconds.items()}))


# Phase 15: frames a timed pass of the entry's frame (host clock, best of 3).
ENTRY_FRAMES = 20


def entry_trace(graph, frames):
    """Phase 15's trace: ``graph`` (the graft entry's frame, captured)
    replayed once, then ``frames`` times inside COUNTED_RANGE, in a
    profiler trace.  Returns (the counted records of each kernel of
    graft_entry.KERNELS by wrapper name, device busy ms a frame)."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from cudagaussianrenderer_torch import graft_entry

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        graph.replay()
        torch.cuda.synchronize()
        with record_function(COUNTED_RANGE):
            for _ in range(frames):
                graph.replay()
            torch.cuda.synchronize()
    device, _ = counted_records(prof)
    records = {k.__name__: sum(1 for e in device if re.search(TRACE_NAMES[k.__name__], e.key))
               for k in graft_entry.KERNELS}
    return records, sum(e.self_device_time_total for e in device) / 1e3 / frames


def graft_entry_phase(dev, card):
    """Phase 15: the graft entry (cudagaussianrenderer_torch.graft_entry,
    the JAX repository's __graft_entry__.py).  entry()'s frame (4,096
    splats SH 2, 256x256) through graft_entry.capture_entry: once eagerly
    under the sync debug mode "error", then captured as a CUDA graph and
    replayed, byte-equal, with the counts of graft_entry.KERNELS (the
    per-splat kernel and K1-K4) set to 0 just before and read just after
    (each 3: the eager frame, the capture's warm-up and the capture); the
    frame against the same function on the CPU (the kernels' plain
    versions) and, with room for every candidate (the entry's list
    saturates, as the JAX entry's does), against golden.py, each by the
    image rule; ms a frame, eager and replayed (host clock, best of 3
    passes of ENTRY_FRAMES frames), and the device busy time of a traced
    pass of replays (entry_trace), each of those kernels once a frame.
    Then dryrun_multichip at the visible card count over NCCL: its five
    checks (the 2-D mesh batch only on an even count of 4 or more),
    seconds and launches of each on rank 0.  Its numbers go to a ``phase
    15 numbers [card]:`` line."""
    import torch

    from cudagaussianrenderer_torch import RenderConfig, graft_entry
    from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
    from cudagaussianrenderer_torch.render import render_frame_tensors

    counted = graft_entry.KERNELS
    fn, args = graft_entry.entry()
    for k in counted:
        k.launches = 0
    eager, graph, replayed = graft_entry.capture_entry(fn, args)
    launches = {k.__name__: k.launches for k in counted}
    log(f"  entry frame {tuple(eager.shape)}: eager under the sync debug mode, captured and "
        f"replayed byte-equal; launches {launches}")
    require(all(n == 3 for n in launches.values()),
            f"the entry's eager frame, warm-up and capture did not launch each kernel once: "
            f"{launches}")
    # The JAX entry's list saturates (its capacity is capacity_factor 8 slots
    # a splat): the frame is held against the same function on the CPU, the
    # kernels' plain versions, and the same frame with room for every
    # candidate against golden.py.
    scene, cam = args
    cpu_fn, cpu_args = graft_entry.entry("cpu")
    check("entry frame vs its plain version", eager.cpu().numpy(), cpu_fn(*cpu_args).numpy())
    config = RenderConfig(screen_size=256)
    _, aux = render_frame_tensors(*cpu_args, config, config.tile_capacity(scene.count))
    candidates, entry_pairs = int(aux["num_candidates"]), int(aux["num_pairs"])
    full, aux = render_frame_tensors(scene, cam, config, -(-candidates // 1024) * 1024)
    require(int(aux["num_pairs"]) == candidates == int(aux["num_candidates"]),
            f"the roomy entry frame holds {int(aux['num_pairs'])} of {candidates} pairs")
    log(f"  entry list: {candidates} candidates, {entry_pairs} pairs kept at capacity "
        f"{config.tile_capacity(scene.count)}")
    want = golden_render(scene_to_numpy(scene), {k: v.cpu().numpy() for k, v in cam.items()},
                         config)
    check("entry scene, every pair, vs golden.py", full.cpu().numpy(), want)

    def best_ms(frame):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ENTRY_FRAMES):
                frame()
            torch.cuda.synchronize()
            best = min(best, (time.perf_counter() - t0) * 1e3 / ENTRY_FRAMES)
        return best

    eager_ms = best_ms(lambda: fn(*args))
    replay_ms = best_ms(graph.replay)
    records, busy = entry_trace(graph, ENTRY_FRAMES)
    require(torch.equal(replayed, eager), "a timed or traced replay of the entry frame differs")
    require(all(n == ENTRY_FRAMES for n in records.values()),
            f"kernel records in a trace of {ENTRY_FRAMES} replayed entry frames: {records}")
    log(f"  entry ms/frame [{card}]: eager {eager_ms:.4f}, replayed {replay_ms:.4f}; device busy "
        f"{busy:.4f} ms/frame in a trace of {ENTRY_FRAMES} replays (records {records})")

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    out = graft_entry.dryrun_multichip(n)
    wall = time.perf_counter() - t0
    want_checks = ["uniform", "balanced", "parity"] + (["mesh_2d"] if n >= 4 and n % 2 == 0
                                                        else []) + ["dp_step"]
    require(list(out) == want_checks, f"dryrun_multichip({n}) ran {list(out)}")
    for name, c in out.items():
        # The training step blends in plain PyTorch: K4 runs only in frames.
        # The sharded frames and the step keep stages A-C in plain PyTorch:
        # the per-splat kernel runs only in check 3's single-device frame.
        need = [k.__name__ for k in counted
                if not (name == "dp_step" and k is graft_entry.rasterize_tiles)
                and not (name != "parity" and k is graft_entry.splat_columns)]
        require(all(c["launches"][k] >= 1 for k in need),
                f"dryrun check {name} did not launch {need}: {c['launches']}")
    checks = {name: {k: v for k, v in c.items() if k != "image"} for name, c in out.items()}
    log(f"  dryrun_multichip({n}) over NCCL in {wall:.1f} s: seconds by check "
        + ", ".join(f"{k} {c['seconds']:.2f}" for k, c in checks.items()))
    numbers = dict(entry=dict(eager_ms=eager_ms, replay_ms=replay_ms, busy_ms=busy,
                              launches=launches, trace_records=records,
                              candidates=candidates, pairs=entry_pairs),
                   dryrun=dict(ranks=n, seconds=wall, checks=checks))
    log(f"  phase 15 numbers [{card}]: {json.dumps(numbers)}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.ops import banded, expand, ranges, raster, sorting, splat
    from cudagaussianrenderer_torch.ops.binning import (
        TilePairs, emit_columns, splat_row_packs, splat_tile_rects,
    )
    from cudagaussianrenderer_torch.ops.geometry import as_u32_i64
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.sorting import sort_pairs
    from cudagaussianrenderer_torch.ops.splat import splat_colors
    from cudagaussianrenderer_torch.render import (
        _band_rows_tensor, _frame_pairs, camera_tensors, round_capacity,
    )
    from cudagaussianrenderer_torch.utils import cuda_build

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- 1. card and build ------------------------------------------------
    log("== 1. card and build")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    builds = cuda_build.build_all()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s wall "
        + ", ".join(f"{k} {v['seconds']:.1f} s" for k, v in builds.items()))
    for name, b in builds.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")

    # ---- 2. kernel parity at main-path shapes -----------------------------
    log("== 2. kernel parity at main-path shapes")
    t0 = time.perf_counter()
    scene = random_scene(
        1_000_000, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
        sh_degree=3, device=dev,
    )
    config = RenderConfig()
    renderer = Renderer(scene, config)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 8)
    log(f"scene: {scene.count} splats (padded {renderer.scene.padded_count}), "
        f"SH degree {scene.sh_degree}, built in {time.perf_counter() - t0:.1f} s")

    s = renderer.scene
    cam = camera_tensors(cams[0].camera_data(), dev)
    colors = splat_colors(s, cam)
    clip = project_splats(s.means, s.scales, s.quats, cam, config, opacities=s.opacities)
    cols, incl = emit_columns(clip, colors, s.opacities, config)
    cols = tuple(c.contiguous() for c in cols)
    total = int(incl[-1])
    capacity = round_capacity(Renderer._bucket(total), dev)
    n = incl.shape[0]
    log(f"camera 0: {total} candidate pairs, capacity {capacity}")
    mip360 = mip360_shape(dev)
    kernels = {"splat": splat_kernel(*mip360),
               "sort": sort_kernel(*mip360, builds["sort"]["seconds"])}
    del mip360

    # K2
    rows = expand.interleave_rows(incl, cols, capacity + 1)
    rows_p = expand._interleave_rows_torch(incl, cols, capacity + 1)
    torch.cuda.synchronize()
    ok2 = bits_equal(rows, rows_p)
    np_cols = rows.shape[1]
    lib_rows = [incl.float(), incl.float(), torch.arange(n, device=dev, dtype=torch.float32), *cols]
    kernels["interleave"] = dict(
        ms=cuda_ms(lambda: expand.interleave_rows(incl, cols, capacity + 1), 20),
        device_ms=trace_ms(lambda: expand.interleave_rows(incl, cols, capacity + 1), 20),
        plain_ms=cuda_ms(lambda: expand._interleave_rows_torch(incl, cols, capacity + 1), 5),
        library_ms=cuda_ms(lambda: torch.stack(lib_rows), 20),
        bytes=4 * n * 14 + 4 * 16 * np_cols,
        max_abs_err=float((rows - rows_p).abs().max()),
    )
    log(f"  K2 interleave [16, {np_cols}]: bit-exact={ok2}")
    if not ok2:
        raise AssertionError("K2 interleave differs from its plain version")

    # K3
    outs = expand.emit_slots(rows, capacity, config)
    outs_p = expand._emit_torch(rows, capacity, config)
    torch.cuda.synchronize()
    ok3 = all(bits_equal(a, b) for a, b in zip(outs, outs_p))
    kernels["emit"] = dict(
        ms=cuda_ms(lambda: expand.emit_slots(rows, capacity, config), 20),
        device_ms=trace_ms(lambda: expand.emit_slots(rows, capacity, config), 20),
        plain_ms=cuda_ms(lambda: expand._emit_torch(rows, capacity, config), 3),
        library_ms=None,
        bytes=4 * 16 * np_cols + 4 * 6 * capacity,
        max_abs_err=max(
            float((as_u32_i64(a) - as_u32_i64(b)).abs().max()) for a, b in zip(outs, outs_p)
        ),
    )
    log(f"  K3 emit {capacity} slots: six outputs equal={ok3}")
    if not ok3:
        raise AssertionError("K3 emit differs from its plain version")

    # K3 on huge splats, capacity below and above the candidate total.
    hcfg = RenderConfig(screen_size=1024)
    hscene = random_scene(
        192, seed=9, min_scale=0.3, max_scale=1.6, extent=3.0, device=dev
    ).pad_to_multiple(256)
    hcam = camera_tensors(
        Camera(aspect=1.0).framed(hscene.bounds_min, hscene.bounds_max).camera_data(), dev
    )
    hclip = project_splats(
        hscene.means, hscene.scales, hscene.quats, hcam, hcfg, opacities=hscene.opacities
    )
    hcols, hincl = emit_columns(hclip, hscene.colors, hscene.opacities, hcfg)
    hcols = tuple(c.contiguous() for c in hcols)
    htotal = int(hincl[-1])
    for hcap in (262144, 524288):
        hrows = expand.interleave_rows(hincl, hcols, hcap + 1)
        ok = bits_equal(hrows, expand._interleave_rows_torch(hincl, hcols, hcap + 1))
        ok = ok and all(
            bits_equal(a, b)
            for a, b in zip(expand.emit_slots(hrows, hcap, hcfg),
                            expand._emit_torch(hrows, hcap, hcfg))
        )
        log(f"  K2+K3 huge splats: {htotal} candidates, capacity {hcap}: equal={ok}")
        if not ok:
            raise AssertionError("K2/K3 differ from their plain versions on huge splats")
    # hrows and hcap are now the roomy case: a few splats of thousands of
    # slots each, the load a per-splat emission balances worst.
    k3_huge = device_ms(lambda: expand.emit_slots(hrows, hcap, hcfg), 20)
    k3_huge_bound = (4 * 16 * hrows.shape[1] + 4 * 6 * hcap) / HBM_BYTES_PER_S * 1e3
    log(f"  K3 emit on the huge-splat rows, capacity {hcap}: {k3_huge} "
        f"(byte bound {k3_huge_bound:.4f} ms); at the main path's shapes "
        f"{device_ms(lambda: expand.emit_slots(rows, capacity, config), 20)}")

    # K1 on the sorted keys of the main-path list.
    pairs = TilePairs(
        keys=(outs[expand.OUT_KEY0],), values=outs[expand.OUT_VALUES],
        attrs=tuple(outs[expand.OUT_CXCY:]), num_candidates=incl[-1],
        num_pairs=torch.clamp(incl[-1], max=capacity),
    )
    keys, _, attrs = sort_pairs(pairs, stable=config.stable_sort)
    probes = config.total_tiles + 1
    edges = ranges.tile_edges(keys[0], probes, 19)
    edges_p = ranges._edges_torch(keys[0], probes, 19)
    ok1 = bits_equal(edges, edges_p)
    bins = torch.clamp(as_u32_i64(keys[0]) >> 19, max=probes - 1)
    kernels["edges"] = dict(
        ms=cuda_ms(lambda: ranges.tile_edges(keys[0], probes, 19), 50),
        device_ms=trace_ms(lambda: ranges.tile_edges(keys[0], probes, 19), 50),
        plain_ms=cuda_ms(lambda: ranges._edges_torch(keys[0], probes, 19), 10),
        library_ms=cuda_ms(lambda: torch.cumsum(torch.bincount(bins, minlength=probes), 0), 20),
        bytes=4 * capacity + 4 * probes,  # the scan: each key read once, each edge written once
        max_abs_err=float((edges - edges_p).abs().max()),
    )
    log(f"  K1 edges over {capacity} keys, {probes} probes: exact={ok1}")
    if not ok1:
        raise AssertionError("K1 edges differ from the plain version")
    edge_corner_parity(segmented=False)

    # K4
    starts, counts = edges[:-1], edges[1:] - edges[:-1]
    pair_data = raster.pack_pair_data(attrs, config.raster_chunk)
    tiles = raster.rasterize_tiles(pair_data, starts, counts, config)
    blended = torch.zeros(1, dtype=torch.int32, device=pair_data.device)
    t0 = time.perf_counter()
    tiles_p = raster._raster_torch(pair_data, starts, counts, config, config.total_tiles, 0,
                                   blended)
    torch.cuda.synchronize()
    plain_raster_ms = (time.perf_counter() - t0) * 1e3
    img_k = raster.tiles_to_image(tiles, config)
    img_p = raster.tiles_to_image(tiles_p, config)
    lsb = int((img_k.int() - img_p.int()).abs().max())
    evals = int(blended) * config.pixels_per_tile
    sfu_rate = sfu_results_per_s()
    kernels["raster"] = dict(
        ms=cuda_ms(lambda: raster.rasterize_tiles(pair_data, starts, counts, config), 20),
        device_ms=trace_ms(
            lambda: raster.rasterize_tiles(pair_data, starts, counts, config), 20),
        plain_ms=plain_raster_ms,
        library_ms=None,
        bytes=4 * 3 * int(incl[-1].clamp(max=capacity)) + 8 * config.total_tiles
        + 16 * config.total_tiles * config.pixels_per_tile,
        ops=K4_OPS_PER_EVAL * evals,
        sfu_ms=evals / sfu_rate * 1e3,
        max_abs_err=float((tiles - tiles_p).abs().max()),
    )
    log(f"  K4 raster {config.total_tiles} tiles: max diff {lsb} LSB (bound "
        f"{K4_LSB_BOUND}), {int(blended)} pairs blended before exit "
        f"= {evals} pixel evaluations")
    log(f"  K4 floors: f32 {K4_OPS_PER_EVAL * evals / F32_OPS_PER_S * 1e3:.4f} ms "
        f"({K4_OPS_PER_EVAL} operations an evaluation at {F32_OPS_PER_S / 1e12:.0f} TFLOP/s), "
        f"ex2 {kernels['raster']['sfu_ms']:.4f} ms ({sfu_rate / 1e12:.3f} T results/s), "
        f"bytes {kernels['raster']['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms")
    if lsb > K4_LSB_BOUND:
        raise AssertionError(f"K4 raster differs by {lsb} LSB from its plain version")
    plain_frame0 = img_p.cpu().numpy()

    # K4 on the huge-splat scene: few tiles are empty, every list is a batch
    # or two deep and most of its pairs are blended.
    _, hattrs, hstarts, hcounts = _frame_pairs(hscene, hcam, hcfg, hcap)
    hpair_data = raster.pack_pair_data(hattrs, hcfg.raster_chunk)
    htiles = raster.rasterize_tiles(hpair_data, hstarts, hcounts, hcfg)
    hblended = torch.zeros(1, dtype=torch.int32, device=hpair_data.device)
    htiles_p = raster._raster_torch(hpair_data, hstarts, hcounts, hcfg, hcfg.total_tiles, 0,
                                    hblended)
    hlsb = int((raster.tiles_to_image(htiles, hcfg).int()
                - raster.tiles_to_image(htiles_p, hcfg).int()).abs().max())
    hevals = int(hblended) * hcfg.pixels_per_tile
    k4_huge = device_ms(
        lambda: raster.rasterize_tiles(hpair_data, hstarts, hcounts, hcfg), 20)
    log(f"  K4 raster on the huge-splat scene: max diff {hlsb} LSB, "
        f"{int(hblended)} of {int(hcounts.sum())} pairs blended (longest list "
        f"{int(hcounts.max())}) = {hevals} pixel evaluations, {k4_huge} (floors: f32 "
        f"{K4_OPS_PER_EVAL * hevals / F32_OPS_PER_S * 1e3:.4f}, ex2 {hevals / sfu_rate * 1e3:.4f} ms); "
        f"at the main path's shapes "
        f"{device_ms(lambda: raster.rasterize_tiles(pair_data, starts, counts, config), 20)}")
    if hlsb > K4_LSB_BOUND:
        raise AssertionError(f"K4 raster differs by {hlsb} LSB on the huge-splat scene")
    k4_tiles = k4_tile_sizes(dev, s, cam, sfu_rate, builds)
    log(f"  K4 tile sizes [{card}]: {json.dumps(k4_tiles)}")
    tile_frames = tile_size_frames(dev, scene, cams)
    log(f"  Renderer.render by tile size [{card}]: {json.dumps(tile_frames)}")

    # ---- 3. golden scenes --------------------------------------------------
    # The non-banded cases of cudagaussianrenderer_torch/tools/selfcheck.py
    # (tools/tpu_selfcheck.py's) and its balanced-bands case; its two banded
    # cases run in phase 6.  The golden frames are kept for phase 6.
    from cudagaussianrenderer_torch.tools import selfcheck

    log("== 3. golden scenes (port vs golden.py)")
    goldens = {}
    for name, c in selfcheck.CASES:
        if not selfcheck.is_banded(c):
            got, want = selfcheck.case_frames(name, c, dev, goldens)
            check(name, got, want, pix_tol=c.get("pix_tol", PIX_TOL))
    # Each of two balanced bands rendered by render_band, the placed frames
    # summed (it raises if two bands overlap).
    got, want = selfcheck.balanced_frames(selfcheck.BALANCED[1], dev)
    check(selfcheck.BALANCED[0], got, want)

    # ---- 4. main path at full width ---------------------------------------
    log("== 4. main path: Renderer, 1M splats SH-3, 1024x1024, 8 orbit cameras")
    counted = (splat.splat_columns, sorting.sort_words, ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    renderer.render(cams[0])  # warm-up: sizes the capacity from its candidates
    torch.cuda.synchronize()
    recs, launches, trace, flat_numbers = graphed_orbit("flat", renderer, cams, counted)
    frames = [rec["image"] for rec in recs[:len(cams)]]
    cands = [rec["after"][4] for rec in recs[:len(cams)]]
    log(f"  pairs/frame mean {sum(cands) / len(cands):.0f} (min {min(cands)}, max {max(cands)}), "
        f"capacity {renderer.capacity}, saturated {renderer.saturated}")
    for i, img in enumerate(frames):
        if img.shape != (1024, 1024, 4) or img[..., 3].max() != 255 or img[..., :3].max() == 0:
            raise AssertionError(f"frame {i} is blank or misshapen: {img.shape}")
    check("frame 0 vs plain-version frame", frames[0], plain_frame0)
    stages = renderer.profile_frame(cams[1], warmup=True)
    log("  per-stage ms (the frame record's device stamps): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")

    # ---- 5. banded kernel parity at full-width shapes ----------------------
    log("== 5. banded kernel parity (sort_bands=16) at full-width shapes")
    G = 16
    bcfg = RenderConfig(sort_bands=G)
    brenderer = Renderer(scene, bcfg)
    bcap, ccap = brenderer.capacity, brenderer.compact_capacity
    band_rows = _band_rows_tensor(None, bcfg, dev)
    rects = splat_tile_rects(clip, bcfg)
    log(f"  fresh banded Renderer: capacity {bcap}, compact capacity {ccap}, "
        f"band rows {band_rows.tolist()}")

    def banded_stage_c(cols_, counts_, rows_, cap_, ccap_, cfg_):
        """Every array of one banded emission, each kernel's output beside
        its plain version's: name -> (kernel output, plain output)."""
        n_ = counts_.shape[1]
        block = banded.banded_block(cap_, ccap_, G)
        pre = banded.band_prefixes(counts_, cap_ // G, ccap_ // G)
        np_ = banded.padded_width(n_)
        zeros = torch.zeros(n_, dtype=torch.float32, device=dev)
        k5_in = (zeros, zeros) + tuple(cols_)
        k6_in = banded.band_prefix_columns(pre, np_)
        full = banded.interleave_rows_padded(k5_in, np_)
        pfx = banded.stack_rows(k6_in)
        comp = banded.compact_rows(full, pfx, pre.pair_end, ccap_)
        outs_ = expand.emit_slots_banded(comp, cap_, cfg_, pre.pair_end, rows_, block)
        plain = dict(
            k5=banded._interleave_rows_padded_torch(k5_in, np_),
            k6=banded._stack_rows_torch(k6_in),
            k7=banded._compact_rows_torch(full, pfx, pre.pair_end, ccap_),
            k8=expand._emit_torch(comp, cap_, cfg_, block=block, pair_end=pre.pair_end,
                                  band_rows=rows_),
        )
        torch.cuda.synchronize()
        return dict(pre=pre, block=block, k5_in=k5_in, k6_in=k6_in, full=full, pfx=pfx,
                    comp=comp, outs=outs_, plain=plain)

    def banded_parity(rows_, cap_, ccap_, must_fit):
        """K5-K8, the segmented K1 and the banded tile ranges at one set of
        full-width shapes (camera 0, the given band rows and capacities),
        each held bit for bit against its plain version and timed.  With
        ``must_fit`` no band may saturate at these capacities.
        Returns the K5-K8 entries of the kernels line and K1's banded
        numbers."""
        counts_ = banded.band_counts(rects, splat_row_packs(clip, rects, bcfg), rows_)
        require(bool(torch.equal(counts_.sum(0).to(torch.int32),
                                 torch.diff(incl, prepend=incl[:1] * 0))),
                "band counts do not sum to the flat candidate counts")
        b = banded_stage_c(cols, counts_, rows_, cap_, ccap_, bcfg)
        pre, np_b = b["pre"], b["full"].shape[1]
        kept = int((b["comp"][0] != b["comp"][1]).sum())
        log(f"  band totals {pre.band_totals.tolist()}")
        log(f"  band splats {pre.band_splats.tolist()} ({kept} kept)")
        saturated = (int(pre.band_totals.max()) > cap_ // G
                     or int(pre.band_splats.max()) > ccap_ // G)
        require(not (saturated and must_fit), "a band saturates at these capacities")
        found = {}

        ok5 = bits_equal(b["full"], b["plain"]["k5"])
        lib5 = [torch.nn.functional.pad(c, (0, np_b - n)) for c in b["k5_in"]]
        lib5.insert(2 + expand.R_IDX, torch.arange(np_b, device=dev, dtype=torch.float32))
        require(bits_equal(torch.stack(lib5), b["full"]),
                "K5's library yardstick computes another array")
        found["interleave_padded"] = dict(
            ms=cuda_ms(lambda: banded.interleave_rows_padded(b["k5_in"], np_b), 20),
            device_ms=trace_ms(lambda: banded.interleave_rows_padded(b["k5_in"], np_b), 20),
            plain_ms=cuda_ms(lambda: banded._interleave_rows_padded_torch(b["k5_in"], np_b), 5),
            library_ms=cuda_ms(lambda: torch.stack(lib5), 20),
            bytes=4 * n * 15 + 4 * 16 * np_b,
            max_abs_err=float((b["full"] - b["plain"]["k5"]).abs().max()),
        )
        del lib5
        log(f"  K5 interleave_padded [16, {np_b}]: bit-exact={ok5}")
        require(ok5, "K5 interleave_padded differs from its plain version")

        ok6 = bits_equal(b["pfx"], b["plain"]["k6"])
        require(bits_equal(torch.stack(b["k6_in"]), b["pfx"]),
                "K6's library yardstick computes another array")
        found["stack"] = dict(
            ms=cuda_ms(lambda: banded.stack_rows(b["k6_in"]), 20),
            device_ms=trace_ms(lambda: banded.stack_rows(b["k6_in"]), 20),
            plain_ms=cuda_ms(lambda: banded._stack_rows_torch(b["k6_in"]), 5),
            library_ms=cuda_ms(lambda: torch.stack(b["k6_in"]), 20),
            bytes=2 * 4 * len(b["k6_in"]) * G * np_b,
            max_abs_err=float((b["pfx"] - b["plain"]["k6"]).abs().max()),
        )
        log(f"  K6 stack [{len(b['k6_in'])}, {G * np_b}]: bit-exact={ok6}")
        require(ok6, "K6 stack differs from its plain version")

        ok7 = bits_equal(b["comp"], b["plain"]["k7"])
        found["compact"] = dict(
            ms=cuda_ms(lambda: banded.compact_rows(b["full"], b["pfx"], pre.pair_end, ccap_), 20),
            device_ms=trace_ms(
                lambda: banded.compact_rows(b["full"], b["pfx"], pre.pair_end, ccap_), 20),
            plain_ms=cuda_ms(
                lambda: banded._compact_rows_torch(b["full"], b["pfx"], pre.pair_end, ccap_), 3),
            library_ms=None,
            # What the function must read and write for this run's data:
            # the two pair-prefix rows of every column, c_incl and the 14
            # attribute rows of the kept columns only (a column with equal
            # pair prefixes is done after those two reads), and the
            # [16, ccap] output.
            bytes=4 * 2 * G * np_b + 4 * kept + 4 * 14 * kept + 4 * 16 * ccap_,
            max_abs_err=float((b["comp"] - b["plain"]["k7"]).abs().max()),
        )
        log(f"  K7 compact [16, {ccap_}]: bit-exact={ok7}")
        require(ok7, "K7 compact differs from its plain version")

        ok8 = all(bits_equal(x, y) for x, y in zip(b["outs"], b["plain"]["k8"]))
        found["emit_banded"] = dict(
            ms=cuda_ms(lambda: expand.emit_slots_banded(
                b["comp"], cap_, bcfg, pre.pair_end, rows_, b["block"]), 20),
            device_ms=trace_ms(lambda: expand.emit_slots_banded(
                b["comp"], cap_, bcfg, pre.pair_end, rows_, b["block"]), 20),
            plain_ms=cuda_ms(lambda: expand._emit_torch(
                b["comp"], cap_, bcfg, block=b["block"], pair_end=pre.pair_end,
                band_rows=rows_), 2),
            library_ms=None,
            # All 16 rows of the kept compact columns and the six [capacity]
            # words.  The fill columns behind a band's kept ones own no
            # slot and are never read: a block searches its band's prefix
            # row with a few probes and walks only the columns that cover
            # its slots.
            bytes=4 * 16 * kept + 4 * 6 * cap_,
            max_abs_err=max(float((as_u32_i64(x) - as_u32_i64(y)).abs().max())
                            for x, y in zip(b["outs"], b["plain"]["k8"])),
        )
        log(f"  K8 emit_banded {cap_} slots in {G} bands: six outputs equal={ok8}")
        require(ok8, "K8 emit_banded differs from its plain version")

        # K1 on the per-band-sorted keys: the one place where boundary
        # detection on a list that is not globally sorted could go wrong.
        bouts = b["outs"]
        bpairs = TilePairs(
            keys=(bouts[expand.OUT_KEY0],), values=bouts[expand.OUT_VALUES],
            attrs=tuple(bouts[expand.OUT_CXCY:]), num_candidates=pre.band_totals.sum(),
            num_pairs=(bouts[expand.OUT_VALUES] >= 0).sum(),
        )
        bkeys, _, _ = banded.sort_pairs_banded(bpairs, G, stable=bcfg.stable_sort)
        bedges = ranges.tile_edges(bkeys[0], probes, 19, segments=G)
        bedges_p = ranges._edges_torch(bkeys[0], probes, 19, segments=G)
        ok1b = bits_equal(bedges, bedges_p)
        k1b = dict(
            banded_ms=cuda_ms(lambda: ranges.tile_edges(bkeys[0], probes, 19, segments=G), 50),
            banded_device_ms=trace_ms(
                lambda: ranges.tile_edges(bkeys[0], probes, 19, segments=G), 50),
            banded_plain_ms=cuda_ms(
                lambda: ranges._edges_torch(bkeys[0], probes, 19, segments=G), 10),
            banded_bound_ms=(4 * cap_ + 4 * G * probes) / HBM_BYTES_PER_S * 1e3,
        )
        log(f"  K1 edges, segmented: {G} x {cap_ // G} keys, {probes} probes: exact={ok1b}, "
            f"{k1b['banded_ms']:.4f} ms (plain {k1b['banded_plain_ms']:.4f} ms, bound "
            f"{k1b['banded_bound_ms']:.4f} ms by bytes)")
        require(ok1b, "K1 edges (segmented) differ from the plain version")
        # Banded tile ranges against the histogram of the whole list, which
        # needs no order: counts are its differences, and a tile of band g
        # starts g * capacity / G past the band's first edge.
        bstarts, bcounts = ranges.tile_ranges(bkeys, bcfg, band_rows=rows_, band_capacity=cap_ // G)
        hist = ranges._edges_torch(bkeys[0], probes, 19)
        tile_band = torch.searchsorted(
            rows_[1:].contiguous(),
            (torch.arange(bcfg.total_tiles, device=dev) // bcfg.tiles_x).to(torch.int32),
            right=True)
        want_starts = (tile_band * (cap_ // G) + hist[:-1]
                       - hist[(rows_[:-1].long() * bcfg.tiles_x)][tile_band]).to(torch.int32)
        okr = bits_equal(bcounts, hist[1:] - hist[:-1]) and bits_equal(bstarts, want_starts)
        log(f"  banded tile_ranges over {bcfg.total_tiles} tiles: starts and counts exact={okr}")
        require(okr, "banded tile_ranges differ from the whole-list histogram")
        require(int(bcounts.sum()) == int(bpairs.num_pairs)
                and (int(bpairs.num_pairs) == total) == (not saturated),
                "the banded ranges do not cover the emitted pairs")
        log("  ms between events (device ms from the trace; plain ms; library ms; byte bound "
            "ms): " + ", ".join(
                f"{name} {k['ms']:.4f} ({k['device_ms']}; {k['plain_ms']:.3f}; "
                f"{k['library_ms']}; {k['bytes'] / HBM_BYTES_PER_S * 1e3:.4f})"
                for name, k in found.items()))
        return found, k1b

    banded_parity(band_rows, bcap, ccap, must_fit=False)
    edge_corner_parity(segmented=True)

    # K5-K8 on the huge-splat scene: roomy, pair-saturated, compact-saturated.
    hbcfg = RenderConfig(screen_size=1024, sort_bands=G)
    hrows_b = _band_rows_tensor(None, hbcfg, dev)
    hrects = splat_tile_rects(hclip, hbcfg)
    hcounts = banded.band_counts(hrects, splat_row_packs(hclip, hrects, hbcfg), hrows_b)
    roomy = banded.band_prefixes(hcounts, 1048576 // G, 1024)
    htot, hspl = int(roomy.band_totals.max()), int(roomy.band_splats.max())
    pair_sat = max(1024, htot // 2 // 1024 * 1024) * G
    for label, hcap, hccap in (("roomy", 1048576, G * 1024),
                               ("pair-saturated", pair_sat, G * 1024),
                               ("compact-saturated", 1048576, G * 128)):
        hb = banded_stage_c(hcols, hcounts, hrows_b, hcap, hccap, hbcfg)
        sat_p = int(hb["pre"].band_totals.max()) > hcap // G
        sat_c = int(hb["pre"].band_splats.max()) > hccap // G
        ok = (bits_equal(hb["full"], hb["plain"]["k5"]) and bits_equal(hb["pfx"], hb["plain"]["k6"])
              and bits_equal(hb["comp"], hb["plain"]["k7"])
              and all(bits_equal(x, y) for x, y in zip(hb["outs"], hb["plain"]["k8"])))
        emitted = int((hb["outs"][expand.OUT_VALUES] >= 0).sum())
        log(f"  K5-K8 huge splats, {label}: capacity {hcap}, compact {hccap}, largest band "
            f"{htot} pairs / {hspl} splats, {emitted} of {htotal} pairs emitted: equal={ok}")
        require(ok, f"K5-K8 differ from their plain versions on huge splats ({label})")
        require((sat_p, sat_c) == (label == "pair-saturated", label == "compact-saturated"),
                f"huge-splat case {label} does not saturate as intended")
        require((emitted == htotal) == (label == "roomy"), f"{label}: {emitted} pairs emitted")

    # ---- 6. banded golden scenes -------------------------------------------
    log("== 6. banded golden scenes (port vs golden.py)")
    for name, c in selfcheck.CASES:
        if selfcheck.is_banded(c):
            got, want = selfcheck.case_frames(name, c, dev, goldens)
            check(name, got, want, pix_tol=c.get("pix_tol", PIX_TOL))

    # ---- 7. banded main path at full width ---------------------------------
    log(f"== 7. banded main path: Renderer(sort_bands={G}), same scene and cameras")
    bcounted = (banded.interleave_rows_padded, banded.stack_rows, banded.compact_rows,
                expand.emit_slots_banded, ranges.tile_edges, raster.rasterize_tiles)
    uniform_rows = brenderer.band_rows.copy()
    for i in range(3):  # the capacities and the band rows settle from the previous frame
        before = (brenderer.capacity, brenderer.compact_capacity)
        brenderer.render(cams[0])
        if (brenderer.capacity, brenderer.compact_capacity) == before:
            break
    log(f"  {i + 1} warm-up frames: capacity {brenderer.capacity}, compact capacity "
        f"{brenderer.compact_capacity}, band rows {brenderer.band_rows.tolist()}")
    # The kernels once more, at the shapes the timed frames run: the settled
    # capacities and the rebalanced, non-uniform band rows.  These are the
    # times and bounds of the kernels line.
    log("  banded kernel parity at the settled shapes")
    settled_kernels, k1b = banded_parity(
        _band_rows_tensor(brenderer.band_rows, bcfg, dev), brenderer.capacity,
        brenderer.compact_capacity, must_fit=True)
    kernels.update(settled_kernels)
    torch.cuda.synchronize()

    brecs, blaunches, btrace, banded_numbers = graphed_orbit("banded", brenderer, cams, bcounted)
    bframes = [rec["image"] for rec in brecs[:len(cams)]]
    bcands = [rec["after"][4] for rec in brecs[:len(cams)]]
    log(f"  pairs/frame mean {sum(bcands) / len(bcands):.0f}, capacity {brenderer.capacity}, "
        f"compact capacity {brenderer.compact_capacity}")
    for i, rec in enumerate(brecs):
        img, (cap_, ccap_) = rec["image"], rec["key"]
        cands_, totals_, splats_ = rec["after"][4], rec["after"][6], rec["after"][7]
        require(img.shape == (1024, 1024, 4) and img[..., 3].max() == 255
                and img[..., :3].max() > 0, f"banded frame {i} is blank or misshapen")
        require(max(totals_) <= cap_ // G and max(splats_) <= ccap_ // G,
                f"banded frame {i}: a band saturated (totals {totals_}, splats {splats_}, "
                f"capacity {cap_}, compact {ccap_})")
        require(sum(totals_) == cands_, f"banded frame {i}: band totals do not add up")
    require(bcands == cands, f"banded candidates {bcands} differ from the flat path's {cands}")
    check("banded frame 0 vs flat frame 0", bframes[0], frames[0])
    rows_now = brenderer.band_rows
    log(f"  band rows after the orbit: {rows_now.tolist()}; last per-band totals "
        f"{brecs[-1]['after'][6]}")
    require(not (rows_now == uniform_rows).all(), "the band rows never moved off uniform")
    require(rows_now[0] == 0 and rows_now[-1] == bcfg.tiles_y and (rows_now[1:] >= rows_now[:-1]).all(),
            f"band rows {rows_now.tolist()} are not a monotone partition of the tile rows")
    bstages = brenderer.profile_frame(cams[1], warmup=True)
    log("  per-stage ms (the frame record's device stamps): "
        + ", ".join(f"{k} {v:.3f}" for k, v in bstages.items())
        + f"; sum {sum(bstages.values()):.3f}")

    def replayed_ms(r):
        t0_ = time.perf_counter()
        for c_ in cams:
            r.render(c_)
            require(r.last_method == "replay", "a settled orbit did not replay")
        return (time.perf_counter() - t0_) * 1e3 / len(cams)

    turns = [replayed_ms(r) for r in (renderer, brenderer, renderer, brenderer, renderer)]
    log("  replayed Renderer.render ms/frame, in turns (flat, banded, flat, banded, flat): "
        + ", ".join(f"{t:.3f}" for t in turns))
    # How much of a frame the card works: the traced pass's kernel and copy
    # time against the untraced frame times.
    for label, nums, replayed in (("flat", flat_numbers, turns[0::2]),
                                  ("banded", banded_numbers, turns[1::2])):
        nums["turns_ms"] = replayed
        nums["idle_share"] = 1 - nums["busy_ms"] / (sum(replayed) / len(replayed))
        nums["eager_idle_share"] = 1 - nums["busy_ms"] / nums["eager_loop_ms"]
        log(f"  {label}: device busy {nums['busy_ms']:.3f} ms/frame; idle share of a replayed "
            f"frame {nums['idle_share']:.3f}, of an eager frame {nums['eager_idle_share']:.3f}")
        log(f"  {label} numbers [{card}]: {json.dumps(nums)}")

    # ---- 8. scene IO on the card -------------------------------------------
    log("== 8. scene IO: the 1M-splat SH-3 scene through .ply (native and Python "
        "importers), .splat and PNG")
    scene_io(scene, cams, frames[0], config, dev)

    # ---- 9. the bench --------------------------------------------------------
    log("== 9. bench: python -m cudagaussianrenderer_torch.bench 1000000 8")
    from cudagaussianrenderer_torch import bench

    t0 = time.perf_counter()
    head = bench.main(["1000000", "8"])
    require(not head["saturated"] and head["pairs_per_frame"] > 0 and "stages_ms" in head,
            f"the bench's line is not a clean measurement: {head}")
    require(head["method"] == "cuda_graph", f"the bench's headline is not graphed: {head}")
    require(head["graph_frames_equal"] == 8,
            f"{head['graph_frames_equal']} of 8 graphed frames equal the eager ones")
    busy = head["device_busy_ms"]
    log(f"  bench: graphed {head['ms_per_frame']} ms/frame ({head['value']} FPS), eager "
        f"{head['eager_ms_per_frame']} ms/frame ({head['eager_fps']} FPS), eager / graphed "
        f"{head['eager_ms_per_frame'] / head['ms_per_frame']:.2f}; device busy in a trace of "
        f"one graphed orbit: "
        + ("not measured (the trace holds no device time)" if busy is None else
           f"{busy} ms/frame, idle share {1 - busy / head['ms_per_frame']:.3f}"))
    log(f"  every graphed frame byte-equal to its camera's eager frame; no host sync in the "
        f"frame under the sync debug mode; {head['pairs_per_frame']} pairs/frame, "
        f"in {time.perf_counter() - t0:.1f} s (its JSON lines above)")

    # ---- 10. the CLI and the viewer at full width ------------------------------
    import tempfile

    with tempfile.TemporaryDirectory(prefix="gsr_cli_") as tmp:
        log("== 10. CLI and viewer: 1M splats SH-3 at 1024x1024 through cli.main")
        t0 = time.perf_counter()
        cli_and_viewer(dev, Path(tmp))
        log(f"  phase 10 in {time.perf_counter() - t0:.1f} s")

        # ---- 11. the differentiable path and fitting ------------------------------
        log("== 11. diff and fit: card vs CPU at 128x128; render --depth and fit --dataset "
            "at 1024x1024 through cli.main")
        t0 = time.perf_counter()
        diff_card_vs_cpu(dev)
        diff_and_fit(dev, Path(tmp))
        log(f"  phase 11 in {time.perf_counter() - t0:.1f} s")

        # ---- 12. multi-device ----------------------------------------------------
        log("== 12. multi-device: render_band of 2, 4 and 8 balanced bands at 1M splats "
            "1024x1024; a world-size-1 NCCL group; the projected N-card frame")
        t0 = time.perf_counter()
        multi = multi_device(dev, renderer.scene, cams, frames, config, renderer.capacity,
                             Path(tmp), card)
        log(f"  phase 12 in {time.perf_counter() - t0:.1f} s")

        # ---- 13. the measurement tools ---------------------------------------------
        log("== 13. measurement tools: bench_suite configs 1-6, fit_artifact, make_artifact, "
            "sh_basis")
        t0 = time.perf_counter()
        measurement_tools(dev, Path(tmp), card, head)
        log(f"  phase 13 in {time.perf_counter() - t0:.1f} s")

    # ---- 14. the measurement harness --------------------------------------------
    log("== 14. measurement harness: every measure subcommand at 1M splats 1024x1024, "
        "capacity 4,587,520; selfcheck")
    t0 = time.perf_counter()
    measure_harness(dev, card, goldens)
    log(f"  phase 14 in {time.perf_counter() - t0:.1f} s")

    # ---- 15. the graft entry -----------------------------------------------------
    log("== 15. the graft entry: graft_entry.entry() eager, captured and replayed; "
        "dryrun_multichip over NCCL at the visible card count")
    t0 = time.perf_counter()
    graft_entry_phase(dev, card)
    log(f"  phase 15 in {time.perf_counter() - t0:.1f} s")

    P = "cudagaussianrenderer_tpu/ops/"
    # name -> (source file, counted wrapper, path that runs it, TPU kernel)
    names = {
        "splat": ("splat", "splat_columns", (launches, trace),
                  "none: stages A-C are plain jnp there (ops/sh.py, ops/projection.py, "
                  "ops/binning.py)"),
        "sort": ("sort", "sort_words", (launches, trace),
                 "none: stage D is lax.sort there (ops/sorting.py)"),
        "edges": ("edges", "tile_edges", (launches, trace), P + "ranges.py:40"),
        "interleave": ("interleave", "interleave_rows", (launches, trace), P + "expand.py:107"),
        "emit": ("emit", "emit_slots", (launches, trace), P + "expand.py:206"),
        "raster": ("raster", "rasterize_tiles", (launches, trace), P + "raster.py:132"),
        "interleave_padded": ("interleave", "interleave_rows_padded", (blaunches, btrace),
                              P + "banded.py:55"),
        "stack": ("stack", "stack_rows", (blaunches, btrace), P + "banded.py:265"),
        "compact": ("compact", "compact_rows", (blaunches, btrace), P + "banded.py:88"),
        "emit_banded": ("emit", "emit_slots_banded", (blaunches, btrace),
                        P + "expand.py:206 (bpb > 0; launched at ops/banded.py:517)"),
    }
    line = []
    for key, (source, wrapper, (counts_of, records_of), replaces) in names.items():
        k = kernels[key]
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        # K4 has two operation floors: f32 and the special-function units.
        ops_ms = max(k.get("ops", 0) / F32_OPS_PER_S * 1e3, k.get("sfu_ms", 0.0))
        line.append(dict(
            name=key,
            route="cuda",
            source=f"cudagaussianrenderer_torch/csrc/{source}.cu",
            replaces=replaces,
            launches=counts_of[wrapper],
            replayed_launches=records_of[wrapper],
            max_abs_err=k["max_abs_err"],
            ms=k["ms"],
            device_ms=k["device_ms"],
            plain_ms=k["plain_ms"],
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            library_ms=k["library_ms"],
        ))
    # Stage D: its parts, the yardsticks, the build.
    line[1].update({k: v for k, v in kernels["sort"].items()
                    if k.startswith(("part_", "library_device", "flipped"))
                    or k in ("slots", "candidates", "peak_bytes", "build_s")})
    # K1 also runs once per banded frame, in its segmented mode.
    line[2].update(banded_launches=blaunches["tile_edges"],
                   banded_replayed_launches=btrace["tile_edges"], **k1b)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"multi_device": multi}), flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
