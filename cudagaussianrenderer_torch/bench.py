"""Benchmark of the port: the JAX package's bench.py headline, on one card.

    python -m cudagaussianrenderer_torch.bench [n_splats] [frames] [--size N]
        [--falloff gaussian|epanechnikov] [--no-stages]
        [--force-fallback-capacity] [--device cpu|cuda]

Workload, as bench.py: ``random_scene(n, seed=0, min_scale=0.002,
max_scale=0.053, extent=4.0)`` padded to a multiple of 4,096 (about 4 pairs
a splat, the reference's Lilly Boquet density) at ``--size``² over
``frames`` orbit cameras.  The pair-list capacity comes from a probe of
every camera's candidate count with 0.5% headroom, rounded up to 4,096
slots (or, with --force-fallback-capacity, 4.6 pairs a splat).

Headline: ``render_frame`` over the orbit's frames issued back to back
with one synchronise at the end, best of 3 repetitions, host clock.  It
prints bench.py's headline JSON keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``ms_per_frame``, ``pairs_per_frame``,
``pairs_per_sec_M``, ``capacity``, ``devices``) plus ``saturated`` (a
frame's candidates exceeded the capacity, so it rendered truncated) and
``device`` (the card's name and power limit, or "cpu"); then, unless
--no-stages, the same object with ``stages_ms`` (``Renderer.profile_frame``
of the first camera under the reference's stage names: CUDA events on the
card, the host clock where ``device`` is "cpu") as the last line.

The default device is the card, and without one the bench raises: it
never falls back.  ``--device cpu`` runs the kernels' plain versions, for
a smoke test of this script; its times are the CPU's and its stage times
come from the host clock.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .config import RenderConfig
from .models.camera import orbit_cameras
from .models.scene import random_scene
from .ops.binning import splat_row_packs, splat_tile_rects
from .ops.projection import project_splats
from .render import Renderer, camera_tensors, render_frame
from .utils.device import resolve_device

T_START = time.monotonic()
# Pair-list capacity grain: whole 4,096-slot groups, as bench.py.
GRAIN = 4096
# The reference's pair throughput: Lilly Boquet, 815,957 splats at ~4
# pairs a splat in 12.502574 ms (its README.md:146,153).
REF_PAIRS_PER_SEC = 815_957 * 4.0 / 12.502574e-3


def _log(msg):
    print(f"[bench +{time.monotonic() - T_START:7.1f}s] {msg}", file=sys.stderr, flush=True)


def device_line(dev: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def probe_capacity(scene, cams, config: RenderConfig, dev) -> int:
    """bench.py's capacity: the largest candidate count over every camera,
    0.5% headroom, whole GRAIN groups, at least 2^17 slots."""
    counts = []
    for c in cams:
        cam = camera_tensors(c.camera_data(), dev)
        clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                              opacities=scene.opacities)
        counts.append(splat_row_packs(clip, splat_tile_rects(clip, config), config).counts.sum())
    candidates = int(torch.stack(counts).max())
    capacity = max(1 << 17, -(-int(candidates * 1.005) // GRAIN) * GRAIN)
    _log(f"probe: max candidates {candidates} -> capacity {capacity}")
    return capacity


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_splats", nargs="?", type=int, default=1_000_000)
    ap.add_argument("frames", nargs="?", type=int, default=32)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--falloff", choices=["gaussian", "epanechnikov"], default="gaussian")
    ap.add_argument("--no-stages", dest="stages", action="store_false")
    ap.add_argument("--force-fallback-capacity", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.devices != 1:
        raise NotImplementedError("the port renders on one device: --devices must be 1")
    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    scene = random_scene(args.n_splats, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                         device=dev).pad_to_multiple(GRAIN)
    config = RenderConfig(screen_size=args.size, falloff=args.falloff)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, args.frames)
    if args.force_fallback_capacity:
        capacity = -(-int(args.n_splats * 4.6) // GRAIN) * GRAIN
        _log(f"capacity probe skipped: fallback capacity {capacity}")
    else:
        capacity = probe_capacity(scene, cams, config, dev)

    cam_data = [c.camera_data() for c in cams]

    def orbit():
        """Every frame issued back to back; one synchronise at the end."""
        auxes = [render_frame(scene, cd, config, capacity, device=dev)[1] for cd in cam_data]
        stats = torch.stack([torch.stack([a["num_pairs"], a["num_candidates"]]) for a in auxes])
        sync()
        return stats

    _log("warming the orbit...")
    orbit()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        stats = orbit()
        best = min(best, time.perf_counter() - t0)
    stats = stats.cpu()
    ms_per_frame = best * 1e3 / args.frames
    fps = 1e3 / ms_per_frame
    pairs_per_frame = int(stats[:, 0].double().mean())
    saturated = int(stats[:, 1].max()) > capacity
    if saturated:
        _log(f"pair list saturated: max candidates {int(stats[:, 1].max())} > capacity "
             f"{capacity}; a frame rendered truncated")
    pairs_per_sec = pairs_per_frame * fps
    result = {
        "metric": f"fps_{args.size}x{args.size}_{args.n_splats // 1000}k_splats",
        "value": round(fps, 2),
        "unit": "frames/s",
        # > 1: a higher sorted-pair throughput than the reference's.
        "vs_baseline": round(pairs_per_sec / REF_PAIRS_PER_SEC, 3),
        "ms_per_frame": round(ms_per_frame, 2),
        "pairs_per_frame": pairs_per_frame,
        "pairs_per_sec_M": round(pairs_per_sec / 1e6, 1),
        "capacity": capacity,
        "devices": 1,
        "saturated": saturated,
        "device": device_line(dev),
    }
    print(json.dumps(result), flush=True)
    _log(f"headline: {result['value']} FPS ({result['ms_per_frame']} ms/frame)")
    if not args.stages:
        return result

    renderer = Renderer(scene, config, device=dev)
    renderer.capacity = capacity
    stages = renderer.profile_frame(cams[0], warmup=True)
    result["stages_ms"] = {k: round(v, 3) for k, v in stages.items()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
