"""Benchmark of the port: the JAX package's bench.py headline, on one card.

    python -m cudagaussianrenderer_torch.bench [n_splats] [frames] [--size N]
        [--falloff gaussian|epanechnikov] [--no-stages]
        [--force-fallback-capacity] [--device cpu|cuda] [--devices N]

Workload, as bench.py: ``random_scene(n, seed=0, min_scale=0.002,
max_scale=0.053, extent=4.0)`` padded to a multiple of 4,096 (about 4 pairs
a splat, the reference's Lilly Boquet density) at ``--size``² over
``frames`` orbit cameras.  The pair-list capacity comes from a probe of
every camera's candidate count with 0.5% headroom, rounded up to 4,096
slots (or, with --force-fallback-capacity, 4.6 pairs a splat).

Headline, on the card: one flat frame (``render_frame_tensors`` at that
capacity) captured as a CUDA graph and replayed once for each camera, the
camera refilled before each replay by a device-to-device copy from a
[frames, CAMERA_FLOATS] table built on the card once; one synchronise at
the end of the orbit, best of 3 repetitions, host clock.  That is bench.py's
jitted scan over the orbit: the host's dispatch is left out, so the figure
is the card's pace.  Before the capture one eager frame runs under
``torch.cuda.set_sync_debug_mode("error")``, so a host sync or a
host-to-device copy inside the frame raises.  A capture or replay that
fails raises too: the bench never falls back to the eager figure.

It prints bench.py's headline JSON keys (``metric``, ``value``, ``unit``,
``vs_baseline``, ``ms_per_frame``, ``pairs_per_frame``,
``pairs_per_sec_M``, ``capacity``, ``devices``) plus
``method`` ("cuda_graph" on the card, "eager" on the CPU);
``eager_fps`` and ``eager_ms_per_frame``, the same orbit as ``render_frame``
calls issued from Python back to back (the host's launch rate);
``graph_frames_equal``, how many graphed frames equal the eager frame of
their camera byte for byte (it raises after printing unless all do);
``device_busy_ms``, kernel and copy time per frame in a torch.profiler trace
of one graphed orbit (null if the trace holds none);
``saturated`` (a frame's candidates exceeded the capacity, so it rendered
truncated) and ``device`` (the card's name and power limit, or "cpu").
``pairs_per_frame`` and ``saturated`` come from each replay's counts.
Then, unless --no-stages, the same object with ``stages_ms``
(``Renderer.profile_frame`` of the first camera under the reference's stage
names: CUDA events on the card, the host clock where ``device`` is "cpu")
as the last line.

The default device is the card, and without one the bench raises.
``--device cpu`` runs the eager loop over the kernels' plain versions, for a
smoke test of this script: ``method`` "eager", the CPU's times, null
``graph_frames_equal`` and ``device_busy_ms``.

``--devices N`` > 1 renders every frame tile-row sharded over N ranks
(parallel.launch.spawn starts one process a card, NCCL, or with
``--device cpu`` N gloo ranks on the CPU), as bench.py's ``--devices``: the
scene padded to 4,096 x N splats, a per-rank capacity of twice the probed
capacity over N on the grain.  On the card the headline replays the rank's
frame (collectives included) captured as one CUDA graph: a
DistributedRenderer at that capacity, its frames_on_device over a
[frames, CAMERA_FLOATS] table on the card (``method`` "cuda_graph"; a warm-up
orbit runs the key's eager first frame and its capture), every graphed
frame checked against the eager frame of its camera (``graph_frames_equal``; it raises after printing
unless all are equal); beside it ``eager_ms_per_frame``, the orbit through
parallel.distributed.render_frames_tilesharded.  Both are timed on rank 0's
host clock between a barrier and a synchronise, best of 3, with rank 0's
``device_busy_ms`` from a trace of one graphed orbit (its NCCL kernels,
waits for the other ranks included) and ``collective_ms``, a key of this
line only, those NCCL kernels' part of it; the rest is the rank's own
work.  On the CPU the orbit is eager (``method`` "eager"; both keys null).
``pairs_per_frame`` is the frame's (the bands partition the pairs) and
``saturated`` says whether a band's candidates exceeded the per-rank
capacity.  One line, no stages.  More ranks than cards raise; nothing
falls back to fewer cards or to the CPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from .config import RenderConfig
from .models.camera import orbit_cameras
from .models.scene import random_scene
from .ops.binning import splat_row_packs, splat_tile_rects
from .ops.projection import project_splats
from .render import (
    Renderer, camera_array, camera_tensors, camera_views, capture_frame, render_frame,
    render_frame_tensors,
)
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


def probe_capacity(scene, cams, config: RenderConfig, dev, floor: int = 1 << 17,
                   headroom: float = 1.005, grain: int = GRAIN) -> int:
    """bench.py's capacity: the largest candidate count over every camera
    of ``cams``, 0.5% headroom, whole GRAIN groups, at least ``floor``
    slots (bench.py's 2^17; tools/bench_suite.py's GRAIN).  The JAX
    package's tools/make_artifact.py takes 4% headroom on a 2^16 grain
    (``headroom``, ``grain``)."""
    counts = []
    for c in cams:
        cam = camera_tensors(c.camera_data(), dev)
        clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                              opacities=scene.opacities)
        counts.append(splat_row_packs(clip, splat_tile_rects(clip, config), config).counts.sum())
    candidates = int(torch.stack(counts).max())
    capacity = max(floor, -(-int(candidates * headroom) // grain) * grain)
    _log(f"probe: max candidates {candidates} -> capacity {capacity}")
    return capacity


class GraphedOrbit:
    """One flat frame captured as a CUDA graph over a static camera buffer
    (render.capture_frame, as Renderer captures its frames), replayed once
    for each camera of ``cams``.

    The kernel wrappers' launch counters count the capture, not the
    replays: a replay runs on the card without calling any wrapper.  A
    graph holds no reference to the tensors it reads, so the orbit holds
    ``scene`` until it is dropped.
    """

    def __init__(self, scene, cams, config: RenderConfig, capacity: int, dev: torch.device):
        self.scene = scene
        self.table = torch.from_numpy(
            np.stack([camera_array(c.camera_data()) for c in cams])).to(dev)
        self.cam = self.table[0].clone()
        views = camera_views(self.cam)

        def frame():
            image, aux = render_frame_tensors(scene, views, config, capacity)
            return image, torch.stack([aux["num_pairs"], aux["num_candidates"]])

        self.graph, (self.image, self.counts) = capture_frame(frame, dev)
        self.frames = len(cams)

    def run(self, images: bool = False):
        """Replay every camera; returns ([frames, 2] (num_pairs,
        num_candidates) on the card, and each frame's image copied out of
        the static output when ``images``).  Nothing waits for the card."""
        stats = torch.empty((self.frames, 2), dtype=self.counts.dtype, device=self.counts.device)
        out = []
        for i in range(self.frames):
            self.cam.copy_(self.table[i])
            self.graph.replay()
            stats[i].copy_(self.counts)
            if images:
                out.append(self.image.clone())
        return stats, out


def device_ms_by_name(fn) -> dict:
    """Device time (ms) of each kernel and copy name that ``fn()`` enqueues,
    summed over its records in a torch.profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}


def device_busy_ms(fn) -> float | None:
    """Summed device time (ms) of every kernel and copy that ``fn()``
    enqueues, from a torch.profiler trace; None if the trace holds none."""
    ms = sum(device_ms_by_name(fn).values())
    return ms if ms > 0 else None


def _headline(args, ms_per_frame, pairs_per_frame, capacity, devices, **extra) -> dict:
    """bench.py's headline keys, then ``extra``."""
    fps = 1e3 / ms_per_frame
    pairs_per_sec = pairs_per_frame * fps
    return {
        "metric": f"fps_{args.size}x{args.size}_{args.n_splats // 1000}k_splats",
        "value": round(fps, 2),
        "unit": "frames/s",
        # > 1: a higher sorted-pair throughput than the reference's.
        "vs_baseline": round(pairs_per_sec / REF_PAIRS_PER_SEC, 3),
        "ms_per_frame": round(ms_per_frame, 3),
        "pairs_per_frame": pairs_per_frame,
        "pairs_per_sec_M": round(pairs_per_sec / 1e6, 1),
        "capacity": capacity,
        "devices": devices,
        **extra,
    }


def _sharded_rank(a: dict) -> dict:
    """One rank of ``--devices N``: the bench's scene and orbit, every frame
    tile-row sharded over the ranks; on the card the rank's frame replayed
    from one CUDA graph (a DistributedRenderer at the bench's capacity),
    beside the eager orbit.  Returns the headline (rank 0's clock)."""
    import torch.distributed as dist

    from .parallel.distributed import (
        DistributedRenderer, make_mesh, render_frames_tilesharded, stack_cameras,
    )

    args = argparse.Namespace(**a)
    mesh = make_mesh()
    dev, world = mesh.device, mesh.shape["tiles"]
    scene = random_scene(args.n_splats, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                         device=dev).pad_to_multiple(GRAIN * world)
    config = RenderConfig(screen_size=args.size, falloff=args.falloff)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, args.frames)
    if args.force_fallback_capacity:
        capacity = -(-int(args.n_splats * 4.6) // GRAIN) * GRAIN
    else:
        capacity = probe_capacity(scene, cams, config, dev)
    # Per rank: the frame's capacity over the ranks, with 2x for the skew
    # between bands (the middle bands carry more pairs than the mean).
    capacity = max(GRAIN, -(-capacity * 2 // world // GRAIN) * GRAIN)
    batch = stack_cameras(cams)
    cuda = dev.type == "cuda"

    def eager_orbit():
        images, aux = render_frames_tilesharded(scene, batch, config, capacity, mesh)
        return torch.stack([aux["num_pairs"], aux["num_candidates"]], 1), images

    def best_of_3(orbit):
        best = float("inf")
        for _ in range(3):
            dist.barrier()
            if cuda:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            stats, _ = orbit()
            if cuda:
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3 / args.frames, stats

    _, eager_frames = eager_orbit()
    eager_ms, stats = best_of_3(eager_orbit)
    ms_per_frame, graph_equal, busy, nccl = eager_ms, None, None, None
    if cuda:
        r = DistributedRenderer(scene, config, mesh=mesh)
        r.capacity = capacity
        table = torch.from_numpy(
            np.stack([camera_array(c.camera_data()) for c in cams])).to(dev)

        def graphed_orbit():
            # (num_pairs, num_candidates) a frame, and the frames.
            images, counts = r.frames_on_device(table)
            return counts.flip(1), images

        graphed_orbit()  # the key's first frame eager, its second captured
        _, graph_frames = graphed_orbit()
        if r.last_method != "replay":
            raise RuntimeError(f"the sharded orbit did not replay: {r.last_method}")
        graph_equal = sum(bool(torch.equal(a, b)) for a, b in zip(graph_frames, eager_frames))
        del graph_frames
        ms_per_frame, stats = best_of_3(graphed_orbit)
        by_name = device_ms_by_name(graphed_orbit)
        busy = sum(by_name.values())
        nccl = sum(ms for name, ms in by_name.items() if "nccl" in name.lower())
    del eager_frames
    stats = stats.cpu()
    cands = int(stats[:, 1].max())
    if cands > capacity:
        _log(f"pair list saturated: a band's {cands} candidates > per-rank capacity {capacity}")
    return _headline(
        args, ms_per_frame, int(stats[:, 0].double().mean()), capacity, world,
        method="cuda_graph" if cuda else "eager", eager_fps=round(1e3 / eager_ms, 2),
        eager_ms_per_frame=round(eager_ms, 3), graph_frames_equal=graph_equal,
        device_busy_ms=None if busy is None else round(busy / args.frames, 3),
        collective_ms=None if nccl is None else round(nccl / args.frames, 3),
        saturated=cands > capacity, device=device_line(dev))


def _require_graph_equal(result: dict, frames: int) -> None:
    """Raise, after the headline has printed, unless every graphed frame
    equals the eager frame of its camera."""
    equal = result["graph_frames_equal"]
    if result["method"] == "cuda_graph" and equal != frames:
        raise RuntimeError(f"only {equal} of {frames} graphed frames equal the eager frames of "
                           "their cameras")


def measure_orbit(scene, cams, config: RenderConfig, capacity: int, dev: torch.device) -> dict:
    """The headline's measurement of one orbit on one device: ``scene``
    rendered at ``capacity`` for each camera of ``cams``.

    The eager loop (render_frame calls issued back to back, nothing
    waits) is warmed once and timed best of 3; on the card the frame is
    then captured as a GraphedOrbit, its frames checked against the eager
    ones byte for byte, timed best of 3 and traced once.  Host clock, one
    synchronise at the end of each orbit.  Returns ``method``,
    ``ms_per_frame`` (graphed on the card, else the eager figure),
    ``eager_ms_per_frame``, ``graph_frames_equal`` and ``device_busy_ms``
    a frame (None on the CPU; busy also None if the trace holds no device
    time), ``pairs_per_frame`` (the mean), ``saturated``, ``frame_pairs``
    (each camera's num_pairs) and ``frame0`` (camera 0's eager frame as
    NumPy).  The orbit's graph is dropped on return."""
    cuda = dev.type == "cuda"
    frames = len(cams)
    cam_data = [c.camera_data() for c in cams]

    def eager_orbit(images=False):
        """Every frame issued from Python back to back; nothing waits."""
        outs = [render_frame(scene, cd, config, capacity, device=dev) for cd in cam_data]
        stats = torch.stack([torch.stack([a["num_pairs"], a["num_candidates"]])
                             for _, a in outs])
        return stats, [img for img, _ in outs] if images else []

    def best_of_3(orbit):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            stats, _ = orbit()
            if cuda:
                torch.cuda.synchronize(dev)
            best = min(best, time.perf_counter() - t0)
        return best * 1e3 / frames, stats

    _log("warming the eager orbit...")
    _, eager_frames = eager_orbit(images=True)
    frame0 = eager_frames[0].cpu().numpy()
    eager_ms, stats = best_of_3(eager_orbit)
    graph_equal = busy = None
    if cuda:
        _log("capturing the frame as a CUDA graph...")
        graphed = GraphedOrbit(scene, cams, config, capacity, dev)
        _, graph_frames = graphed.run(images=True)
        graph_equal = sum(bool(torch.equal(a, b)) for a, b in zip(graph_frames, eager_frames))
        del graph_frames
        ms_per_frame, stats = best_of_3(graphed.run)
        busy = device_busy_ms(graphed.run)
        busy = None if busy is None else busy / frames
        del graphed
    else:
        ms_per_frame = eager_ms
    del eager_frames
    stats = stats.cpu()
    saturated = int(stats[:, 1].max()) > capacity
    if saturated:
        _log(f"pair list saturated: max candidates {int(stats[:, 1].max())} > capacity "
             f"{capacity}; a frame rendered truncated")
    return dict(method="cuda_graph" if cuda else "eager", ms_per_frame=ms_per_frame,
                eager_ms_per_frame=eager_ms, graph_frames_equal=graph_equal,
                device_busy_ms=busy, pairs_per_frame=int(stats[:, 0].double().mean()),
                saturated=saturated, frame_pairs=stats[:, 0].tolist(), frame0=frame0)


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
    if args.devices < 1:
        raise ValueError(f"--devices must be >= 1, got {args.devices}")
    dev = resolve_device(args.device)
    if args.devices > 1:
        from .parallel.launch import spawn

        result = spawn(_sharded_rank, args.devices, dev.type, vars(args))[0]
        print(json.dumps(result), flush=True)
        _log(f"headline ({args.devices} ranks, {result['method']}): {result['value']} FPS "
             f"({result['ms_per_frame']} ms/frame); eager {result['eager_fps']} FPS")
        _require_graph_equal(result, args.frames)
        return result
    scene = random_scene(args.n_splats, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                         device=dev).pad_to_multiple(GRAIN)
    config = RenderConfig(screen_size=args.size, falloff=args.falloff)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, args.frames)
    if args.force_fallback_capacity:
        capacity = -(-int(args.n_splats * 4.6) // GRAIN) * GRAIN
        _log(f"capacity probe skipped: fallback capacity {capacity}")
    else:
        capacity = probe_capacity(scene, cams, config, dev)

    m = measure_orbit(scene, cams, config, capacity, dev)
    result = _headline(
        args, m["ms_per_frame"], m["pairs_per_frame"], capacity, 1, method=m["method"],
        eager_fps=round(1e3 / m["eager_ms_per_frame"], 2),
        eager_ms_per_frame=round(m["eager_ms_per_frame"], 3),
        graph_frames_equal=m["graph_frames_equal"],
        device_busy_ms=None if m["device_busy_ms"] is None else round(m["device_busy_ms"], 3),
        saturated=m["saturated"], device=device_line(dev))
    print(json.dumps(result), flush=True)
    _log(f"headline ({result['method']}): {result['value']} FPS ({result['ms_per_frame']} "
         f"ms/frame); eager {result['eager_fps']} FPS ({result['eager_ms_per_frame']} ms/frame)")
    _require_graph_equal(result, args.frames)
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
