"""The JAX package's benchmark suite (tools/bench_suite.py) on the port: the
five BASELINE.json configs and one diagnostic, one JSON line each.

    1. Procedural 10k splats, SH degree 0, 256x256, static camera (16
       frames of camera 0)
    2. A 100k-splat .ply (synth_ply: written by write_gaussian_ply and
       loaded back by the importer), SH degree 0, 512x512, 16 orbit frames
    3. View-dependent SH degree 3, 1M splats, 1024x1024, 8 orbit frames
    4. Gaussian against Epanechnikov falloff, 1M splats, 1024x1024, 8
       orbit frames (two lines)
    5. 1M splats at 1024x1024 over 16 orbit frames: the headline config,
       the bench's workload
    6. Diagnostic: 1M splats with trained-3DGS-like opacities
       (np.random.default_rng(1).beta(0.5, 1.5, n)), opacity-aware extents
       off and on (two lines)

Run it on the card:

    python -m cudagaussianrenderer_torch.tools.bench_suite          # all configs
    python -m cudagaussianrenderer_torch.tools.bench_suite 1 3      # a subset

Method, the bench's (bench.measure_orbit): the scene padded to 4,096
splats; the capacity from a probe of the candidate count of every
rendered camera (camera 0 alone when static), times 1.005, rounded up to
whole groups of 4,096 slots and at least 4,096 (the suite's own rule, not
the bench's floor of 2^17); the eager orbit warmed once; one flat frame
captured as a CUDA graph and replayed for each camera, every graphed frame
checked byte for byte against its eager frame; best of 3, host clock.  A
capture that fails, or a graphed frame that differs, raises: nothing falls
back to the eager figure.

Each line carries the JAX suite's keys (``config``, ``ms_per_frame``
graphed, ``fps``, ``pairs_per_frame``, ``capacity``), then ``splats``,
``size``, ``frames``, ``method``, ``eager_ms_per_frame``,
``graph_frames_equal``, ``device_busy_ms`` (a frame, from a trace of one
graphed orbit), ``saturated``, ``peak_allocated_mb`` (the card's
``max_memory_allocated`` over the measurement, the scene included; null on
the CPU) and ``device`` (the card's name and power limit).  Each config's graph and scene are dropped, and the allocator's
cache emptied, before the next one.

Only the default sizes are the configs.  ``--n-scale``, ``--frames-scale``
and ``--size-scale`` multiply the splat counts, frame counts and screen
sizes, so that a test or a smoke run can drive the same code small.  The
default device is the card, and without one the suite raises;
``--device cpu`` runs the eager loop over the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
from typing import Iterator, Tuple

import numpy as np
import torch

from .. import bench
from ..config import RenderConfig
from ..models.camera import orbit_cameras
from ..models.scene import SH_C0, GaussianScene, random_scene
from ..ply import load_gaussian_ply, write_gaussian_ply
from ..utils.device import resolve_device
from ..utils.quantize import decode_quat_xyzw

CONFIGS = (1, 2, 3, 4, 5, 6)
# The suite's procedural scenes (tools/bench_suite.py:128-181).
SCALES = dict(min_scale=0.002, max_scale=0.053)


def synth_ply(n: int, seed: int, device=None) -> GaussianScene:
    """A raw .ply synthesized through the exporter and loaded back through
    the importer (the scene-ingestion path), as tools/bench_suite.py's
    synth_ply: the values of ``random_scene(n, seed)`` with the suite's
    scales, its packed rotations decoded.  A stream takes the Python
    importer in both packages."""
    scene = random_scene(n, seed=seed, device="cpu", **SCALES)
    opac = np.clip(scene.opacities.numpy(), 1e-6, 1 - 1e-6)
    xyzw = decode_quat_xyzw(scene.quats.numpy().view(np.uint32))
    buf = io.BytesIO()
    write_gaussian_ply(
        buf,
        scene.means.numpy().T,
        np.log(scene.scales.numpy().T),
        xyzw[:, [3, 0, 1, 2]],
        np.log(opac / (1.0 - opac)),
        (scene.colors.numpy().T - 0.5) / SH_C0,
    )
    buf.seek(0)
    return load_gaussian_ply(buf, device=device)


def realistic_opacities(n: int) -> np.ndarray:
    """Config 6's trained-3DGS-like opacities: a heavy low-alpha tail."""
    return np.random.default_rng(1).beta(0.5, 1.5, n).astype(np.float32)


def throughput(scene: GaussianScene, config: RenderConfig, frames: int, dev: torch.device, *,
               static_camera: bool = False) -> Tuple[dict, dict]:
    """One config line's numbers (without ``config``) and bench.measure_orbit's
    record: ``scene`` over ``frames`` orbit cameras (``frames`` copies of
    camera 0 when ``static_camera``)."""
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, frames)
    if static_camera:
        cams = [cams[0]] * frames
    capacity = bench.probe_capacity(scene, cams[:1] if static_camera else cams, config, dev,
                                    floor=bench.GRAIN)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    m = bench.measure_orbit(scene, cams, config, capacity, dev)
    ms = m["ms_per_frame"]
    busy = m["device_busy_ms"]
    line = dict(
        ms_per_frame=round(ms, 3),
        fps=round(1e3 / ms, 2),
        pairs_per_frame=m["pairs_per_frame"],
        capacity=capacity,
        splats=scene.count,
        size=config.screen_size,
        frames=frames,
        method=m["method"],
        eager_ms_per_frame=round(m["eager_ms_per_frame"], 3),
        graph_frames_equal=m["graph_frames_equal"],
        device_busy_ms=None if busy is None else round(busy, 3),
        saturated=m["saturated"],
        peak_allocated_mb=(round(torch.cuda.max_memory_allocated(dev) / 2**20, 1) if cuda
                           else None),
        device=bench.device_line(dev),
    )
    return line, m


def _scaled(value: int, scale: float, least: int = 1) -> int:
    return max(least, int(round(value * scale)))


def runs(which, dev: torch.device, *, n_scale: float = 1.0, frames_scale: float = 1.0,
         size_scale: float = 1.0) -> Iterator[Tuple[str, GaussianScene, RenderConfig, int, bool]]:
    """(config name, scene, render config, frames, static camera) for each
    line of the configs in ``which``, in the suite's order; a config's
    scene is built when it is reached and released after its lines."""

    def n(count):
        return _scaled(count, n_scale)

    def frames(count):
        return _scaled(count, frames_scale)

    def cfg(size, **kw):
        # Whole 16-pixel tiles.
        return RenderConfig(screen_size=_scaled(size // 16, size_scale) * 16, **kw)

    def padded(scene):
        return scene.pad_to_multiple(bench.GRAIN)

    if 1 in which:
        scene = random_scene(n(10_000), seed=0, device=dev, **SCALES)
        yield "1_procedural_10k_256px_static", padded(scene), cfg(256), frames(16), True
    if 2 in which:
        yield "2_ply_100k_512px_orbit", padded(synth_ply(n(100_000), 1, dev)), cfg(512), \
            frames(16), False
    if 3 in which:
        scene = random_scene(n(1_000_000), seed=0, sh_degree=3, device=dev, **SCALES)
        yield "3_sh_deg3_1m_1024px_orbit", padded(scene), cfg(1024), frames(8), False
    if 4 in which:
        scene = padded(random_scene(n(1_000_000), seed=0, device=dev, **SCALES))
        for falloff in ("gaussian", "epanechnikov"):
            yield (f"4_falloff_{falloff}_1m_1024px", scene, cfg(1024, falloff=falloff),
                   frames(8), False)
    if 5 in which:
        scene = random_scene(n(1_000_000), seed=0, device=dev, **SCALES)
        yield "5_flythrough_1m_1024px", padded(scene), cfg(1024), frames(16), False
    if 6 in which:
        scene = random_scene(n(1_000_000), seed=0, device=dev, **SCALES)
        alpha = torch.from_numpy(realistic_opacities(scene.count)).to(dev)
        scene = padded(dataclasses.replace(scene, opacities=alpha))
        for flag in (False, True):
            name = "aware" if flag else "exact3sigma"
            yield (f"6_realistic_alpha_{name}_1m", scene,
                   cfg(1024, opacity_aware_extents=flag), frames(8), False)


def main(argv=None) -> list:
    """Print one JSON line a config line; return [(line, measure_orbit's
    record)] in order.  Raises, after the line has printed, unless every
    graphed frame of a line equals its eager frame."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", type=int, choices=CONFIGS)
    ap.add_argument("--n-scale", type=float, default=1.0)
    ap.add_argument("--frames-scale", type=float, default=1.0)
    ap.add_argument("--size-scale", type=float, default=1.0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = []
    for name, scene, config, frames, static in runs(
            set(args.configs) or set(CONFIGS), dev, n_scale=args.n_scale,
            frames_scale=args.frames_scale, size_scale=args.size_scale):
        line, m = throughput(scene, config, frames, dev, static_camera=static)
        line = dict(config=name, **line)
        print(json.dumps(line), flush=True)
        out.append((line, m))
        bench._require_graph_equal(line, frames)
        del scene
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
