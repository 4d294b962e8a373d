"""The headline config's artifact (the JAX package's tools/make_artifact.py
on the port): a 1M-splat SH-degree-3 scene written to a real .ply, ingested
through the native C++ importer onto the card, benched at 1024x1024 with
the bench's graphed method, with PNG frames saved.

    python -m cudagaussianrenderer_torch.tools.make_artifact [--frames 8]
        [--out artifacts/torch_h100] [--device cuda|cpu]

The .ply holds the raw (pre-activation) values of the JAX tool's numpy
draws (random_scene's distributions with the suite's scales and SH bands
1-15 from N(0, 0.15)); it is written to a temporary directory unless
``--ply`` names a path.  The native importer (native/libgsply.so, built by
``make -C native`` at first use) loads it; when that library cannot be
built or loaded the tool raises, and never falls back to the Python
importer (the record's ``importer`` says which ran).  The capacity is the
JAX tool's: the largest candidate count of frames 0 and frames // 2, 4%
headroom, whole 2^16-slot groups.  The bench is bench.measure_orbit (the eager orbit, then one frame
captured as a CUDA graph and replayed for each orbit camera, every graphed
frame byte-equal to its eager frame; best of 3, host clock).  Frames 0 and
frames // 2 are written as artifact_1m_sh3_frame{i}.png, and the record as
artifact_1m_sh3.json, with the JAX record's keys and ``importer``,
``device`` (the card's name and power limit), ``method``,
``eager_ms_per_frame``, ``graph_frames_equal``, ``device_busy_ms`` and
``saturated``.  ``--n`` and ``--size`` shrink the run for a smoke test;
only the defaults are the artifact.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def write_scene_ply(path, n: int) -> None:
    """The JAX tool's raw .ply: pure numpy, random_scene's distributions
    (seed 0, scales 0.002-0.053) with SH degree 3."""
    from ..models.scene import SH_C0
    from ..ply import write_gaussian_ply

    rng = np.random.default_rng(0)
    means = rng.uniform(-4.0, 4.0, (n, 3)).astype(np.float32)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.0, np.pi, n)
    s, c = np.sin(angle * 0.5), np.cos(angle * 0.5)
    xyzw = np.concatenate([axis * s[:, None], c[:, None]], axis=1).astype(np.float32)
    scales = rng.uniform(0.002, 0.053, (n, 3)).astype(np.float32)
    rgba = rng.uniform(0.0, 1.0, (n, 4)).astype(np.float32)
    k = 16  # (degree 3 + 1)^2 SH bands
    sh = np.zeros((n, k, 3), np.float32)
    sh[:, 0, :] = (rgba[:, :3] - 0.5) / SH_C0
    sh[:, 1:, :] = rng.normal(scale=0.15, size=(n, k - 1, 3))
    opac = np.clip(rgba[:, 3], 1e-6, 1 - 1e-6)
    write_gaussian_ply(
        path,
        means,
        np.log(scales),
        xyzw[:, [3, 0, 1, 2]],
        np.log(opac / (1.0 - opac)),
        sh[:, 0, :],                            # f_dc
        np.transpose(sh[:, 1:, :], (0, 2, 1)),  # f_rest [N, 3, K-1]
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--ply", default=None, help="the .ply to write (default: a temporary file)")
    ap.add_argument("--out", default="artifacts/torch_h100")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(args: argparse.Namespace) -> dict:
    """The artifact for ``args`` (parser()'s namespace); returns the record."""
    if args.ply is None:
        with tempfile.TemporaryDirectory(prefix="gsr_artifact_") as tmp:
            return _run(args, Path(tmp) / "scene_1m_sh3.ply")
    return _run(args, Path(args.ply))


def _run(args: argparse.Namespace, ply_path: Path) -> dict:
    from .. import bench
    from ..config import RenderConfig
    from ..models.camera import orbit_cameras
    from ..ply import load_gaussian_ply
    from ..render import render_frame
    from ..utils.device import resolve_device
    from ..utils.native import native_available
    from ..utils.png import write_png

    dev = resolve_device(args.device)
    if not native_available():
        raise RuntimeError("the native .ply importer (native/libgsply.so) did not build or load")

    # ---- the raw .ply (pre-activation storage format) ----
    t0 = time.perf_counter()
    write_scene_ply(ply_path, args.n)
    size_mb = ply_path.stat().st_size / 1e6
    print(f"wrote {ply_path} ({size_mb:.0f} MB) in {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)

    # ---- ingest through the importer onto the device ----
    t0 = time.perf_counter()
    scene = load_gaussian_ply(ply_path, use_native=True, device=dev).pad_to_multiple(4096)
    load_s = time.perf_counter() - t0
    print(f"native import: {scene.count} splats, SH degree {scene.sh_degree}, "
          f"{load_s:.2f}s", file=sys.stderr)
    if scene.sh_degree != 3 or scene.count != args.n:
        raise RuntimeError(f"imported {scene.count} splats of SH degree {scene.sh_degree}")

    # ---- bench: the graphed orbit at size x size (the bench's method) ----
    config = RenderConfig(screen_size=args.size)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, args.frames)
    shown = (0, args.frames // 2)
    capacity = bench.probe_capacity(scene, [cams[i] for i in shown], config, dev,
                                    floor=1 << 16, headroom=1.04, grain=1 << 16)
    m = bench.measure_orbit(scene, cams, config, capacity, dev)
    ms = m["ms_per_frame"]

    # ---- save PNG frames ----
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    for i in shown:
        img, _ = render_frame(scene, cams[i].camera_data(), config, capacity, device=dev)
        write_png(outdir / f"artifact_1m_sh3_frame{i}.png", img.cpu().numpy())

    busy = m["device_busy_ms"]
    result = dict(
        config="artifact_1m_sh3_native_ply_1024px",
        splats=args.n,
        sh_degree=3,
        ply_mb=round(size_mb, 1),
        native_import_s=round(load_s, 2),
        ms_per_frame=round(ms, 2),
        fps=round(1e3 / ms, 2),
        pairs_per_frame=m["pairs_per_frame"],
        capacity=capacity,
        importer="native",
        size=args.size,
        frames=args.frames,
        method=m["method"],
        eager_ms_per_frame=round(m["eager_ms_per_frame"], 2),
        graph_frames_equal=m["graph_frames_equal"],
        device_busy_ms=None if busy is None else round(busy, 3),
        saturated=m["saturated"],
        device=bench.device_line(dev),
    )
    print(json.dumps(result), flush=True)
    (outdir / "artifact_1m_sh3.json").write_text(json.dumps(result, indent=1))
    bench._require_graph_equal(result, args.frames)
    return result


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
