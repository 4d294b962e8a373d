"""The compiled-numerics check of the JAX repository (tools/tpu_selfcheck.py)
on the port: small scenes rendered through the hand-written kernels on the
card, each against the float64 oracle golden.py.

    python -m cudagaussianrenderer_torch.tools.selfcheck [--device cuda|cpu]

The CPU tests hold each kernel's plain PyTorch version; this is the one
command that holds the kernels themselves, compiled for the card, to the
oracle.  It renders the JAX check's ten single-frame scenes (the same scene
arguments, padding, capacities, compacted-splat capacities and pixel
tolerances, the pix_tol = 5 margin scene included) and its balanced-bands
case (each of two balanced bands through parallel.distributed.render_band,
the placed frames summed), and holds each frame to the suite's rule: at
most 2% of pixels off by more than ``pix_tol`` levels (8 unless the case
says otherwise; tests/test_pipeline.py).  A case whose pair list or
compacted-splat axis saturates raises: raise its capacity.  Prints a line a
case, then PASS (exit 0) or FAILED with the drifting cases (exit 1).
``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..golden import golden_render, scene_to_numpy
from ..models.camera import Camera
from ..models.scene import random_scene
from ..render import render_frame
from ..utils.device import resolve_device

PIX_TOL, BAD_FRAC = 8, 0.02
HUGE = dict(min_scale=0.3, max_scale=1.6, extent=3.0)

# (name, case): n splats from seed (sh: SH degree; scene_kw: random_scene's
# scales), padded to ``pad`` (256), framed; ``capacity`` (16,384) pair
# slots, ``ccap`` compacted splats of a banded frame, ``pix_tol`` levels.
CASES = (
    ("gaussian 128px", dict(n=500, seed=2, cfg=dict(screen_size=128))),
    ("epanechnikov 128px", dict(n=500, seed=2, cfg=dict(screen_size=128,
                                                        falloff="epanechnikov"))),
    ("sh-degree-3 128px", dict(n=300, seed=8, sh=3, cfg=dict(screen_size=128))),
    ("rect 192x128", dict(n=400, seed=6, cfg=dict(screen_size=192, screen_height=128))),
    # Tall and wide splats (rects over 8 rows or 63 tiles at 1024px): the
    # emit kernel's full-rect rows and their quotient decode.
    ("huge splats 1024px", dict(n=192, seed=9, scene_kw=HUGE, cfg=dict(screen_size=1024),
                                capacity=524288)),
    # Two-word (tile, depth) keys, the path of screens over 8,191 tiles.
    ("lex keys (depth_bits=32)", dict(n=400, seed=2, cfg=dict(screen_size=128,
                                                              depth_bits=32))),
    # The banded frame: band compaction (K5-K7), the banded emit (K8), the
    # per-band sort and the segmented ranges (K1); the huge splats also
    # cross band boundaries.  ccap keeps the compaction from saturating.
    ("banded G=8 128px", dict(n=500, seed=2, cfg=dict(screen_size=128, sort_bands=8),
                              ccap=8 * 1024)),
    ("banded G=16 huge 1024px", dict(n=192, seed=9, scene_kw=HUGE,
                                     cfg=dict(screen_size=1024, sort_bands=16),
                                     capacity=1048576, ccap=16 * 1024)),
    # A splat count of whole 4,096-splat blocks, as every production scene.
    ("prod no-pad interleave 4096", dict(n=500, seed=5, pad=4096, cfg=dict(screen_size=128),
                                         capacity=16384)),
    # A tighter margin than the suite's, so that drift shows here first.
    ("scan-limb margin 128px", dict(n=350, seed=4, cfg=dict(screen_size=128), pix_tol=5)),
)

# Two balanced bands of parallel.distributed.render_band, summed.
BALANCED = ("balanced bands 2-dev 128px", dict(n=500, seed=2, cfg=dict(screen_size=128),
                                               capacity=16384, n_dev=2))


def is_banded(case: dict) -> bool:
    return case["cfg"].get("sort_bands", 0) > 1


def case_scene(case: dict, dev: torch.device):
    """(scene on ``dev``, its config, the framed camera's data)."""
    config = RenderConfig(**case["cfg"])
    scene = random_scene(case["n"], seed=case["seed"], sh_degree=case.get("sh", 0), device=dev,
                         **case.get("scene_kw", {})).pad_to_multiple(case.get("pad", 256))
    cam = Camera(aspect=config.aspect).framed(scene.bounds_min, scene.bounds_max)
    return scene, config, cam.camera_data()


def _golden(case: dict, scene, cd, config: RenderConfig, cache) -> np.ndarray:
    """golden.py's frame of the case.  The oracle ignores ``sort_bands`` (a
    banded frame must equal the flat one), so ``cache`` (a dict, or None)
    keeps one frame for the cases that differ only in it (the two huge-splat
    scenes at 1024², about 18 s each on a CPU; the balanced-bands case and
    the first one)."""
    cfg = {k: v for k, v in case["cfg"].items() if k != "sort_bands"}
    key = repr((case["n"], case["seed"], case.get("sh", 0), case.get("scene_kw"),
                case.get("pad", 256), sorted(cfg.items())))
    if cache is None or key not in cache:
        frame = golden_render(scene_to_numpy(scene), cd, config)
        if cache is None:
            return frame
        cache[key] = frame
    return cache[key]


def case_frames(name: str, case: dict, dev: torch.device,
                golden_cache=None) -> Tuple[np.ndarray, np.ndarray]:
    """The case's frame through the port on ``dev`` and golden.py's, as
    [H, W, 4] uint8 arrays (golden frames shared through ``golden_cache``,
    see _golden).  Raises if a list saturated."""
    scene, config, cd = case_scene(case, dev)
    capacity = case.get("capacity", 16384)
    ccap = case.get("ccap", 0)
    got, aux = render_frame(scene, cd, config, capacity, compact_capacity=ccap, device=dev)
    if int(aux["num_candidates"]) > capacity:
        raise RuntimeError(f"{name}: {int(aux['num_candidates'])} candidates saturate "
                           f"capacity {capacity}: raise the case's capacity")
    if is_banded(case):
        g = config.sort_bands
        if int(aux["band_totals"].max()) > capacity // g:
            raise RuntimeError(f"{name}: a band saturated: raise the case's capacity")
        if int(aux["band_splats"].max()) > ccap // g:
            raise RuntimeError(f"{name}: band compaction saturated: raise the case's ccap")
    return got.cpu().numpy(), _golden(case, scene, cd, config, golden_cache)


def balanced_frames(case: dict, dev: torch.device,
                    golden_cache=None) -> Tuple[np.ndarray, np.ndarray]:
    """Each band of ``case["n_dev"]`` balanced bands rendered by render_band,
    the placed frames summed (bands partition the rows, so no pixel may
    exceed 255), and golden.py's frame (see case_frames)."""
    from ..parallel.distributed import render_band

    scene, config, cd = case_scene(case, dev)
    total = sum(render_band(scene, cd, config, case["capacity"], case["n_dev"], d,
                            device=dev)[0].to(torch.int32) for d in range(case["n_dev"]))
    if int(total.max()) > 255:
        raise RuntimeError("two balanced bands overlap")
    return total.to(torch.uint8).cpu().numpy(), _golden(case, scene, cd, config, golden_cache)


def compare(got: np.ndarray, want: np.ndarray, pix_tol: int = PIX_TOL) -> Tuple[float, int]:
    """(share of pixels with a channel off by more than ``pix_tol``, the
    largest difference)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    return float((diff > pix_tol).any(axis=-1).mean()), int(diff.max())


def run(dev: torch.device, golden_cache=None) -> List[str]:
    """Every case on ``dev``, a line each; returns the names of the cases
    that drifted.  ``golden_cache`` (a dict) keeps golden.py's frames for
    another call (see _golden)."""
    cache = {} if golden_cache is None else golden_cache
    failures = []
    for name, case in CASES + (BALANCED,):
        if case is BALANCED[1]:
            got, want = balanced_frames(case, dev, cache)
        else:
            got, want = case_frames(name, case, dev, cache)
        bad, worst = compare(got, want, case.get("pix_tol", PIX_TOL))
        status = "ok" if bad <= BAD_FRAC else "DRIFT"
        print(f"{name:42s} bad_px={bad:.4f} max_diff={worst:3d}  {status}", flush=True)
        if bad > BAD_FRAC:
            failures.append(name)
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    kernels = "the hand-written kernels" if dev.type == "cuda" else "their plain versions"
    print(f"device: {dev.type} ({kernels})", flush=True)
    failures = run(dev)
    if failures:
        print(f"FAILED: {failures}", flush=True)
        return 1
    print("PASS: the kernels match the golden oracle", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
