"""The JAX repository's entry points (``__graft_entry__.py``) on the port:
``entry()`` gives one frame's function and its example arguments, and
``dryrun_multichip(n)`` runs one sharded frame, its balanced-band and
single-device twins, a 2-D mesh batch and one data-parallel training step on
``n`` ranks, each checked.

    python -m cudagaussianrenderer_torch.graft_entry [--device cpu]
    python -m cudagaussianrenderer_torch.graft_entry multichip [N] [--device cpu]

The first renders ``entry()``'s frame: on the card once eagerly under
``render.run_sync_free``, then captured as a CUDA graph and replayed, and it
raises unless the replay equals the eager frame byte for byte; it prints the
image's shape.  The second runs ``dryrun_multichip(N)``: N ranks through
``parallel.launch.spawn``, NCCL with a card a rank (N defaults to the
visible cards, and more ranks than cards raises), or gloo ranks on the CPU
with ``--device cpu``; it ends with a JSON line of rank 0's numbers by
check (seconds, launches of the per-splat kernel and K1-K4, pairs).

The JAX ``fn`` is jittable; its counterpart here is capturable: ``fn(scene,
cam)`` takes the camera as device tensors (``render.camera_tensors``) and
runs ``render.render_frame_tensors``, which copies nothing from the host.
Where the JAX dry run re-executes itself on a virtual CPU mesh, the ranks
here are processes; each check raises on failure, rank 0 prints the JAX
check's line with its numbers, and ``dryrun_multichip`` returns rank 0's
numbers.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import diff
from .config import RenderConfig
from .models.camera import Camera, orbit_cameras
from .models.scene import random_scene
from .ops.expand import emit_slots, interleave_rows
from .ops.ranges import tile_edges
from .ops.raster import rasterize_tiles
from .ops.splat import splat_columns
from .parallel import launch
from .parallel.distributed import (
    make_mesh, make_mesh_2d, render_frame_sharded, render_frames_sharded, stack_cameras,
)
from .parallel.train import make_train_step_dp, view_batch
from .render import camera_tensors, capture_frame, render_frame, render_frame_tensors, run_sync_free
from .utils.device import resolve_device

# The kernels of this path (the per-splat kernel of stages A-C, K1-K4),
# whose launches each check counts.
KERNELS = (splat_columns, tile_edges, interleave_rows, emit_slots, rasterize_tiles)


def entry(device=None):
    """One frame of a 4,096-splat SH-2 scene at 256x256 on ``device``
    (default: the card).  Returns ``(fn, example_args)``: ``fn(scene, cam)``
    renders the [256, 256, 4] uint8 image of the scene from the camera
    tensors ``cam`` (projection, binning, sort, ranges, blend), and
    ``example_args`` is the scene and its framing camera's tensors."""
    dev = resolve_device(device)
    config = RenderConfig(screen_size=256)
    scene = random_scene(4096, seed=0, sh_degree=2, device=dev).pad_to_multiple(256)
    camera = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    capacity = config.tile_capacity(scene.count)

    def fn(scene, cam):
        image, _ = render_frame_tensors(scene, cam, config, capacity)
        return image

    return fn, (scene, camera_tensors(camera.camera_data(), dev))


def capture_entry(fn, args):
    """``fn(*args)`` on the card: once eagerly under run_sync_free, then
    captured as a CUDA graph (render.capture_frame) and replayed.  Returns
    (the eager image, the graph, its static output as replayed).  Raises
    unless the replay equals the eager frame byte for byte."""
    dev = args[0].device
    eager = run_sync_free(lambda: fn(*args))
    graph, replayed = capture_frame(lambda: fn(*args), dev, checked=True)
    graph.replay()
    torch.cuda.synchronize(dev)
    if not torch.equal(replayed, eager):
        raise RuntimeError("the replayed entry frame differs from the eager one")
    return eager, graph, replayed


def _checked(name, out, mesh, run):
    """Run one check, ``run() -> (numbers, line)``, with each kernel's
    launch count set to 0 just before and read just after; rank 0 prints
    the line.  Its numbers, seconds and launches go into ``out[name]``."""
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    numbers, line = run()
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    out[name] = dict(numbers, seconds=time.perf_counter() - t0,
                     launches={k.__name__: k.launches for k in KERNELS})
    if torch.distributed.get_rank() == 0:
        print(f"dryrun_multichip({mesh.shape['tiles']}): {line} OK", flush=True)


def _dryrun_rank(n: int) -> dict:
    """One rank of dryrun_multichip's ``n``-rank group: the five checks of
    the JAX dry run.  Returns each check's numbers (NumPy and Python
    values), check 1's image among them."""
    mesh = make_mesh(n)
    dev = mesh.device
    if dev.type == "cpu":
        # Every rank is a process on the same cores.
        torch.set_num_threads(1)
    out = {}
    config = RenderConfig(screen_size=256)
    # Splat count divisible by the mesh; tiny but non-trivial.
    scene = random_scene(256 * n, seed=1, sh_degree=1, device=dev).pad_to_multiple(256 * n)
    camera = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    capacity = 16384

    def uniform():
        image, aux = render_frame_sharded(scene, camera.camera_data(), config, capacity, mesh)
        image, pairs = image.cpu().numpy(), int(aux["num_pairs"])
        if image.shape != (256, 256, 4) or pairs <= 0:
            raise AssertionError(f"sharded frame {image.shape} with {pairs} pairs")
        return (dict(image=image, pairs=pairs, candidates=int(aux["num_candidates"])),
                f"render image {image.shape}, pairs={pairs}")

    _checked("uniform", out, mesh, uniform)

    def balanced():
        # Balanced (equal-work) tile-row bands, bounded on the device each frame.
        bconfig = dataclasses.replace(config, balanced_bands=True)
        _, aux = render_frame_sharded(scene, camera.camera_data(), bconfig, capacity, mesh)
        pairs, worst = int(aux["num_pairs"]), int(aux["num_candidates"])
        if pairs != out["uniform"]["pairs"]:
            raise AssertionError(f"balanced bands hold {pairs} pairs, uniform bands "
                                 f"{out['uniform']['pairs']}: they must partition one set")
        return (dict(pairs=pairs, candidates=worst),
                f"balanced bands worst-band candidates {worst} vs uniform "
                f"{out['uniform']['candidates']}")

    _checked("balanced", out, mesh, balanced)

    def parity():
        # Sharded against single-device pixels under a stable sort, so that
        # depth ties order alike in the bands' and the whole frame's lists.
        # Small splats keep every tile rect under MAX_PACK_ROWS, so the flat
        # path's tall-rect fallback never fires and both lists hold the same
        # pairs.  The single-device frame needs the mesh's whole capacity.
        pscene = random_scene(256 * n, seed=3, max_scale=0.04, sh_degree=1,
                              device=dev).pad_to_multiple(256 * n)
        pcam = Camera(aspect=1.0).framed(pscene.bounds_min, pscene.bounds_max).camera_data()
        sconfig = dataclasses.replace(config, stable_sort=True)
        image_s, aux_s = render_frame_sharded(pscene, pcam, sconfig, capacity, mesh)
        image_1, aux_1 = render_frame(pscene, pcam, sconfig, capacity * n, device=dev)
        d = (image_s.to(torch.int32) - image_1.to(torch.int32)).abs()
        frac, worst = float((d > 1).double().mean()), int(d.max())
        pairs_s, pairs_1 = int(aux_s["num_pairs"]), int(aux_1["num_pairs"])
        if frac > 0.001:
            raise AssertionError(f"sharded vs single-device pixel mismatch {frac}")
        if pairs_s != pairs_1:
            raise AssertionError(f"sharded frame {pairs_s} pairs, single-device {pairs_1}")
        return (dict(frac=frac, max_diff=worst, pairs=pairs_1),
                f"sharded == single-device pixels (>1-level frac {frac:.4f}, max diff {worst})")

    _checked("parity", out, mesh, parity)

    if n >= 4 and n % 2 == 0:
        def mesh_2d():
            # Frames on the outer axis, tile rows on the inner one; frame 0
            # at check 1's camera, frame 1 an orbit view.
            mesh2 = make_mesh_2d(2, n // 2)
            cams2 = [camera, orbit_cameras(scene.bounds_min, scene.bounds_max, 4)[1]]
            imgs, _ = render_frames_sharded(scene, stack_cameras(cams2), config, capacity, mesh2)
            imgs = imgs.cpu().numpy()
            if imgs.shape != (2, 256, 256, 4):
                raise AssertionError(f"2-D mesh batch {imgs.shape}")
            d = np.abs(imgs[0].astype(int) - out["uniform"]["image"].astype(int))
            frac = float((d > 2).any(axis=-1).mean())
            if frac > 0.001:
                raise AssertionError(f"2D-mesh frame-0 pixel mismatch {frac}")
            return (dict(frac=frac),
                    f"2D mesh (2x{n // 2}) batch render {imgs.shape}, frame-0 parity "
                    f"(mismatch frac {frac:.4f})")

        _checked("mesh_2d", out, mesh, mesh_2d)

    def dp_step():
        # One data-parallel training step: a view a rank, the gradients
        # all-reduced, replicated parameters and Adam state.
        tconfig = RenderConfig(screen_size=64)
        cams = orbit_cameras(scene.bounds_min, scene.bounds_max, n)
        rng = np.random.default_rng(0)
        targets = [rng.uniform(0, 1, (64, 64, 3)).astype(np.float32) for _ in range(n)]
        params = diff.random_init(64, scene.bounds_min, scene.bounds_max, seed=0, device=dev)
        tx = diff.Adam(1e-3)
        step, _ = make_train_step_dp(tconfig, 4096, 128, tx, make_mesh(axis="dp"))
        cams_b, tgts_b = view_batch([c.camera_data() for c in cams], targets, dev)
        new_params, _, loss = step(params, tx.init(params), cams_b, tgts_b)
        loss = float(loss)
        moved = float((new_params.means - params.means).abs().max())
        if not np.isfinite(loss) or moved <= 0.0:
            raise AssertionError(f"dp train step: loss {loss}, max param delta {moved}")
        return (dict(loss=loss, moved=moved),
                f"dp train step loss={loss:.4f}, max param delta={moved:.2e}")

    _checked("dp_step", out, mesh, dp_step)
    return out


def dryrun_multichip(n_devices: Optional[int] = None, device=None) -> dict:
    """The JAX dry run's five checks on ``n_devices`` ranks (default: the
    visible cards): NCCL with a card a rank on ``device`` "cuda" (the
    default), gloo ranks on "cpu".  Check 4, the 2-D mesh batch, runs
    only on an even count of 4 or more.  Raises if a check fails or a rank
    raises.  Returns rank 0's numbers by check ("uniform", "balanced",
    "parity", "mesh_2d", "dp_step"), each with its seconds and the
    launches of KERNELS on that rank, and check 1's image under "uniform"."""
    dev = resolve_device(device)
    if n_devices is None:
        if dev.type != "cuda":
            raise ValueError("n_devices=None counts the visible cards; give the number of "
                             "CPU ranks")
        n_devices = torch.cuda.device_count()
    return launch.spawn(_dryrun_rank, n_devices, dev.type, n_devices)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("command", nargs="?", choices=["multichip"],
                    help="run dryrun_multichip instead of the entry frame")
    ap.add_argument("n", nargs="?", type=int, help="ranks (default: the visible cards)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    if args.command == "multichip":
        out = dryrun_multichip(args.n, args.device)
        print("dryrun_multichip numbers:", json.dumps(
            {name: {k: v for k, v in c.items() if k != "image"} for name, c in out.items()}),
            flush=True)
        return 0
    fn, example_args = entry(args.device)
    if example_args[0].device.type == "cuda":
        image, _, _ = capture_entry(fn, example_args)
    else:
        image = fn(*example_args)
    print("entry:", tuple(image.shape), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
