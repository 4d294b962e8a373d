"""Training-path convergence artifact (the JAX package's tools/fit_artifact.py
on the port): fit splats to a posed-image dataset and record PSNR before and
after, on the card unless ``--device cpu``.

The loop it runs end to end: a procedural scene (``random_scene(3000,
seed=7)``) -> Renderer.render of an orbit -> dataset.export_dataset
(transforms.json and PNGs) or a COLMAP workspace (PNGs, sparse/0 with SfM
points) -> dataset.load_posed -> diff.fit with the 3DGS loss (L1 0.8 +
D-SSIM 0.2), Adam or diff.tx_3dgs, optional density control and pose
refinement -> Renderer.render of the fitted scene -> PSNR over black
against the targets.

    python -m cudagaussianrenderer_torch.tools.fit_artifact [--steps 600]
        [--optimizer adam|3dgs] [--layout transforms|colmap]
        [--perturb-poses SIGMA] [--refine-poses] [--out artifacts/torch_h100]
        [--device cuda|cpu]

The flags and defaults are the JAX tool's, but ``--out`` defaults to
artifacts/torch_h100 (the JAX records in artifacts/ stay as they are) and
``--dataset-dir`` to a temporary directory.  It writes fit_init.png,
fit_final.png, fit_target.png and fit_dataset.json (the JAX record's keys,
``backend`` the card's name and power limit) into ``--out``.  The pair-list
capacity is the JAX tool's, ``round_capacity(32 * n_fit)``: diff.fit warns
when a view's candidates exceed it and the frame trains on a truncated
list; nothing is truncated silently.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = float(np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(1.0 / mse)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene-splats", type=int, default=3000)
    ap.add_argument("--fit-splats", type=int, default=2000)
    ap.add_argument("--views", type=int, default=10)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--densify-every", type=int, default=0)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--optimizer", choices=("adam", "3dgs"), default="adam")
    ap.add_argument("--layout", choices=("transforms", "colmap"), default="transforms",
                    help="dataset layout to exercise; colmap additionally inits splats from "
                         "the exported SfM point cloud")
    ap.add_argument("--perturb-poses", type=float, default=0.0, metavar="SIGMA",
                    help="corrupt the stored poses (rotation SIGMA rad, translation "
                         "SIGMA*extent) before fitting: the pose-refinement testbed")
    ap.add_argument("--refine-poses", action="store_true")
    ap.add_argument("--camera-lr", type=float, default=1e-3)
    ap.add_argument("--out", default="artifacts/torch_h100")
    ap.add_argument("--dataset-dir", default=None,
                    help="where the dataset is written (default: a temporary directory)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def run(args: argparse.Namespace) -> dict:
    """The artifact for ``args`` (parser()'s namespace): writes the PNGs and
    fit_dataset.json into ``args.out`` and returns the record."""
    if args.dataset_dir is None:
        with tempfile.TemporaryDirectory(prefix="gsr_fit_dataset_") as tmp:
            return _run(args, Path(tmp))
    return _run(args, Path(args.dataset_dir))


def _run(args: argparse.Namespace, root: Path) -> dict:
    from .. import dataset, diff
    from ..bench import device_line
    from ..config import RenderConfig
    from ..models.camera import orbit_cameras
    from ..models.scene import random_scene
    from ..render import Renderer, round_capacity
    from ..utils.device import resolve_device
    from ..utils.png import write_png

    dev = resolve_device(args.device)
    backend = device_line(dev)
    print(f"backend: {backend}", file=sys.stderr)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    # 1. Ground-truth scene -> dataset on disk (the exportable layout).
    scene = random_scene(args.scene_splats, seed=7, device=dev)
    config = RenderConfig(screen_size=args.size)
    renderer = Renderer(scene, config, device=dev)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, args.views)
    stored_cams = cams
    extent = float(np.linalg.norm(np.asarray(scene.bounds_max) - np.asarray(scene.bounds_min)))
    if args.perturb_poses > 0:
        # Targets come from the TRUE cameras; the dataset stores noisy
        # poses, the situation --refine-poses exists for.
        prng = np.random.default_rng(13)
        stored_cams = [
            diff.refined_camera(
                c,
                args.perturb_poses * prng.standard_normal(3),
                args.perturb_poses * extent * prng.standard_normal(3),
            )
            for c in cams
        ]
    t0 = time.perf_counter()
    if args.layout == "colmap":
        from .. import colmap

        (root / "images").mkdir(parents=True, exist_ok=True)
        names = []
        for i, cam in enumerate(cams):
            name = f"frame_{i:04d}.png"
            write_png(root / "images" / name, renderer.render(cam))
            names.append(name)
        n_pts = min(args.fit_splats, scene.count)
        idx = np.random.default_rng(0).choice(scene.count, n_pts, replace=False)
        tpath = colmap.export_model(
            root, stored_cams, names, args.size, args.size,
            scene.means.cpu().numpy().T[: scene.count][idx].astype(np.float32),
            np.full((n_pts, 3), 0.5, np.float32),
        )
    else:
        tpath = dataset.export_dataset(root, renderer, cams)
        if args.perturb_poses > 0:
            dataset.write_transforms(
                tpath, stored_cams, [f"frame_{i:04d}.png" for i in range(len(cams))])
    print(f"exported {args.views} views -> {tpath} ({time.perf_counter() - t0:.1f}s)",
          file=sys.stderr)

    # 2. Load it back the way a user with captured data would.
    ds = dataset.load_posed(root)
    loaded_cams, targets = ds.cameras, ds.images
    cam_data = [c.camera_data() for c in loaded_cams]

    # 3. Init: SfM points (colmap layout) or random in rig bounds.
    lo, hi = dataset.init_bounds_from_cameras(loaded_cams)
    if args.layout == "colmap":
        params = diff.init_from_points(ds.points_xyz, ds.points_rgb, device=dev)
        print(f"init from {ds.points_xyz.shape[0]} SfM points", file=sys.stderr)
    else:
        params = diff.random_init(args.fit_splats, lo, hi, seed=0, scale=0.05, device=dev)

    def eval_psnr(p):
        r = Renderer(diff.to_scene(p), config, device=dev)
        vals = []
        for cam, tgt in zip(loaded_cams, targets):
            img = r.render(cam).astype(np.float32) / 255.0
            rgb = img[..., :3] * img[..., 3:4]  # over black, like targets
            vals.append(psnr(rgb, tgt))
        return float(np.mean(vals)), r

    psnr_init, r_init = eval_psnr(params)
    write_png(out / "fit_init.png", r_init.render(loaded_cams[0]))

    # 4. Fit with the 3DGS loss (L1 0.8 + D-SSIM 0.2, L2 dropped).
    n_fit = int(params.means.shape[-1])
    capacity = round_capacity(32 * n_fit, dev)
    structure = diff.build_structure(params, cam_data[0], config, capacity, device=dev)
    k_max = max(256, 2 * diff.max_tile_count(structure))
    print(f"fitting {n_fit} splats, capacity {capacity}, k_max {k_max}, {args.steps} steps",
          file=sys.stderr)
    tx = None
    if args.optimizer == "3dgs":
        fit_extent = float(np.linalg.norm(np.asarray(hi) - np.asarray(lo)))
        tx = diff.tx_3dgs(fit_extent, args.steps)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    fit_out = diff.fit(
        params, cam_data, targets, config,
        capacity=capacity, k_max=k_max, steps=args.steps,
        learning_rate=args.lr, tx=tx,
        l1_weight=0.8, ssim_weight=0.2, l2_weight=0.0,
        densify_every=args.densify_every,
        optimize_cameras=args.refine_poses, camera_lr=args.camera_lr,
        log_every=max(1, args.steps // 10), device=dev,
    )
    pose_err = None
    if args.refine_poses:
        params, losses, deltas = fit_out
        dr = deltas.dr.detach().cpu().numpy()
        dt_c = deltas.dt.detach().cpu().numpy()
        loaded_cams = [diff.refined_camera(c, dr[i], dt_c[i]) for i, c in enumerate(loaded_cams)]
        # Pose error against the TRUE rig, before and after refinement
        # (position only; rotation follows the same trend).
        err0 = [float(np.linalg.norm(np.asarray(a.position) - np.asarray(b.position)))
                for a, b in zip(stored_cams, cams)]
        err1 = [float(np.linalg.norm(np.asarray(a.position) - np.asarray(b.position)))
                for a, b in zip(loaded_cams, cams)]
        pose_err = {
            "pose_pos_err_before": round(float(np.mean(err0)), 5),
            "pose_pos_err_after": round(float(np.mean(err1)), 5),
        }
        print(f"pose error (mean position): {np.mean(err0):.5f} -> {np.mean(err1):.5f}",
              file=sys.stderr)
    else:
        params, losses = fit_out
    dt = time.perf_counter() - t0  # fit returns its losses on the host: the card is done

    psnr_fit, r_fit = eval_psnr(params)
    write_png(out / "fit_final.png", r_fit.render(loaded_cams[0]))
    write_png(out / "fit_target.png", (targets[0] * 255 + 0.5).astype(np.uint8))

    rec = {
        "backend": backend,
        "scene_splats": args.scene_splats,
        "fit_splats_final": int(params.means.shape[-1]),
        "views": args.views,
        "size": args.size,
        "steps": args.steps,
        "densify_every": args.densify_every,
        "optimizer": args.optimizer,
        "layout": args.layout,
        "perturb_poses": args.perturb_poses,
        "refine_poses": bool(args.refine_poses),
        **(pose_err or {}),
        "loss_first": round(float(losses[0]), 5),
        "loss_last": round(float(losses[-1]), 5),
        "psnr_init_db": round(psnr_init, 2),
        "psnr_fit_db": round(psnr_fit, 2),
        "fit_seconds": round(dt, 1),
        "ms_per_step": round(1e3 * dt / args.steps, 1),
    }
    (out / "fit_dataset.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
