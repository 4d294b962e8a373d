"""Headless command-line renderer of the port.

The reference app is ``GaussianRender <scene.ply>`` — a GLFW window with a
60 FPS frame loop and an exit-time per-stage timing report (its
src/Demo.cpp:196-566).  This CLI is the JAX package's (cudagaussianrenderer_tpu
cli.py) with the same subcommands and flags, rendering on the card: single
views, scripted orbit fly-throughs, a benchmark mode printing the same
per-stage stat names, an input-script frame loop, the live viewer, scene
conversion and merging, and image metrics.  It adds one flag, ``--device
{cuda,cpu}`` (default ``cuda``), passed to every scene, Renderer and
metric; without a card the default raises.  ``render`` renders its view
again while the frame overflowed a list of the fresh Renderer (the JAX
CLI writes that first, truncated frame: a banded Renderer's first frame at
1M splats overflows its compacted-splat axis).

Usage:
    python -m cudagaussianrenderer_torch.cli render scene.ply -o out.png
    python -m cudagaussianrenderer_torch.cli orbit scene.ply -o frames/ -n 60
    python -m cudagaussianrenderer_torch.cli bench --procedural 100000
    python -m cudagaussianrenderer_torch.cli serve scene.ply --port 8000
    python -m cudagaussianrenderer_torch.cli render --procedural 300 --device cpu
    python -m cudagaussianrenderer_torch.cli render scene.ply -o c.png --depth d.png
    python -m cudagaussianrenderer_torch.cli fit --dataset ws/ --init points \
        --optimizer 3dgs --densify-every 100 --holdout 8 -o fitted.ply

``fit`` and ``render --depth`` run the differentiable path (diff.py): its
pair structure comes from kernels K1-K3, its blend and gradient from
autograd.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np


def _add_device(p):
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where scenes, frames and metrics live (default: the card)")


def _add_common(p):
    p.add_argument("--size", type=int, default=1024, help="framebuffer width (and height unless --height)")
    p.add_argument("--height", type=int, default=None, help="framebuffer height (rectangular viewport)")
    p.add_argument("--falloff", choices=["gaussian", "epanechnikov"], default="gaussian")
    p.add_argument("--depth-bits", type=int, choices=[19, 32], default=19)
    p.add_argument(
        "--bands", type=int, default=0,
        help="band-segmented sort over N tile-row bands (0 = flat sort)",
    )
    p.add_argument("--raster-chunk", type=int, default=None)
    p.add_argument("--tiles-per-cell", type=int, default=None)
    p.add_argument("--capacity-factor", type=int, default=8)
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument(
        "--background", default=None, metavar="COLOR",
        help='opaque background: "white", "black", or "R,G,B" in [0,1] '
        "(default: reference-exact transparent-black clear)",
    )
    p.add_argument(
        "--procedural",
        type=int,
        default=None,
        metavar="N",
        help="use N random splats instead of a .ply scene (Demo.cpp:256-269)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sh-degree", type=int, default=0,
                   help="SH degree for procedural scenes and fitted models")
    _add_device(p)


def _parse_background(spec):
    if spec is None:
        return None
    named = {"white": (1.0, 1.0, 1.0), "black": (0.0, 0.0, 0.0)}
    if spec in named:
        return named[spec]
    try:
        return tuple(float(c) for c in spec.split(","))
    except ValueError:
        raise SystemExit(f'bad --background {spec!r}: use "white", "black" or R,G,B')


def _config_from_args(args):
    from .config import RenderConfig

    kwargs = dict(
        screen_size=args.size,
        screen_height=args.height,
        falloff=args.falloff,
        depth_bits=args.depth_bits,
        capacity_factor=args.capacity_factor,
        gamma=args.gamma,
        sort_bands=args.bands,
        background=_parse_background(args.background),
    )
    if args.raster_chunk is not None:
        kwargs["raster_chunk"] = args.raster_chunk
    if args.tiles_per_cell is not None:
        kwargs["tiles_per_cell"] = args.tiles_per_cell
    return RenderConfig(**kwargs)


def _build(args):
    # Import late so --help stays fast.
    from .models.camera import Camera
    from .models.scene import random_scene
    from .render import Renderer
    from .splatfile import load_scene
    from .utils.device import resolve_device

    config = _config_from_args(args)
    dev = resolve_device(args.device)

    if args.procedural is not None:
        scene = random_scene(args.procedural, seed=args.seed, sh_degree=args.sh_degree,
                             device=dev)
    elif args.scene:
        scene = load_scene(args.scene, device=dev)
    else:
        raise SystemExit("provide a scene .ply/.splat or --procedural N")

    print(
        f"scene: {scene.count} splats, SH degree {scene.sh_degree}, "
        f"bounds {np.round(scene.bounds_min, 3)}..{np.round(scene.bounds_max, 3)}",
        file=sys.stderr,
    )
    renderer = Renderer(scene, config, device=dev)
    camera = Camera(aspect=config.aspect).framed(scene.bounds_min, scene.bounds_max)
    return renderer, camera, scene, config


def cmd_render(args):
    from .utils.png import write_png

    renderer, camera, scene, config = _build(args)
    t0 = time.perf_counter()
    if args.passes > 1:
        # Multi-pass tile-row bands: effective capacity above the emit
        # kernel's 2^24 pair ceiling (render.render_frame_multipass).
        from .ops.expand import MAX_EXACT_I32
        from .render import render_frame_multipass, round_capacity

        # The initial per-pass sizing assumes pairs spread evenly over
        # tile-row slabs; center slabs can carry 2-3x the mean.  The
        # flag exists to render EXACTLY, so on per-pass saturation
        # retry once with the measured worst-pass requirement (the
        # reference's grow-on-saturation, Demo.cpp:356-366, at
        # pass granularity) and only then warn.
        cap = renderer.capacity // args.passes + 1024
        for _ in range(2):
            image, aux = render_frame_multipass(
                renderer.scene, camera.camera_data(), config,
                cap, args.passes, device=renderer.device,
            )
            pc = aux["pass_candidates"].cpu().numpy()
            pp = aux["pass_pairs"].cpu().numpy()
            if not (pp < pc).any():
                break
            need = int(pc.max()) + int(pc.max()) // 50 + 1024
            if need >= MAX_EXACT_I32 - 1024:
                print(
                    f"WARNING: a pass needs {int(pc.max())} pair slots, "
                    f"past the per-pass 2^24 ceiling — output truncated; "
                    f"re-run with more --passes",
                    file=sys.stderr,
                )
                break
            new_cap = round_capacity(need, renderer.device)
            if new_cap <= cap:
                break
            print(
                f"pass saturation ({int(pc.max())} candidates > {cap} "
                f"slots): regrowing per-pass capacity to {new_cap}",
                file=sys.stderr,
            )
            cap = new_cap
        image = image.cpu().numpy()
        print(f"multipass x{args.passes}: {int(aux['num_pairs'])} pairs",
              file=sys.stderr)
        if (pp < pc).any():
            print(
                f"WARNING: pass(es) {np.flatnonzero(pp < pc).tolist()} "
                f"still saturated — output is truncated; use more "
                f"--passes or a larger --capacity-factor",
                file=sys.stderr,
            )
    else:
        # A fresh Renderer sizes its lists from the splat count; a frame
        # that overflows one renders truncated and grows it for the next
        # frame.  One view should be exact, so render again while the frame
        # is truncated and a list grew (twice at most).
        def sizes():
            return renderer.capacity, getattr(renderer, "compact_capacity", 0)

        before = sizes()
        image = renderer.render(camera)
        for _ in range(2):
            if not renderer.last_truncated or (sizes() == before and not renderer.saturated):
                break
            print(f"frame truncated ({renderer.last_candidates} candidate pairs): "
                  f"rendering again with the lists grown to {sizes()}", file=sys.stderr)
            before = sizes()
            image = renderer.render(camera)
        if renderer.last_truncated:
            print("WARNING: the frame is still truncated — its pairs exceed the "
                  "capacity ceiling; use --passes", file=sys.stderr)
    print(f"rendered in {(time.perf_counter() - t0) * 1e3:.1f} ms (incl. kernel build)",
          file=sys.stderr)
    write_png(args.output, image)
    print(f"wrote {args.output}", file=sys.stderr)
    if args.depth:
        _write_depth(args.depth, renderer, camera, scene, config)


def _write_depth(path, renderer, camera, scene, config):
    """The expected-depth map of the differentiable path (a gather per pair
    and pixel: for inspection, not the frame loop), normalized near to far
    as black to white."""
    import torch

    from . import diff
    from .render import round_capacity
    from .utils.png import write_png

    dev = renderer.device
    with torch.no_grad():
        params = diff.from_scene(scene)
        cap = round_capacity(renderer.capacity, dev)
        structure = diff.build_structure(params, camera.camera_data(), config, cap, device=dev)
        k_max = max(128, diff.max_tile_count(structure))
        _, depth, _ = diff.render_diff(params, camera.camera_data(), config, cap, k_max,
                                       structure=structure, return_depth=True, device=dev)
    d = depth.cpu().numpy()
    lo, hi = float(d.min()), float(d.max())
    dn = (d - lo) / (hi - lo) if hi > lo else np.zeros_like(d)
    write_png(path, np.repeat((dn * 255 + 0.5).astype(np.uint8)[:, :, None], 3, axis=2))
    print(f"wrote {path} (depth range [{lo:.4f}, {hi:.4f}] linear clip)", file=sys.stderr)


def cmd_orbit(args):
    from .models.camera import orbit_cameras
    from .utils.png import write_png

    renderer, _, scene, config = _build(args)
    out = Path(args.output)
    frames_dir = out / "images" if args.colmap else out
    frames_dir.mkdir(parents=True, exist_ok=True)
    cams = orbit_cameras(
        scene.bounds_min, scene.bounds_max, args.frames, aspect=config.aspect
    )
    names = []
    for i, cam in enumerate(cams):
        image = renderer.render(cam)
        names.append(f"frame_{i:04d}.png")
        write_png(frames_dir / names[-1], image)
    if args.transforms:
        from .dataset import write_transforms

        # With --colmap the frames live under images/; transforms.json
        # paths are relative to the json, so they must carry the prefix.
        tnames = [f"images/{n}" for n in names] if args.colmap else names
        write_transforms(out / "transforms.json", cams, tnames)
        print(f"wrote {out / 'transforms.json'}", file=sys.stderr)
    if args.colmap:
        # A full COLMAP workspace: sparse/0 binary model + images/,
        # with the scene's splat centers/colors standing in for the
        # SfM point cloud (up to 100k, subsampled), the 3DGS point init.
        from .colmap import export_model

        n_pts = min(scene.count, 100_000)
        idx = np.random.default_rng(0).choice(
            scene.count, n_pts, replace=False
        )
        idx.sort()
        sparse = export_model(
            out, cams, names, config.screen_w, config.screen_h,
            scene.means.cpu().numpy().T[: scene.count][idx].astype(np.float32),
            np.clip(
                scene.colors.cpu().numpy().T[: scene.count][idx], 0.0, 1.0
            ).astype(np.float32),
        )
        print(f"wrote COLMAP model {sparse}", file=sys.stderr)
    print(f"wrote {args.frames} frames to {frames_dir}", file=sys.stderr)


def cmd_bench(args):
    import torch

    from .models.camera import orbit_cameras

    if args.frames < 1:
        raise SystemExit("--frames must be >= 1")
    renderer, camera, scene, config = _build(args)
    cams = orbit_cameras(
        scene.bounds_min, scene.bounds_max, args.frames, aspect=config.aspect
    )

    # Warm-up: the first render adapts the pair-list capacity (and builds
    # the kernels); warm again until it settles so the timed loop runs at
    # one capacity.
    for _ in range(3):
        cap = renderer.capacity
        renderer.render(cams[0])
        if renderer.capacity == cap:
            break

    t0 = time.perf_counter()
    for cam in cams:
        renderer.render(cam, check_saturation=False)
    if renderer.device.type == "cuda":
        torch.cuda.synchronize(renderer.device)
    dt = time.perf_counter() - t0
    fps = args.frames / dt
    print(f"{args.frames} frames in {dt * 1e3:.1f} ms -> {fps:.1f} FPS", file=sys.stderr)

    if args.profile:
        renderer.profile_frame(camera, warmup=True)
        stages = renderer.profile_frame(camera)
        for name, ms in stages.items():
            print(f"{name} average time ms: {ms:2.6f}")
        print(f"Total average time ms: {sum(stages.values()):2.6f}")


def cmd_interactive(args):
    """Input-driven frame loop — the headless analog of the reference's
    GLFW event loop with its 60 FPS spin-wait cap (Demo.cpp:352-528,
    521-525).  Input events come from a script (JSON lines) instead of a
    window; each line holds an InputState for `frames` frames:

        {"frames": 30, "buttons": "left", "pointer": [x, y],
         "move": [x, y, z]}

    The loop is deterministic (fixed dt = 1/fps-cap) so replays produce
    identical frames; --realtime additionally sleeps each frame to the
    cap like the reference.
    """
    import json

    from .models.camera import CameraController, InputState
    from .utils.png import write_png

    renderer, _, scene, config = _build(args)
    controller = CameraController((config.screen_w, config.screen_h))
    controller.set_bounds(scene.bounds_min, scene.bounds_max)

    if args.script:
        events = [json.loads(line) for line in Path(args.script).read_text().splitlines() if line.strip()]
    else:
        # Built-in demo: drag-rotate right, fly forward, orbit down.
        events = [
            dict(frames=1, buttons="none", pointer=[512, 512]),
            *[
                dict(frames=1, buttons="left", pointer=[512 + 12 * f, 512])
                for f in range(20)
            ],
            *[
                dict(frames=1, buttons="none", pointer=[752, 512], move=[0, 0, -1])
                for _ in range(20)
            ],
            *[
                dict(frames=1, buttons="middle", pointer=[752, 512 + 6 * f])
                for f in range(20)
            ],
        ]

    out = Path(args.output)
    out.mkdir(parents=True, exist_ok=True)
    dt = 1.0 / args.fps_cap
    frame = 0
    for ev in events:
        state = InputState(
            pointer=tuple(ev.get("pointer", (0.0, 0.0))),
            buttons=ev.get("buttons", "none"),
            move=tuple(ev.get("move", (0.0, 0.0, 0.0))),
        )
        for _ in range(int(ev.get("frames", 1))):
            t0 = time.perf_counter()
            cam = controller.update(state, dt)
            image = renderer.render(cam)
            if frame % args.save_every == 0:
                write_png(out / f"frame_{frame:04d}.png", image)
            frame += 1
            if args.realtime:
                # Spin-wait to the frame cap (Demo.cpp:521-525).
                while time.perf_counter() - t0 < dt:
                    pass
    print(f"ran {frame} interactive frames -> {out}", file=sys.stderr)


def fit_graphs_line(report: dict) -> str:
    """diff.FitStepGraphs.report() as one line: how the fit's steps ran."""

    def ran(counts):
        return ", ".join(f"{k} {counts[k]}" for k in ("eager", "capture", "replay") if k in counts)

    line = (f"fit graphs: {report['keys']} keys, {report['graphs']} graphs held, structure "
            f"({ran(report['structure'])}), step ({ran(report['step'])}), {report['resets']} "
            f"cache drops, chunk-tiles {report['chunk_tiles_run']} run / "
            f"{report['chunk_tiles_exact']} exact")
    if "memory_reserved" in report:
        line += f", memory_reserved {report['memory_reserved'] / 2 ** 20:.0f} MiB"
    return line


def cmd_fit(args):
    """Fit a splat scene to target views by gradient descent: the
    differentiable path (diff.py) on the card.

    Targets are a posed-image dataset (--dataset: a COLMAP workspace or a
    NeRF-synthetic transforms.json), or orbit views of the input scene
    rendered by the production pipeline.  The fit starts from the SfM point
    cloud (--init points, the 3DGS recipe) or random splats in the same
    bounds, and writes the fitted scene as a standard .ply.
    """
    from . import diff
    from .models.camera import orbit_cameras
    from .render import Renderer, round_capacity
    from .utils.device import resolve_device
    from .utils.png import write_png

    dev = resolve_device(args.device)
    if args.resume:
        # Validate the checkpoint before the (expensive) dataset and target
        # build; the optimizer state is rebuilt once the optimizer is known.
        if not args.checkpoint:
            raise SystemExit("--resume needs --checkpoint PATH")
        ck_probe = diff.load_checkpoint(args.checkpoint, device="cpu")
        if ck_probe["step"] >= args.steps:
            raise SystemExit(
                f"checkpoint is already at step {ck_probe['step']}; "
                f"raise --steps past it to continue training"
            )
        if ck_probe["camera_deltas"] is not None and not args.refine_poses:
            raise SystemExit(
                "checkpoint carries refined poses; resume with "
                "--refine-poses (or they would be silently dropped)"
            )
        if ck_probe["exposure"] is not None and not args.refine_exposure:
            raise SystemExit(
                "checkpoint carries per-view exposure; resume with "
                "--refine-exposure (or it would be silently dropped)"
            )
    points_xyz = points_rgb = None
    holdout_cams, holdout_targets = [], []
    if args.holdout and not args.dataset:
        raise SystemExit("--holdout needs --dataset")
    if args.dataset:
        # Posed-image dataset; splat init from the SfM point cloud when the
        # layout has one, else random inside rig-derived bounds.
        from .dataset import init_bounds_from_cameras, load_posed

        ds = load_posed(
            args.dataset,
            downscale=args.downscale,
            background=_parse_background(args.background),
            max_frames=args.views or 0,
        )
        cams, images = ds.cameras, ds.images
        frame_names = list(ds.names)
        if args.holdout:
            # llffhold-style split: every K'th view is test-only.
            if args.holdout < 2:
                raise SystemExit("--holdout takes K >= 2")
            test = set(range(0, len(cams), args.holdout))
            keep = [i for i in range(len(cams)) if i not in test]
            if not keep:
                raise SystemExit(
                    f"--holdout {args.holdout} leaves no training views out of {len(cams)}"
                )
            holdout_cams = [cams[i] for i in sorted(test)]
            holdout_targets = [images[i] for i in sorted(test)]
            cams = [cams[i] for i in keep]
            images = images[keep]
            frame_names = [frame_names[i] for i in keep]
            print(f"holdout: {len(holdout_cams)} test / {len(cams)} train views",
                  file=sys.stderr)
        if ds.points_xyz.shape[0] and args.init != "random":
            points_xyz, points_rgb = ds.points_xyz, ds.points_rgb
        elif args.init == "points":
            raise SystemExit("--init points: the dataset has no SfM point cloud")
        h, w = images.shape[1:3]
        args.size, args.height = w, h
        config = _config_from_args(args)
        bounds_min, bounds_max = init_bounds_from_cameras(cams)
        targets = list(images)
        print(
            f"dataset: {len(cams)} views at {w}x{h}, {ds.points_xyz.shape[0]} SfM points, "
            f"init bounds {np.round(bounds_min, 3)}..{np.round(bounds_max, 3)}",
            file=sys.stderr,
        )
    else:
        renderer, camera, scene, config = _build(args)
        bounds_min, bounds_max = scene.bounds_min, scene.bounds_max
        views = args.views or 6
        cams = orbit_cameras(bounds_min, bounds_max, views, aspect=config.aspect)
        print(f"rendering {views} target views...", file=sys.stderr)
        targets = [renderer.render(c)[..., :3] for c in cams]
        frame_names = [f"frame_{i:04d}.png" for i in range(len(cams))]
    cam_data = [c.camera_data() for c in cams]

    tx = None
    if args.optimizer == "3dgs":
        extent = float(np.linalg.norm(
            np.asarray(bounds_max, np.float64) - np.asarray(bounds_min, np.float64))) or 1.0
        tx = diff.tx_3dgs(extent, args.steps)
    resume_kw = {}
    if args.resume:
        # A resume replaces the init wholesale.  (Validated above; read again
        # to rebuild the optimizer state now that the optimizer is known.)
        tx_for_state = tx if tx is not None else diff.Adam(args.lr)
        ck = diff.load_checkpoint(args.checkpoint, tx=tx_for_state, device=dev)
        params = ck["params"]
        for what in ("camera_deltas", "exposure"):
            leaf = ck[what]
            if leaf is not None and leaf[0].shape[0] != len(cams):
                raise SystemExit(
                    f"checkpoint {what} cover {leaf[0].shape[0]} views but this run trains "
                    f"{len(cams)} — resume with the same dataset/--views/--holdout split"
                )
        resume_kw = dict(
            start_step=ck["step"],
            opt_state=ck["opt_state"],
            camera_deltas=ck["camera_deltas"],
            exposure=ck["exposure"],
        )
        print(f"resumed {args.checkpoint} at step {ck['step']} "
              f"({params.means.shape[-1]} splats)", file=sys.stderr)
    elif points_xyz is not None:
        params = diff.init_from_points(
            points_xyz, points_rgb, max_points=args.max_init_points, seed=args.seed,
            sh_degree=args.sh_degree, device=dev,
        )
        print(f"init: {params.means.shape[-1]} splats from the SfM point cloud (3DGS recipe)",
              file=sys.stderr)
    else:
        params = diff.random_init(
            args.splats, bounds_min, bounds_max, seed=args.seed, scale=args.init_scale,
            sh_degree=args.sh_degree, device=dev,
        )
    n_splats = int(params.means.shape[-1])
    capacity = round_capacity(args.capacity or 16 * n_splats, dev)
    if args.k_max:
        k_max = args.k_max
    else:
        structure = diff.build_structure(params, cam_data[0], config, capacity, device=dev)
        k_max = max(128, 2 * diff.max_tile_count(structure))
    print(f"fitting {n_splats} splats, capacity {capacity}, k_max {k_max}, "
          f"{args.steps} steps...", file=sys.stderr)
    t0 = time.perf_counter()
    graphs = {}
    fit_out = diff.fit(
        params, cam_data, targets, config,
        capacity=capacity, k_max=k_max, steps=args.steps,
        learning_rate=args.lr, tx=tx,
        l1_weight=args.l1_weight, ssim_weight=args.ssim_weight,
        l2_weight=args.l2_weight,
        log_every=max(1, args.steps // 10),
        densify_every=args.densify_every,
        optimize_cameras=args.refine_poses, camera_lr=args.camera_lr,
        optimize_exposure=args.refine_exposure,
        exposure_lr=args.exposure_lr,
        sh_warmup_every=args.sh_warmup,
        remat=args.remat,
        checkpoint_every=(args.checkpoint_every or (args.steps if args.checkpoint else 0)),
        checkpoint_path=args.checkpoint,
        device=dev,
        stats=graphs,
        **resume_kw,
    )
    print(fit_graphs_line(graphs), file=sys.stderr)
    fit_out = list(fit_out)
    exposure_out = fit_out.pop() if args.refine_exposure else None
    if args.refine_poses:
        params, losses, deltas = fit_out
        dr = deltas.dr.cpu().numpy()
        dt_corr = deltas.dt.cpu().numpy()
        cams = [diff.refined_camera(c, dr[i], dt_corr[i]) for i, c in enumerate(cams)]
        print(
            f"pose refinement: max rotation {np.degrees(np.linalg.norm(dr, axis=1).max()):.3f} "
            f"deg, max translation {np.linalg.norm(dt_corr, axis=1).max():.4f}",
            file=sys.stderr,
        )
        if args.export_poses:
            from .dataset import write_transforms

            write_transforms(args.export_poses, cams, frame_names)
            print(f"wrote {args.export_poses}", file=sys.stderr)
    else:
        params, losses = fit_out
    if exposure_out is not None:
        g = exposure_out.gain.cpu().numpy()
        b = exposure_out.bias.cpu().numpy()
        print(f"exposure: gain deviation max {np.abs(g - 1.0).max():.4f}, bias max "
              f"{np.abs(b).max():.4f}", file=sys.stderr)
    if args.densify_every:
        print(f"density control: {n_splats} -> {params.means.shape[-1]} splats",
              file=sys.stderr)
    dt = time.perf_counter() - t0
    first = resume_kw.get("start_step", 0)
    steps_run = max(1, args.steps - first)
    print(
        f"fit: loss {losses[first]:.5f} -> {losses[-1]:.5f} in {dt:.1f}s "
        f"({1e3 * dt / steps_run:.1f} ms/step incl. kernel build)",
        file=sys.stderr,
    )

    diff.write_fitted_ply(args.output, params)
    print(f"wrote {args.output}", file=sys.stderr)
    fitted_scene = None
    if args.preview or holdout_cams or args.eval_dataset:
        fitted_scene = diff.to_scene(params)
    if args.preview:
        img = Renderer(fitted_scene, config, device=dev).render(cams[0])
        write_png(args.preview, img)
        print(f"wrote {args.preview}", file=sys.stderr)
    if holdout_cams:
        # The llffhold-style split of the same dataset: evaluate every
        # --holdout'th view, never trained, at its stored pose.
        _eval_views(fitted_scene, holdout_cams, holdout_targets, args,
                    f"holdout eval (every {args.holdout}th view)")
    if args.eval_dataset:
        # Held-out evaluation (the 3DGS protocol): PSNR/SSIM on test views
        # the fit never saw, composited like the training targets.
        from .dataset import load_posed

        ecams, etargets = load_posed(
            args.eval_dataset,
            downscale=args.downscale,
            background=_parse_background(args.background),
        )[:2]
        h, w = etargets.shape[1:3]
        args.size, args.height = w, h
        _eval_views(fitted_scene, ecams, list(etargets), args, "eval")


def cmd_serve(args):
    """Live interactive viewer: the reference's GLFW window + event loop
    (Demo.cpp:196-237, 484-525) as a dependency-free HTTP server — open
    the printed URL, drag/orbit/pan with the mouse, fly with WASD/QE."""
    from .viewer import serve

    renderer, _, scene, config = _build(args)
    print(
        f"serving live viewer on http://{args.host}:{args.port}/  (Ctrl-C stops)",
        file=sys.stderr,
    )
    serve(
        renderer, scene, config,
        host=args.host, port=args.port,
        fps_cap=args.fps_cap, max_frames=args.max_frames,
        stream_level=args.stream_level,
    )


def _eval_views(scene, cams, targets, args, label):
    """Render each view of ``scene`` and report mean PSNR/SSIM against
    the targets (the 3DGS eval protocol's metrics)."""
    import torch

    from .diff import ssim
    from .render import Renderer

    er = Renderer(scene, _config_from_args(args), device=args.device)
    psnrs, ssims = [], []
    for cam, tgt in zip(cams, targets):
        rgb = er.render(cam)[..., :3].astype(np.float32) / 255.0
        mse = float(np.mean((rgb - tgt) ** 2))
        psnrs.append(float("inf") if mse == 0 else -10.0 * np.log10(mse))
        ssims.append(float(ssim(torch.from_numpy(rgb).to(er.device),
                                torch.from_numpy(np.asarray(tgt)).to(er.device))))
    print(
        f"{label} ({len(psnrs)} views): PSNR {np.mean(psnrs):.2f} dB, "
        f"SSIM {np.mean(ssims):.4f}",
        file=sys.stderr,
    )
    return float(np.mean(psnrs)), float(np.mean(ssims))


def cmd_eval(args):
    """Evaluate an existing scene against a posed-image dataset:
    PSNR/SSIM per the 3DGS protocol, no fitting."""
    from .dataset import load_posed
    from .splatfile import load_scene
    from .utils.device import resolve_device

    scene = load_scene(args.scene, device=resolve_device(args.device))
    cams, targets = load_posed(
        args.dataset,
        downscale=args.downscale,
        background=_parse_background(args.background),
        max_frames=args.views or 0,
    )[:2]
    h, w = targets.shape[1:3]
    args.size, args.height = w, h
    _eval_views(scene, cams, list(targets), args, "eval")


def _parse_floats(spec, n, name):
    vals = [float(x) for x in str(spec).split(",")]
    if len(vals) != n:
        raise SystemExit(f"{name} takes {n} comma-separated numbers")
    return vals


def _apply_scene_edits(scene, args):
    """Shared convert/merge editing pipeline (scene_ops), applied in
    crop -> opacity filter -> decimate -> transform order.  scene_ops
    validation errors surface as one-line CLI errors."""
    from . import scene_ops

    try:
        return _apply_scene_edits_inner(scene, args, scene_ops)
    except ValueError as e:
        raise SystemExit(f"scene edit failed: {e}")


def _apply_scene_edits_inner(scene, args, scene_ops):
    n0 = scene.count
    if getattr(args, "crop", None):
        v = _parse_floats(args.crop, 6, "--crop")
        scene = scene_ops.crop(scene, v[:3], v[3:])
    if getattr(args, "min_opacity", 0.0):
        scene = scene_ops.filter_opacity(scene, args.min_opacity)
    if getattr(args, "max_splats", 0):
        scene = scene_ops.decimate(scene, args.max_splats)
    if (
        getattr(args, "translate", None)
        or getattr(args, "scale", 1.0) != 1.0
    ):
        t = (
            _parse_floats(args.translate, 3, "--translate")
            if args.translate
            else (0.0, 0.0, 0.0)
        )
        scene = scene_ops.transform(scene, translate=t, scale=args.scale)
    if scene.count != n0:
        print(f"edits: {n0} -> {scene.count} splats", file=sys.stderr)
    return scene


def _add_edit_flags(p):
    p.add_argument("--crop", default=None, metavar="X0,Y0,Z0,X1,Y1,Z1",
                   help="keep splats whose centers lie in the box")
    p.add_argument("--min-opacity", type=float, default=0.0,
                   help="drop splats below this opacity")
    p.add_argument("--max-splats", type=int, default=0,
                   help="cap the count (keeps highest opacity x scale)")
    p.add_argument("--translate", default=None, metavar="X,Y,Z")
    p.add_argument("--scale", type=float, default=1.0,
                   help="uniform similarity scale about the origin")
    _add_device(p)


def cmd_merge(args):
    """Merge scenes into one file (scene_ops.merge; SH degrees promote
    to the maximum).  Inputs/output by extension like convert."""
    from . import scene_ops
    from .splatfile import load_scene
    from .utils.device import resolve_device

    dev = resolve_device(args.device)
    scenes = [load_scene(p, device=dev) for p in args.inputs]
    try:
        merged = scene_ops.merge(scenes)
    except ValueError as e:
        raise SystemExit(f"merge failed: {e}")
    merged = _apply_scene_edits(merged, args)
    _write_scene(merged, args.output)
    print(
        f"merged {len(scenes)} scenes -> {merged.count} splats "
        f"-> {args.output}",
        file=sys.stderr,
    )


def _write_scene(scene, out):
    """Write a scene by output extension (.ply stores the raw
    pre-activation values the importer expects, PlyParser.cpp:317-327;
    .splat drops SH bands beyond the baked base color — the format has
    no field for them)."""
    from .models.scene import SH_C0
    from .ply import write_gaussian_ply
    from .splatfile import write_splat
    from .utils.quantize import decode_quat_xyzw

    out = str(out)
    if out.lower().endswith(".splat"):
        write_splat(out, scene)
    elif out.lower().endswith(".ply"):
        n = scene.count
        means = scene.means[:, :n].cpu().numpy().T
        scales = scene.scales[:, :n].cpu().numpy().T
        # Invert the importer's activations; clamp away the infinities
        # at exactly 0/1 (log/logit poles).
        scales_log = np.log(np.maximum(scales, 1e-30))
        op = np.clip(scene.opacities[:n].cpu().numpy(), 1e-6, 1.0 - 1e-6)
        opacity_logit = np.log(op / (1.0 - op))
        f_dc = (scene.colors[:, :n].cpu().numpy().T - 0.5) / SH_C0
        q = decode_quat_xyzw(scene.quats[:n].cpu().numpy())  # xyzw
        quats_wxyz = q[:, [3, 0, 1, 2]]
        f_rest = None
        if scene.sh is not None:
            sh = scene.sh[:, :, :n].cpu().numpy()  # [3, K, N]
            f_dc = sh[:, 0, :].T  # exact DC, not the re-derived bake
            f_rest = np.transpose(sh[:, 1:, :], (2, 0, 1))  # [N, 3, K-1]
        write_gaussian_ply(
            out,
            means.astype(np.float32),
            scales_log.astype(np.float32),
            quats_wxyz.astype(np.float32),
            opacity_logit.astype(np.float32),
            f_dc.astype(np.float32),
            f_rest,
        )
    else:
        raise SystemExit(f"unknown output format: {out} (use .ply or .splat)")
    print(
        f"wrote {out}: {scene.count} splats, SH degree "
        f"{scene.sh_degree if out.lower().endswith('.ply') else 0}",
        file=sys.stderr,
    )


def cmd_convert(args):
    """Convert between scene formats by extension (.ply <-> .splat),
    with optional edits (--crop / --min-opacity / --max-splats /
    --translate / --scale; scene_ops)."""
    from .splatfile import load_scene
    from .utils.device import resolve_device

    scene = load_scene(args.input, device=resolve_device(args.device))
    scene = _apply_scene_edits(scene, args)
    _write_scene(scene, args.output)


def cmd_compare(args):
    """Image-parity metrics between two PNGs: per-channel max |delta|,
    mean |delta|, PSNR and SSIM.  The tool for checking a migration
    against reference-rendered frames (or any A/B of this renderer's
    own outputs); exits non-zero when --max-delta is exceeded."""
    import json as _json

    import torch

    from .diff import ssim
    from .utils.device import resolve_device
    from .utils.png import read_png

    dev = resolve_device(args.device)
    a = read_png(args.a).astype(np.float32)
    b = read_png(args.b).astype(np.float32)
    if a.shape != b.shape:
        raise SystemExit(f"shape mismatch: {a.shape} vs {b.shape}")
    c = min(a.shape[2], 3)
    a, b = a[..., :c], b[..., :c]
    delta = np.abs(a - b)
    mse = float(np.mean((a - b) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)

    s = float(ssim(torch.from_numpy(a / 255.0).to(dev), torch.from_numpy(b / 255.0).to(dev)))
    out = {
        "max_delta": int(delta.max()),
        "mean_delta": round(float(delta.mean()), 4),
        "psnr_db": round(psnr, 2) if np.isfinite(psnr) else "inf",
        "ssim": round(s, 5),
    }
    print(_json.dumps(out))
    if args.max_delta is not None and out["max_delta"] > args.max_delta:
        raise SystemExit(
            f"max delta {out['max_delta']} exceeds --max-delta {args.max_delta}"
        )


def main(argv=None):
    parser = argparse.ArgumentParser(prog="cudagaussianrenderer_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("render", help="render one framed view to PNG")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("-o", "--output", default="out.png")
    p.add_argument(
        "--passes", type=int, default=1,
        help="render in N tile-row band passes (capacity-ceiling escape hatch)",
    )
    p.add_argument(
        "--depth", default=None, metavar="PNG",
        help="also write a normalized expected-depth map (the differentiable "
             "path: for inspection, not the frame loop)",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("orbit", help="render an orbit fly-through")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("-o", "--output", default="frames")
    p.add_argument("-n", "--frames", type=int, default=60)
    p.add_argument("--transforms", action="store_true",
                   help="also write transforms.json (NeRF-synthetic "
                        "dataset layout, consumable by eval --dataset)")
    p.add_argument("--colmap", action="store_true",
                   help="write a COLMAP workspace instead (sparse/0 "
                        "binary model + images/, splat centers as the "
                        "SfM point cloud)")
    _add_common(p)
    p.set_defaults(fn=cmd_orbit)

    p = sub.add_parser("bench", help="benchmark an orbit fly-through")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--profile", action="store_true", help="per-stage timing report")
    _add_common(p)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "interactive",
        help="input-script-driven frame loop (headless GLFW-loop analog)",
    )
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("-o", "--output", default="frames")
    p.add_argument("--script", default=None, help="JSON-lines input script")
    p.add_argument("--fps-cap", type=float, default=60.0)
    p.add_argument("--save-every", type=int, default=1, metavar="N")
    p.add_argument("--realtime", action="store_true", help="sleep to the frame cap")
    _add_common(p)
    p.set_defaults(fn=cmd_interactive)

    p = sub.add_parser("fit", help="fit splats to views by gradient descent (diff.py)")
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("-o", "--output", default="fitted.ply")
    p.add_argument("--preview", default=None, metavar="PNG")
    p.add_argument("--splats", type=int, default=2000)
    p.add_argument("--views", type=int, default=None)
    p.add_argument("--dataset", default=None, metavar="DIR")
    p.add_argument("--init", choices=("auto", "random", "points"), default="auto")
    p.add_argument("--max-init-points", type=int, default=0, metavar="N")
    p.add_argument("--downscale", type=int, default=1, metavar="F")
    p.add_argument("--eval-dataset", default=None, metavar="DIR")
    p.add_argument("--holdout", type=int, default=0, metavar="K")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--lr", type=float, default=5e-3)
    p.add_argument("--optimizer", choices=("adam", "3dgs"), default="adam")
    p.add_argument("--l1-weight", type=float, default=0.8)
    p.add_argument("--ssim-weight", type=float, default=0.2)
    p.add_argument("--l2-weight", type=float, default=0.0)
    p.add_argument("--capacity", type=int, default=None)
    p.add_argument("--k-max", type=int, default=None)
    p.add_argument("--init-scale", type=float, default=0.1)
    p.add_argument("--refine-poses", action="store_true")
    p.add_argument("--camera-lr", type=float, default=1e-4)
    p.add_argument("--refine-exposure", action="store_true")
    p.add_argument("--exposure-lr", type=float, default=1e-3)
    p.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None)
    p.add_argument("--sh-warmup", type=int, default=0, metavar="K")
    p.add_argument("--export-poses", default=None, metavar="JSON")
    p.add_argument("--checkpoint", default=None, metavar="NPZ")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="K")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--densify-every", type=int, default=0, metavar="K")
    _add_common(p)
    p.set_defaults(fn=cmd_fit)

    p = sub.add_parser(
        "serve",
        help="live interactive viewer over HTTP (GLFW-window analog)",
    )
    p.add_argument("scene", nargs="?", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--fps-cap", type=float, default=60.0)
    p.add_argument("--max-frames", type=int, default=0, help="stop after N frames (0 = run)")
    p.add_argument(
        "--stream-level", type=int, default=0, choices=range(10),
        help="zlib effort for streamed PNGs: 0 (default) encodes faster at "
        "more bytes — right for loopback; raise it when the browser link "
        "is the bottleneck",
    )
    _add_common(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "convert", help="convert scene files by extension (.ply <-> .splat)"
    )
    p.add_argument("input")
    p.add_argument("output")
    _add_edit_flags(p)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser(
        "merge", help="merge scenes into one (.ply/.splat in and out)"
    )
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    _add_edit_flags(p)
    p.set_defaults(fn=cmd_merge)

    p = sub.add_parser(
        "eval",
        help="PSNR/SSIM of a scene against a posed-image dataset "
             "(3DGS eval protocol, no fitting)",
    )
    p.add_argument("scene")
    p.add_argument("--dataset", required=True, metavar="DIR")
    p.add_argument("--downscale", type=int, default=1, metavar="F")
    p.add_argument("--views", type=int, default=None,
                   help="cap on evaluated frames (default all)")
    _add_common(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "compare", help="image parity metrics between two PNGs (PSNR/SSIM)"
    )
    p.add_argument("a")
    p.add_argument("b")
    p.add_argument(
        "--max-delta", type=int, default=None,
        help="exit non-zero if any pixel differs by more than this",
    )
    _add_device(p)
    p.set_defaults(fn=cmd_compare)

    args = parser.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
