#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (cudagaussianrenderer_torch) on one GPU.

Run from the repository root on a machine with one NVIDIA card:

    python3 chip_smoke.py

It builds the four CUDA kernels from csrc/ (nvcc, at first use), then:

  1. card and build: the card's name and power limit, torch and CUDA
     versions, the build time, TF32 off;
  2. kernel parity at the main path's shapes: each of K1-K4 against its
     plain PyTorch version on the same inputs (K1-K3 exact, K4 within
     K4_LSB_BOUND output levels), with per-kernel times;
  3. golden scenes: the non-banded scenes of tools/tpu_selfcheck.py
     through the port, each against the port's golden.py oracle;
  4. the main path at full width: Renderer on the 1M-splat SH-3 scene at
     1024x1024 over 8 orbit cameras, with the launch counts of K1-K4.

Any failure raises and exits non-zero.  The last line of stdout is one
JSON object naming the device; the line before it is the card's
``nvidia-smi`` name and power limit, and before that the per-kernel JSON
line.  Without a CUDA device the script exits non-zero and prints no
result.
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
# loop, counted from csrc/raster.cu: dx, dy (2); the quadratic form (7);
# min, exp (2); alpha, weight (2); three colour multiply-adds (6);
# 1 - alpha and the transmittance product (2); the exp counted as one.
K4_OPS_PER_EVAL = 21
# K4 against its plain version, after tiles_to_image: the two blend the
# same pairs in the same order and differ only by contraction of
# multiply-adds and exp rounding.
K4_LSB_BOUND = 4
# Main-path frame against the plain-version frame, and the golden scenes:
# the repo's rule (tests/test_pipeline.py:20-27).
PIX_TOL, BAD_FRAC = 8, 0.02


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


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


def bits_equal(a, b) -> bool:
    import torch

    a = a.contiguous().view(torch.int32) if a.dtype == torch.float32 else a
    b = b.contiguous().view(torch.int32) if b.dtype == torch.float32 else b
    return a.shape == b.shape and bool(torch.equal(a, b))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.golden import golden_render, scene_to_numpy
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.ops import expand, ranges, raster
    from cudagaussianrenderer_torch.ops.binning import TilePairs, emit_columns
    from cudagaussianrenderer_torch.ops.geometry import as_u32_i64
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.ops.sorting import sort_pairs
    from cudagaussianrenderer_torch.render import (
        _splat_colors, camera_tensors, render_frame, round_capacity,
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
    colors = _splat_colors(s, cam)
    clip = project_splats(s.means, s.scales, s.quats, cam, config, opacities=s.opacities)
    cols, incl = emit_columns(clip, colors, s.opacities, config)
    cols = tuple(c.contiguous() for c in cols)
    total = int(incl[-1])
    capacity = round_capacity(Renderer._bucket(total), dev)
    n = incl.shape[0]
    log(f"camera 0: {total} candidate pairs, capacity {capacity}")
    kernels = {}

    # K2
    rows = expand.interleave_rows(incl, cols, capacity + 1)
    rows_p = expand._interleave_rows_torch(incl, cols, capacity + 1)
    torch.cuda.synchronize()
    ok2 = bits_equal(rows, rows_p)
    np_cols = rows.shape[1]
    lib_rows = [incl.float(), incl.float(), torch.arange(n, device=dev, dtype=torch.float32), *cols]
    kernels["interleave"] = dict(
        ms=cuda_ms(lambda: expand.interleave_rows(incl, cols, capacity + 1), 20),
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
        plain_ms=cuda_ms(lambda: ranges._edges_torch(keys[0], probes, 19), 10),
        library_ms=cuda_ms(lambda: torch.cumsum(torch.bincount(bins, minlength=probes), 0), 20),
        bytes=4 * capacity + 4 * probes,
        max_abs_err=float((edges - edges_p).abs().max()),
    )
    log(f"  K1 edges over {capacity} keys, {probes} probes: exact={ok1}")
    if not ok1:
        raise AssertionError("K1 edges differ from the plain version")

    # K4
    starts, counts = edges[:-1], edges[1:] - edges[:-1]
    pair_data = raster.pack_pair_data(attrs, config.raster_chunk)
    tiles = raster.rasterize_tiles(pair_data, starts, counts, config)
    stats = {}
    t0 = time.perf_counter()
    tiles_p = raster._raster_torch(pair_data, starts, counts, config, config.total_tiles, 0, stats)
    torch.cuda.synchronize()
    plain_raster_ms = (time.perf_counter() - t0) * 1e3
    img_k = raster.tiles_to_image(tiles, config)
    img_p = raster.tiles_to_image(tiles_p, config)
    lsb = int((img_k.int() - img_p.int()).abs().max())
    evals = stats["pairs_blended"] * config.pixels_per_tile
    kernels["raster"] = dict(
        ms=cuda_ms(lambda: raster.rasterize_tiles(pair_data, starts, counts, config), 20),
        plain_ms=plain_raster_ms,
        library_ms=None,
        bytes=4 * 3 * int(incl[-1].clamp(max=capacity)) + 8 * config.total_tiles
        + 16 * config.total_tiles * config.pixels_per_tile,
        ops=K4_OPS_PER_EVAL * evals,
        max_abs_err=float((tiles - tiles_p).abs().max()),
    )
    log(f"  K4 raster {config.total_tiles} tiles: max diff {lsb} LSB (bound "
        f"{K4_LSB_BOUND}), {stats['pairs_blended']} pairs blended before exit "
        f"= {evals} pixel evaluations")
    if lsb > K4_LSB_BOUND:
        raise AssertionError(f"K4 raster differs by {lsb} LSB from its plain version")
    plain_frame0 = img_p.cpu().numpy()

    # ---- 3. golden scenes --------------------------------------------------
    # The non-banded cases of tools/tpu_selfcheck.py:52-106; its two banded
    # cases and the balanced-bands case wait for the banded path's port.
    log("== 3. golden scenes (port vs golden.py)")
    cases = [
        ("gaussian 128px", dict(n=500, seed=2, cfg=dict(screen_size=128))),
        ("epanechnikov 128px", dict(n=500, seed=2, cfg=dict(screen_size=128, falloff="epanechnikov"))),
        ("sh-degree-3 128px", dict(n=300, seed=8, sh=3, cfg=dict(screen_size=128))),
        ("rect 192x128", dict(n=400, seed=6, cfg=dict(screen_size=192, screen_height=128))),
        ("huge splats 1024px", dict(
            n=192, seed=9, scene_kw=dict(min_scale=0.3, max_scale=1.6, extent=3.0),
            cfg=dict(screen_size=1024), capacity=524288,
        )),
        ("lex keys (depth_bits=32)", dict(n=400, seed=2, cfg=dict(screen_size=128, depth_bits=32))),
        ("prod no-pad interleave 4096", dict(
            n=500, seed=5, pad=4096, cfg=dict(screen_size=128), capacity=16384,
        )),
        ("scan-limb margin 128px", dict(n=350, seed=4, cfg=dict(screen_size=128), pix_tol=5)),
    ]
    for name, c in cases:
        gcfg = RenderConfig(**c["cfg"])
        gscene = random_scene(
            c["n"], seed=c["seed"], sh_degree=c.get("sh", 0), device=dev,
            **c.get("scene_kw", {}),
        ).pad_to_multiple(c.get("pad", 256))
        gcam = Camera(aspect=gcfg.aspect).framed(gscene.bounds_min, gscene.bounds_max)
        gcap = c.get("capacity", 16384)
        got, aux = render_frame(gscene, gcam.camera_data(), gcfg, gcap)
        if int(aux["num_candidates"]) > gcap:
            raise AssertionError(f"{name}: saturated, raise the case capacity")
        want = golden_render(scene_to_numpy(gscene), gcam.camera_data(), gcfg)
        check(name, got.cpu().numpy(), want, pix_tol=c.get("pix_tol", PIX_TOL))

    # ---- 4. main path at full width ---------------------------------------
    log("== 4. main path: Renderer, 1M splats SH-3, 1024x1024, 8 orbit cameras")
    counted = (ranges.tile_edges, expand.interleave_rows, expand.emit_slots,
               raster.rasterize_tiles)
    renderer.render(cams[0])  # warm-up: sizes the capacity from its candidates
    torch.cuda.synchronize()
    for fn in counted:
        fn.launches = 0
    frames, cands = [], []
    t0 = time.perf_counter()
    for c in cams:
        frames.append(renderer.render(c))
        cands.append(renderer.last_candidates)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counted}
    ms_frame = wall * 1e3 / len(cams)
    log(f"  {len(cams)} frames: {ms_frame:.3f} ms/frame, {1e3 / ms_frame:.2f} FPS, "
        f"pairs/frame mean {sum(cands) / len(cands):.0f} (min {min(cands)}, max {max(cands)}), "
        f"capacity {renderer.capacity}, saturated {renderer.saturated}")
    log(f"  launches in the main path: {launches}")
    for name, count in launches.items():
        if count < len(cams):
            raise AssertionError(f"{name} launched {count} times in {len(cams)} frames")
    for i, img in enumerate(frames):
        if img.shape != (1024, 1024, 4) or img[..., 3].max() != 255 or img[..., :3].max() == 0:
            raise AssertionError(f"frame {i} is blank or misshapen: {img.shape}")
    check("frame 0 vs plain-version frame", frames[0], plain_frame0)
    stages = renderer.profile_frame(cams[1], warmup=True)
    log("  per-stage ms (CUDA events, stages back to back): "
        + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
        + f"; sum {sum(stages.values()):.3f}")

    names = {
        "edges": ("tile_edges", "cudagaussianrenderer_tpu/ops/ranges.py:40"),
        "interleave": ("interleave_rows", "cudagaussianrenderer_tpu/ops/expand.py:107"),
        "emit": ("emit_slots", "cudagaussianrenderer_tpu/ops/expand.py:206"),
        "raster": ("rasterize_tiles", "cudagaussianrenderer_tpu/ops/raster.py:132"),
    }
    line = []
    for key in ("edges", "interleave", "emit", "raster"):
        k = kernels[key]
        bytes_ms = k["bytes"] / HBM_BYTES_PER_S * 1e3
        ops_ms = k.get("ops", 0) / F32_OPS_PER_S * 1e3
        line.append(dict(
            name=key,
            route="cuda",
            source=f"cudagaussianrenderer_torch/csrc/{key}.cu",
            replaces=names[key][1],
            launches=launches[names[key][0]],
            max_abs_err=k["max_abs_err"],
            ms=k["ms"],
            plain_ms=k["plain_ms"],
            bound_ms=max(bytes_ms, ops_ms),
            bound_by="operations" if ops_ms > bytes_ms else "bytes",
            library_ms=k["library_ms"],
        ))
    log(f"total {time.perf_counter() - t_start:.1f} s")
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
