"""The checks of the port's bench suite (cudagaussianrenderer_torch.tools.
bench_suite) against the JAX package's (tools/bench_suite.py), shared by
the tests/test_torch_bench_suite*.py files, which split the configs so
that each file stays near 30 s on one worker: a JAX frame in interpret
mode costs ~15 s.

Each config runs small through the port suite's own ``main`` on the CPU
(SCALES: about 350 splats at 64-128 pixels, 2-4 frames), and its line is
held against the JAX package on the same scene, config and capacity:
the JAX suite's keys and config name; the capacity by the JAX suite's
rule over the JAX candidate counts of every rendered camera; camera 0's
num_pairs equal to the JAX render_frame's, exactly; camera 0's frame
within the suite's image rule of the JAX frame."""

import dataclasses
import json
import pathlib
import sys

import numpy as np

import jax.numpy as jnp

import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.tools import bench_suite as port_suite
from cudagaussianrenderer_tpu.ops.binning import splat_row_packs, splat_tile_rects
from cudagaussianrenderer_tpu.ops.projection import project_splats
from cudagaussianrenderer_tpu.render import render_frame

from torch_port_cases import image_close

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import bench_suite as jax_suite  # noqa: E402  (tools/bench_suite.py)

JAX_KEYS = ("config", "ms_per_frame", "fps", "pairs_per_frame", "capacity")
# Config -> (--n-scale, --size-scale, --frames-scale): ~350 splats, 64-128
# pixels, 2 frames (4 for config 5).
SCALES = {1: (0.035, 0.25, 0.125), 2: (0.0035, 0.25, 0.125)}
SCALES.update({c: (0.00035, 0.125, 0.25) for c in (3, 4, 5, 6)})
# Each config's lines as the JAX suite names them: (name, RenderConfig
# options).
LINES = {
    1: [("1_procedural_10k_256px_static", {})],
    2: [("2_ply_100k_512px_orbit", {})],
    3: [("3_sh_deg3_1m_1024px_orbit", {})],
    4: [(f"4_falloff_{f}_1m_1024px", dict(falloff=f)) for f in ("gaussian", "epanechnikov")],
    5: [("5_flythrough_1m_1024px", {})],
    6: [(f"6_realistic_alpha_{name}_1m", dict(opacity_aware_extents=flag))
        for name, flag in (("exact3sigma", False), ("aware", True))],
}


def jax_scene(config: int, n: int):
    """The JAX suite's scene of ``config`` at ``n`` splats, built as its
    main() builds it."""
    kw = dict(min_scale=0.002, max_scale=0.053)
    if config == 2:
        return jax_suite.synth_ply(n, seed=1)
    scene = jx.random_scene(n, seed=0, sh_degree=3 if config == 3 else 0, **kw)
    if config == 6:
        alpha = np.random.default_rng(1).beta(0.5, 1.5, scene.opacities.shape[0])
        scene = dataclasses.replace(scene, opacities=jnp.asarray(alpha.astype(np.float32)))
    return scene


def jax_candidates(scene, cam, cfg) -> int:
    """The JAX suite's probe (tools/bench_suite.py:54-59)."""
    clip = project_splats(scene.means, scene.scales, scene.quats, cam.camera_data(), cfg,
                          opacities=scene.opacities)
    rects = splat_tile_rects(clip, cfg)
    return int(jnp.sum(splat_row_packs(clip, rects, cfg).counts))


def check_config(config: int, capsys):
    n_scale, size_scale, frames_scale = SCALES[config]
    out = port_suite.main([str(config), "--device", "cpu", "--n-scale", str(n_scale),
                           "--size-scale", str(size_scale), "--frames-scale", str(frames_scale)])
    printed = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [line for line, _ in out] == printed
    assert len(out) == len(LINES[config])
    scene = None
    for (line, m), (name, cfg_kw) in zip(out, LINES[config]):
        assert line["config"] == name
        assert all(k in line for k in JAX_KEYS), line
        assert line["method"] == "eager" and line["device"] == "cpu" and not line["saturated"]
        if scene is None:
            scene = jax_scene(config, line["splats"])
            assert scene.count == line["splats"]
        cfg = jx.RenderConfig(screen_size=line["size"], **cfg_kw)
        cams = jx.orbit_cameras(scene.bounds_min, scene.bounds_max, line["frames"])
        probed = cams[:1] if config == 1 else cams
        candidates = max(jax_candidates(scene, c, cfg) for c in probed)
        assert line["capacity"] == max(4096, -(-int(candidates * 1.005) // 4096) * 4096)
        img, aux = render_frame(scene, cams[0].camera_data(), cfg, line["capacity"])
        assert m["frame_pairs"][0] == int(aux["num_pairs"]) > 0, name
        assert len(m["frame_pairs"]) == line["frames"]
        if config == 1:
            assert line["pairs_per_frame"] == m["frame_pairs"][0]
        image_close(m["frame0"], np.asarray(img), name)
    return out
