"""The benchmark's one door into the program under test.

It hands the program the scene's arrays and each pose as the program's
own types (``GaussianScene``, ``Camera``) and builds the ``Renderer`` a
viewer builds; nothing else of the harness imports the program.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def _quaternion(m: np.ndarray) -> np.ndarray:
    """Unit (w, x, y, z) quaternion of a rotation matrix."""
    t = np.trace(m)
    if t > 0:
        s = 2.0 * np.sqrt(t + 1.0)
        q = [0.25 * s, (m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s]
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2])
        q = [(m[2, 1] - m[1, 2]) / s, 0.25 * s, (m[0, 1] + m[1, 0]) / s, (m[0, 2] + m[2, 0]) / s]
    elif m[1, 1] > m[2, 2]:
        s = 2.0 * np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2])
        q = [(m[0, 2] - m[2, 0]) / s, (m[0, 1] + m[1, 0]) / s, 0.25 * s, (m[1, 2] + m[2, 1]) / s]
    else:
        s = 2.0 * np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1])
        q = [(m[1, 0] - m[0, 1]) / s, (m[0, 2] + m[2, 0]) / s, (m[1, 2] + m[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


def camera(pose: Dict):
    """The program's Camera at ``pose``: looking from ``position`` at
    ``target`` down its local -Z axis, y up."""
    from cudagaussianrenderer_torch.models.camera import Camera

    pos = np.asarray(pose["position"], np.float64)
    back = pos - np.asarray(pose["target"], np.float64)
    back /= np.linalg.norm(back)
    right = np.cross([0.0, 1.0, 0.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    rot = _quaternion(np.stack([right, up, back], axis=1))
    return Camera(position=pos.astype(np.float32), rotation=rot.astype(np.float32),
                  fov_y=float(pose["fov_y"]), near=float(pose["near"]), far=float(pose["far"]),
                  aspect=float(pose["aspect"]))


def renderer(scene: Dict, screen: Dict, frame: Dict, device):
    """A Renderer over the scene's arrays (the program pads its own copy),
    configured with the screen, the tile and the configuration's frame
    parameters, ``RenderConfig``'s defaults otherwise."""
    from cudagaussianrenderer_torch.config import RenderConfig
    from cudagaussianrenderer_torch.models.scene import GaussianScene
    from cudagaussianrenderer_torch.render import Renderer

    half = float(scene["extent"])
    n = scene["means"].shape[1]
    gs = GaussianScene(means=scene["means"], scales=scene["scales"], quats=scene["quats"],
                       opacities=scene["opacities"], colors=scene["colors"], sh=scene["sh"],
                       sh_degree=scene["sh_degree"], count=n, bounds_min=(-half,) * 3,
                       bounds_max=(half,) * 3)
    config = RenderConfig(screen_size=int(screen["width"]), screen_height=int(screen["height"]),
                          tile_size=int(screen["tile"]), depth_bits=int(frame["depth_bits"]),
                          raster_chunk=int(frame["raster_chunk"]),
                          transmittance_eps=float(frame["transmittance_eps"]),
                          falloff=frame["falloff"],
                          opacity_aware_extents=bool(frame["opacity_aware_extents"]),
                          center_sampled_runs=bool(frame["center_sampled_runs"]))
    return Renderer(gs, config, device=device)


def eager_frame(r, pose: Dict, capacity: int):
    """One stand-alone eager frame of Renderer ``r``'s scene at ``pose`` and
    ``capacity`` (render_frame, the image left on the device)."""
    from cudagaussianrenderer_torch.render import render_frame

    return render_frame(r.scene, camera(pose).camera_data(), r.config, capacity,
                        device=r.device)
