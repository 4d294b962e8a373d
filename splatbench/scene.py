"""The scene a cell renders, made on the device from the seed.

A configuration's ``scene`` block gives the splat count, the SH degree,
the half-size of the cube the centres fill and the range of the scales.
The arrays follow the procedural fixture's distributions: uniform
centres, uniform axis-angle rotations packed to 8 bits a component (the
format the scene files carry), uniform scales, uniform opacities and base
colours, SH bands above the first drawn from N(0, 0.15).  They are drawn
by one ``torch.Generator`` on the device in a few large calls, in float32.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

# Y_0^0 = 1 / (2 sqrt(pi)): the DC band of a base colour c is (c - 0.5) / SH_C0.
SH_C0 = 0.28209479177387814
SH_SPREAD = 0.15


def pack_rotation(q: torch.Tensor) -> torch.Tensor:
    """[4, N] (x, y, z, w) in [-1, 1] -> [N] int32 words holding the
    unsigned x8|y8|z8|w8 layout, each byte trunc((q + 1) / 2 * 255)."""
    b = (torch.clamp((q + 1.0) * 0.5, 0.0, 1.0) * 255.0).to(torch.int64)
    words = (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def make_scene(spec: Dict, seed: int, device) -> Dict:
    """The scene's arrays on ``device``: ``means``, ``scales``, ``colors``
    [3, N], ``quats`` [N] int32 packed words, ``opacities`` [N], ``sh``
    [3, (degree + 1)^2, N] (None at degree 0), ``sh_degree``, ``extent``."""
    n, degree = int(spec["splats"]), int(spec["sh_degree"])
    half = float(spec["extent"])
    lo, hi = (float(v) for v in spec["scale_range"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))

    def uniform(shape, a, b):
        return torch.rand(shape, generator=g, device=device) * (b - a) + a

    means = uniform((3, n), -half, half)
    axis = torch.randn((3, n), generator=g, device=device)
    axis = axis / torch.linalg.vector_norm(axis, dim=0)
    half_angle = uniform((n,), 0.0, math.pi) * 0.5
    quats = pack_rotation(torch.cat([axis * torch.sin(half_angle), torch.cos(half_angle)[None]]))
    scales = uniform((3, n), lo, hi)
    rgba = uniform((4, n), 0.0, 1.0)
    sh = None
    if degree > 0:
        sh = torch.randn((3, (degree + 1) ** 2, n), generator=g, device=device) * SH_SPREAD
        sh[:, 0] = (rgba[:3] - 0.5) / SH_C0
    return dict(means=means, scales=scales, colors=rgba[:3].contiguous(), quats=quats,
                opacities=rgba[3].contiguous(), sh=sh, sh_degree=degree, extent=half)
