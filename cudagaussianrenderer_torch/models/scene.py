"""Gaussian-splat scene model.

The scene lives on one device as planar SoA torch tensors with the splat
axis last ([3, N] rather than [N, 3]), the layout of the JAX package's
``GaussianScene``, so the two packages' stage functions take the same
arrays.  The packed 8-bit quaternions ride as int32 tensors holding the
uint32 bit patterns (torch has no shifts on uint32).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device
from ..utils.quantize import encode_quat_xyzw

# SH DC normalization constant: Y_0^0 = 1 / (2 sqrt(pi))
# (reference: PlyParser.cpp:326).
SH_C0 = 0.28209479177387814


def _u32_to_i32(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(np.int32)


@dataclasses.dataclass(frozen=True)
class GaussianScene:
    """A splat scene resident on one device.

    Attributes
    ----------
    means:      [3, N] float32 world-space centers (rows x, y, z).
    scales:     [3, N] float32 per-axis std-dev (activation exp() already
                applied, PlyParser.cpp:318).
    quats:      [N] int32 bit patterns of the packed uint32 (x,y,z,w)
                rotation, 8 bits/component (PlyParser.cpp:330).
    opacities:  [N] float32 in [0, 1] (sigmoid applied, PlyParser.cpp:319).
    colors:     [3, N] float32 baked degree-0 color = f_dc * SH_C0 + 0.5
                (PlyParser.cpp:326-327); used directly when sh is None.
    sh:         [3, K, N] float32 or None.  K = (sh_degree + 1)^2 bands
                including the DC band at k=0 (PlyParser.cpp:245-267).
    sh_degree:  int, 0..4.
    count:      int, true splat count (arrays may be padded beyond).
    bounds_min/bounds_max: 3-tuples, world AABB of the means
                (PlyParser.cpp:289-324).
    """

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    colors: torch.Tensor
    sh: Optional[torch.Tensor]

    sh_degree: int = 0
    count: int = 0
    bounds_min: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    bounds_max: Tuple[float, float, float] = (0.0, 0.0, 0.0)

    @property
    def device(self) -> torch.device:
        return self.means.device

    @property
    def padded_count(self) -> int:
        return self.means.shape[-1]

    @property
    def sh_coeff_count(self) -> int:
        """Bands per channel, (degree+1)^2."""
        return (self.sh_degree + 1) ** 2

    def to(self, device) -> "GaussianScene":
        """The same scene on ``device`` (self when already there)."""
        device = torch.device(device)
        if self.device == device:
            return self
        return dataclasses.replace(
            self,
            means=self.means.to(device),
            scales=self.scales.to(device),
            quats=self.quats.to(device),
            opacities=self.opacities.to(device),
            colors=self.colors.to(device),
            sh=None if self.sh is None else self.sh.to(device),
        )

    def pad_to(self, n: int) -> "GaussianScene":
        """Pad arrays to ``n`` splats with inert entries.

        Padding splats have opacity 0 and zero scale, parked at the
        bounds-min corner.  The projection culls opacity-0 splats
        outright (ops.projection), so they emit zero tile pairs.
        """
        cur = self.padded_count
        if n < cur:
            raise ValueError(f"cannot pad {cur} splats down to {n}")
        if n == cur:
            return self
        pad = n - cur
        dev = self.device
        park = torch.tensor(self.bounds_min, dtype=torch.float32, device=dev)
        identity = int(_u32_to_i32(encode_quat_xyzw(np.array([0.0, 0, 0, 1.0])))[0])

        def pad_last(a, fill):
            fills = torch.as_tensor(fill, dtype=a.dtype, device=dev)[..., None]
            return torch.cat([a, fills.expand(*a.shape[:-1], pad)], dim=-1)

        return dataclasses.replace(
            self,
            means=pad_last(self.means, park),
            scales=pad_last(self.scales, torch.zeros(3, device=dev)),
            quats=pad_last(self.quats, identity),
            opacities=pad_last(self.opacities, 0.0),
            colors=pad_last(self.colors, torch.zeros(3, device=dev)),
            sh=None
            if self.sh is None
            else pad_last(self.sh, torch.zeros(self.sh.shape[:-1], device=dev)),
        )

    def pad_to_multiple(self, m: int = 256) -> "GaussianScene":
        n = -(-self.padded_count // m) * m
        return self.pad_to(n)


def scene_from_arrays(
    means: np.ndarray,
    scales: np.ndarray,
    quats_xyzw: np.ndarray,
    opacities: np.ndarray,
    colors: Optional[np.ndarray] = None,
    sh: Optional[np.ndarray] = None,
    sh_degree: int = 0,
    *,
    device=None,
) -> GaussianScene:
    """Build a scene from raw (already activated) numpy arrays.

    Inputs use the conventional splat-major shapes — means/scales/colors
    [N, 3], sh [N, K, 3], quats [N, 4] (x, y, z, w) — and are transposed
    to the planar layout on the host.  Rotations are quantized to the
    packed uint32 representation exactly as the reference importer does
    (PlyParser.cpp:330).
    """
    dev = resolve_device(device)
    n = means.shape[0]
    means = np.asarray(means, np.float32)
    if colors is None:
        colors = np.full((n, 3), 0.5, np.float32)
    packed = encode_quat_xyzw(np.asarray(quats_xyzw, np.float32))
    bmin = means.min(axis=0) if n else np.zeros(3, np.float32)
    bmax = means.max(axis=0) if n else np.zeros(3, np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return GaussianScene(
        means=t(means.T),
        scales=t(np.asarray(scales, np.float32).T),
        quats=t(_u32_to_i32(packed)),
        opacities=t(np.asarray(opacities, np.float32)),
        colors=t(np.asarray(colors, np.float32).T),
        sh=None
        if sh is None
        else t(np.transpose(np.asarray(sh, np.float32), (2, 1, 0))),
        sh_degree=sh_degree,
        count=n,
        bounds_min=tuple(float(x) for x in bmin),
        bounds_max=tuple(float(x) for x in bmax),
    )


def scene_from_numpy(d: dict, device=None) -> GaussianScene:
    """A scene from the planar numpy arrays of another package's scene.

    ``d`` holds ``means``/``scales``/``colors`` [3, N], ``quats`` [N]
    uint32, ``opacities`` [N], ``sh`` [3, K, N] or None, and the metadata
    ``sh_degree``, ``count``, ``bounds_min``, ``bounds_max`` — the fields
    of the JAX package's ``GaussianScene`` converted with ``np.asarray``.
    The arrays are copied bit for bit, so both packages render the same
    scene.
    """
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype, order="C")).to(dev)

    return GaussianScene(
        means=t(d["means"], np.float32),
        scales=t(d["scales"], np.float32),
        quats=torch.from_numpy(_u32_to_i32(d["quats"])).to(dev),
        opacities=t(d["opacities"], np.float32),
        colors=t(d["colors"], np.float32),
        sh=None if d.get("sh") is None else t(d["sh"], np.float32),
        sh_degree=int(d.get("sh_degree", 0)),
        count=int(d["count"]),
        bounds_min=tuple(float(x) for x in d["bounds_min"]),
        bounds_max=tuple(float(x) for x in d["bounds_max"]),
    )


def random_scene_arrays(
    count: int,
    *,
    min_scale: float = 0.01,
    max_scale: float = 0.5,
    extent: float = 4.0,
    seed: int = 0,
    sh_degree: int = 0,
) -> dict:
    """The activated NumPy arrays of ``random_scene`` (splat-major, as
    scene_from_arrays takes them): ``means``, ``scales``, ``colors`` [N, 3],
    ``quats_xyzw`` [N, 4], ``opacities`` [N] and ``sh`` [N, K, 3] or None.

    Draws from the same ``np.random.default_rng(seed)`` stream in the same
    order as the JAX package, so one seed gives both packages the same
    scene.  Uniform positions in a cube of half-size ``extent``, random
    axis-angle rotations, uniform scales in [min_scale, max_scale],
    uniform RGBA colors (alpha doubles as opacity), and optionally random
    SH coefficients.
    """
    rng = np.random.default_rng(seed)
    means = rng.uniform(-extent, extent, (count, 3)).astype(np.float32)

    axis = rng.normal(size=(count, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(0.0, np.pi, count)
    s, c = np.sin(angle * 0.5), np.cos(angle * 0.5)
    quats = np.concatenate([axis * s[:, None], c[:, None]], axis=1).astype(np.float32)

    scales = rng.uniform(min_scale, max_scale, (count, 3)).astype(np.float32)
    rgba = rng.uniform(0.0, 1.0, (count, 4)).astype(np.float32)

    sh = None
    if sh_degree > 0:
        k = (sh_degree + 1) ** 2
        sh = np.zeros((count, k, 3), np.float32)
        # DC band consistent with the baked color; higher bands small.
        sh[:, 0, :] = (rgba[:, :3] - 0.5) / SH_C0
        sh[:, 1:, :] = rng.normal(scale=0.15, size=(count, k - 1, 3))
    return dict(means=means, scales=scales, quats_xyzw=quats, opacities=rgba[:, 3],
                colors=rgba[:, :3], sh=sh)


def random_scene(
    count: int,
    *,
    min_scale: float = 0.01,
    max_scale: float = 0.5,
    extent: float = 4.0,
    seed: int = 0,
    sh_degree: int = 0,
    device=None,
) -> GaussianScene:
    """Procedural random scene — the reference's debug fixture
    (generateRandomGaussians, Demo.cpp:119-143) — from the arrays of
    ``random_scene_arrays``, with the cube of half-size ``extent`` as its
    bounds."""
    a = random_scene_arrays(count, min_scale=min_scale, max_scale=max_scale, extent=extent,
                            seed=seed, sh_degree=sh_degree)
    scene = scene_from_arrays(
        a["means"], a["scales"], a["quats_xyzw"], a["opacities"], a["colors"], a["sh"],
        sh_degree, device=device,
    )
    bounds = (float(-extent),) * 3, (float(extent),) * 3
    return dataclasses.replace(scene, bounds_min=bounds[0], bounds_max=bounds[1])
