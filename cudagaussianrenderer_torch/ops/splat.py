"""Stages A-C's per-splat work as one kernel: the columns a flat frame's
pair list is emitted from.

``splat_columns`` takes a scene and a camera to what
ops.binning.build_tile_pairs_from_columns takes: the 13 flat [N] f32
columns of ops.binning.pack_columns and the [N] int32 exact candidate
counts.  On the card that is one pass over each splat
(``splat_columns_kernel``, csrc/splat.cu): the SH colour, the EWA
projection, the tile rect, the eight strip runs and the packing.  Its
plain version is the stage functions themselves, unchanged: splat_colors,
ops.projection.project_splats, then ops.binning.columns_and_counts.  The
kernel replaces no Pallas kernel: the JAX package writes these stages as
plain jnp, which XLA fuses.

The paths that need more than the columns keep the stage functions: the
banded frame (its band counts need the rects and row packs),
parallel.distributed (its band weights need the clip data) and diff.py
(autograd).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import RenderConfig
from ..models.scene import GaussianScene
from ..utils import cuda_build as cb
from .binning import DEPTH_BITS_PACKED, columns_and_counts
from .expand import R_ALPHA, R_RGB
from .projection import project_splats
from .sh import evaluate_sh_colors, num_sh_coeffs

# Rows of the kernel's [OUT_ROWS, N] output: the columns of pack_columns
# (R_* order without R_IDX, which comes before R_RGB) but alpha, which is
# the scene's opacities as they are.
OUT_ROWS = 12
RGB_COLUMN = R_RGB - 1
ALPHA_COLUMN = R_ALPHA - 1

# The kernel's truncation of the extents (config.opacity_aware_extents).
_TRUNC = {None: 0, "gaussian": 1, "epanechnikov": 2}


def splat_colors(scene: GaussianScene, cam: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Stage A: per-frame view-dependent colors when the scene has SH,
    otherwise the baked import-time colors (Demo.cpp:432-436)."""
    if _sh_degree(scene) > 0:
        return evaluate_sh_colors(scene.means, scene.sh, cam["position"], scene.sh_degree)
    return scene.colors


def _sh_degree(scene: GaussianScene) -> int:
    """The SH degree stage A evaluates: 0 where it takes the baked colors."""
    return scene.sh_degree if scene.sh is not None else 0


def _splat_columns_torch(scene, cam, config, row_band):
    """Plain PyTorch version of the kernel (see splat_columns)."""
    clip = project_splats(
        scene.means, scene.scales, scene.quats, cam, config, opacities=scene.opacities
    )
    return columns_and_counts(clip, splat_colors(scene, cam), scene.opacities, config,
                              row_band=row_band)


def _constants(config: RenderConfig):
    """The config's constants as the kernel takes them, each the Python
    float that the plain path's f32 op meets (ctypes rounds it to f32 as
    torch does): the trace bumps of x and y, epsilon, sigma factor, a tile
    row in clip units, the strip's height, the depth scale."""
    texel_x = 2.0 / float(config.screen_w)
    texel_y = 2.0 / float(config.screen_h)
    tch = 2.0 * config.tile_size / config.screen_h
    bits = DEPTH_BITS_PACKED if config.depth_bits == DEPTH_BITS_PACKED else 24
    return (
        (1.0 / math.pi) * texel_x * texel_x,
        (1.0 / math.pi) * texel_y * texel_y,
        config.epsilon,
        config.sigma_factor,
        tch,
        (15.0 / 16.0) * tch if config.center_sampled_runs else tch,
        float(2**bits - 1),
    )


def _camera_buffer(cam: Dict[str, torch.Tensor], dev) -> torch.Tensor:
    """The [CAMERA_FLOATS] float32 buffer that ``cam``'s tensors view
    (render.camera_views), so that the kernel reads the camera where
    Renderer refills it in place; a camera of separate tensors is gathered
    into one on the device first."""
    from ..render import _CAMERA_FIELDS, camera_flat

    base, off, views = cam["view"], 0, True
    for key, shape in _CAMERA_FIELDS:
        cb.require(cam[key], f"camera {key}", torch.float32, dev, shape)
        views = views and cam[key].data_ptr() == base.data_ptr() + 4 * off
        off += cam[key].numel()
    return base if views else camera_flat(cam)


def _band_bound(b, name, dev):
    """A row-band bound as the kernel takes it: (int, None) or (0, the
    0-d int32 device tensor)."""
    if isinstance(b, torch.Tensor):
        cb.require(b, name, torch.int32, dev, ())
        return 0, b
    return int(b), None


def splat_columns(scene: GaussianScene, cam: Dict[str, torch.Tensor], config: RenderConfig,
                  row_band=None):
    """Stages A-C's per-splat work: (13 flat [N] f32 columns in R_* order
    without R_IDX, [N] int32 exact candidate counts), the inputs of
    ops.binning.build_tile_pairs_from_columns.

    ``cam`` is the camera dict of render.camera_tensors or camera_views;
    the kernel reads it on the device.  ``row_band`` is None or a (lo, hi)
    pair of tile-row bounds, each an int or a 0-d int32 device tensor, as
    ops.binning.splat_tile_rects takes it.

    On the card every column but rgb equals the plain version's bit for
    bit, and rgb is within one level a channel (cuBLAS sums the plain
    version's SH contraction in its own order).  The alpha column is
    ``scene.opacities`` itself.
    """
    if cb.dispatch_device(scene.means) == "cpu":
        return _splat_columns_torch(scene, cam, config, row_band)
    dev = scene.means.device
    n = scene.means.shape[-1]
    cb.require(scene.means, "means", torch.float32, dev, (3, n))
    cb.require(scene.scales, "scales", torch.float32, dev, (3, n))
    cb.require(scene.quats, "quats", torch.int32, dev, (n,))
    cb.require(scene.opacities, "opacities", torch.float32, dev, (n,))
    degree = _sh_degree(scene)
    if degree > 0:
        sh_k = scene.sh.shape[1] if scene.sh.dim() == 3 else 0
        if sh_k < num_sh_coeffs(degree):
            raise ValueError(f"sh has shape {tuple(scene.sh.shape)}, expected "
                             f"(3, K >= {num_sh_coeffs(degree)}, {n})")
        cb.require(scene.sh, "sh", torch.float32, dev, (3, sh_k, n))
        colors, sh = 0, scene.sh.data_ptr()
    else:
        cb.require(scene.colors, "colors", torch.float32, dev, (3, n))
        colors, sh, sh_k = scene.colors.data_ptr(), 0, 0
    camera = _camera_buffer(cam, dev)
    lo, hi = (0, config.tiles_y) if row_band is None else row_band
    lo, lo_t = _band_bound(lo, "row_band[0]", dev)
    hi, hi_t = _band_bound(hi, "row_band[1]", dev)
    trunc = _TRUNC[config.falloff if config.opacity_aware_extents else None]

    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=dev)
    counts = torch.empty(n, dtype=torch.int32, device=dev)
    fn = cb.kernel(
        "splat", "gsr_splat_columns",
        [cb.P, cb.P, cb.P, cb.P, cb.P, cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.P, cb.I64]
        + [cb.F32] * 7 + [cb.I32] * 4 + [cb.P] * 5,
    )
    code = fn(
        scene.means.data_ptr(), scene.scales.data_ptr(), scene.quats.data_ptr(),
        scene.opacities.data_ptr(), colors, sh, sh_k, degree, trunc,
        int(config.center_sampled_runs), camera.data_ptr(), n, *_constants(config),
        config.tiles_x, config.tiles_y, lo, hi,
        None if lo_t is None else lo_t.data_ptr(), None if hi_t is None else hi_t.data_ptr(),
        out.data_ptr(), counts.data_ptr(), cb.stream_handle(scene.means),
    )
    cb.check("splat", code)
    splat_columns.launches += 1
    rows = out.unbind(0)
    return rows[:ALPHA_COLUMN] + (scene.opacities,) + rows[ALPHA_COLUMN:], counts


splat_columns.launches = 0
