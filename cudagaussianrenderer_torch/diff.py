"""Differentiable rendering and scene fitting — gradients through the splat
pipeline, by autograd.

The JAX package's diff.py renders as a function of the raw splat
parameters that ``jax.grad`` differentiates; here ``torch.autograd`` does,
on tensors that carry ``requires_grad``.  The design is the JAX package's:

- The pair STRUCTURE (which (tile, splat) pairs exist, their front-to-back
  order, the per-tile ranges) is discrete.  It comes from the production
  stages B-E under ``torch.no_grad()``: projection, exact binning with the
  emit kernels (K2, K3), the stable sort carrying the splat indices, and
  the tile ranges (K1).
- The pair VALUES (clip centre, conic, colour, opacity per splat) are
  recomputed differentiably at full f32 and gathered per sorted pair.
- Blending runs in the log domain (exclusive cumsum of log1p(-alpha)),
  with alpha bounded by ``alpha_max`` so the 1/(1 - alpha) backward term
  stays finite.  The blend is plain PyTorch, as it is plain jnp under
  ``jax.grad`` in the JAX package: a Python loop over blocks of tiles and
  chunks of pairs (``lax.map`` and ``lax.scan`` there), each chunk
  checkpointed with ``torch.utils.checkpoint`` where ``jax.checkpoint``
  is used.

Every clip that autograd runs through uses ops.geometry.clip, whose
gradient at a tie with a bound is JAX's (half to each side), not
torch.clamp's.

Parameters are carried unconstrained (``DiffSplats``: log-scales, opacity
logits, unnormalized quaternions).  ``from_scene``/``to_scene`` convert to
and from ``GaussianScene``; ``fit`` is the 3DGS training loop with the
hand-written optax-equivalent optimizers ``Adam`` and ``tx_3dgs``, density
control, pose and exposure refinement and ``.npz`` checkpoints whose keys
are the JAX package's, so a checkpoint written by either package resumes
in the other.  ``ssim`` is the D-SSIM statistic of the training loss.
The JAX fit jits its step; here the step runs as FitStepGraphs
(GraphedStep): on the card two CUDA graphs a step, cached per key.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from collections import Counter
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .config import RenderConfig
from .models.scene import GaussianScene, scene_from_arrays
from .ops.binning import build_tile_pairs
from .ops.geometry import clip as _clip
from .ops.projection import SplatClipData, project_splats
from .ops.ranges import tile_ranges
from .ops.sh import evaluate_sh_colors, num_sh_coeffs
from .ops.sorting import sort_pairs
from .render import (
    CAMERA_FLOATS, camera_flat, camera_tensors, camera_views, round_capacity, run_graphed,
)
from .utils.device import resolve_device
from .utils.quantize import decode_quat_components, quat_xyzw_to_rotation_matrix

SH_C0 = 0.28209479177387814

# Tiles blended at once by rasterize_diff: the JAX package's 64 on the CPU;
# on the card a block of TILE_BATCH_CUDA tiles, which keeps the number of
# launches a frame low (the result does not depend on it).
TILE_BATCH_CPU = 64
TILE_BATCH_CUDA = 1024


# ---------------------------------------------------------------------------
# Pytrees of tensors: NamedTuples, tuples and dicts (keys in sorted order,
# as jax.tree_util takes them), None for an absent leaf
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and the matching leaves of
    ``rest``), keeping its structure; None stays None."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    items = [tree_map(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def tree_leaves(tree) -> list:
    """The tensors of ``tree`` in the order of jax.tree_util.tree_leaves
    (fields in order, depth first, None skipped)."""
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [leaf for t in tree for leaf in tree_leaves(t)]


def tree_unflatten(template, leaves):
    """The structure of ``template`` filled with ``leaves`` in
    tree_leaves order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


# ---------------------------------------------------------------------------
# Parameters and structure
# ---------------------------------------------------------------------------


class DiffSplats(NamedTuple):
    """Unconstrained splat parameters (all leaves differentiable).

    means:          [3, N] world centres (GaussianScene's planar layout).
    log_scales:     [3, N] log of the per-axis std-dev.
    quats:          [4, N] UNNORMALIZED (x, y, z, w) rows, normalized in the
                    forward pass so rotation gradients stay on the sphere.
    opacity_logits: [N]; opacity = sigmoid(logits).
    colors:         [3, N] raw; colour = clip(colors, 0, 1).  Ignored when
                    ``sh`` is present.
    sh:             [3, K, N] SH coefficients or None; colour =
                    clip(basis . sh + 0.5, 0, 1) as stage A computes it.
                    The degree is derived from K.
    """

    means: torch.Tensor
    log_scales: torch.Tensor
    quats: torch.Tensor
    opacity_logits: torch.Tensor
    colors: torch.Tensor
    sh: Optional[torch.Tensor] = None

    @property
    def sh_degree(self) -> int:
        if self.sh is None:
            return 0
        return int(math.isqrt(self.sh.shape[1])) - 1


class PairStructure(NamedTuple):
    """Frozen pair structure for one camera.

    sids:   [C] int32 splat index per sorted pair (-1 on sentinel slots).
    starts: [T] int32 first pair slot of each tile.
    counts: [T] int32 pairs per tile.
    num_candidates: 0-d int32 exact candidate count (> C means the frame
        rendered with a truncated list).
    """

    sids: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    num_candidates: torch.Tensor


def from_scene(scene: GaussianScene, *, min_scale: float = 1e-8) -> DiffSplats:
    """GaussianScene -> unconstrained parameters (inverse activations), on
    the scene's device."""
    qx, qy, qz, qw = decode_quat_components(scene.quats)
    op = torch.clamp(scene.opacities, 1e-4, 1.0 - 1e-4)
    return DiffSplats(
        means=scene.means,
        log_scales=torch.log(torch.clamp(scene.scales, min=min_scale)),
        quats=torch.stack([qx, qy, qz, qw]),
        opacity_logits=torch.log(op) - torch.log1p(-op),
        colors=scene.colors,
        sh=scene.sh,
    )


def _np(a) -> np.ndarray:
    """A tensor (any device) or array-like as a NumPy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_scene(params: DiffSplats) -> GaussianScene:
    """Parameters -> GaussianScene on the parameters' device (rotations
    quantized to the packed representation, as the reference importer
    does)."""
    with torch.no_grad():
        scales, (qx, qy, qz, qw), opac = _activate(params)
    quats = np.stack([_np(qx), _np(qy), _np(qz), _np(qw)], axis=-1)
    colors = np.clip(_np(params.colors).T, 0.0, 1.0)
    sh = params.sh
    return scene_from_arrays(
        _np(params.means).T,
        _np(scales).T,
        quats,
        _np(opac),
        colors,
        None if sh is None else np.transpose(_np(sh), (2, 1, 0)),
        params.sh_degree,
        device=params.means.device,
    )


def _activate(params: DiffSplats):
    """Unconstrained -> model quantities: (scales [3, N], (qx, qy, qz, qw)
    unit rows, opacities [N])."""
    scales = torch.exp(params.log_scales)
    q = params.quats
    inv = 1.0 / _clip(torch.sqrt(torch.sum(q * q, dim=0)), 1e-12)
    opac = torch.sigmoid(params.opacity_logits)
    return scales, (q[0] * inv, q[1] * inv, q[2] * inv, q[3] * inv), opac


def _diff_colors(params: DiffSplats, camera_position) -> torch.Tensor:
    """Stage A, differentiable: [3, N] colours in [0, 1]."""
    if params.sh is not None and params.sh_degree > 0:
        return evaluate_sh_colors(params.means, params.sh, camera_position, params.sh_degree)
    if params.sh is not None:
        # Degree 0: DC band only, the importer's affine map.
        return _clip(params.sh[:, 0] * SH_C0 + 0.5, 0.0, 1.0)
    return _clip(params.colors, 0.0, 1.0)


def _project(params: DiffSplats, camera: dict, config: RenderConfig):
    scales, qc, opac = _activate(params)
    clip = project_splats(
        params.means, scales, None, camera, config, opacities=opac, quat_components=qc
    )
    return clip, opac


def _camera(camera_data: dict, device) -> dict:
    """A camera as the stages take it: Camera.camera_data() (NumPy) moves
    to ``device`` in one copy; a dict of tensors passes as it is."""
    if isinstance(camera_data.get("view"), torch.Tensor):
        return dict(camera_data)
    return camera_tensors(camera_data, device)


def _pair_structure(clip: SplatClipData, colors, opacities, config: RenderConfig,
                    capacity: int) -> PairStructure:
    """Stages C-E on frozen clip data: binning and emission (K2, K3), the
    stable sort carrying the splat indices, the tile ranges (K1)."""
    pairs = build_tile_pairs(clip, colors, opacities, config, capacity)
    keys, sids, _ = sort_pairs(pairs, with_values=True)
    starts, counts = tile_ranges(keys, config)
    return PairStructure(
        sids=sids,
        starts=starts.to(torch.int32),
        counts=counts.to(torch.int32),
        num_candidates=pairs.num_candidates,
    )


def build_structure(
    params: DiffSplats,
    camera_data: dict,
    config: RenderConfig,
    capacity: int,
    *,
    device=None,
) -> PairStructure:
    """Freeze the pair structure for one camera through the production
    stages B-E, under ``torch.no_grad()`` (the camera too: it may carry
    pose-refinement gradients).

    The sort carries the splat indices (``with_values=True``, which forces
    the stable sort: front-to-back ties resolve by emission order, as in
    the golden oracle).
    """
    dev = resolve_device(device)
    capacity = round_capacity(capacity, dev)
    with torch.no_grad():
        p = tree_map(lambda a: a.detach().to(dev), params)
        cam = {k: v.detach() for k, v in _camera(camera_data, dev).items()}
        clip, opac = _project(p, cam, config)
        colors = _diff_colors(p, cam["position"])
        return _pair_structure(clip, colors, opac, config, capacity)


# ---------------------------------------------------------------------------
# Per-view pose and exposure corrections
# ---------------------------------------------------------------------------


class CameraDeltas(NamedTuple):
    """Learnable per-view pose corrections (fit(optimize_cameras=True)).

    dr: [V, 3] rotation vectors (radians, camera frame, Rodrigues).
    dt: [V, 3] translations (camera frame: x right, y up, z backward).
    """

    dr: torch.Tensor
    dt: torch.Tensor


def zero_camera_deltas(num_views: int, *, device=None) -> CameraDeltas:
    dev = resolve_device(device)
    return CameraDeltas(
        dr=torch.zeros((num_views, 3), dtype=torch.float32, device=dev),
        dt=torch.zeros((num_views, 3), dtype=torch.float32, device=dev),
    )


class Exposure(NamedTuple):
    """Learnable per-view colour correction (fit(optimize_exposure=True)):
    rendered' = rendered * gain + bias per channel.

    gain: [V, 3] (identity 1), bias: [V, 3] (identity 0).
    """

    gain: torch.Tensor
    bias: torch.Tensor


def identity_exposure(num_views: int, *, device=None) -> Exposure:
    dev = resolve_device(device)
    return Exposure(
        gain=torch.ones((num_views, 3), dtype=torch.float32, device=dev),
        bias=torch.zeros((num_views, 3), dtype=torch.float32, device=dev),
    )


def _rodrigues(r: torch.Tensor) -> torch.Tensor:
    """[3] rotation vector -> [3, 3] rotation matrix, differentiable at the
    identity (Taylor branches keep the gradient finite at ||r|| = 0)."""
    theta2 = torch.sum(r * r)
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, 1.0, theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2_safe)
    z = torch.zeros((), dtype=r.dtype, device=r.device)
    k = torch.stack([
        torch.stack([z, -r[2], r[1]]),
        torch.stack([r[2], z, -r[0]]),
        torch.stack([-r[1], r[0], z]),
    ])
    return torch.eye(3, dtype=r.dtype, device=r.device) + a * k + b * (k @ k)


def apply_camera_delta(camera_data: dict, dr: torch.Tensor, dt: torch.Tensor) -> dict:
    """Right-multiply the camera-to-world pose by the small SE(3) correction
    (R(dr), dt), expressed in the camera's own frame, and return the camera
    dict with the new ``view`` and ``position`` (intrinsics stay).

    With M = camera-to-world = inv(view) and A = [[R, t], [0, 1]]: M' = M A,
    so view' = inv(A) view and position' = position + M_r t.  Differentiable
    in (dr, dt); zero deltas are exactly the identity.
    """
    rot = _rodrigues(dr)
    view = camera_data["view"]
    r3 = view[:3, :3]
    t3 = view[:3, 3:4]
    inv_r = rot.T
    new_top = torch.cat([inv_r @ r3, inv_r @ t3 - (inv_r @ dt)[:, None]], dim=1)
    out = dict(camera_data)
    out["view"] = torch.cat([new_top, view[3:4, :]], dim=0)
    out["position"] = camera_data["position"] + r3.T @ dt
    return out


def refined_camera(camera, dr, dt):
    """Host-side: bake a fitted pose correction into a models.camera.Camera
    (for exporting refined datasets), matching apply_camera_delta."""
    from .models.camera import quat_from_matrix, quat_to_matrix

    dr = np.asarray(_np(dr), np.float64)
    dt = np.asarray(_np(dt), np.float64)
    # float32, as the JAX package evaluates it.
    rot = np.asarray(_np(_rodrigues(torch.as_tensor(dr, dtype=torch.float32))), np.float64)
    r_c2w = quat_to_matrix(camera.rotation).astype(np.float64)
    return dataclasses.replace(
        camera,
        position=(np.asarray(camera.position, np.float64) + r_c2w @ dt).astype(np.float32),
        rotation=quat_from_matrix((r_c2w @ rot).astype(np.float32)),
    )


# ---------------------------------------------------------------------------
# The differentiable rasterizer
# ---------------------------------------------------------------------------


def max_tile_count(structure: PairStructure) -> int:
    """The largest per-tile pair count (to pick a static ``k_max``)."""
    return int(structure.counts.max())


def default_tile_batch(device) -> int:
    """rasterize_diff's block of tiles on ``device``."""
    return TILE_BATCH_CUDA if torch.device(device).type == "cuda" else TILE_BATCH_CPU


def _chunking(config: RenderConfig, k_max: int):
    """(pairs a chunk, chunks that cover ``k_max`` pairs)."""
    chunk = min(config.raster_chunk, max(8, k_max))
    return chunk, max(1, -(-k_max // chunk))


def round_up_chunks(c: int, n_chunks: int) -> int:
    """``c`` chunks rounded up to three significant bits (1-7, 8, 10, 12,
    14, 16, 20, 24, 28, 32, 40, ...), at most ``n_chunks``: at most a
    quarter more chunks, for far fewer distinct block profiles."""
    c = int(c)
    if c > 7:
        shift = c.bit_length() - 3
        c = -(-c >> shift) << shift
    return min(c, n_chunks)


def block_profile(counts, config: RenderConfig, k_max: int, tile_batch: int) -> tuple:
    """rasterize_diff's host part: from the per-tile pair counts (host
    values), the chunks each block of ``tile_batch`` tiles blends, the tiles
    taken in order of falling pair count (capped at ``k_max``): enough for
    its fullest tile, at most k_max's.  A chunk past a tile's pairs adds
    exactly zero to the image and to every gradient, so any profile that
    is at least this one block by block gives the same result."""
    chunk, n_chunks = _chunking(config, k_max)
    needed = np.minimum(np.asarray(counts).reshape(-1).astype(np.int64), k_max)
    fullest = -np.sort(-needed)[::tile_batch]
    return tuple(int(c) for c in np.minimum(n_chunks, -(-fullest // chunk)))


def tile_order(counts: torch.Tensor, k_max: int):
    """rasterize_diff's device part of the tile order: the tiles by falling
    pair count (capped at ``k_max``), ties in tile order (the permutation of
    ``np.argsort(-needed, kind="stable")``), and its inverse; no readback."""
    needed = torch.clamp(counts, max=k_max)
    order = torch.sort(-needed, stable=True).indices
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.shape[0], dtype=order.dtype, device=order.device))
    return order, inverse


def rasterize_diff(
    clip: SplatClipData,
    colors: torch.Tensor,
    opacities: torch.Tensor,
    structure: PairStructure,
    config: RenderConfig,
    k_max: int,
    *,
    tile_batch: Optional[int] = None,
    alpha_max: float = 0.9995,
    return_depth: bool = False,
    remat: Optional[bool] = None,
    profile: Optional[tuple] = None,
):
    """Differentiable rasterizer.  Returns [H, W, 4] float32 in [0, 1];
    with ``return_depth``, a ([H, W, 4], depth [H, W]) pair where depth is
    the alpha-weighted expected linear clip depth sum(w_i z_i).

    Per tile, gathers its first ``k_max`` sorted pairs (front to back) and
    alpha-blends them in the log domain with the production semantics:
    alpha = opacity * clip(density, 0, 1), colour += c T alpha, T *= 1 -
    alpha, with the chunk-granular saturation exit (a tile whose every
    pixel has T <= transmittance_eps after a chunk takes nothing further),
    reproduced exactly as a mask from log T, which carries no gradient.

    ``k_max`` caps the pairs per tile (pick k_max >= max_tile_count for
    exactness).  ``tile_batch`` tiles are blended at once (default
    TILE_BATCH_CPU on the CPU, TILE_BATCH_CUDA on the card), the tiles
    taken in order of falling pair count (tile_order, on the device), and
    a block blends only the chunks of ``profile`` (block_profile: enough
    for its fullest tile, rounded up or not): a chunk of dead pairs adds
    exactly zero, so neither changes the image or the gradient.  Without a
    ``profile`` the counts come to the host to make one: one readback a
    frame.  With one, nothing is read back or copied from the host, so a
    CUDA graph can capture the call.  ``remat`` checkpoints each chunk's
    blend: the
    backward pass recomputes the chunk's [tiles, pixels, chunk]
    activations instead of storing all of them.  None turns it on when the
    estimated stored residuals (pixels x k_max x 16 B) exceed 2 GiB.
    """
    if remat is None:
        remat = config.screen_w * config.screen_h * k_max * 16 > 2 << 30
    dev = opacities.device
    if tile_batch is None:
        tile_batch = default_tile_batch(dev)
    ts = config.tile_size
    ntx, nty = config.tiles_x, config.tiles_y
    t_total = config.total_tiles
    chunk, n_chunks = _chunking(config, k_max)
    if profile is None:
        profile = block_profile(structure.counts.cpu().numpy(), config, k_max, tile_batch)
    if len(profile) != -(-t_total // tile_batch) or max(profile) > n_chunks:
        raise ValueError(f"a profile of {len(profile)} blocks of at most {n_chunks} chunks, "
                         f"got {profile}")
    cap = structure.sids.shape[0]
    p_tile = ts * ts
    gauss = config.falloff == "gaussian"
    log_eps = float(np.log(config.transmittance_eps))
    sx, sy = 2.0 / config.screen_w, 2.0 / config.screen_h

    col = torch.arange(ts, dtype=torch.float32, device=dev)
    sids = torch.clamp(structure.sids, min=0)
    valid_sid = structure.sids >= 0
    # Per-splat values gathered per pair, one gather a chunk: centre, conic,
    # opacity, then what the blend sums (rgb, and z for depth).  Held in
    # float64, so that the gather's backward sums a splat's pair gradients
    # in float64: the float32 result then does not depend on the order of
    # the sum, which the tile blocks (and the card's atomics) set.
    cols = [clip.cx, clip.cy, clip.con_a, clip.con_b, clip.con_c, opacities,
            colors[0], colors[1], colors[2]]
    if return_depth:
        cols.append(clip.z)
    attrs = torch.stack(cols, dim=1).to(torch.float64)
    karange = torch.arange(chunk, dtype=torch.int32, device=dev)
    if config.background is not None:
        # The background's floats as fills on the device (no host copy).
        bg = torch.stack([torch.full((), float(c), dtype=torch.float32, device=dev)
                          for c in config.background])

    def tile_block(tids, n_chunks):
        """Blend the tiles ``tids`` over their first ``n_chunks`` chunks of
        pairs -> [TB, p_tile, 4 or 5]."""
        n_t = tids.shape[0]
        tx = (tids % ntx).to(torch.float32)
        ty = torch.div(tids, ntx, rounding_mode="floor").to(torch.float32)
        px = (tx[:, None] * ts + col[None, :]) * sx - 1.0  # [TB, ts]
        py = (ty[:, None] * ts + col[None, :]) * sy - 1.0
        # Flattened pixel index r * ts + c (image row-major).
        pxf = px.repeat(1, ts)                              # [TB, p]
        pyf = py.repeat_interleave(ts, dim=1)
        starts = structure.starts[tids]
        counts = structure.counts[tids]

        def body(rgb, log_t, dep, k0):
            k = k0 + karange                                 # [chunk]
            idx = starts[:, None] + k[None, :]               # [TB, chunk]
            live = k[None, :] < counts[:, None]
            idx = torch.clamp(idx, 0, cap - 1)
            sid = sids[idx]
            live = live & valid_sid[idx]
            # Saturation exit at chunk granularity (golden.py:271-272).
            active = torch.any(log_t > log_eps, dim=-1)     # [TB]
            live = live & active[:, None]

            a = attrs[sid].to(torch.float32)                 # [TB, chunk, A]
            cx, cy, ca, cb, cc, op = (a[..., i] for i in range(6))
            dx = pxf[:, :, None] - cx[:, None, :]            # [TB, p, chunk]
            dy = pyf[:, :, None] - cy[:, None, :]
            dpow = (
                ca[:, None, :] * dx * dx
                + cc[:, None, :] * dy * dy
                + 2.0 * cb[:, None, :] * dx * dy
            )
            if gauss:
                density = torch.exp(-0.5 * dpow)
            else:
                density = 1.0 - dpow * (1.0 / 7.0)
            alpha = op[:, None, :] * _clip(density, 0.0, 1.0)
            alpha = _clip(alpha, hi=alpha_max)
            alpha = torch.where(live[:, None, :], alpha, 0.0)

            l1m = torch.log1p(-alpha)                        # [TB, p, chunk]
            cum = torch.cumsum(l1m, dim=-1)
            log_t_k = log_t[:, :, None] + (cum - l1m)        # exclusive
            w = torch.exp(log_t_k) * alpha
            acc = torch.matmul(w, a[..., 6:])                # [TB, p, 3 or 4]
            rgb = rgb + acc[..., :3]
            if return_depth:
                dep = dep + acc[..., 3]
            return rgb, log_t + cum[:, :, -1], dep

        rgb = torch.zeros((n_t, p_tile, 3), dtype=torch.float32, device=dev)
        log_t = torch.zeros((n_t, p_tile), dtype=torch.float32, device=dev)
        dep = torch.zeros((n_t, p_tile), dtype=torch.float32, device=dev)
        for c in range(n_chunks):
            if remat:
                rgb, log_t, dep = checkpoint(body, rgb, log_t, dep, c * chunk,
                                             use_reentrant=False, preserve_rng_state=False)
            else:
                rgb, log_t, dep = body(rgb, log_t, dep, c * chunk)
        if config.background is not None:
            # The production raster's compositing: the opaque background
            # under the remaining transmittance (differentiable: gradients
            # reach the occluding alphas through log T).
            rgb = rgb + torch.exp(log_t)[:, :, None] * bg[None, None, :]
            alpha_ch = torch.ones((n_t, p_tile), dtype=torch.float32, device=dev)
        else:
            alpha_ch = (counts > 0).to(torch.float32)[:, None].expand(n_t, p_tile)
        out = [rgb, alpha_ch[:, :, None]]
        if return_depth:
            out.append(dep[:, :, None])
        return torch.cat(out, dim=-1)

    nc = 5 if return_depth else 4
    order, inverse = tile_order(structure.counts, k_max)
    blocks = [tile_block(order[i * tile_batch:(i + 1) * tile_batch], c)
              for i, c in enumerate(profile)]
    tiles = torch.cat(blocks)[inverse]
    image = (
        tiles.reshape(nty, ntx, ts, ts, nc)
        .permute(0, 2, 1, 3, 4)
        .reshape(config.screen_h, config.screen_w, nc)
    )
    rgba = _clip(image[..., :4], 0.0, 1.0)
    if return_depth:
        return rgba, image[..., 4]
    return rgba


def render_diff(
    params: DiffSplats,
    camera_data: dict,
    config: RenderConfig,
    capacity: int,
    k_max: int,
    *,
    structure: Optional[PairStructure] = None,
    tile_batch: Optional[int] = None,
    alpha_max: float = 0.9995,
    return_depth: bool = False,
    remat: Optional[bool] = None,
    profile: Optional[tuple] = None,
    device=None,
):
    """Differentiable frame render on ``device`` (default: the card; the
    parameters live there).  Gradients flow to every DiffSplats leaf (and
    to the camera's tensors, if they carry any).

    Returns (image [H, W, 4] float32, structure), or (image, depth [H, W],
    structure) with ``return_depth`` (expected linear clip depth; see
    rasterize_diff).  Pass ``structure`` to reuse a frozen one; by default
    it is built for this camera by build_structure.  ``profile``: see
    rasterize_diff.
    """
    dev = resolve_device(device)
    cam = _camera(camera_data, dev)
    if structure is None:
        structure = build_structure(params, cam, config, capacity, device=dev)
    clip, opac = _project(params, cam, config)
    colors = _diff_colors(params, cam["position"])
    out = rasterize_diff(
        clip, colors, opac, structure, config, k_max,
        tile_batch=tile_batch, alpha_max=alpha_max, return_depth=return_depth, remat=remat,
        profile=profile,
    )
    if return_depth:
        image, depth = out
        return image, depth, structure
    return out, structure


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------


def _gaussian_window(window: int, sigma: float) -> list:
    """The normalised 1-D Gaussian window as Python floats that are exact
    float32 values (computed in float32, as the JAX package does)."""
    r = window // 2
    x = torch.arange(-r, r + 1, dtype=torch.float32)
    g = torch.exp(-(x * x) / (2.0 * sigma * sigma))
    return (g / torch.sum(g)).tolist()


def _blur(img: torch.Tensor, g: list) -> torch.Tensor:
    """[C, H, W] Gaussian filter with zero ("SAME") padding, as two
    separable passes of shifted multiply-adds in float32.

    Plain elementwise arithmetic on purpose: a float32 convolution on the
    card goes through cuDNN, which rounds its inputs to TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is off, and the moment estimates
    blur(a*a) - mu*mu below cancel to ~1e-3 at that precision on flat
    regions, enough to flip the SSIM denominator's sign (c2 is 9e-4).
    """
    r = len(g) // 2
    h, w = img.shape[1:]
    p = torch.nn.functional.pad(img, (0, 0, r, r))
    out = g[0] * p[:, 0:h]
    for k in range(1, len(g)):
        out = out + g[k] * p[:, k : k + h]
    p = torch.nn.functional.pad(out, (r, r))
    out = g[0] * p[:, :, 0:w]
    for k in range(1, len(g)):
        out = out + g[k] * p[:, :, k : k + w]
    return out


def ssim(a, b, *, window: int = 11, sigma: float = 1.5, c1: float = 0.01 ** 2,
         c2: float = 0.03 ** 2) -> torch.Tensor:
    """Mean SSIM between two [H, W, C] images in [0, 1] (differentiable),
    a 0-d float32 tensor on ``a``'s device.

    ``a`` and ``b`` are tensors or NumPy arrays.  The standard Wang et al.
    formulation with a Gaussian window, evaluated as separable filters:
    the statistic the 3DGS training loss uses (1 - SSIM as D-SSIM).
    """
    a = torch.as_tensor(a)
    b = torch.as_tensor(b, device=a.device)
    g = _gaussian_window(window, sigma)
    ac = a.permute(2, 0, 1).to(torch.float32)
    bc = b.permute(2, 0, 1).to(torch.float32)
    mu_a, mu_b = _blur(ac, g), _blur(bc, g)
    # Enforce the moment invariants (true variance >= 0 and
    # |cov| <= sqrt(var_a * var_b)) against residual floating-point
    # cancellation; together they pin SSIM to its mathematical [-1, 1]
    # range, so 1 - SSIM (the D-SSIM loss term) can never go negative.
    var_a = _clip(_blur(ac * ac, g) - mu_a * mu_a, 0.0)
    var_b = _clip(_blur(bc * bc, g) - mu_b * mu_b, 0.0)
    cov = _blur(ac * bc, g) - mu_a * mu_b
    # detach: the bound is a numerical guard, not an objective term, and
    # d(sqrt)/d(var) blows up at var = 0 (flat patches).
    cov_bound = torch.sqrt(var_a * var_b).detach()
    cov = torch.minimum(torch.maximum(cov, -cov_bound), cov_bound)
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)


def target_tensor(image, device) -> torch.Tensor:
    """A target image ([H, W, >=3], uint8 or float in [0, 1], tensor or
    NumPy) as the [H, W, 3] float32 RGB the loss takes, on ``device``."""
    a = _np(image)
    scale = 255.0 if a.dtype == np.uint8 else 1.0
    return torch.from_numpy(np.ascontiguousarray(a[..., :3], np.float32)).to(device) / scale


def view_loss(
    params: DiffSplats,
    camera: dict,
    target: torch.Tensor,
    config: RenderConfig,
    capacity: int,
    k_max: int,
    *,
    l1_weight: float = 0.0,
    ssim_weight: float = 0.0,
    l2_weight: float = 1.0,
    depth_weight: float = 0.0,
    depth_target: Optional[torch.Tensor] = None,
    gain: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    remat: Optional[bool] = None,
    structure: Optional[PairStructure] = None,
    profile: Optional[tuple] = None,
    device=None,
):
    """The training loss of one view, as ``fit`` takes it: render_diff of
    ``camera``, then ``l2_weight`` MSE + ``l1_weight`` L1 + ``ssim_weight``
    (1 - SSIM) of its RGB against ``target`` ([H, W, 3] float in [0, 1]),
    and, with ``depth_weight`` and ``depth_target``, a masked depth L1 (NaN
    marks unsupervised pixels).  ``gain`` and ``bias`` ([3] each) expose
    the render per view first.  ``structure`` and ``profile`` go to
    render_diff.

    Returns (loss: a 0-d tensor, or 0.0 when every weight is 0, the
    structure's num_candidates).
    """
    use_depth = depth_weight > 0 and depth_target is not None
    out = render_diff(params, camera, config, capacity, k_max, return_depth=use_depth,
                      remat=remat, structure=structure, profile=profile, device=device)
    image, structure = out[0], out[-1]
    rgb = image[..., :3]
    if gain is not None:
        # Per-view exposure on the RENDER, so the target stays the ground
        # truth and the splats learn exposure-free colour.
        rgb = rgb * gain[None, None, :] + bias[None, None, :]
    err = rgb - target
    loss = l2_weight * torch.mean(err * err) if l2_weight else 0.0
    if l1_weight:
        loss = loss + l1_weight * torch.mean(torch.abs(err))
    if ssim_weight:
        # The 3DGS D-SSIM term (1 - SSIM); the paper's loss is
        # l1_weight=0.8, ssim_weight=0.2, l2_weight=0.
        loss = loss + ssim_weight * (1.0 - ssim(rgb, target))
    if use_depth:
        # Masked L1 on expected linear clip depth: only pixels whose
        # target is finite (NaN = unknown depth).
        depth = out[1]
        m = torch.isfinite(depth_target)
        d0 = torch.where(m, depth_target, 0.0)
        n_valid = _clip(torch.sum(m.to(torch.float32)), 1.0)
        loss = loss + depth_weight * (torch.sum(torch.abs(depth - d0) * m) / n_valid)
    return loss, structure.num_candidates


def loss_grads(loss, inputs) -> list:
    """The gradients of ``loss`` with respect to each tensor of ``inputs``.
    A tensor the loss does not reach (colors when SH is present; every one
    when the view holds no pair, so that the loss has no graph) gets
    zeros, as jax.grad gives."""
    grads = [None] * len(inputs)
    if isinstance(loss, torch.Tensor) and loss.requires_grad:
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


# ---------------------------------------------------------------------------
# Optimizers: optax's Adam arithmetic, written out
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    """optax.ScaleByAdamState: the step count, first and second moments."""

    count: torch.Tensor
    mu: tuple
    nu: tuple


class Transform(NamedTuple):
    """An optax.GradientTransformation: ``init(params) -> state`` and
    ``update(grads, state, params=None) -> (updates, state)``."""

    init: Callable
    update: Callable


class Adam:
    """optax.adam(learning_rate) on pytrees of tensors, by hand: the moments
    (1 - b1) g + b1 mu and (1 - b2) g^2 + b2 nu, bias correction
    1 - b^count from the step count, and the update
    mu_hat / (sqrt(nu_hat) + eps), scaled by -learning_rate.  With
    ``learning_rate=None`` the update is not scaled (optax.scale_by_adam).

    torch.optim.Adam is not used: its eps sits in another place and its
    state lives per Parameter, which a densify step replaces.  The state is
    an AdamState whose tree_leaves come in optax's order (count, mu, nu),
    which the checkpoints rely on.
    """

    def __init__(self, learning_rate: Optional[float] = None, *, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params) -> AdamState:
        dev = tree_leaves(params)[0].device
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=dev),
            mu=tree_map(torch.zeros_like, params),
            nu=tree_map(torch.zeros_like, params),
        )

    def update(self, grads, state: AdamState, params=None):
        b1, b2, eps = self.b1, self.b2, self.eps
        mu = tree_map(lambda g, t: (1 - b1) * g + b1 * t, grads, state.mu)
        nu = tree_map(lambda g, t: (1 - b2) * (g * g) + b2 * t, grads, state.nu)
        count = state.count + 1
        n = count.to(torch.float32)
        bc1 = 1 - torch.pow(b1, n)
        bc2 = 1 - torch.pow(b2, n)
        updates = tree_map(lambda m, v: (m / bc1) / (torch.sqrt(v / bc2) + eps), mu, nu)
        if self.learning_rate is not None:
            lr = -self.learning_rate
            updates = tree_map(lambda u: lr * u, updates)
        return updates, AdamState(count=count, mu=mu, nu=nu)


def apply_updates(params, updates):
    """optax.apply_updates: params + updates, leaf by leaf."""
    return tree_map(lambda p, u: p + u, params, updates)


def tx_3dgs(
    scene_extent: float,
    total_steps: int,
    *,
    lr_scale: float = 1.0,
    position_lr: float = 1.6e-4,
    position_lr_final_ratio: float = 0.01,
    scale_lr: float = 5e-3,
    quat_lr: float = 1e-3,
    opacity_lr: float = 5e-2,
    color_lr: float = 2.5e-3,
    sh_rest_div: float = 20.0,
    eps: float = 1e-15,
) -> Transform:
    """The 3DGS per-parameter Adam schedule over the DiffSplats leaves:
    positions at ``position_lr * scene_extent`` decayed exponentially by
    ``position_lr_final_ratio`` over the run, opacity logits at 5e-2,
    rotations at 1e-3, log-scales at 5e-3, colours and the SH DC band at
    2.5e-3 and the SH rest bands at 1/20 of that.  Pass it as
    ``fit(tx=...)``.

    Its state is (AdamState, step count): the leaves of the JAX package's
    (optax.scale_by_adam state, count), in that order.  The decay clock
    restarts when fit() re-inits the optimizer after a densify step.
    """
    adam = Adam(None, eps=eps)
    lo = float(position_lr_final_ratio)

    def init(params):
        inner = adam.init(params)
        return (inner, torch.zeros((), dtype=torch.int32, device=inner.count.device))

    def update(grads, state, params=None):
        inner, count = state
        upd, inner = adam.update(grads, inner)
        t = torch.clamp(count.to(torch.float32) / float(max(1, total_steps)), 0.0, 1.0)
        pos_lr = position_lr * scene_extent * torch.pow(lo, t)
        s = -lr_scale
        sh = upd.sh
        if sh is not None:
            k = sh.shape[1]
            mult = torch.full((1, k, 1), color_lr / sh_rest_div, dtype=sh.dtype, device=sh.device)
            mult[:, 0] = color_lr
            sh = sh * (s * mult)
        new = DiffSplats(
            means=upd.means * (s * pos_lr),
            log_scales=upd.log_scales * (s * scale_lr),
            quats=upd.quats * (s * quat_lr),
            opacity_logits=upd.opacity_logits * (s * opacity_lr),
            colors=upd.colors * (s * color_lr),
            sh=sh,
        )
        return new, (inner, count + 1)

    return Transform(init, update)


# ---------------------------------------------------------------------------
# Adaptive density control (3DGS clone / split / prune)
# ---------------------------------------------------------------------------


def densify_and_prune(
    params: DiffSplats,
    mean_grad_norm,
    *,
    grad_threshold: float = 2e-4,
    dense_scale: float = 0.01,
    scene_extent: float = 1.0,
    split_factor: float = 1.6,
    prune_opacity: float = 1.0 / 255.0,
    max_splats: Optional[int] = None,
    seed: int = 0,
) -> DiffSplats:
    """One adaptive-density step on the host (NumPy, the JAX package's
    arithmetic and random draws); the result lands on the parameters'
    device as new leaf tensors.

    Splats whose mean positional-gradient norm reaches ``grad_threshold``
    are CLONED when small (max scale < dense_scale * scene_extent) and
    SPLIT into two samples of their own Gaussian, scales divided by
    ``split_factor``, when large; splats below ``prune_opacity`` are
    PRUNED.  ``max_splats`` caps growth (highest-gradient splats win).
    """
    rng = np.random.default_rng(seed)
    n = params.means.shape[-1]
    g = np.asarray(_np(mean_grad_norm), np.float32)
    if g.shape != (n,):
        raise ValueError(f"mean_grad_norm must be [{n}], got {g.shape}")

    means = _np(params.means)
    log_scales = _np(params.log_scales)
    quats = _np(params.quats)
    logits = _np(params.opacity_logits)
    colors = _np(params.colors)
    sh = None if params.sh is None else _np(params.sh)

    opac = 1.0 / (1.0 + np.exp(-logits))
    keep = opac >= prune_opacity

    scales = np.exp(log_scales)
    big = scales.max(axis=0) >= dense_scale * scene_extent
    hot = (g >= grad_threshold) & keep
    clone = hot & ~big
    split = hot & big
    if max_splats is not None:
        budget = max(0, max_splats - int(keep.sum()))
        grow = np.flatnonzero(clone | split)
        if grow.size > budget:
            # Highest-gradient splats win the budget.
            order = grow[np.argsort(-g[grow])]
            drop = order[budget:]
            clone[drop] = False
            split[drop] = False

    pieces = []

    def emit(mask_or_idx, means_sel=None, log_scales_sel=None):
        pieces.append((
            means[..., mask_or_idx] if means_sel is None else means_sel,
            log_scales[..., mask_or_idx] if log_scales_sel is None else log_scales_sel,
            quats[..., mask_or_idx],
            logits[mask_or_idx],
            colors[..., mask_or_idx],
            None if sh is None else sh[..., mask_or_idx],
        ))

    # Survivors (split parents are replaced by their two children, the
    # paper's behaviour; clone parents stay), then the clones.
    emit(keep & ~split)
    if clone.any():
        emit(clone)
    # Splits: two samples from the parent's own Gaussian, shrunk.
    if split.any():
        idx = np.flatnonzero(split)
        q = quats[:, idx].T.astype(np.float64)
        q /= np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-12)
        rot = quat_xyzw_to_rotation_matrix(q)  # [M, 3, 3]
        s = scales[:, idx].T  # [M, 3]
        for _ in range(2):
            z = rng.normal(size=s.shape).astype(np.float32) * s
            offs = np.einsum("mij,mj->mi", rot, z).astype(np.float32)
            emit(idx, means[:, idx] + offs.T,
                 log_scales[:, idx] - np.float32(np.log(split_factor)))

    dev = params.means.device

    def cat(i):
        return torch.from_numpy(np.concatenate([p[i] for p in pieces], axis=-1)).to(dev)

    return DiffSplats(
        means=cat(0), log_scales=cat(1), quats=cat(2), opacity_logits=cat(3), colors=cat(4),
        sh=None if sh is None else cat(5),
    )


# ---------------------------------------------------------------------------
# The compiled training step: CUDA graphs cached per key
# ---------------------------------------------------------------------------


def _same_layout(a, b) -> bool:
    """Whether two pytrees have the same leaves in count, shape and dtype."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return type(a) is type(b) and len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


class GraphedStep:
    """A training step in the compiled form the JAX package jits it to: on
    the card two CUDA graphs a step, cached per key as the JAX jit caches
    its programs, with one readback between them.

    - **S**, the structure: each view's pair structure (build_structure:
      stages A-E under ``no_grad``, K2, K3, the stable sort, K1) into
      static buffers, and its per-tile counts into a host buffer (pinned
      on the card).
    - The host waits for S and makes each view's block profile from the
      counts (block_profile; on the card covered by a key already made, or
      rounded up, to bound the keys: _cover).
    - **B**, the step: the blend over that profile, the loss, its
      gradients, the optimizer's update, written into the state's static
      buffers in place (the subclass's ``_step_body``).

    S's key is the subclass's static key (``key()``: what the JAX jit
    retraces on); B's adds the profiles.  A key's first visit runs eagerly
    under render.run_sync_free, so that a host copy or sync in a body
    raises; its second is captured (render.capture_frame, into the one
    pool of this object) and replayed; later visits replay.  A failed
    capture raises.  B's side-stream warm-up writes nothing, so a capture
    visit takes one step.  On the CPU every body runs eagerly.

    Memory: the state, the inputs and the structure are static tensors
    allocated outside the pool.  The graphs share the pool, which is safe
    because they replay one at a time on one stream and nothing a graph
    allocates is read after another graph replays: S's results go to
    static buffers, B's outputs (loss, candidates, gradient norms) are
    read before the next step.  State whose leaves change shape (a
    densify) takes new buffers, and the graphs, which read the old ones,
    are dropped with their pool."""

    def __init__(self, config: RenderConfig, capacity: int, k_max: int, n_views: int, device, *,
                 remat: Optional[bool] = None, error_mode: str = "global"):
        self.dev = resolve_device(device)
        # run_graphed's switch: graphs on the card, eager elsewhere.
        self.device = self.dev
        self.config = config
        self.capacity = round_capacity(capacity, self.dev)
        self.k_max = k_max
        self.remat = remat
        self.error_mode = error_mode
        self.tile_batch = default_tile_batch(self.dev)
        # The graph cache (render.run_graphed's): key -> (graph, outputs),
        # the visited keys and the one pool; set by _structure_buffers.
        self._structure_buffers(n_views)
        self._ready = torch.cuda.Event() if self.dev.type == "cuda" else None
        self.last_method: Optional[str] = None
        # What ran, by graph ("structure", "step") and method; keys made;
        # cache drops; blended chunk-tiles of the exact and the run profiles.
        self.methods = {"structure": Counter(), "step": Counter()}
        self._keys: set = set()
        self.resets = 0
        self.chunk_tiles = [0, 0]

    # -- state --------------------------------------------------------------

    def _structure_buffers(self, n_views: int) -> None:
        """Static buffers for the structures of ``n_views`` views and their
        counts on the host; the graphs, which read the old ones, go."""
        t = self.config.total_tiles

        def buf(*shape):
            return torch.zeros(shape, dtype=torch.int32, device=self.dev)

        self.structures = [PairStructure(sids=buf(self.capacity), starts=buf(t), counts=buf(t),
                                         num_candidates=buf()) for _ in range(n_views)]
        self._counts_host = torch.zeros((n_views, t), dtype=torch.int32,
                                        pin_memory=self.dev.type == "cuda")
        self._graphs, self._visited, self._pool = {}, set(), None

    def _bind(self, **trees) -> None:
        """Make ``trees`` the state: copied into its static buffers where
        every leaf keeps its shape and dtype, else into new ones, and then
        the graphs, which read the old buffers, are dropped."""
        renewed = False
        for name, tree in trees.items():
            old = getattr(self, name, None)
            if old is not None and _same_layout(old, tree):
                for d, x in zip(tree_leaves(old), tree_leaves(tree)):
                    if d is not x:
                        d.copy_(x)
            else:
                setattr(self, name, tree_map(lambda a: a.detach().to(self.dev).clone(), tree))
                renewed = True
        if renewed:
            self._graphs, self._visited, self._pool = {}, set(), None
            self.resets += 1

    def _state(self) -> list:
        """The state's leaves, in the order _step_body returns them."""
        raise NotImplementedError

    def _commit(self, new_leaves) -> None:
        for d, x in zip(self._state(), new_leaves):
            d.copy_(x)

    # -- the two graphs ------------------------------------------------------

    def key(self):
        """The static key (S's; B's adds the profiles)."""
        raise NotImplementedError

    def _structure_cameras(self) -> list:
        """Each view's camera for S (a dict of tensors, no gradient)."""
        raise NotImplementedError

    def _run(self, kind: str, key, body, warmup=None):
        key = (kind, key)
        self._keys.add(key)
        out = run_graphed(self, key, body, error_mode=self.error_mode, warmup=warmup)
        self.methods[kind][self.last_method] += 1
        return out

    def _structure_body(self):
        with torch.no_grad():
            for v, cam in enumerate(self._structure_cameras()):
                st = build_structure(self.params, cam, self.config, self.capacity, device=self.dev)
                for dst, src in zip(self.structures[v], st):
                    dst.copy_(src)
                self._counts_host[v].copy_(st.counts, non_blocking=True)
        return ()

    def _profiles(self, key) -> tuple:
        """S at ``key``, the wait for its counts, and each view's exact
        block profile."""
        self._run("structure", key, self._structure_body)
        if self._ready is not None:
            self._ready.record()
            self._ready.synchronize()
        return tuple(block_profile(c, self.config, self.k_max, self.tile_batch)
                     for c in self._counts_host.numpy())

    def _chunk_tiles(self, profiles) -> int:
        """The chunk-tiles that ``profiles`` blend."""
        t, tb = self.config.total_tiles, self.tile_batch
        sizes = [min(tb, t - i * tb) for i in range(-(-t // tb))]
        return sum(int(np.dot(p, sizes)) for p in profiles)

    def _cover(self, key, exact) -> tuple:
        """The profiles B blends.  On the CPU the exact ones.  On the card a
        profile that covers them block by block gives the same result (a
        chunk past a tile's pairs adds exactly zero), so B reuses the
        cheapest key already made at ``key`` whose profiles cover them and
        blend at most a quarter more chunk-tiles than the exact ones rounded
        up (round_up_chunks); else it makes a key of the rounded ones."""
        if self.device.type != "cuda":
            return exact
        n_chunks = _chunking(self.config, self.k_max)[1]
        best = tuple(tuple(round_up_chunks(c, n_chunks) for c in p) for p in exact)
        limit = 1.25 * self._chunk_tiles(best)
        cost = None
        for kind, (k, profiles) in (v for v in self._visited if v[0] == "step"):
            covers = k == key and all(a >= b for pa, pb in zip(profiles, exact)
                                      for a, b in zip(pa, pb))
            c = self._chunk_tiles(profiles) if covers else None
            if covers and c <= limit and (cost is None or c < cost):
                best, cost = profiles, c
        return best

    def _step(self, body):
        """S, the profiles, then B (``body(profiles, effects=...)``: the
        warm-up runs it without its effects); returns B's outputs."""
        key = self.key()
        exact = self._profiles(key)
        profiles = self._cover(key, exact)
        self.chunk_tiles[0] += self._chunk_tiles(exact)
        self.chunk_tiles[1] += self._chunk_tiles(profiles)
        return self._run("step", (key, profiles), functools.partial(body, profiles),
                         warmup=functools.partial(body, profiles, effects=False))

    def report(self) -> dict:
        """What ran: keys made, graphs held now, each graph's eager,
        captured and replayed visits, cache drops, the chunk-tiles the
        rounded profiles blended against the exact ones, and the card's
        memory_reserved (bytes)."""
        out = dict(keys=len(self._keys), graphs=len(self._graphs), resets=self.resets,
                   structure=dict(self.methods["structure"]), step=dict(self.methods["step"]),
                   chunk_tiles_exact=self.chunk_tiles[0], chunk_tiles_run=self.chunk_tiles[1])
        if self.dev.type == "cuda":
            out["memory_reserved"] = torch.cuda.memory_reserved(self.dev)
        return out


def fit_step_key(params: DiffSplats, config: RenderConfig, capacity: int, k_max: int,
                 n_views: int, image_shape, *, loss_weights, use_depth: bool, sh_warmup: bool,
                 optimize_cameras: bool, optimize_exposure: bool, remat: Optional[bool]):
    """diff.fit's graph key: what the JAX fit's jitted step retraces on.
    The splat count and SH width (a densify changes them), the capacity,
    k_max and config, the loss weights (L1, D-SSIM, L2, depth) and flags
    (depth, SH warm-up, pose and exposure refinement, remat), the view
    count and the image shape."""
    return (int(params.means.shape[-1]), None if params.sh is None else int(params.sh.shape[1]),
            capacity, k_max, config, tuple(float(w) for w in loss_weights), bool(use_depth),
            bool(sh_warmup), bool(optimize_cameras), bool(optimize_exposure), n_views,
            tuple(image_shape), remat)


class FitStepGraphs(GraphedStep):
    """diff.fit's step (the JAX fit's ``@jax.jit step``) as GraphedStep's
    two graphs.  Its state: the DiffSplats leaves, the optimizer state,
    the extras (CameraDeltas, Exposure) and their Adam states.  Its inputs,
    refilled before each step: the view's camera (camera_array's floats,
    a device-to-device copy), target and depth target, and the view index
    and SH warm-up degree as 0-d int32 tensors.  B's outputs: the loss,
    the candidate count and the per-splat gradient norms."""

    def __init__(self, config: RenderConfig, capacity: int, k_max: int, *, params, opt_state,
                 tx, extras: dict, extra_state: dict, extra_txs: dict, n_views: int,
                 image_shape, l1_weight: float, ssim_weight: float, l2_weight: float,
                 depth_weight: float, use_depth: bool, sh_bands: Optional[torch.Tensor],
                 remat: Optional[bool], device):
        super().__init__(config, capacity, k_max, 1, device, remat=remat)
        dev = self.dev
        self.tx, self.extra_txs, self.n_views = tx, extra_txs, n_views
        self.image_shape = tuple(image_shape)
        self.weights = (l1_weight, ssim_weight, l2_weight, depth_weight)
        self.use_depth = use_depth
        self.sh_bands = sh_bands
        self._camera = torch.zeros(CAMERA_FLOATS, dtype=torch.float32, device=dev)
        self._camera_views = camera_views(self._camera)
        self._target = torch.zeros(self.image_shape + (3,), dtype=torch.float32, device=dev)
        self._dtarget = (torch.zeros(self.image_shape, dtype=torch.float32, device=dev)
                         if use_depth else None)
        self._idx = torch.zeros((), dtype=torch.int32, device=dev)
        self._sh_active = torch.zeros((), dtype=torch.int32, device=dev)
        self._bind(params=params, opt_state=opt_state, extras=extras, extra_state=extra_state)

    def load(self, params, opt_state) -> None:
        """New parameters and optimizer state (after a densify)."""
        self._bind(params=params, opt_state=opt_state)

    def key(self):
        return fit_step_key(
            self.params, self.config, self.capacity, self.k_max, self.n_views, self.image_shape,
            loss_weights=self.weights, use_depth=self.use_depth,
            sh_warmup=self.sh_bands is not None, optimize_cameras="cam" in self.extras,
            optimize_exposure="exp" in self.extras, remat=self.remat)

    def _state(self) -> list:
        return tree_leaves((self.params, self.opt_state, self.extras, self.extra_state))

    def _rows(self, ex):
        """The view's camera (with its pose correction) and exposure."""
        idx = self._idx.reshape(1)
        cam = self._camera_views
        if "cam" in ex:
            cam = apply_camera_delta(cam, ex["cam"].dr.index_select(0, idx)[0],
                                     ex["cam"].dt.index_select(0, idx)[0])
        gain = bias = None
        if "exp" in ex:
            gain = ex["exp"].gain.index_select(0, idx)[0]
            bias = ex["exp"].bias.index_select(0, idx)[0]
        return cam, gain, bias

    def _structure_cameras(self) -> list:
        return [self._rows(self.extras)[0]]

    def _step_body(self, profiles, effects: bool = True):
        dev, n_views = self.dev, self.n_views
        l1_weight, ssim_weight, l2_weight, depth_weight = self.weights
        p = tree_map(lambda a: a.detach().requires_grad_(True), self.params)
        ex = {k: tree_map(lambda a: a.detach().requires_grad_(True), v)
              for k, v in self.extras.items()}
        cam, gain, bias = self._rows(ex)
        loss, cand = view_loss(
            p, cam, self._target, self.config, self.capacity, self.k_max, l1_weight=l1_weight,
            ssim_weight=ssim_weight, l2_weight=l2_weight, depth_weight=depth_weight,
            depth_target=self._dtarget, gain=gain, bias=bias, remat=self.remat,
            structure=self.structures[0], profile=profiles[0], device=dev)
        grads = loss_grads(loss, tree_leaves(p) + tree_leaves(ex))
        n_p = len(tree_leaves(p))
        with torch.no_grad():
            p = tree_map(torch.detach, p)
            ex = {k: tree_map(torch.detach, v) for k, v in ex.items()}
            gp = tree_unflatten(p, grads[:n_p])
            gex = tree_unflatten(ex, grads[n_p:])
            if self.sh_bands is not None:
                mask = (self.sh_bands <= self._sh_active).to(torch.float32)
                gp = gp._replace(sh=gp.sh * mask[None, :, None])
            gnorm = torch.sqrt(torch.sum(gp.means * gp.means, dim=0))
            updates, opt_state = self.tx.update(gp, self.opt_state, p)
            p = apply_updates(p, updates)
            # Per-view sparsity: only the rendered view's row may move.
            # Without this, Adam's decaying first moment would move every
            # other view's row too.  Other rows keep their value and moments.
            row = (torch.arange(n_views, device=dev) == self._idx).to(torch.float32)

            def active_rows_only(new, old):
                if new.ndim >= 1 and new.shape[0] == n_views:
                    m = row.reshape((n_views,) + (1,) * (new.ndim - 1))
                    return new * m + old * (1.0 - m)
                return new  # scalars (the Adam step count)

            new_ex, new_ex_state = {}, {}
            for name in ex:
                u, st = self.extra_txs[name].update(gex[name], self.extra_state[name], ex[name])
                u = tree_map(lambda a: active_rows_only(a, torch.zeros_like(a)), u)
                new_ex_state[name] = tree_map(active_rows_only, st, self.extra_state[name])
                new_ex[name] = apply_updates(ex[name], u)
            if effects:
                self._commit(tree_leaves((p, opt_state, new_ex, new_ex_state)))
            if not isinstance(loss, torch.Tensor):
                loss = torch.full((), float(loss), dtype=torch.float32, device=dev)
        return loss.detach(), cand, gnorm

    def step(self, camera: torch.Tensor, target: torch.Tensor, depth_target, view: int,
             sh_active: int):
        """One step on view ``view``: the inputs refilled (``camera`` a
        [CAMERA_FLOATS] tensor, ``target`` [H, W, 3], ``depth_target``
        [H, W] or None), S, the profile, B.  Returns B's (loss, candidate
        count, gradient norms), device tensors that the next step
        overwrites."""
        self._camera.copy_(camera)
        self._target.copy_(target)
        if self.use_depth:
            self._dtarget.copy_(depth_target)
        self._idx.fill_(view)
        self._sh_active.fill_(sh_active)
        return self._step(self._step_body)


# ---------------------------------------------------------------------------
# Scene fitting (training loop)
# ---------------------------------------------------------------------------


def fit(
    params: DiffSplats,
    cameras_data,
    targets,
    config: RenderConfig,
    *,
    capacity: int,
    k_max: int,
    steps: int = 200,
    learning_rate: float = 5e-3,
    tx=None,
    l1_weight: float = 0.0,
    ssim_weight: float = 0.0,
    l2_weight: float = 1.0,
    depth_weight: float = 0.0,
    depth_targets=None,
    densify_every: int = 0,
    densify_until: Optional[int] = None,
    densify_args: Optional[dict] = None,
    optimize_cameras: bool = False,
    camera_lr: float = 1e-4,
    optimize_exposure: bool = False,
    exposure_lr: float = 1e-3,
    sh_warmup_every: int = 0,
    remat: Optional[bool] = None,
    checkpoint_every: int = 0,
    checkpoint_path=None,
    start_step: int = 0,
    opt_state=None,
    camera_deltas: Optional[CameraDeltas] = None,
    exposure: Optional[Exposure] = None,
    device=None,
    log_every: int = 0,
    stats: Optional[dict] = None,
):
    """Fit splat parameters to target images by gradient descent on
    ``device`` (default: the card).

    cameras_data: list of Camera.camera_data() dicts, cycled round-robin;
    targets: matching [H, W, >=3] images (uint8, or float in [0, 1]; only
    RGB is fitted).  Every step rebuilds the pair structure for its camera
    (build_structure: K1-K3), renders with autograd, and applies the
    optimizer: ``tx`` (an object with init/update, e.g. tx_3dgs), default
    Adam(learning_rate).

    The options are the JAX package's fit: ``densify_every`` (clone /
    split / prune every that many steps until ``densify_until``, default
    steps // 2, then a fresh optimizer state), ``depth_weight`` with
    ``depth_targets`` (a masked depth L1 term; NaN marks unsupervised
    pixels), ``optimize_cameras`` (per-view CameraDeltas with their own
    Adam at ``camera_lr``), ``optimize_exposure`` (per-view Exposure at
    ``exposure_lr``, applied to the render in the loss only),
    ``sh_warmup_every`` (SH bands above the active degree get no gradient;
    the degree grows by one every that many steps), ``remat`` (see
    rasterize_diff), and checkpoints every ``checkpoint_every`` steps (and
    at the end) to ``checkpoint_path``.  Resume by passing
    load_checkpoint's ``params``, ``step`` (as ``start_step``),
    ``opt_state``, ``camera_deltas`` and ``exposure`` back in; the extras'
    Adam moments are not checkpointed and warm-restart.

    The step is the JAX fit's jitted ``step`` in compiled form
    (FitStepGraphs): on the card two CUDA graphs a step, cached per
    fit_step_key and the block profile, eager on a key's first visit,
    captured on its second, replayed after that; on the CPU eager.  A
    densify that changes the splat count drops the graphs, as the JAX jit
    recompiles.  ``stats``, a dict, receives FitStepGraphs.report().

    Returns (params, losses: np.ndarray [steps]); when enabled, the fitted
    CameraDeltas and then the Exposure append in that order.
    """
    dev = resolve_device(device)
    if tx is None:
        tx = Adam(learning_rate)
    if densify_until is None:
        densify_until = steps // 2
    params = tree_map(lambda a: a.detach().to(dev), params)

    tgts = [target_tensor(t, dev) for t in targets]
    cams = [_camera(c, dev) for c in cameras_data]

    use_depth = depth_weight > 0 and depth_targets is not None
    if use_depth:
        dtgts = [torch.from_numpy(np.asarray(_np(d), np.float32)).to(dev) for d in depth_targets]
        if len(dtgts) != len(cameras_data):
            raise ValueError(f"{len(dtgts)} depth targets for {len(cameras_data)} cameras")

    # Optional per-view parameters ("extras") train alongside the splats,
    # each with its own Adam.  Their moments are not checkpointed (the
    # values are); a resume warm-restarts them.
    n_views = len(cameras_data)
    extras, txs = {}, {}
    if optimize_cameras:
        extras["cam"] = (zero_camera_deltas(n_views, device=dev) if camera_deltas is None
                         else tree_map(lambda a: a.detach().to(dev), camera_deltas))
        txs["cam"] = Adam(camera_lr)
    if optimize_exposure:
        extras["exp"] = (identity_exposure(n_views, device=dev) if exposure is None
                         else tree_map(lambda a: a.detach().to(dev), exposure))
        txs["exp"] = Adam(exposure_lr)
    extra_state = {k: txs[k].init(v) for k, v in extras.items()}

    # SH warm-up: the band of each coefficient (0, 1,1,1, 2, ...), against
    # the active degree, masks the SH gradient.
    use_sh_warmup = sh_warmup_every > 0 and params.sh is not None
    if sh_warmup_every > 0 and params.sh is None:
        warnings.warn(
            "sh_warmup_every set but the model has no SH bands (sh_degree 0) — the "
            "warm-up schedule has nothing to do",
            RuntimeWarning,
        )
    sh_bands = None
    if use_sh_warmup:
        sh_bands = torch.from_numpy(
            np.floor(np.sqrt(np.arange(params.sh.shape[1]))).astype(np.int32)).to(dev)

    if densify_every:
        m = _np(params.means)
        scene_extent = float(np.linalg.norm(m.max(axis=1) - m.min(axis=1))) or 1.0

    if opt_state is None:
        opt_state = tx.init(params)
    else:
        opt_state = tree_map(lambda a: a.to(dev), opt_state)
    # The step, compiled as the JAX fit jits it: CUDA graphs on the card.
    graphs = FitStepGraphs(
        config, capacity, k_max, params=params, opt_state=opt_state, tx=tx, extras=extras,
        extra_state=extra_state, extra_txs=txs, n_views=n_views,
        image_shape=(config.screen_h, config.screen_w), l1_weight=l1_weight,
        ssim_weight=ssim_weight, l2_weight=l2_weight, depth_weight=depth_weight,
        use_depth=use_depth, sh_bands=sh_bands, remat=remat, device=dev)
    cam_rows = torch.stack([camera_flat(c) for c in cams])
    losses = np.zeros(steps, np.float32)
    sat_warned = False
    gacc = torch.zeros(params.means.shape[-1], dtype=torch.float64, device=dev)
    gcnt = 0
    for i in range(start_step, steps):
        f = i % len(cams)
        sh_active = i // sh_warmup_every if use_sh_warmup else 127
        loss, cand, gnorm = graphs.step(cam_rows[f], tgts[f], dtgts[f] if use_depth else None,
                                        f, sh_active)
        losses[i] = float(loss)
        cand = int(cand)
        gacc += gnorm.to(torch.float64)
        gcnt += 1
        if not sat_warned and cand > capacity:
            warnings.warn(
                f"fit step {i}: {cand} candidate pairs exceed the structure capacity "
                f"({capacity}); frames render with a truncated pair list — raise `capacity`.",
                RuntimeWarning,
            )
            sat_warned = True
        if densify_every and i < densify_until and (i + 1) % densify_every == 0:
            n0 = graphs.params.means.shape[-1]
            params = densify_and_prune(
                graphs.params, (gacc / max(1, gcnt)).to(torch.float32),
                scene_extent=scene_extent, seed=i, **(densify_args or {}),
            )
            graphs.load(params, tx.init(params))
            gacc = torch.zeros(params.means.shape[-1], dtype=torch.float64, device=dev)
            gcnt = 0
            if log_every:
                print(f"step {i:5d}  densify: {n0} -> {params.means.shape[-1]} splats",
                      flush=True)
        if checkpoint_every and checkpoint_path and (
                (i + 1) % checkpoint_every == 0 or i == steps - 1):
            save_checkpoint(checkpoint_path, graphs.params, step=i + 1,
                            opt_state=graphs.opt_state, camera_deltas=graphs.extras.get("cam"),
                            exposure=graphs.extras.get("exp"))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i:5d}  loss {losses[i]:.6f}", flush=True)
    if stats is not None:
        stats.update(graphs.report())
    params, extras = graphs.params, graphs.extras
    out = [params, losses]
    if optimize_cameras:
        out.append(extras["cam"])
    if optimize_exposure:
        out.append(extras["exp"])
    return tuple(out)


# ---------------------------------------------------------------------------
# Checkpoints, export and initialization
# ---------------------------------------------------------------------------


def _npz_path(path) -> str:
    """np.savez appends '.npz' to bare paths; normalize up front so save and
    load agree on the file name."""
    p = str(path)
    return p if p.endswith(".npz") else p + ".npz"


def save_checkpoint(
    path,
    params: DiffSplats,
    *,
    step: int = 0,
    opt_state=None,
    camera_deltas: Optional[CameraDeltas] = None,
    exposure: Optional[Exposure] = None,
) -> None:
    """Write a training checkpoint (one .npz, the JAX package's keys): the
    DiffSplats leaves (``p_<field>``), the step, and optionally the
    optimizer state's leaves in tree_leaves order (``o_<i>``), the pose
    corrections (``d_dr``, ``d_dt``) and the exposure (``e_gain``,
    ``e_bias``)."""
    arrs = {"step": np.int64(step)}
    for name in params._fields:
        leaf = getattr(params, name)
        if leaf is not None:
            arrs[f"p_{name}"] = _np(leaf)
    if camera_deltas is not None:
        arrs["d_dr"] = _np(camera_deltas.dr)
        arrs["d_dt"] = _np(camera_deltas.dt)
    if exposure is not None:
        arrs["e_gain"] = _np(exposure.gain)
        arrs["e_bias"] = _np(exposure.bias)
    if opt_state is not None:
        for i, leaf in enumerate(tree_leaves(opt_state)):
            arrs[f"o_{i}"] = _np(leaf)
    np.savez(_npz_path(path), **arrs)


def load_checkpoint(path, *, tx=None, device=None) -> dict:
    """Read a save_checkpoint .npz (either package's) onto ``device``
    (default: the card).  Returns a dict with ``params`` (DiffSplats),
    ``step`` (int), ``camera_deltas`` (CameraDeltas or None), ``exposure``
    (Exposure or None), and, when the matching optimizer is passed as
    ``tx``, ``opt_state`` rebuilt from the stored leaves (None otherwise,
    or if the leaf count does not match)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a)).to(dev)

    with np.load(_npz_path(path)) as z:
        params = DiffSplats(**{
            name: t(z[f"p_{name}"]) for name in DiffSplats._fields if f"p_{name}" in z
        })
        step = int(z["step"])
        deltas = CameraDeltas(dr=t(z["d_dr"]), dt=t(z["d_dt"])) if "d_dr" in z else None
        exp = Exposure(gain=t(z["e_gain"]), bias=t(z["e_bias"])) if "e_gain" in z else None
        opt_state = None
        if tx is not None:
            template = tx.init(params)
            want = len(tree_leaves(template))
            leaves = [t(z[f"o_{i}"]) for i in range(want) if f"o_{i}" in z]
            if len(leaves) == want:
                opt_state = tree_unflatten(template, leaves)
    return dict(params=params, step=step, camera_deltas=deltas, exposure=exp,
                opt_state=opt_state)


def write_fitted_ply(path_or_stream, params: DiffSplats) -> None:
    """Write fitted parameters as a standard raw .ply: DiffSplats already
    IS the raw pre-activation parametrization (log-scales, logit
    opacities, unnormalized quaternions), so this is a field mapping."""
    from .ply import write_gaussian_ply

    q = _np(params.quats)  # [4, N] xyzw -> [N, 4] wxyz
    quats_wxyz = np.stack([q[3], q[0], q[1], q[2]], axis=-1)
    if params.sh is not None:
        sh = _np(params.sh)  # [3, K, N]
        f_dc = sh[:, 0].T
        f_rest = np.transpose(sh[:, 1:], (2, 0, 1)) if sh.shape[1] > 1 else None
    else:
        colors = np.clip(_np(params.colors), 0.0, 1.0)
        f_dc = ((colors - 0.5) / SH_C0).T
        f_rest = None
    write_gaussian_ply(
        path_or_stream, _np(params.means).T, _np(params.log_scales).T, quats_wxyz,
        _np(params.opacity_logits), f_dc, f_rest,
    )


def _splats(means, log_scales, quats, opacity_logits, colors, sh, device) -> DiffSplats:
    """DiffSplats from NumPy arrays, on ``device``."""
    dev = resolve_device(device)

    def t(a):
        return None if a is None else torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return DiffSplats(means=t(means), log_scales=t(log_scales), quats=t(quats),
                      opacity_logits=t(opacity_logits), colors=t(colors), sh=t(sh))


def random_init(
    count: int,
    bounds_min,
    bounds_max,
    *,
    seed: int = 0,
    scale: float = 0.1,
    opacity: float = 0.5,
    sh_degree: int = 0,
    device=None,
) -> DiffSplats:
    """Random initialization inside a world AABB (fitting from scratch);
    the JAX package's draws, on ``device`` (default: the card)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(bounds_min, np.float32)
    hi = np.asarray(bounds_max, np.float32)
    means = rng.uniform(lo, hi, (count, 3)).astype(np.float32).T
    q = rng.normal(size=(4, count)).astype(np.float32)
    op = np.float32(np.log(opacity) - np.log1p(-opacity))
    sh = None
    colors = rng.uniform(0.2, 0.8, (3, count)).astype(np.float32)
    if sh_degree > 0:
        sh = np.zeros((3, num_sh_coeffs(sh_degree), count), np.float32)
        sh[:, 0] = (colors - 0.5) / SH_C0
    return _splats(means, np.full((3, count), np.log(scale), np.float32), q,
                   np.full((count,), op, np.float32), colors, sh, device)


def _knn_mean_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean distance from each point to its ``k`` nearest neighbours
    (exclusive of self): cKDTree when scipy is present, chunked brute
    force otherwise."""
    n = points.shape[0]
    if n <= 1:
        return np.ones(n, np.float32)
    k = min(k, n - 1)
    try:
        from scipy.spatial import cKDTree

        d, _ = cKDTree(points).query(points, k=k + 1, workers=-1)
        return d[:, 1:].mean(axis=1).astype(np.float32)
    except ImportError:  # pragma: no cover - scipy is in the image
        out = np.empty(n, np.float32)
        for s in range(0, n, 4096):
            blk = points[s:s + 4096]
            d2 = ((blk[:, None, :] - points[None, :, :]) ** 2).sum(-1)
            part = np.partition(d2, k, axis=1)[:, 1:k + 1]
            out[s:s + 4096] = np.sqrt(np.maximum(part, 0.0)).mean(axis=1)
        return out


def init_from_points(
    points_xyz: np.ndarray,
    points_rgb: np.ndarray,
    *,
    opacity: float = 0.1,
    sh_degree: int = 0,
    max_points: int = 0,
    seed: int = 0,
    device=None,
) -> DiffSplats:
    """SfM point-cloud initialization, the canonical 3DGS recipe: one
    isotropic splat per point, scale = mean distance to the 3 nearest
    neighbours (floored at 1e-4), opacity 0.1, colour from the point's RGB
    (as the SH DC term when ``sh_degree`` > 0).  ``max_points`` > 0
    subsamples uniformly.  On ``device`` (default: the card)."""
    xyz = np.asarray(points_xyz, np.float32).reshape(-1, 3)
    rgb = np.clip(np.asarray(points_rgb, np.float32).reshape(-1, 3), 0, 1)
    if xyz.shape[0] == 0:
        raise ValueError("empty point cloud")
    if rgb.shape[0] != xyz.shape[0]:
        raise ValueError(f"{xyz.shape[0]} points but {rgb.shape[0]} colors")
    if max_points > 0 and xyz.shape[0] > max_points:
        idx = np.random.default_rng(seed).choice(xyz.shape[0], max_points, replace=False)
        idx.sort()
        xyz, rgb = xyz[idx], rgb[idx]
    n = xyz.shape[0]
    dist = np.maximum(_knn_mean_dist(xyz), 1e-4)
    quats = np.zeros((4, n), np.float32)
    quats[3] = 1.0  # identity in the (x, y, z, w) row order
    op = float(np.clip(opacity, 1e-4, 1.0 - 1e-4))
    op_logit = np.float32(np.log(op) - np.log1p(-op))
    colors = rgb.T.copy()
    sh = None
    if sh_degree > 0:
        sh = np.zeros((3, num_sh_coeffs(sh_degree), n), np.float32)
        sh[:, 0] = (colors - 0.5) / SH_C0
    return _splats(xyz.T, np.broadcast_to(np.log(dist), (3, n)), quats,
                   np.full((n,), op_logit, np.float32), colors, sh, device)
