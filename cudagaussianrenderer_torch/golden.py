"""Golden NumPy renderer — the slow, independent correctness oracle.

The CUDA reference has no automated tests (SURVEY.md §4); its fixtures are
a procedural random scene and visual inspection.  This module supplies the
missing oracle: a dead-simple, loop-based NumPy implementation of the same
rendering semantics — per-splat EWA projection, per-tile exact binning,
(tile, quantized-depth) ordering, front-to-back blending with the
chunk-granular saturation exit — written directly from the math rather
than from the pipeline's tensor code, so the two can disagree.

Everything here favors clarity over speed; use scenes of ~<= 10k splats.

A NumPy copy of the JAX package's oracle, reading the port's own
RenderConfig and quantize module, so the port can check its frames without
importing the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import RenderConfig
from .utils.quantize import decode_quat_xyzw, quat_xyzw_to_rotation_matrix


# ---------------------------------------------------------------------------
# Independent SH oracle: associated-Legendre recurrence in f64, written
# from the real-SH definition — NOT the production polynomial table
# (ops/sh.py), so the two can disagree (the oracle discipline the
# projection/blend code already follows).
# ---------------------------------------------------------------------------


def _assoc_legendre_no_cs(l, m, x):
    """P_l^m(x) without the Condon-Shortley (-1)^m factor."""
    pmm = np.ones_like(x)
    if m > 0:
        somx2 = np.sqrt(np.maximum(0.0, 1.0 - x * x))
        fact = 1.0
        for _ in range(m):
            pmm = pmm * fact * somx2
            fact += 2.0
    if l == m:
        return pmm
    pmmp1 = x * (2 * m + 1) * pmm
    if l == m + 1:
        return pmmp1
    for ll in range(m + 2, l + 1):
        pll = (x * (2 * ll - 1) * pmmp1 - (ll + m - 1) * pmm) / (ll - m)
        pmm, pmmp1 = pmmp1, pll
    return pmmp1


def oracle_sh_basis(dirs, degree):
    """Real SH basis with the y-up 3DGS index order: within degree l the
    m index runs -l..l; phi is measured in the x/y plane from x, theta
    from z (matching sh_gen.py's parametrization)."""
    import math

    x, y, z = dirs[:, 0], dirs[:, 1], dirs[:, 2]
    phi = np.arctan2(y, x)
    out = []
    for l in range(degree + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = np.sqrt(
                (2 * l + 1) / (4 * np.pi)
                * float(math.factorial(l - am)) / float(math.factorial(l + am))
            )
            p = _assoc_legendre_no_cs(l, am, z)
            if m == 0:
                out.append(k * p)
            elif m > 0:
                out.append(np.sqrt(2.0) * k * p * np.cos(am * phi))
            else:
                out.append(np.sqrt(2.0) * k * p * np.sin(am * phi))
    return np.stack(out, axis=-1)


def golden_project(means, scales, quats_packed, camera, config: RenderConfig):
    """Per-splat projection, scalar loop. Returns dict of arrays."""
    n = means.shape[0]
    view = np.asarray(camera["view"], np.float64)
    cot = np.asarray(camera["fov_cotangent"], np.float64)
    dsb = np.asarray(camera["depth_scale_bias"], np.float64)

    out = dict(
        clip_xy=np.zeros((n, 2)), clip_z=np.zeros(n),
        ellipse=np.zeros((n, 4)), conic=np.zeros((n, 3)),
    )
    q = decode_quat_xyzw(np.asarray(quats_packed))
    rots = quat_xyzw_to_rotation_matrix(q)
    bump_x = (1.0 / np.pi) * (2.0 / config.screen_w) ** 2
    bump_y = (1.0 / np.pi) * (2.0 / config.screen_h) ** 2

    for i in range(n):
        r = rots[i]
        s = np.diag(np.asarray(scales[i], np.float64))
        rs = r @ s
        sigma = rs @ rs.T

        vp = view[:3, :3] @ np.asarray(means[i], np.float64) + view[:3, 3]
        vx, vy, vz = vp
        j = np.zeros((3, 3))
        j[0, 0] = -cot[0] / vz
        j[1, 1] = -cot[1] / vz
        j[0, 2] = cot[0] * vx / vz**2
        j[1, 2] = cot[1] * vy / vz**2
        j[2, 2] = dsb[0]
        m = j @ view[:3, :3]
        cov = m @ sigma @ m.T
        a, b, c = cov[0, 0] + bump_x, cov[1, 0], cov[1, 1] + bump_y

        # Affine projection of the center reduces to the plain perspective
        # point: -cot * v / vz for x,y; linear depth for z.
        clip = np.array([
            -cot[0] * vx / vz,
            -cot[1] * vy / vz,
            dsb[0] * vz + dsb[1],
        ])

        det = a * c - b * b
        mid = 0.5 * (a + c)
        radius = np.sqrt(max(config.epsilon, mid * mid - det))
        l0, l1 = mid + radius, max(0.0, mid - radius)
        ev = np.array([b, l0 - a])
        norm = np.linalg.norm(ev)
        if norm < 1e-20:
            ev = np.array([1.0, 0.0])
            norm = 1.0
        cos_t, sin_t = ev / norm
        sf = config.sigma_factor
        e0, e1 = np.sqrt(l0) * sf, np.sqrt(l1) * sf
        inv_det = 1.0 / max(config.epsilon, det)
        conic = np.array([c, -b, a]) * inv_det

        visible = np.all((clip >= -1) & (clip <= 1)) and l1 >= 0
        out["clip_xy"][i] = clip[:2] if visible else (-128.0, -128.0)
        out["clip_z"][i] = clip[2]
        out["ellipse"][i] = (cos_t, sin_t, e0 * visible, e1 * visible)
        out["conic"][i] = conic
    return out


def _ellipse_local(cx, cy, cos_t, sin_t, e0, e1, px, py):
    dx, dy = px - cx, py - cy
    with np.errstate(divide="ignore", invalid="ignore"):
        return (
            (dx * cos_t + dy * sin_t) / e0,
            (dy * cos_t - dx * sin_t) / e1,
        )


def _segment_circle(p0, p1):
    # Zero-extent ellipses (opacity-truncated to nothing) put inf/nan
    # into the unit-circle coordinates; every arithmetic path below
    # yields a non-hit for them, so just silence the invalid-op noise.
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.asarray(p1) - np.asarray(p0)
        ls = float(d @ d)
        t = -(np.asarray(p0) @ d) / ls
        if np.isnan(t):
            t = 0.0
        t = min(1.0, max(0.0, t))
        proj = np.asarray(p0) + t * d
        return bool(proj @ proj < 1.0)


def golden_ellipse_rect_overlap(center, cos_sin, extent, rmin, rmax) -> bool:
    cx, cy = center
    if rmin[0] < cx < rmax[0] and rmin[1] < cy < rmax[1]:
        return True
    args = (cx, cy, cos_sin[0], cos_sin[1], extent[0], extent[1])
    mx, my = (rmin[0] + rmax[0]) / 2, (rmin[1] + rmax[1]) / 2
    lx, ly = _ellipse_local(*args, mx, my)
    if lx * lx + ly * ly < 1.0:
        return True
    corners = [
        _ellipse_local(*args, rmin[0], rmin[1]),
        _ellipse_local(*args, rmax[0], rmin[1]),
        _ellipse_local(*args, rmax[0], rmax[1]),
        _ellipse_local(*args, rmin[0], rmax[1]),
    ]
    for k in range(4):
        if _segment_circle(corners[k], corners[(k + 1) % 4]):
            return True
    return False


def golden_render(
    scene_numpy: dict,
    camera: dict,
    config: RenderConfig,
    *,
    depth_bits: Optional[int] = None,
) -> np.ndarray:
    """Render a scene dict of numpy arrays.  Returns [H, W, 4] uint8.

    scene_numpy keys: means [N,3], scales [N,3], quats (packed uint32 [N]),
    opacities [N], colors [N,3], optionally sh [N,K,3] + sh_degree.
    """
    means = scene_numpy["means"]
    n = means.shape[0]
    sh_degree = int(scene_numpy.get("sh_degree", 0))
    if sh_degree > 0 and scene_numpy.get("sh") is not None:
        d = np.asarray(camera["position"])[None, :] - means
        d = d / np.linalg.norm(d, axis=1, keepdims=True)
        basis = oracle_sh_basis(d.astype(np.float64), sh_degree)
        k = (sh_degree + 1) ** 2
        colors = np.einsum("nk,nkc->nc", basis, scene_numpy["sh"][:, :k])
        colors = np.clip(colors + 0.5, 0.0, 1.0)
    else:
        colors = scene_numpy["colors"]
    opac = scene_numpy["opacities"]

    proj = golden_project(
        means, scene_numpy["scales"], scene_numpy["quats"], camera, config
    )

    ntx, nty = config.tiles_x, config.tiles_y
    ts = config.tile_size
    w, h = config.screen_w, config.screen_h
    if depth_bits is None:
        depth_bits = config.depth_bits if config.depth_bits <= 24 else 24
    dmax = float(2**depth_bits - 1)

    # Bin: per splat, AABB in tile space then exact test per candidate.
    # Under config.center_sampled_runs (the default) the per-tile test
    # uses the tile's PIXEL-CENTER span ([16t, 16t+15] px per axis —
    # pixels sample at integer coordinates) instead of the full rect,
    # mirroring ops.binning.splat_row_packs: tiles the ellipse grazes
    # only in the pixel-free trailing sliver are never binned.
    tile_lists = [[] for _ in range(ntx * nty)]
    tile_clip_w = 2.0 * ts / w
    tile_clip_h = 2.0 * ts / h
    span_f = 15.0 / 16.0 if getattr(config, "center_sampled_runs", True) else 1.0
    # Opacity-aware extent truncation for BINNING, mirroring
    # ops.projection (the conic — and so the blend density below — is
    # untouched).  golden_project returns untruncated extents; without
    # this mirror the center-sampled tile test can disagree with the
    # production pipeline on grazing tiles of low-opacity splats.
    if config.opacity_aware_extents:
        a255 = 255.0 * np.asarray(opac, np.float64)
        if config.falloff == "gaussian":
            dxc = 2.0 * np.log(np.maximum(a255, 1e-12))
            trunc = np.sqrt(np.clip(dxc, 0.0, 9.0)) / 3.0
        else:
            trunc = np.sqrt(
                np.clip(1.0 - 1.0 / np.maximum(a255, 1e-12), 0.0, 1.0)
            )
    else:
        trunc = np.ones(n)

    for i in range(n):
        cx, cy = proj["clip_xy"][i]
        cos_t, sin_t, e0, e1 = proj["ellipse"][i]
        e0, e1 = e0 * trunc[i], e1 * trunc[i]
        hx = abs(cos_t * e0) + abs(sin_t * e1)
        hy = abs(sin_t * e0) + abs(cos_t * e1)
        fx0 = (cx - hx + 1) * 0.5 * ntx
        fy0 = (cy - hy + 1) * 0.5 * nty
        fx1 = (cx + hx + 1) * 0.5 * ntx
        fy1 = (cy + hy + 1) * 0.5 * nty
        x0 = min(max(int(np.floor(fx0)), 0), ntx)
        y0 = min(max(int(np.floor(fy0)), 0), nty)
        x1 = min(max(int(np.ceil(fx1)), 0), ntx)
        y1 = min(max(int(np.ceil(fy1)), 0), nty)
        q = np.uint32(min(max((proj["clip_z"][i] + 1) * 0.5, 0.0), 1.0) * dmax)
        for gy in range(y0, y1):
            for gx in range(x0, x1):
                rmin = (gx * tile_clip_w - 1, gy * tile_clip_h - 1)
                rmax = (
                    rmin[0] + span_f * tile_clip_w,
                    rmin[1] + span_f * tile_clip_h,
                )
                if golden_ellipse_rect_overlap(
                    (cx, cy), (cos_t, sin_t), (e0, e1), rmin, rmax
                ):
                    tile_lists[gy * ntx + gx].append((int(q), i))

    img = np.zeros((h, w, 4), np.float64)
    bg = None if config.background is None else np.asarray(config.background)
    if bg is not None:
        # Empty tiles show the opaque background instead of the clear.
        img[..., :3] = bg
        img[..., 3] = 1.0
    gauss = config.falloff == "gaussian"
    for t, entries in enumerate(tile_lists):
        if not entries:
            continue
        entries.sort(key=lambda e: (e[0], e[1]))
        ty, tx = divmod(t, ntx)
        px = (tx * ts + np.arange(ts))[None, :] * (2.0 / w) - 1.0
        py = (ty * ts + np.arange(ts))[:, None] * (2.0 / h) - 1.0
        color = np.zeros((ts, ts, 3))
        trans = np.ones((ts, ts))
        chunk = config.raster_chunk
        for c0 in range(0, len(entries), chunk):
            for _, i in entries[c0 : c0 + chunk]:
                dx = px - proj["clip_xy"][i][0]
                dy = py - proj["clip_xy"][i][1]
                ca, cb, cc = proj["conic"][i]
                dpow = ca * dx * dx + cc * dy * dy + 2 * cb * dx * dy
                density = np.exp(-0.5 * dpow) if gauss else 1.0 - dpow / 7.0
                alpha = opac[i] * np.clip(density, 0.0, 1.0)
                color += colors[i][None, None, :] * trans[..., None] * alpha[..., None]
                trans *= 1.0 - alpha
            if np.all(trans <= config.transmittance_eps):
                break
        if bg is not None:
            color = color + trans[..., None] * bg
        img[ty * ts : (ty + 1) * ts, tx * ts : (tx + 1) * ts, :3] = color
        img[ty * ts : (ty + 1) * ts, tx * ts : (tx + 1) * ts, 3] = 1.0

    return (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)


def scene_to_numpy(scene) -> dict:
    """Back to splat-major [N, ...] numpy shapes for the loop-based oracle
    (quats as the packed uint32 words)."""
    n = scene.count

    def host(t):
        return t.detach().cpu().numpy()

    return dict(
        means=host(scene.means).T[:n],
        scales=host(scene.scales).T[:n],
        quats=host(scene.quats).view(np.uint32)[:n],
        opacities=host(scene.opacities)[:n],
        colors=host(scene.colors).T[:n],
        sh=None
        if scene.sh is None
        else np.transpose(host(scene.sh), (2, 1, 0))[:n],
        sh_degree=scene.sh_degree,
    )
