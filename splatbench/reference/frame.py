"""Plain reference of one frame of a Gaussian-splat scene.

Written from the rendering's mathematics in plain PyTorch, in blocks so
that a scene of millions of splats fits on one card, and independent of
the program under test: it imports nothing of it and works out again
everything a frame derives from the scene's arrays and the pose.

  * the view rows from the pose's position and look-at target (the
    camera looks down its local -Z axis, y up);
  * each splat's colour from its spherical-harmonics coefficients, the
    real basis built from associated Legendre functions (no
    Condon-Shortley phase), clamped to [0, 1] after a +0.5 offset;
  * the EWA projection: world covariance R S S^T R^T from the 8-bit
    packed rotation (not re-normalised), the perspective Jacobian at the
    splat's centre, an anti-aliasing bump of (1/pi)(2/screen)^2 a clip
    axis, the 3-sigma confidence ellipse cut to where opacity x density
    reaches 1/255, the conic as the inverse covariance, and a cull of
    splats whose centre lies outside the clip cube or whose opacity is 0;
  * the tile lists: a tile takes a splat where the ellipse meets the span
    of the tile's pixel centres (pixels sample at clip = px * 2 / W - 1);
  * the order: tile, then depth quantised to ``depth_bits`` bits, then
    splat index;
  * the blend: front to back, alpha = opacity * exp(-q / 2), and a tile
    stops after a chunk of ``chunk`` positions of the sorted list (chunks
    aligned to multiples of ``chunk``) once every pixel's transmittance is
    at most ``eps``; the image is the truncated colour x 255, with alpha
    255 on every tile that holds a pair.

Every floating-point step runs in ``dtype``: float64 for the reference,
a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch

# Splats a block of the per-splat stages, candidate tiles a block of the
# tile test, and tiles a block of the blend.
SPLAT_BLOCK = 1 << 20
CANDIDATE_BLOCK = 1 << 23
TILE_BLOCK = 1024
# Opacity floor of the 8-bit output that cuts a splat's ellipse.
OUTPUT_FLOOR = 255.0


class Frame(NamedTuple):
    image: torch.Tensor        # [H, W, 4] uint8
    pairs: int                 # (tile, splat) pairs in the lists
    pairs_blended: int         # pairs blended before each tile stopped
    tiles: int


def view_rows(position, target, dtype, device):
    """World -> view rotation rows (right, up, back) and the position."""
    p = torch.as_tensor(position, dtype=torch.float64)
    back = p - torch.as_tensor(target, dtype=torch.float64)
    back = back / back.norm()
    right = torch.linalg.cross(torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64), back)
    right = right / right.norm()
    up = torch.linalg.cross(back, right)
    rows = torch.stack([right, up, back])
    return rows.to(dtype=dtype, device=device), p.to(dtype=dtype, device=device)


def _legendre(l, m, x):
    """P_l^m(x) without the Condon-Shortley phase."""
    pmm = torch.ones_like(x)
    if m > 0:
        somx2 = torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))
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


def sh_basis(x, y, z, degree):
    """[(degree + 1)^2, N] real SH basis of unit directions, m = -l..l
    within degree l; phi from x in the x/y plane, theta from z."""
    phi = torch.atan2(y, x)
    out = []
    for l in range(degree + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            k = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            p = _legendre(l, am, z)
            if m == 0:
                out.append(k * p)
            elif m > 0:
                out.append(math.sqrt(2.0) * k * p * torch.cos(am * phi))
            else:
                out.append(math.sqrt(2.0) * k * p * torch.sin(am * phi))
    return torch.stack(out)


def rotation(packed):
    """[N, 3, 3] rotation of the packed 8-bit (x, y, z, w) words, as
    decoded, not re-normalised."""
    words = packed.to(torch.int64) & 0xFFFFFFFF
    q = [((words >> s) & 0xFF).to(torch.float64) / 255.0 * 2.0 - 1.0 for s in (24, 16, 8, 0)]
    x, y, z, w = q
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], -1)
    return r.view(-1, 3, 3)


def splat_stage(scene, pose, screen, dtype):
    """Per splat, in blocks: colour, clip centre and depth, ellipse cut for
    the tile lists, conic, opacity, visibility.  Returns a dict of [N]
    tensors (colour [3, N]) in ``dtype``."""
    dev = scene["means"].device
    w, h = screen["width"], screen["height"]
    rows, pos = view_rows(pose["position"], pose["target"], dtype, dev)
    cot_y = 1.0 / math.tan(pose["fov_y"] * 0.5)
    cot_x = cot_y / pose["aspect"]
    near, far = pose["near"], pose["far"]
    d_scale, d_bias = -2.0 / (far - near), -(far + near) / (far - near)
    bump = torch.tensor([(2.0 / w) ** 2 / math.pi, (2.0 / h) ** 2 / math.pi], dtype=dtype,
                        device=dev)
    n = scene["means"].shape[1]
    degree = scene["sh_degree"]
    parts = []
    for lo in range(0, n, SPLAT_BLOCK):
        sl = slice(lo, min(n, lo + SPLAT_BLOCK))
        m = scene["means"][:, sl].to(dtype)
        opac = scene["opacities"][sl].to(dtype)
        # Colour: the basis at the direction from the splat to the camera.
        d = pos[:, None] - m
        d = d / torch.sqrt((d * d).sum(0))
        basis = sh_basis(d[0], d[1], d[2], degree)
        k = (degree + 1) ** 2
        rgb = torch.einsum("kn,ckn->cn", basis, scene["sh"][:, :k, sl].to(dtype))
        rgb = torch.clamp(rgb + 0.5, 0.0, 1.0)
        # View-space centre, clip centre and linear depth.
        v = rows @ (m - pos[:, None])
        vx, vy, vz = v[0], v[1], v[2]
        cx, cy = -cot_x * vx / vz, -cot_y * vy / vz
        z = d_scale * vz + d_bias
        # Covariance in clip space: J V Sigma V^T J^T plus the bump.
        r = rotation(scene["quats"][sl]).to(dtype)
        s2 = scene["scales"][:, sl].to(dtype).T ** 2
        sigma = (r * s2[:, None, :]) @ r.transpose(1, 2)
        jac = torch.zeros((m.shape[1], 2, 3), dtype=dtype, device=dev)
        jac[:, 0, 0] = -cot_x / vz
        jac[:, 1, 1] = -cot_y / vz
        jac[:, 0, 2] = cot_x * vx / (vz * vz)
        jac[:, 1, 2] = cot_y * vy / (vz * vz)
        t = jac @ rows
        cov = t @ sigma @ t.transpose(1, 2)
        a = cov[:, 0, 0] + bump[0]
        b = cov[:, 0, 1]
        c = cov[:, 1, 1] + bump[1]
        det = a * c - b * b
        mid = 0.5 * (a + c)
        rad = torch.sqrt(torch.clamp(mid * mid - det, min=1e-12))
        l0, l1 = mid + rad, torch.clamp(mid - rad, min=0.0)
        ex, ey = b, l0 - a
        norm = torch.sqrt(ex * ex + ey * ey)
        flat = norm < 1e-20
        cos_t = torch.where(flat, 1.0, ex / torch.where(flat, 1.0, norm))
        sin_t = torch.where(flat, 0.0, ey / torch.where(flat, 1.0, norm))
        # 3 sigma, cut to where opacity * density reaches the output floor.
        cut = torch.sqrt(torch.clamp(2.0 * torch.log(torch.clamp(OUTPUT_FLOOR * opac, min=1e-12)),
                                     0.0, 9.0)) / 3.0
        e0 = 3.0 * torch.sqrt(l0) * cut
        e1 = 3.0 * torch.sqrt(l1) * cut
        inv = 1.0 / torch.clamp(det, min=1e-12)
        inside = ((cx.abs() <= 1.0) & (cy.abs() <= 1.0) & (z.abs() <= 1.0) & (opac > 0.0)
                  & torch.isfinite(e0) & torch.isfinite(e1))
        parts.append(dict(cx=cx, cy=cy, z=z, cos=cos_t, sin=sin_t, e0=e0, e1=e1,
                          ca=c * inv, cb=-b * inv, cc=a * inv, opac=opac, rgb=rgb,
                          visible=inside))
    return {k: torch.cat([p[k] for p in parts], -1) for k in parts[0]}


def _local(sp, px, py):
    """A clip point in a splat's unit-circle frame."""
    dx, dy = px - sp["cx"], py - sp["cy"]
    return ((dx * sp["cos"] + dy * sp["sin"]) / sp["e0"],
            (dy * sp["cos"] - dx * sp["sin"]) / sp["e1"])


def _edge_hits(p0, p1):
    """Whether the segment p0-p1 enters the unit circle."""
    dx, dy = p1[0] - p0[0], p1[1] - p0[1]
    t = torch.clamp(-(p0[0] * dx + p0[1] * dy) / (dx * dx + dy * dy), 0.0, 1.0)
    t = torch.nan_to_num(t, nan=0.0)
    qx, qy = p0[0] + t * dx, p0[1] + t * dy
    return qx * qx + qy * qy < 1.0


def ellipse_meets_rect(sp, x0, y0, x1, y1):
    """Exact test of an oriented ellipse against an axis-aligned rect:
    centre in the rect, the rect's centre in the ellipse, or an edge
    entering the ellipse."""
    hit = (sp["cx"] > x0) & (sp["cx"] < x1) & (sp["cy"] > y0) & (sp["cy"] < y1)
    mx, my = _local(sp, 0.5 * (x0 + x1), 0.5 * (y0 + y1))
    hit |= mx * mx + my * my < 1.0
    corners = [_local(sp, x0, y0), _local(sp, x1, y0), _local(sp, x1, y1), _local(sp, x0, y1)]
    for i in range(4):
        hit |= _edge_hits(corners[i], corners[(i + 1) % 4])
    return hit


def tile_pairs(sp, screen, dtype):
    """(tile, splat) pairs of every visible splat, in splat order:
    [P] int64 tile ids and splat indices."""
    dev = sp["cx"].device
    ts = screen["tile"]
    tx, ty = screen["width"] // ts, screen["height"] // ts
    vis = torch.nonzero(sp["visible"]).flatten()
    s = {k: sp[k][vis] for k in ("cx", "cy", "cos", "sin", "e0", "e1")}
    hx = (s["cos"] * s["e0"]).abs() + (s["sin"] * s["e1"]).abs()
    hy = (s["sin"] * s["e0"]).abs() + (s["cos"] * s["e1"]).abs()
    gx0 = torch.clamp(torch.floor((s["cx"] - hx + 1.0) * 0.5 * tx), 0, tx).to(torch.int64)
    gx1 = torch.clamp(torch.ceil((s["cx"] + hx + 1.0) * 0.5 * tx), 0, tx).to(torch.int64)
    gy0 = torch.clamp(torch.floor((s["cy"] - hy + 1.0) * 0.5 * ty), 0, ty).to(torch.int64)
    gy1 = torch.clamp(torch.ceil((s["cy"] + hy + 1.0) * 0.5 * ty), 0, ty).to(torch.int64)
    wid = torch.clamp(gx1 - gx0, min=0)
    cand = wid * torch.clamp(gy1 - gy0, min=0)
    ends = torch.cumsum(cand, 0)
    tile_w, tile_h = 2.0 * ts / screen["width"], 2.0 * ts / screen["height"]
    span = (ts - 1.0) / ts
    tiles, splats = [], []
    lo = 0
    while lo < vis.numel():
        base = int(ends[lo - 1]) if lo else 0
        hi = int(torch.searchsorted(ends, base + CANDIDATE_BLOCK, right=True))
        hi = max(hi, lo + 1)
        owner = torch.repeat_interleave(torch.arange(lo, hi, device=dev), cand[lo:hi])
        j = torch.arange(owner.numel(), device=dev) - (torch.cumsum(cand[lo:hi], 0) - cand[lo:hi]
                                                       ).repeat_interleave(cand[lo:hi])
        gx = gx0[owner] + j % wid[owner]
        gy = gy0[owner] + j // wid[owner]
        rx0 = gx.to(dtype) * tile_w - 1.0
        ry0 = gy.to(dtype) * tile_h - 1.0
        sub = {k: v[owner] for k, v in s.items()}
        keep = ellipse_meets_rect(sub, rx0, ry0, rx0 + span * tile_w, ry0 + span * tile_h)
        tiles.append((gy * tx + gx)[keep])
        splats.append(vis[owner[keep]])
        lo = hi
    if not tiles:
        empty = torch.zeros(0, dtype=torch.int64, device=dev)
        return empty, empty
    return torch.cat(tiles), torch.cat(splats)


def blend(sp, tile, splat, screen, chunk, eps, dtype):
    """Front-to-back blend of each tile's sorted list with the chunked
    early exit.  Returns ([T, ts * ts, 3] colour, pairs blended)."""
    dev = tile.device
    ts = screen["tile"]
    tx, ty = screen["width"] // ts, screen["height"] // ts
    nt, npix = tx * ty, ts * ts
    counts = torch.bincount(tile, minlength=nt)
    starts = torch.cumsum(counts, 0) - counts
    ends = starts + counts
    astart = starts // chunk * chunk
    nchunks = torch.where(counts > 0, (ends - astart + chunk - 1) // chunk, 0)
    attrs = torch.stack([sp[k][splat] for k in ("cx", "cy", "ca", "cb", "cc", "opac")]
                        + [sp["rgb"][i][splat] for i in range(3)])          # [9, P]
    npairs = tile.numel()
    pix = torch.arange(npix, device=dev)
    t_all = torch.arange(nt, device=dev)
    px_all = ((t_all % tx)[:, None] * ts + pix % ts).to(dtype) * (2.0 / screen["width"]) - 1.0
    py_all = ((t_all // tx)[:, None] * ts + pix // ts).to(dtype) * (2.0 / screen["height"]) - 1.0
    color = torch.zeros((nt, npix, 3), dtype=dtype, device=dev)
    trans = torch.ones((nt, npix), dtype=dtype, device=dev)
    active = nchunks > 0
    k = torch.arange(chunk, device=dev)
    blended = 0
    c = 0
    while True:
        run = torch.nonzero(active & (c < nchunks)).flatten()
        if run.numel() == 0:
            break
        for lo in range(0, run.numel(), TILE_BLOCK):
            idx = run[lo:lo + TILE_BLOCK]
            pos = astart[idx, None] + c * chunk + k                          # [B, chunk]
            inseg = (pos >= starts[idx, None]) & (pos < ends[idx, None])
            blended += int(inseg.sum())
            a = attrs[:, torch.clamp(pos, max=max(npairs - 1, 0))]           # [9, B, chunk]
            dx = px_all[idx][:, None, :] - a[0][..., None]                  # [B, chunk, npix]
            dy = py_all[idx][:, None, :] - a[1][..., None]
            q = a[2][..., None] * dx * dx + 2.0 * a[3][..., None] * dx * dy \
                + a[4][..., None] * dy * dy
            alpha = a[5][..., None] * torch.clamp(torch.exp(-0.5 * q), 0.0, 1.0)
            alpha = torch.where(inseg[..., None], alpha, torch.zeros((), dtype=dtype, device=dev))
            keep = torch.cumprod(1.0 - alpha, 1)                             # T after each pair
            before = torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], 1)
            t0 = trans[idx]
            weight = t0[:, None, :] * before * alpha                          # [B, chunk, npix]
            color[idx] += torch.einsum("bkp,cbk->bpc", weight, a[6:9])
            t1 = t0 * keep[:, -1]
            trans[idx] = t1
            active[idx] = (t1 > eps).any(1)
        c += 1
    return color, counts, blended


def render(scene: Dict, pose: Dict, screen: Dict, *, dtype=torch.float64,
           depth_bits: int = 19, chunk: int = 128, eps: float = 0.02) -> Frame:
    """One frame of ``scene`` (the benchmark's arrays: ``means``,
    ``scales`` [3, N] float32, ``quats`` [N] int32 packed words,
    ``opacities`` [N], ``sh`` [3, K, N], ``sh_degree``) from ``pose``
    (``position``, ``target``, ``fov_y``, ``aspect``, ``near``, ``far``)
    on ``screen`` (``width``, ``height``, ``tile``)."""
    sp = splat_stage(scene, pose, screen, dtype)
    tile, splat = tile_pairs(sp, screen, dtype)
    dmax = float(2 ** depth_bits - 1)
    qdepth = (torch.clamp((sp["z"][splat] + 1.0) * 0.5, 0.0, 1.0) * dmax).to(torch.int64)
    order = torch.sort(tile * (1 << depth_bits) + qdepth, stable=True).indices
    tile, splat = tile[order], splat[order]
    color, counts, blended = blend(sp, tile, splat, screen, chunk, eps, dtype)
    ts = screen["tile"]
    tx, ty = screen["width"] // ts, screen["height"] // ts
    rgb = (torch.clamp(color, 0.0, 1.0) * 255.0).to(torch.uint8)
    alpha = torch.where(counts > 0, 255, 0).to(torch.uint8)[:, None, None].expand(-1, ts * ts, 1)
    img = torch.cat([rgb, alpha], -1).view(ty, tx, ts, ts, 4).permute(0, 2, 1, 3, 4)
    return Frame(image=img.reshape(ty * ts, tx * ts, 4), pairs=int(tile.numel()),
                 pairs_blended=blended, tiles=tx * ty)
