"""Per-splat EWA projection — clip-space position, confidence ellipse, conic.

Stage B of the frame pipeline (evaluateSplatClipDataKernel,
GaussianRender.cu:203-348), written as elementwise torch over planar [N]
vectors.  The linear algebra is expanded component-wise in the same
operation order as the JAX package, so the two agree to float32
rounding.

Math summary (the epsilons, the lambda clamps and the anti-shrink trace
bump are load-bearing for tiny splats):
  - world covariance Sigma = R S S^T R^T with R from the 8-bit-quantized
    quaternion (not re-normalized) and S = diag(scales);
  - para-perspective affine projection: the EWA Jacobian of the perspective
    map linearized at the splat's view-space center, with a *linear*
    depth for sort precision;
  - clip 2x2 covariance + trace bump (1/pi)*(2/screen)^2 so distant splats
    cover at least ~a texel;
  - eigenvalues via det/trace closed form -> oriented confidence ellipse
    (extent = sigma_factor * sqrt(lambda)), conic = inverse covariance;
  - branchless frustum cull: out-of-frustum splats get center (-128, -128)
    and zero extent so downstream binning sees zero candidate tiles.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import RenderConfig
from ..utils.quantize import decode_quat_components
from .geometry import clip


class SplatClipData(NamedTuple):
    """SoA outputs of the projection stage (GaussianRender.cu:324-327),
    all planar [N] float32 tensors."""

    cx: torch.Tensor      # clip-space center x (or -128 if culled)
    cy: torch.Tensor      # clip-space center y
    z: torch.Tensor       # linear clip depth in [-1, 1]
    cos_t: torch.Tensor   # ellipse principal-axis direction
    sin_t: torch.Tensor
    e0: torch.Tensor      # ellipse extents (0 if culled)
    e1: torch.Tensor
    con_a: torch.Tensor   # conic (inverse 2x2 covariance)
    con_b: torch.Tensor
    con_c: torch.Tensor

    # Stacked views, as the JAX package's, for tests and tools (not for the
    # hot path).
    @property
    def clip_xy(self):
        return torch.stack([self.cx, self.cy], dim=-1)

    @property
    def clip_z(self):
        return self.z

    @property
    def ellipse(self):
        return torch.stack([self.cos_t, self.sin_t, self.e0, self.e1], dim=-1)

    @property
    def conic(self):
        return torch.stack([self.con_a, self.con_b, self.con_c], dim=-1)


def project_splats(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats_packed: torch.Tensor,
    camera: dict,
    config: RenderConfig,
    opacities: torch.Tensor = None,
    quat_components=None,
) -> SplatClipData:
    """Project splats into clip space.

    means, scales: planar [3, N] rows.  quats_packed: [N] int32 bit
    patterns of the packed uint32 rotations.  ``camera`` is the camera
    dict as tensors on the device (render.camera_tensors): view [4,4],
    position [3], fov_cotangent [2], depth_scale_bias [2].

    ``opacities`` ([N], optional) enables opacity-aware extent
    truncation when config.opacity_aware_extents is set, and culls
    opacity-0 splats.  ``quat_components`` ((qx, qy, qz, qw) [N] float
    rows, optional) bypasses the 8-bit packed-quaternion decode; when
    given, ``quats_packed`` is ignored (pass None).
    """
    eps = config.epsilon
    view = camera["view"]
    fov_cot = camera["fov_cotangent"]
    depth_sb = camera["depth_scale_bias"]

    mx, my, mz = means[0], means[1], means[2]
    sx2, sy2, sz2 = scales[0] ** 2, scales[1] ** 2, scales[2] ** 2

    # --- rotation matrix from the quantized quaternion (cu:209-224) ---
    if quat_components is not None:
        qx, qy, qz, qw = quat_components
    else:
        qx, qy, qz, qw = decode_quat_components(quats_packed)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)

    # --- world covariance Sigma = R diag(s^2) R^T, 6 unique entries ---
    a00 = r00 * r00 * sx2 + r01 * r01 * sy2 + r02 * r02 * sz2
    a11 = r10 * r10 * sx2 + r11 * r11 * sy2 + r12 * r12 * sz2
    a22 = r20 * r20 * sx2 + r21 * r21 * sy2 + r22 * r22 * sz2
    a01 = r00 * r10 * sx2 + r01 * r11 * sy2 + r02 * r12 * sz2
    a02 = r00 * r20 * sx2 + r01 * r21 * sy2 + r02 * r22 * sz2
    a12 = r10 * r20 * sx2 + r11 * r21 * sy2 + r12 * r22 * sz2

    # --- view-space center (cu:227) ---
    v = view
    vx = v[0, 0] * mx + v[0, 1] * my + v[0, 2] * mz + v[0, 3]
    vy = v[1, 0] * mx + v[1, 1] * my + v[1, 2] * mz + v[1, 3]
    vz = v[2, 0] * mx + v[2, 1] * my + v[2, 2] * mz + v[2, 3]

    # --- para-perspective Jacobian terms (cu:234-259) ---
    z_rcp = 1.0 / vz
    z_rcp_sqr = z_rcp * z_rcp
    scale_x = -fov_cot[0] * z_rcp
    scale_y = -fov_cot[1] * z_rcp
    shear_x = fov_cot[0] * vx * z_rcp_sqr
    shear_y = fov_cot[1] * vy * z_rcp_sqr

    # Rows of (J @ view3x3); only the two rows feeding the 2x2 covariance.
    x0 = scale_x * v[0, 0] + shear_x * v[2, 0]
    x1 = scale_x * v[0, 1] + shear_x * v[2, 1]
    x2 = scale_x * v[0, 2] + shear_x * v[2, 2]
    y0 = scale_y * v[1, 0] + shear_y * v[2, 0]
    y1 = scale_y * v[1, 1] + shear_y * v[2, 1]
    y2 = scale_y * v[1, 2] + shear_y * v[2, 2]

    # cov2d = row Sigma row^T expanded over the 6 unique Sigma entries.
    cov_a = (
        a00 * x0 * x0 + a11 * x1 * x1 + a22 * x2 * x2
        + 2.0 * (a01 * x0 * x1 + a02 * x0 * x2 + a12 * x1 * x2)
    )
    cov_c = (
        a00 * y0 * y0 + a11 * y1 * y1 + a22 * y2 * y2
        + 2.0 * (a01 * y0 * y1 + a02 * y0 * y2 + a12 * y1 * y2)
    )
    cov_b = (
        a00 * x0 * y0 + a11 * x1 * y1 + a22 * x2 * y2
        + a01 * (x0 * y1 + x1 * y0)
        + a02 * (x0 * y2 + x2 * y0)
        + a12 * (x1 * y2 + x2 * y1)
    )

    # Anti-shrink trace bump: (1/pi) * (2/screen)^2 (cu:267-276), per axis.
    texel_x = 2.0 / float(config.screen_w)
    texel_y = 2.0 / float(config.screen_h)
    cov_a = cov_a + (1.0 / math.pi) * texel_x * texel_x
    cov_c = cov_c + (1.0 / math.pi) * texel_y * texel_y

    # --- clip-space center (cu:265): the perspective point -cot * v / vz ---
    clip_x = scale_x * vx
    clip_y = scale_y * vy
    clip_z = depth_sb[0] * vz + depth_sb[1]

    # --- closed-form 2x2 eigendecomposition (cu:279-292) ---
    det = cov_a * cov_c - cov_b * cov_b
    mid = 0.5 * (cov_a + cov_c)
    radius = torch.sqrt(clip(mid * mid - det, eps))
    lambda0 = mid + radius
    lambda1 = clip(mid - radius, 0.0)

    # Principal eigenvector; the degenerate (already axis-aligned) case
    # falls back to (1, 0).  The minor axis is the clip-space
    # perpendicular (sin, -cos) (GaussianRender.cuh:48-52).
    ev_x, ev_y = cov_b, lambda0 - cov_a
    ev_norm = torch.sqrt(ev_x * ev_x + ev_y * ev_y)
    degenerate = ev_norm < 1e-20
    ev_x = torch.where(degenerate, 1.0, ev_x)
    ev_y = torch.where(degenerate, 0.0, ev_y)
    ev_norm = torch.where(degenerate, 1.0, ev_norm)
    cos_t = ev_x / ev_norm
    sin_t = ev_y / ev_norm

    # Confidence ellipse (cu:295-302).
    sf = config.sigma_factor
    ext0 = torch.sqrt(lambda0) * sf
    ext1 = torch.sqrt(lambda1) * sf

    if opacities is not None and config.opacity_aware_extents:
        # Truncate the support to where alpha * density crosses the 8-bit
        # output floor 1/255 (binning only; the conic is untouched).
        a255 = 255.0 * opacities
        if config.falloff == "gaussian":
            dxc = 2.0 * torch.log(clip(a255, 1e-12))
            trunc = torch.sqrt(clip(dxc, 0.0, 9.0)) * (1.0 / 3.0)
        else:
            trunc = torch.sqrt(clip(1.0 - 1.0 / clip(a255, 1e-12), 0.0, 1.0))
        ext0 = ext0 * trunc
        ext1 = ext1 * trunc

    # Conic = inverse 2x2 covariance (cu:305-307).
    inv_det = 1.0 / clip(det, eps)
    conic_a = cov_c * inv_det
    conic_b = -cov_b * inv_det
    conic_c = cov_a * inv_det

    # --- branchless frustum cull (cu:314-321) ---
    inside = (
        (clip_x >= -1.0) & (clip_x <= 1.0)
        & (clip_y >= -1.0) & (clip_y <= 1.0)
        & (clip_z >= -1.0) & (clip_z <= 1.0)
    )
    visible = inside & (lambda1 >= 0.0)
    if opacities is not None:
        # alpha == 0 contributes nothing to any pixel: cull outright, so
        # inert scene-padding splats (GaussianScene.pad_to) emit no pairs.
        visible = visible & (opacities > 0.0)
    visf = visible.to(clip_x.dtype)

    return SplatClipData(
        cx=torch.where(visible, clip_x, -128.0),
        cy=torch.where(visible, clip_y, -128.0),
        z=clip_z,
        cos_t=cos_t,
        sin_t=sin_t,
        e0=ext0 * visf,
        e1=ext1 * visf,
        con_a=conic_a,
        con_b=conic_b,
        con_c=conic_c,
    )
