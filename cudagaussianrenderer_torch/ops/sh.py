"""Real spherical-harmonics evaluation, degrees 0-4 — stage A.

The reference evaluates a generated polynomial per splat on the GPU
(GaussianRender.cu:62-182).  The basis is written in canonical
z-polynomial form and contracted with the [3, K, N] coefficients in plain
torch: the stage is a few elementwise passes and one small contraction,
with no kernel of its own.

Convention: real SH, all-positive signs (no Condon-Shortley phase), the
standard 3DGS table.  Coefficients are ordered (l, m) with m = -l..l,
flattened: index = l^2 + l + m.
"""

from __future__ import annotations

import torch

from .geometry import clip


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def sh_basis(dirs: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis values for unit directions: ``dirs`` [..., 3] (assumed
    normalized) -> [..., (degree+1)^2], the planar basis stacked last."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    return torch.stack(sh_basis_components(x, y, z, degree), -1)


def sh_basis_components(x, y, z, degree: int):
    """Planar basis: x, y, z are [N] rows of unit directions; returns a
    LIST of (degree+1)^2 [N] tensors.  The single home of the coefficient
    table; sh_basis stacks it."""
    if not 0 <= degree <= 4:
        raise ValueError("SH degree must be in [0, 4]")
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 1:
        c1 = 0.4886025119029199
        out += [c1 * y, c1 * z, c1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            1.0925484305920792 * xy,
            1.0925484305920792 * yz,
            0.31539156525252005 * (3.0 * zz - 1.0),
            1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 3:
        out += [
            0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            0.4570457994644658 * y * (5.0 * zz - 1.0),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.4570457994644658 * x * (5.0 * zz - 1.0),
            1.445305721320277 * z * (xx - yy),
            0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            2.5033429417967046 * xy * (xx - yy),
            1.7701307697799304 * yz * (3.0 * xx - yy),
            0.9461746957575601 * xy * (7.0 * zz - 1.0),
            0.6690465435572892 * yz * (7.0 * zz - 3.0),
            0.10578554691520431 * (35.0 * zz * zz - 30.0 * zz + 3.0),
            0.6690465435572892 * xz * (7.0 * zz - 3.0),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.6258357354491761 * (xx * xx - 6.0 * xx * yy + yy * yy),
        ]
    return out


def evaluate_sh_colors(means, sh, camera_position, degree: int) -> torch.Tensor:
    """Per-splat view-dependent color (evaluateSphericalHarmonicsKernel,
    GaussianRender.cu:158-182).

    means:  [3, N] planar splat centers (world).
    sh:     [3, K, N] planar coefficients, K >= (degree+1)^2.
    camera_position: [3] tensor on the same device.
    Returns [3, N] planar colors, clamp(sum + 0.5, 0, 1) like the
    reference (GaussianRender.cu:154).
    """
    dx = camera_position[0] - means[0]
    dy = camera_position[1] - means[1]
    dz = camera_position[2] - means[2]
    inv = 1.0 / clip(torch.sqrt(dx * dx + dy * dy + dz * dz), 1e-20)
    basis = torch.stack(sh_basis_components(dx * inv, dy * inv, dz * inv, degree))
    k = num_sh_coeffs(degree)
    acc = torch.einsum("kn,ckn->cn", basis, sh[:, :k])
    return clip(acc + 0.5, 0.0, 1.0)
