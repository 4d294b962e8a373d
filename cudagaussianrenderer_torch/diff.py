"""Image losses of the differentiable path.

For now this holds only ``ssim``, the statistic the CLI's ``eval`` and
``compare`` report (the JAX package's diff.ssim, diff.py:557-612).  The
differentiable renderer and the fitting loop of the JAX package's diff.py
come here with the port's module 11 (ROADMAP.md).
"""

from __future__ import annotations

import torch


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
    var_a = torch.clamp(_blur(ac * ac, g) - mu_a * mu_a, min=0.0)
    var_b = torch.clamp(_blur(bc * bc, g) - mu_b * mu_b, min=0.0)
    cov = _blur(ac * bc, g) - mu_a * mu_b
    # detach: the bound is a numerical guard, not an objective term, and
    # d(sqrt)/d(var) blows up at var = 0 (flat patches).
    cov_bound = torch.sqrt(var_a * var_b).detach()
    cov = torch.minimum(torch.maximum(cov, -cov_bound), cov_bound)
    num = (2.0 * mu_a * mu_b + c1) * (2.0 * cov + c2)
    den = (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2)
    return torch.mean(num / den)
