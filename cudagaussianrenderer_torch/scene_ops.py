"""Scene editing: crop / filter / decimate / merge / rigid transform.

The port of the JAX package's scene_ops.py.  Splat-ecosystem housekeeping
the reference leaves to external tools: trimming floaters outside a box,
dropping sub-threshold opacities, capping splat counts for a target
device, merging captures, and re-posing a scene.  Every operation works
on the scene's tensors on the scene's own device and returns a scene
there; the packed rotations pass through untouched except for
``transform``'s rotation composition (decode -> Hamilton product ->
re-encode, the same 8-bit quantization the importer applies).  The
arithmetic follows the JAX package's NumPy code operation for operation,
so both give the same arrays bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .models.scene import SH_C0, GaussianScene


def _live(scene: GaussianScene) -> dict:
    """The true (unpadded) splat tensors, splat axis last."""
    n = scene.count
    return dict(
        means=scene.means[:, :n],
        scales=scene.scales[:, :n],
        quats=scene.quats[:n],
        opacities=scene.opacities[:n],
        colors=scene.colors[:, :n],
        sh=None if scene.sh is None else scene.sh[:, :, :n],
    )


def _rebuild(scene: GaussianScene, a: dict) -> GaussianScene:
    n = int(a["means"].shape[-1])
    if n == 0:
        raise ValueError("operation would leave an empty scene")
    bounds = torch.stack([a["means"].min(dim=1).values, a["means"].max(dim=1).values]).tolist()
    return dataclasses.replace(
        scene,
        **{k: None if v is None else v.contiguous() for k, v in a.items()},
        count=n,
        bounds_min=tuple(bounds[0]),
        bounds_max=tuple(bounds[1]),
    )


def take(scene: GaussianScene, indices) -> GaussianScene:
    """A new scene holding the given splat indices (bounds recomputed):
    a sequence, a NumPy array or a tensor on any device."""
    if not isinstance(indices, torch.Tensor):
        indices = torch.from_numpy(np.asarray(indices))
    idx = indices.to(device=scene.device, dtype=torch.long)
    a = _live(scene)
    return _rebuild(scene, dict(
        means=a["means"][:, idx],
        scales=a["scales"][:, idx],
        quats=a["quats"][idx],
        opacities=a["opacities"][idx],
        colors=a["colors"][:, idx],
        sh=None if a["sh"] is None else a["sh"][:, :, idx],
    ))


def crop(scene: GaussianScene, lo, hi) -> GaussianScene:
    """Keep splats whose CENTERS lie inside the axis-aligned box."""
    lo = torch.tensor(np.asarray(lo, np.float32), device=scene.device)
    hi = torch.tensor(np.asarray(hi, np.float32), device=scene.device)
    m = scene.means[:, : scene.count]
    keep = ((m >= lo[:, None]) & (m <= hi[:, None])).all(dim=0)
    return take(scene, torch.nonzero(keep).flatten())


def filter_opacity(scene: GaussianScene, min_opacity: float) -> GaussianScene:
    """Drop splats whose opacity is below ``min_opacity`` (floaters and
    pruning leftovers; below 1/255 they cannot touch an 8-bit pixel)."""
    op = scene.opacities[: scene.count]
    return take(scene, torch.nonzero(op >= float(np.float32(min_opacity))).flatten())


def decimate(
    scene: GaussianScene,
    max_splats: int,
    *,
    mode: str = "importance",
    seed: int = 0,
) -> GaussianScene:
    """Cap the splat count.  ``importance`` keeps the highest
    opacity x mean-scale splats (what a far viewer sees most of);
    ``random`` subsamples uniformly (NumPy's generator, as in the JAX
    package, so a seed picks the same splats).  Order is preserved."""
    n = scene.count
    if max_splats >= n:
        return scene
    if max_splats <= 0:
        raise ValueError("max_splats must be positive")
    if mode == "importance":
        op = scene.opacities[:n].double()
        sc = scene.scales[:, :n].double()
        score = op * torch.clamp(sc[0] * sc[1] * sc[2], min=1e-30).pow(1.0 / 3.0)
        idx = torch.argsort(-score, stable=True)[:max_splats]
    elif mode == "random":
        idx = torch.from_numpy(np.random.default_rng(seed).choice(n, max_splats, replace=False))
    else:
        raise ValueError(f"unknown decimate mode {mode!r}")
    return take(scene, torch.sort(idx).values)


def merge(scenes: Sequence[GaussianScene]) -> GaussianScene:
    """Concatenate scenes, onto the first one's device.  SH degrees may
    differ: every scene promotes to the maximum degree (missing DC
    synthesized from the baked color, higher bands zero — exactly how a
    degree-0 splat renders)."""
    if not scenes:
        raise ValueError("nothing to merge")
    dev = scenes[0].device
    deg = max(s.sh_degree for s in scenes)
    k = (deg + 1) ** 2
    parts = [_live(s.to(dev)) for s in scenes]
    for a in parts:
        if deg == 0:
            a["sh"] = None
            continue
        sh = torch.zeros((3, k, a["means"].shape[-1]), dtype=torch.float32, device=dev)
        if a["sh"] is not None:
            sh[:, : a["sh"].shape[1]] = a["sh"]
        else:
            sh[:, 0] = (a["colors"] - 0.5) / torch.tensor(SH_C0, dtype=torch.float32, device=dev)
        a["sh"] = sh
    out = {
        f: None if deg == 0 and f == "sh" else torch.cat([a[f] for a in parts], dim=-1)
        for f in parts[0]
    }
    return _rebuild(dataclasses.replace(scenes[0].to(dev), sh_degree=deg), out)


def _hamilton_xyzw(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion product a*b, (x, y, z, w) component order, [..., 4]."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        dim=-1,
    )


def _decode_xyzw(packed: torch.Tensor) -> torch.Tensor:
    """[N] int32 bit patterns -> [N, 4] float32 (x, y, z, w) in [-1, 1],
    as utils.quantize.decode_quat_xyzw.  The division is by a tensor on the
    same device: a division by a Python number may become a multiply by
    its reciprocal on the card, one bit off NumPy's quotient."""
    shifts = torch.tensor([24, 16, 8, 0], dtype=torch.int32, device=packed.device)
    q = ((packed[:, None] >> shifts) & 0xFF).to(torch.float32)
    return q / torch.tensor(255.0, device=packed.device) * 2.0 - 1.0


def _encode_xyzw(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] float32 (x, y, z, w) -> [N] int32 bit patterns of the packed
    uint32, as utils.quantize.encode_quat_xyzw (truncation to 8 bits)."""
    b = (torch.clamp((q + 1.0) * 0.5, 0.0, 1.0) * 255.0).to(torch.int64)
    packed = (b[:, 0] << 24) | (b[:, 1] << 16) | (b[:, 2] << 8) | b[:, 3]
    return torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)


def transform(
    scene: GaussianScene,
    *,
    translate=(0.0, 0.0, 0.0),
    scale: float = 1.0,
    rotate_xyzw: Optional[np.ndarray] = None,
) -> GaussianScene:
    """Similarity transform: means' = scale * R @ means + translate;
    per-axis std-devs multiply by |scale|; rotations compose on the
    left (world-side) and re-quantize to 8 bits like the importer.
    SH coefficients are kept as-is — view-dependent lobes rotate with
    the scene only approximately; exact SH rotation is out of scope
    and irrelevant at degree 0."""
    if scale == 0.0:
        raise ValueError("scale must be nonzero")
    dev = scene.device
    a = _live(scene)
    t = torch.tensor(np.asarray(translate, np.float32).reshape(3, 1), device=dev)
    if rotate_xyzw is not None:
        q = np.asarray(rotate_xyzw, np.float64)
        q = q / np.linalg.norm(q)
        x, y, z, w = q
        rot = torch.tensor(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            dtype=torch.float64, device=dev,
        )
        a["means"] = (rot @ a["means"].double()).to(torch.float32)
        qs = _decode_xyzw(a["quats"])
        composed = _hamilton_xyzw(
            torch.tensor(q.astype(np.float32), device=dev).expand_as(qs), qs
        )
        # The norm as NumPy sums 4 numbers: one after the other.
        sq = composed * composed
        norm = torch.sqrt(sq[:, 0] + sq[:, 1] + sq[:, 2] + sq[:, 3])[:, None]
        a["quats"] = _encode_xyzw(composed / torch.clamp(norm, min=1e-12))
    # The f32 factor as a Python number, which torch takes as exactly that f32.
    a["means"] = a["means"] * float(np.float32(scale)) + t
    a["scales"] = a["scales"] * float(np.float32(abs(scale)))
    return _rebuild(scene, a)
