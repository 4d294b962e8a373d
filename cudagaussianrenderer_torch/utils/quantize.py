"""8-bit rotation quantization.

The reference packs each splat's unit quaternion into a single uint32 with
8 bits per component (pack: PlyParser.cpp:155-165, unpack:
GaussianRender.cu:55-58).  The quantization changes the rendered
covariance slightly, so the port reproduces it bit-exactly.

Layout (MSB..LSB): [x:8][y:8][z:8][w:8], each component mapped from
[-1, 1] -> [0, 1] -> round-toward-zero to [0, 255].

The NumPy functions serve scene construction and the golden oracle;
``decode_quat_components`` also takes a torch tensor of int32 bit
patterns, which is how the port carries packed quaternions on a device.
"""

from __future__ import annotations

import numpy as np
import torch


def encode_quat_xyzw(q_xyzw: np.ndarray) -> np.ndarray:
    """Pack quaternion components (x, y, z, w in [-1, 1]) into uint32.

    ``q_xyzw``: (..., 4) float array.  Returns (...,) uint32.
    Matches encodeVec4((q + 1) * 0.5): clamp to [0,1], scale by 255,
    truncate (C float->uint cast).
    """
    v = np.clip((q_xyzw + 1.0) * 0.5, 0.0, 1.0)
    b = (v * 255.0).astype(np.uint32)  # truncation, like the C cast
    return (b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8) | b[..., 3]


def decode_quat_components(packed):
    """Unpack -> 4 separate float32 [N] vectors (x, y, z, w) in [-1, 1].

    ``packed`` is a NumPy uint32 array or a torch int32 tensor holding the
    same bit patterns (an arithmetic shift is harmless: every field is
    masked to 8 bits)."""
    if isinstance(packed, torch.Tensor):
        packed = packed.to(torch.int32)

        def comp(shift):
            return ((packed >> shift) & 0xFF).to(torch.float32) / 255.0 * 2.0 - 1.0

    else:
        packed = np.asarray(packed).astype(np.uint32)

        def comp(shift):
            return ((packed >> shift) & 0xFF).astype(np.float32) / 255.0 * 2.0 - 1.0

    return comp(24), comp(16), comp(8), comp(0)


def decode_quat_xyzw(packed: np.ndarray) -> np.ndarray:
    """Unpack uint32 -> (..., 4) float32 quaternion components in [-1, 1].

    Matches decodeVec4(v) * 2 - 1.  The result is *not* re-normalized,
    matching the reference (GaussianRender.cu:220-221).
    """
    packed = np.asarray(packed).astype(np.uint32)
    x = ((packed >> 24) & 0xFF).astype(np.float32)
    y = ((packed >> 16) & 0xFF).astype(np.float32)
    z = ((packed >> 8) & 0xFF).astype(np.float32)
    w = (packed & 0xFF).astype(np.float32)
    q = np.stack([x, y, z, w], axis=-1) / 255.0
    return q * 2.0 - 1.0


def quat_xyzw_to_rotation_matrix(q_xyzw: np.ndarray) -> np.ndarray:
    """Rotation matrix from quaternion (x, y, z, w), glm::mat3_cast form.

    Assumes (approximately) unit quaternions; intentionally does NOT divide
    by the norm, matching glm's behavior on the slightly-off-unit decoded
    quaternions.  Returns (..., 3, 3) with rows indexing matrix rows.
    """
    x, y, z, w = (q_xyzw[..., 0], q_xyzw[..., 1], q_xyzw[..., 2], q_xyzw[..., 3])
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r00 = 1.0 - 2.0 * (yy + zz)
    r01 = 2.0 * (xy - wz)
    r02 = 2.0 * (xz + wy)
    r10 = 2.0 * (xy + wz)
    r11 = 1.0 - 2.0 * (xx + zz)
    r12 = 2.0 * (yz - wx)
    r20 = 2.0 * (xz - wy)
    r21 = 2.0 * (yz + wx)
    r22 = 1.0 - 2.0 * (xx + yy)
    rows = [
        np.stack([r00, r01, r02], axis=-1),
        np.stack([r10, r11, r12], axis=-1),
        np.stack([r20, r21, r22], axis=-1),
    ]
    return np.stack(rows, axis=-2)
