""".splat file import/export — the antimatter15 web-viewer format.

The port's copy of the JAX package's splatfile.py: the same format, checks
and error texts, scenes on a torch device (the card unless
``device="cpu"``).  Beyond-reference scene I/O: the CUDA reference ingests
only raw 3DGS .ply files (its src/PlyParser.cpp), but the wider splat
ecosystem ships pre-activated ".splat" files (antimatter15/splat).  The
format is a headerless little-endian stream of 32-byte records:

    offset  type    field
    0       f32[3]  position (x, y, z)
    12      f32[3]  scale (per-axis std-dev; exp() already applied)
    24      u8[4]   color  (r, g, b = clamp(0.5 + SH_C0 * f_dc) * 255;
                    a = sigmoid(opacity) * 255)
    28      u8[4]   rotation (rot_0..rot_3 = w, x, y, z of the unit
                    quaternion, each mapped q -> q * 128 + 128)

i.e. exactly a degree-0 ``GaussianScene`` with the activations the .ply
importer applies (PlyParser.cpp:317-327) pre-baked, so the loader maps
fields 1:1 and reuses the same 8-bit rotation quantization feature
(utils/quantize.py) the reference applies to .ply rotations.

SH bands beyond the DC term do not exist in the format: exporting a
degree>0 scene keeps only the baked base color (lossy, like every
.splat converter), and loading always yields sh_degree 0.
"""

from __future__ import annotations

import numpy as np

from .models.scene import GaussianScene, scene_from_arrays
from .utils.quantize import decode_quat_xyzw

RECORD_BYTES = 32

_DTYPE = np.dtype(
    [
        ("position", "<f4", 3),
        ("scale", "<f4", 3),
        ("rgba", "u1", 4),
        ("rot", "u1", 4),
    ]
)
assert _DTYPE.itemsize == RECORD_BYTES


class SplatError(ValueError):
    """Malformed .splat input."""


def load_splat(path_or_stream, *, device=None) -> GaussianScene:
    """Load an antimatter15 .splat file into a GaussianScene on ``device``
    (None: the card).

    The format is headerless, so validation is structural: the byte
    length must be a positive multiple of the 32-byte record, and the
    float fields must be finite (a text or .ply file read as f32 records
    fails these immediately).
    """
    if hasattr(path_or_stream, "read"):
        data = path_or_stream.read()
    else:
        with open(path_or_stream, "rb") as f:
            data = f.read()
    if len(data) == 0:
        raise SplatError("Empty .splat file.")
    if len(data) % RECORD_BYTES != 0:
        raise SplatError(
            f"File size {len(data)} is not a multiple of the 32-byte "
            ".splat record."
        )
    rec = np.frombuffer(data, dtype=_DTYPE)
    means = rec["position"].astype(np.float32)
    scales = rec["scale"].astype(np.float32)
    if not (np.isfinite(means).all() and np.isfinite(scales).all()):
        raise SplatError("Non-finite position/scale — not a .splat file?")
    if (scales < 0).any():
        raise SplatError("Negative scale — not a .splat file?")

    rgba = rec["rgba"].astype(np.float32) / 255.0
    colors = rgba[:, :3]
    opacities = rgba[:, 3]

    # rot bytes are (w, x, y, z) mapped q*128+128; undo and re-normalize
    # before handing to the scene's own 8-bit packer.
    rot = (rec["rot"].astype(np.float32) - 128.0) / 128.0
    norms = np.linalg.norm(rot, axis=1, keepdims=True)
    rot = np.where(norms > 0, rot / np.maximum(norms, 1e-30), rot)
    quats_xyzw = rot[:, [1, 2, 3, 0]]

    return scene_from_arrays(means, scales, quats_xyzw, opacities, colors, device=device)


def write_splat(path_or_stream, scene: GaussianScene) -> None:
    """Write a GaussianScene as an antimatter15 .splat file.

    Emits the scene's baked base color (SH bands beyond DC are dropped —
    the format has nowhere to put them) and re-quantizes the already
    8-bit rotation onto the format's q*128+128 grid.
    """
    n = scene.count
    rec = np.zeros(n, dtype=_DTYPE)
    rec["position"] = scene.means[:, :n].cpu().numpy().T
    rec["scale"] = scene.scales[:, :n].cpu().numpy().T
    colors = np.clip(scene.colors[:, :n].cpu().numpy().T, 0.0, 1.0)
    alpha = np.clip(scene.opacities[:n].cpu().numpy(), 0.0, 1.0)
    rec["rgba"][:, :3] = (colors * 255.0 + 0.5).astype(np.uint8)
    rec["rgba"][:, 3] = (alpha * 255.0 + 0.5).astype(np.uint8)
    q = decode_quat_xyzw(scene.quats[:n].cpu().numpy())  # [n, 4] xyzw
    norms = np.linalg.norm(q, axis=1, keepdims=True)
    q = np.where(norms > 0, q / np.maximum(norms, 1e-30), q)
    rot_wxyz = q[:, [3, 0, 1, 2]]
    rec["rot"] = np.clip(rot_wxyz * 128.0 + 128.0, 0.0, 255.0).astype(np.uint8)

    if hasattr(path_or_stream, "write"):
        path_or_stream.write(rec.tobytes())
    else:
        with open(path_or_stream, "wb") as f:
            f.write(rec.tobytes())


def load_scene(path, *, device=None):
    """Load a scene by file extension onto ``device`` (None: the card):
    .splat or .ply (anything else is tried as .ply, whose header validation
    gives the clear error)."""
    from .ply import load_gaussian_ply

    if str(path).lower().endswith(".splat"):
        return load_splat(path, device=device)
    return load_gaussian_ply(path, device=device)
