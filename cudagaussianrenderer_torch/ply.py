"""Gaussian-splat .ply scene import/export.

The port's copy of the JAX package's ply.py, with the same header rules,
error texts and typed transform; scenes land on a torch device (the card
unless ``device="cpu"``).  Functional equivalent of the reference importer
(its src/PlyParser.cpp): a generic two-level parse (header ->
per-property float columns) followed by the typed gaussian-splat transform
(activations, SH degree inference + reorder, 8-bit rotation quantization,
scene bounds).  Implementation is numpy-vectorized (with an optional C++
fast loader in native/, see utils.native), not a translation of the C++
row loop.

Header rules (PlyParser.cpp:15-109):
  - only ``format binary_little_endian`` accepted;
  - only ``property float`` accepted; duplicates rejected;
  - ``element vertex N`` required;  unknown lines (e.g. comments) ignored;
  - empty lines rejected; header must end within 256 lines.

Typed transform (PlyParser.cpp:167-339):
  - required: x y z, rot_0..3 (quaternion w,x,y,z), scale_0..2,
    f_dc_0..2, opacity;
  - optional f_rest_0..M-1 with M = sum_{d=1..D} (2(d+1)+1)*3 for a whole
    degree D, else error;
  - activations: normalize(rot), exp(scale), sigmoid(opacity);
  - baked color = f_dc * SH_C0 + 0.5 (not clamped);
  - rotation quantized to 8 bits/component in one uint32;
  - SH output here is [N, K, 3] with K=(D+1)^2: band 0 = f_dc, bands 1+ =
    f_rest reordered from planar [R..,G..,B..] to interleaved per-band rgb
    (PlyParser.cpp:269-286).  The additional GPU block-interleave
    (Demo.cpp:160-194) is a coalescing trick of the reference's own kernels;
    the port's kernels read the planar [3, K, N] layout instead.
"""

from __future__ import annotations

import io
from typing import Dict, List, Optional, Tuple

import numpy as np

from .models.scene import GaussianScene, SH_C0, scene_from_arrays, scene_from_numpy


class PlyError(ValueError):
    pass


MAX_HEADER_LINES = 256


def parse_header(stream) -> Tuple[List[str], int]:
    """Parse the header; returns (property names in file order, vertex count).

    ``stream`` is a binary file-like positioned at the start; on return it is
    positioned at the first body byte.
    """
    properties: List[str] = []
    vertex_count = -1
    little_endian = False

    for iteration in range(MAX_HEADER_LINES + 2):
        line = stream.readline()
        if not line:
            raise PlyError("PLY header terminator (end_header) not found.")
        words = line.decode("ascii", errors="replace").split()
        if not words:
            raise PlyError("Blank line inside PLY header.")
        word = words[0]
        if word == "ply":
            continue
        elif word == "format":
            little_endian = len(words) >= 2 and words[1] == "binary_little_endian"
        elif word == "element":
            if len(words) < 2 or words[1] != "vertex":
                raise PlyError("Unsupported element (only 'vertex' is accepted).")
            if len(words) < 3:
                raise PlyError("Malformed vertex count.")
            try:
                vertex_count = int(words[2])
            except ValueError:
                raise PlyError("Malformed vertex count.") from None
            if vertex_count < 0:
                raise PlyError("Malformed vertex count.")
        elif word == "property":
            if len(words) < 2 or words[1] != "float":
                raise PlyError("Unsupported property type (only float is accepted).")
            if len(words) < 3:
                raise PlyError("Property declaration lacks a name.")
            name = words[2]
            if name in properties:
                raise PlyError(f'Property declared twice: "{name}".')
            properties.append(name)
        elif word == "end_header":
            if not little_endian or vertex_count == -1:
                raise PlyError("Header lacks binary_little_endian format or a vertex count.")
            return properties, vertex_count
        # Unknown keywords (comment, obj_info, ...) are ignored, like the
        # reference's if/else-if chain with no final else.
        if iteration >= MAX_HEADER_LINES:
            raise PlyError("PLY header terminator (end_header) not found.")
    raise PlyError("PLY header terminator (end_header) not found.")


def parse_ply_columns(path_or_stream) -> Tuple[Dict[str, np.ndarray], int]:
    """Generic parse: {property -> float32 column}, vertex count."""
    if hasattr(path_or_stream, "read"):
        stream = path_or_stream
        close = False
    else:
        stream = open(path_or_stream, "rb")
        close = True
    try:
        properties, n = parse_header(stream)
        p = len(properties)
        # Read until full: raw/pipe streams may return less than
        # requested from a single read() on perfectly valid data.
        want = 4 * n * p
        body = bytearray()
        while len(body) < want:
            chunk = stream.read(want - len(body))
            if not chunk:
                break
            body.extend(chunk)
        if len(body) != want:
            raise PlyError("Vertex data ends early (truncated file).")
        body = bytes(body)
        data = np.frombuffer(body, dtype="<f4").reshape(n, p)
        return {name: np.ascontiguousarray(data[:, j]) for j, name in enumerate(properties)}, n
    finally:
        if close:
            stream.close()


def _sigmoid(x: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-x))


REQUIRED_PROPS = (
    "x", "y", "z",
    "rot_0", "rot_1", "rot_2", "rot_3",
    "scale_0", "scale_1", "scale_2",
    "f_dc_0", "f_dc_1", "f_dc_2",
    "opacity",
)


def infer_sh_degree(extra_count: int) -> int:
    """SH degree from the f_rest_* count: each degree d >= 1 adds
    (2(d+1)+1)*3 coefficients (PlyParser.cpp:223-241)."""
    expected = 0
    degree = 0
    while expected < extra_count:
        expected += (2 * (degree + 1) + 1) * 3
        degree += 1
    if expected != extra_count:
        raise PlyError(
            f"f_rest_* count {extra_count} does not complete an SH degree"
            f" (degree {degree} needs {expected})."
        )
    return degree


def load_gaussian_ply(path_or_stream, *, use_native: bool = True, device=None) -> GaussianScene:
    """Load a gaussian-splat .ply into a GaussianScene on ``device`` (None:
    the card).

    File paths go through the native C++ loader (native/libgsply.so) when
    it is available — it streams and transforms into the planar layout in
    one pass on the host — with a fallback to the pure-Python importer
    when it is not (streams always take the Python path).
    """
    if use_native and not hasattr(path_or_stream, "read"):
        from .utils.native import load_scene_native

        try:
            data = load_scene_native(path_or_stream)
        except ValueError as e:
            raise PlyError(str(e)) from None
        if data is not None:
            return scene_from_numpy(dict(data, count=data["means"].shape[1]), device=device)

    cols, n = parse_ply_columns(path_or_stream)

    missing = [p for p in REQUIRED_PROPS if p not in cols]
    if missing:
        raise PlyError(f'Required property absent: "{missing[0]}".')
    if n == 0:
        # An empty scene has no bounds (downstream min/max over zero
        # rows) — reject with a clear message, like the native loader.
        raise PlyError("Vertex element declares zero vertices.")

    # f_rest_* discovery, in index order, stopping at the first gap.
    extra = 0
    while f"f_rest_{extra}" in cols:
        extra += 1
    degree = infer_sh_degree(extra)

    means = np.stack([cols["x"], cols["y"], cols["z"]], axis=1)
    # rot_0 is the scalar (w) part (PlyParser.cpp:294-304).
    quats_wxyz = np.stack([cols[f"rot_{i}"] for i in range(4)], axis=1)
    norms = np.linalg.norm(quats_wxyz, axis=1, keepdims=True)
    # An all-zero rot row has no direction to normalize: leave it raw
    # (quantizing zeros), matching the native loader's norm > 0 guard —
    # 0/0 would propagate NaN into the packed rotation.
    quats_wxyz = np.where(norms > 0, quats_wxyz / np.maximum(norms, 1e-30), quats_wxyz)
    quats_xyzw = quats_wxyz[:, [1, 2, 3, 0]]

    scales = np.exp(np.stack([cols[f"scale_{i}"] for i in range(3)], axis=1))
    opacity = _sigmoid(cols["opacity"])
    f_dc = np.stack([cols[f"f_dc_{i}"] for i in range(3)], axis=1)
    colors = f_dc * SH_C0 + 0.5  # intentionally unclamped (PlyParser.cpp:326)

    sh = None
    if degree > 0:
        k = (degree + 1) ** 2
        per_channel = extra // 3
        sh = np.empty((n, k, 3), np.float32)
        sh[:, 0, :] = f_dc
        # f_rest is planar per channel: [R_0..R_{m-1}, G_0.., B_0..].
        rest = np.stack([cols[f"f_rest_{j}"] for j in range(extra)], axis=1)
        rest = rest.reshape(n, 3, per_channel)  # [n, channel, band]
        sh[:, 1:, :] = np.transpose(rest, (0, 2, 1))

    return scene_from_arrays(
        means.astype(np.float32),
        scales.astype(np.float32),
        quats_xyzw.astype(np.float32),
        opacity.astype(np.float32),
        colors.astype(np.float32),
        sh,
        degree,
        device=device,
    )


def write_gaussian_ply(
    path_or_stream,
    means: np.ndarray,
    scales_log: np.ndarray,
    quats_wxyz: np.ndarray,
    opacity_logit: np.ndarray,
    f_dc: np.ndarray,
    f_rest: Optional[np.ndarray] = None,
    extra_properties: Optional[Dict[str, np.ndarray]] = None,
) -> None:
    """Write a scene in the raw (pre-activation) .ply format.

    Used to build test fixtures and to round-trip scenes; inputs are the
    *raw* stored values (log-scales, logit-opacity, un-normalized quats).
    ``f_rest``: [N, 3, M/3] planar per channel, or None.
    """
    n = means.shape[0]
    names = list(REQUIRED_PROPS)
    columns = [
        means[:, 0], means[:, 1], means[:, 2],
        quats_wxyz[:, 0], quats_wxyz[:, 1], quats_wxyz[:, 2], quats_wxyz[:, 3],
        scales_log[:, 0], scales_log[:, 1], scales_log[:, 2],
        f_dc[:, 0], f_dc[:, 1], f_dc[:, 2],
        opacity_logit,
    ]
    if f_rest is not None:
        flat = f_rest.reshape(n, -1)
        for j in range(flat.shape[1]):
            names.append(f"f_rest_{j}")
            columns.append(flat[:, j])
    if extra_properties:
        for name, col in extra_properties.items():
            names.append(name)
            columns.append(col)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {name}" for name in names]
    header.append("end_header")
    body = np.stack(columns, axis=1).astype("<f4").tobytes()

    if hasattr(path_or_stream, "write"):
        stream = path_or_stream
        stream.write(("\n".join(header) + "\n").encode("ascii"))
        stream.write(body)
    else:
        with open(path_or_stream, "wb") as f:
            f.write(("\n".join(header) + "\n").encode("ascii"))
            f.write(body)
