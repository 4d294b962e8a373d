"""Posed-image dataset ingestion/export.

The standard 3DGS training workflow fits splats against a directory of
posed images.  This module owns the NeRF-synthetic layout
(``transforms.json`` with ``camera_angle_x`` + per-frame
camera-to-world matrices, RGBA PNGs) and the layout-dispatching front
door ``load_posed`` (COLMAP workspaces route to colmap.py).  The CUDA
reference is a forward-only renderer with no training path; these
loaders feed the differentiable path (``cli fit``, diff.py) and ``cli
eval``, and the exporters (``cli orbit --transforms`` /
``--colmap``) round-trip a dataset end to end without external data.
The port's copy of the JAX package's dataset.py: the same files, byte for
byte, from the same cameras.

Conventions: the transforms matrices are OpenGL-style camera-to-world
(camera looks down local -Z, +Y up) — exactly models.camera.Camera's
quaternion convention, so conversion is rotation-matrix <-> quaternion
plus the translation column.  ``camera_angle_x`` is the HORIZONTAL fov;
Camera stores the vertical one (fov_y = 2*atan(tan(fov_x/2)/aspect)).
Everything is stdlib + numpy; images go through utils.png.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .models.camera import Camera, quat_from_matrix, quat_to_matrix
from .utils.png import read_png, write_png

TRANSFORMS_NAMES = ("transforms.json", "transforms_train.json")


def camera_to_transform(camera: Camera) -> np.ndarray:
    """Camera -> 4x4 camera-to-world matrix (OpenGL convention)."""
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = quat_to_matrix(camera.rotation)
    m[:3, 3] = np.asarray(camera.position, np.float64)
    return m


def transform_to_camera(
    matrix: np.ndarray, fov_x: float, aspect: float
) -> Camera:
    """4x4 camera-to-world + horizontal fov -> Camera."""
    m = np.asarray(matrix, np.float64)
    if m.shape != (4, 4):
        raise ValueError(f"transform_matrix must be 4x4, got {m.shape}")
    fov_y = 2.0 * math.atan(math.tan(fov_x * 0.5) / aspect)
    return Camera(
        position=m[:3, 3].astype(np.float32),
        rotation=quat_from_matrix(m[:3, :3].astype(np.float32)),
        fov_y=fov_y,
        aspect=aspect,
    )


def write_transforms(
    path, cameras: Sequence[Camera], file_paths: Sequence[str]
) -> None:
    """Write a ``transforms.json`` for ``cameras`` referencing
    ``file_paths`` (relative to the json's directory, extension kept)."""
    if len(cameras) != len(file_paths):
        raise ValueError("one file path per camera required")
    if not cameras:
        raise ValueError("empty camera list")
    cam0 = cameras[0]
    fov_x = 2.0 * math.atan(math.tan(cam0.fov_y * 0.5) * cam0.aspect)
    doc = {
        "camera_angle_x": fov_x,
        "frames": [
            {
                "file_path": str(fp),
                "transform_matrix": camera_to_transform(c).tolist(),
            }
            for c, fp in zip(cameras, file_paths)
        ],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)


def _resolve_transforms(path) -> Path:
    p = Path(path)
    if p.is_dir():
        for name in TRANSFORMS_NAMES:
            if (p / name).exists():
                return p / name
        raise FileNotFoundError(
            f"no {' / '.join(TRANSFORMS_NAMES)} under {p}"
        )
    return p


def load_transforms(path) -> Tuple[list, float, Path]:
    """Parse a transforms.json (or a directory holding one).

    Returns (frames, camera_angle_x, base_dir) where each frame is a
    (transform_matrix [4,4] f64, image_path Path) pair.  Cameras are
    materialized later, once the image aspect is known (the json does
    not store the resolution).
    """
    tpath = _resolve_transforms(path)
    with open(tpath) as f:
        doc = json.load(f)
    if "camera_angle_x" not in doc:
        raise ValueError(f"{tpath}: missing camera_angle_x")
    frames = []
    for fr in doc.get("frames", []):
        fp = Path(str(fr["file_path"]))
        if not fp.suffix:
            fp = fp.with_suffix(".png")  # blender sets omit the extension
        frames.append(
            (np.asarray(fr["transform_matrix"], np.float64), fp)
        )
    if not frames:
        raise ValueError(f"{tpath}: no frames")
    return frames, float(doc["camera_angle_x"]), tpath.parent


def _downscale(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[:2]
    if factor == 1:
        return img
    if h % factor or w % factor:
        raise ValueError(
            f"image {w}x{h} not divisible by downscale factor {factor}"
        )
    blocks = img.reshape(
        h // factor, factor, w // factor, factor, img.shape[2]
    )
    return blocks.astype(np.float32).mean(axis=(1, 3))


def load_dataset(
    path,
    *,
    downscale: int = 1,
    background: Optional[Tuple[float, float, float]] = None,
    max_frames: int = 0,
) -> Tuple[List[Camera], np.ndarray]:
    """Load a posed-image dataset for fitting.

    Returns (cameras, images [N, H, W, 3] float32 in [0, 1]).  RGBA
    images are composited over ``background`` (default black — pass the
    RenderConfig.background used for fitting so targets and renders
    agree; the 3DGS evaluation protocol uses white).  ``downscale``
    block-averages by an integer factor; ``max_frames`` > 0 truncates.
    """
    frames, fov_x, base = load_transforms(path)
    if max_frames > 0:
        frames = frames[:max_frames]
    bg = np.zeros(3, np.float32) if background is None else np.asarray(
        background, np.float32
    )
    cameras: List[Camera] = []
    images = []
    shape = None
    for matrix, rel in frames:
        img = read_png(base / rel)
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        imgf = _downscale(img, downscale) if downscale != 1 else (
            img.astype(np.float32)
        )
        imgf = imgf / 255.0
        if imgf.shape[2] == 4:
            a = imgf[..., 3:4]
            imgf = imgf[..., :3] * a + bg * (1.0 - a)
        else:
            imgf = imgf[..., :3]
        if shape is None:
            shape = imgf.shape
        elif imgf.shape != shape:
            raise ValueError(
                f"{rel}: image shape {imgf.shape} != first frame {shape}"
            )
        h, w = imgf.shape[:2]
        cameras.append(transform_to_camera(matrix, fov_x, w / h))
        images.append(imgf)
    return cameras, np.stack(images)


def export_dataset(
    out_dir,
    renderer,
    cameras: Sequence[Camera],
    *,
    prefix: str = "frame",
) -> Path:
    """Render ``cameras`` with the production pipeline into ``out_dir``
    as a NeRF-synthetic-style dataset (PNGs + transforms.json).  The
    frames keep the renderer's alpha channel, so a fit loaded with a
    background composites exactly like the production render. Returns
    the transforms.json path.  ``renderer`` is a Renderer of this package,
    whose render returns a NumPy frame."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    names = []
    for i, cam in enumerate(cameras):
        name = f"{prefix}_{i:04d}.png"
        write_png(out / name, renderer.render(cam))
        names.append(name)
    tpath = out / "transforms.json"
    write_transforms(tpath, cameras, names)
    return tpath


class PosedDataset(NamedTuple):
    """A posed-image dataset in either ecosystem layout, ready to fit.

    cameras: per-frame models.camera.Camera.
    images:  [N, H, W, 3] float32 targets in [0, 1], background
             composited.
    points_xyz / points_rgb: the SfM point cloud ([P, 3] each, P = 0
             for layouts without one) — feeds diff.init_from_points.
    names:   per-frame image file names (for re-exporting poses).
    """

    cameras: List[Camera]
    images: np.ndarray
    points_xyz: np.ndarray
    points_rgb: np.ndarray
    names: List[str]


def load_posed(
    path,
    *,
    downscale: int = 1,
    background: Optional[Tuple[float, float, float]] = None,
    max_frames: int = 0,
) -> PosedDataset:
    """Front door for ``fit --dataset``: load a posed-image dataset of
    either supported layout — a COLMAP workspace (``sparse/0`` +
    ``images/``, the real-capture 3DGS input) or NeRF-synthetic
    (``transforms.json`` + PNGs).  Dispatch is by on-disk layout."""
    from . import colmap

    if colmap.find_sparse_dir(path) is not None:
        cams, images, xyz, rgb, names = colmap.load_dataset(
            path, downscale=downscale, background=background,
            max_frames=max_frames,
        )
        return PosedDataset(cams, images, xyz, rgb, names)
    cams, images = load_dataset(
        path, downscale=downscale, background=background,
        max_frames=max_frames,
    )
    frames, _, _ = load_transforms(path)
    names = [str(rel) for _, rel in frames]
    if max_frames > 0:
        names = names[:max_frames]
    empty = np.zeros((0, 3), np.float32)
    return PosedDataset(cams, images, empty, empty, names)


def init_bounds_from_cameras(
    cameras: Sequence[Camera], *, extent_factor: float = 0.4
) -> Tuple[np.ndarray, np.ndarray]:
    """Splat-init bounds for a dataset with no SfM points: an
    inward-looking rig orbits its subject, so the subject sits near the
    camera-position centroid within a fraction of the mean rig radius.
    (3DGS proper initializes from COLMAP points; NeRF-synthetic has
    none, and random-in-bounds + density control recovers the rest.)"""
    pos = np.stack([np.asarray(c.position, np.float64) for c in cameras])
    center = pos.mean(axis=0)
    radius = float(np.linalg.norm(pos - center, axis=1).mean())
    half = extent_factor * (radius if radius > 0 else 1.0)
    return (
        (center - half).astype(np.float32),
        (center + half).astype(np.float32),
    )
