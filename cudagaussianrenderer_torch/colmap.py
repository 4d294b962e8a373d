"""COLMAP sparse-reconstruction ingestion (the real-world 3DGS input).

Captured 3DGS scenes (Mip-NeRF 360, Tanks & Temples, user phone
captures) arrive as a COLMAP workspace: ``sparse/0/{cameras, images,
points3D}.{bin,txt}`` plus an ``images/`` directory.  The CUDA
reference is a forward-only renderer with no dataset layer at all; this
module reads that layout for ``cli eval`` and for fitting (``cli fit``,
diff.py) — poses to models.camera.Camera, the SfM point
cloud for the canonical 3DGS splat initialization.  The port's copy of the
JAX package's colmap.py: the same files, byte for byte, from the same
cameras and points.

Format notes (COLMAP src/colmap/scene/reconstruction_io.cc semantics):

* ``cameras.bin``: u64 count, then per camera i32 id, i32 model id,
  u64 width, u64 height, f64 params (count fixed per model).
* ``images.bin``: u64 count, then per image i32 id, 4×f64 qvec
  (w, x, y, z), 3×f64 tvec, i32 camera id, NUL-terminated name,
  u64 num 2D points, then (f64 x, f64 y, i64 point3D id) each.
* ``points3D.bin``: u64 count, then per point i64 id, 3×f64 xyz,
  3×u8 rgb, f64 reprojection error, u64 track length, then
  (i32 image id, i32 point2D idx) each.
* Pose convention: x_cam = R(qvec)·x_world + tvec with OpenCV axes
  (+Z forward, +Y down).  models.camera.Camera is OpenGL camera-to-
  world (−Z forward, +Y up), so R_c2w = Rᵀ·diag(1,−1,−1) and
  position = −Rᵀ·t.
* Principal-point offsets and distortion are not modeled by the
  render pipeline (the reference's projection has neither,
  its src/GaussianRender.cu:234-259); only the pinhole
  models are accepted, like graphdeco-inria/gaussian-splatting.

Everything is stdlib + numpy; image decoding uses utils.png for PNGs
and PIL (if present, imported only for other files) for anything else.
"""

from __future__ import annotations

import math
import struct
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from .models.camera import Camera, quat_from_matrix, quat_to_matrix

# model id -> (name, param count); params orders per COLMAP docs.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),   # f, cx, cy
    1: ("PINHOLE", 4),          # fx, fy, cx, cy
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
_PINHOLE_MODELS = ("SIMPLE_PINHOLE", "PINHOLE")


class ColmapCamera(NamedTuple):
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # f64 [num_params]


class ColmapImage(NamedTuple):
    image_id: int
    qvec: np.ndarray  # f64 [4] (w, x, y, z), world-to-camera
    tvec: np.ndarray  # f64 [3], world-to-camera
    camera_id: int
    name: str


class ColmapModel(NamedTuple):
    cameras: Dict[int, ColmapCamera]
    images: List[ColmapImage]
    points_xyz: np.ndarray  # f32 [N, 3]
    points_rgb: np.ndarray  # f32 [N, 3] in [0, 1]


class ColmapError(ValueError):
    pass


# ---------------------------------------------------------------- binary IO


def _read(f, fmt: str):
    size = struct.calcsize("<" + fmt)  # "<": no native alignment padding
    data = f.read(size)
    if len(data) != size:
        raise ColmapError("unexpected end of file")
    return struct.unpack("<" + fmt, data)


def read_cameras_bin(path) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    with open(path, "rb") as f:
        (count,) = _read(f, "Q")
        for _ in range(count):
            cid, model_id, width, height = _read(f, "iiQQ")
            if model_id not in CAMERA_MODELS:
                raise ColmapError(f"unknown camera model id {model_id}")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, "d" * n_params), np.float64)
            cams[cid] = ColmapCamera(cid, name, int(width), int(height),
                                     params)
    if not cams:
        raise ColmapError(f"{path}: no cameras")
    return cams


def read_images_bin(path) -> List[ColmapImage]:
    images: List[ColmapImage] = []
    with open(path, "rb") as f:
        (count,) = _read(f, "Q")
        for _ in range(count):
            (iid,) = _read(f, "i")
            qvec = np.array(_read(f, "dddd"), np.float64)
            tvec = np.array(_read(f, "ddd"), np.float64)
            (cid,) = _read(f, "i")
            chars = bytearray()
            while True:
                c = f.read(1)
                if not c:
                    raise ColmapError("unexpected end of file in name")
                if c == b"\x00":
                    break
                chars.extend(c)
            (n2d,) = _read(f, "Q")
            f.seek(24 * n2d, 1)  # (x f64, y f64, point3D id i64) each
            images.append(ColmapImage(iid, qvec, tvec, cid,
                                      chars.decode("utf-8")))
    if not images:
        raise ColmapError(f"{path}: no registered images")
    return images


def read_points3d_bin(path) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        (count,) = _read(f, "Q")
        for _ in range(count):
            rec = _read(f, "qdddBBBdQ")
            xyzs.append(rec[1:4])
            rgbs.append(rec[4:7])
            track_len = rec[8]
            f.seek(8 * track_len, 1)  # (image id i32, p2d idx i32) each
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


def write_cameras_bin(path, cameras: Sequence[ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cameras)))
        for c in cameras:
            mid = _MODEL_IDS[c.model]
            n = CAMERA_MODELS[mid][1]
            if len(c.params) != n:
                raise ColmapError(
                    f"{c.model} takes {n} params, got {len(c.params)}")
            f.write(struct.pack("<iiQQ", c.camera_id, mid, c.width,
                                c.height))
            f.write(struct.pack("<" + "d" * n, *map(float, c.params)))


def write_images_bin(path, images: Sequence[ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im.image_id))
            f.write(struct.pack("<dddd", *map(float, im.qvec)))
            f.write(struct.pack("<ddd", *map(float, im.tvec)))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))  # no 2D observations


def write_points3d_bin(path, xyz: np.ndarray, rgb: np.ndarray) -> None:
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    rgb8 = np.clip(np.asarray(rgb, np.float64).reshape(-1, 3) * 255.0
                   + 0.5, 0, 255).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", xyz.shape[0]))
        for i in range(xyz.shape[0]):
            f.write(struct.pack("<qdddBBBdQ", i + 1, *xyz[i], *rgb8[i],
                                0.0, 0))


# ------------------------------------------------------------------ text IO


def _data_lines(path):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def read_cameras_txt(path) -> Dict[int, ColmapCamera]:
    cams: Dict[int, ColmapCamera] = {}
    for line in _data_lines(path):
        parts = line.split()
        cid, model = int(parts[0]), parts[1]
        if model not in _MODEL_IDS:
            raise ColmapError(f"unknown camera model {model!r}")
        n = CAMERA_MODELS[_MODEL_IDS[model]][1]
        params = np.array([float(x) for x in parts[4:4 + n]], np.float64)
        if len(params) != n:
            raise ColmapError(f"{model} takes {n} params, got "
                              f"{len(parts) - 4}")
        cams[cid] = ColmapCamera(cid, model, int(parts[2]), int(parts[3]),
                                 params)
    if not cams:
        raise ColmapError(f"{path}: no cameras")
    return cams


def read_images_txt(path) -> List[ColmapImage]:
    images: List[ColmapImage] = []
    expect_pose = True
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if line.startswith("#"):
                continue
            if not expect_pose:
                expect_pose = True  # 2D-observations line (may be empty)
                continue
            if not line:
                continue
            parts = line.split()
            images.append(ColmapImage(
                int(parts[0]),
                np.array([float(x) for x in parts[1:5]], np.float64),
                np.array([float(x) for x in parts[5:8]], np.float64),
                int(parts[8]),
                # Names may contain spaces (COLMAP keeps originals);
                # the 9 pose fields are fixed, the rest is the name.
                " ".join(parts[9:]),
            ))
            expect_pose = False
    if not images:
        raise ColmapError(f"{path}: no registered images")
    return images


def read_points3d_txt(path) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    for line in _data_lines(path):
        parts = line.split()
        xyzs.append([float(x) for x in parts[1:4]])
        rgbs.append([float(x) for x in parts[4:7]])
    xyz = np.asarray(xyzs, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgbs, np.float32).reshape(-1, 3) / 255.0
    return xyz, rgb


# ------------------------------------------------------------- model lookup


def find_sparse_dir(path) -> Optional[Path]:
    """Locate a COLMAP sparse model under ``path``: the directory itself,
    ``sparse/0`` (standard workspace), or ``sparse``."""
    p = Path(path)
    for cand in (p, p / "sparse" / "0", p / "sparse"):
        if (cand / "cameras.bin").exists() or (cand / "cameras.txt").exists():
            return cand
    return None


def load_model(path) -> ColmapModel:
    """Read a sparse model (binary preferred over text, like COLMAP)."""
    sparse = find_sparse_dir(path)
    if sparse is None:
        raise ColmapError(f"no COLMAP sparse model under {path}")
    if (sparse / "cameras.bin").exists():
        cams = read_cameras_bin(sparse / "cameras.bin")
        images = read_images_bin(sparse / "images.bin")
        pts = sparse / "points3D.bin"
        xyz, rgb = (read_points3d_bin(pts) if pts.exists()
                    else (np.zeros((0, 3), np.float32),) * 2)
    else:
        cams = read_cameras_txt(sparse / "cameras.txt")
        images = read_images_txt(sparse / "images.txt")
        pts = sparse / "points3D.txt"
        xyz, rgb = (read_points3d_txt(pts) if pts.exists()
                    else (np.zeros((0, 3), np.float32),) * 2)
    return ColmapModel(cams, sorted(images, key=lambda im: im.name),
                       xyz, rgb)


# ------------------------------------------------------------ pose convert


def qvec_to_rotmat(qvec: np.ndarray) -> np.ndarray:
    """COLMAP (w, x, y, z) quaternion -> world-to-camera rotation.
    models.camera shares the (w, x, y, z) component order."""
    return quat_to_matrix(np.asarray(qvec, np.float64)).astype(np.float64)


def pose_to_camera(img: ColmapImage, cam: ColmapCamera) -> Camera:
    """COLMAP world-to-camera pose (OpenCV axes) -> Camera (OpenGL
    camera-to-world).  Focal length -> vertical fov; principal-point
    offset and distortion are ignored (pinhole models only)."""
    if cam.model not in _PINHOLE_MODELS:
        raise ColmapError(
            f"camera model {cam.model} not supported — undistort with "
            f"`colmap image_undistorter` to PINHOLE first")
    r_w2c = qvec_to_rotmat(img.qvec)
    position = -r_w2c.T @ np.asarray(img.tvec, np.float64)
    # OpenCV c2w -> OpenGL c2w: flip the camera-local Y and Z axes.
    r_c2w_gl = r_w2c.T @ np.diag([1.0, -1.0, -1.0])
    if cam.model == "SIMPLE_PINHOLE":
        fx = fy = float(cam.params[0])
    else:
        fx, fy = float(cam.params[0]), float(cam.params[1])
    fov_y = 2.0 * math.atan(cam.height / (2.0 * fy))
    # The pipeline derives cot_x = cot_y / aspect; for it to equal
    # 2*fx/w under non-square pixels, aspect = (w*fy) / (h*fx).
    return Camera(
        position=position.astype(np.float32),
        rotation=quat_from_matrix(r_c2w_gl.astype(np.float32)),
        fov_y=fov_y,
        aspect=(cam.width * fy) / (cam.height * fx),
    )


def camera_to_pose(camera: Camera) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of pose_to_camera: Camera -> COLMAP (qvec, tvec)."""
    r_c2w_gl = quat_to_matrix(camera.rotation).astype(np.float64)
    r_w2c = (r_c2w_gl @ np.diag([1.0, -1.0, -1.0])).T
    tvec = -r_w2c @ np.asarray(camera.position, np.float64)
    qvec = quat_from_matrix(r_w2c.astype(np.float32)).astype(np.float64)
    return qvec, tvec


# ----------------------------------------------------------- image loading


def _read_image(path: Path) -> np.ndarray:
    """Decode an image to uint8 [H, W, C]; PNGs via the in-tree decoder,
    anything else (JPEG etc.) via PIL when available."""
    if path.suffix.lower() == ".png":
        from .utils.png import read_png

        img = read_png(path)
        return img[:, :, None] if img.ndim == 2 else img
    try:
        from PIL import Image
    except ImportError as e:
        raise ColmapError(
            f"{path.suffix} images need PIL, which is unavailable; "
            f"convert the dataset to PNG") from e
    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA", "L"):
            im = im.convert("RGB")
        arr = np.asarray(im)
        return arr[:, :, None] if arr.ndim == 2 else arr


def _resize(img: np.ndarray, factor: int) -> np.ndarray:
    """Integer block-average when divisible (matches dataset._downscale),
    PIL Lanczos otherwise (real captures are rarely factor-aligned)."""
    if factor == 1:
        return img.astype(np.float32)
    h, w = img.shape[:2]
    if h % factor == 0 and w % factor == 0:
        blocks = img.reshape(h // factor, factor, w // factor, factor,
                             img.shape[2])
        return blocks.astype(np.float32).mean(axis=(1, 3))
    from PIL import Image

    # PIL wants 2D arrays for single-channel images.
    im = Image.fromarray(img[:, :, 0] if img.shape[2] == 1 else img)
    im = im.resize(
        (max(1, round(w / factor)), max(1, round(h / factor))),
        Image.LANCZOS)
    out = np.asarray(im).astype(np.float32)
    return out[:, :, None] if out.ndim == 2 else out


def load_dataset(
    path,
    *,
    downscale: int = 1,
    background: Optional[Tuple[float, float, float]] = None,
    max_frames: int = 0,
    images_dir: Optional[str] = None,
) -> Tuple[List[Camera], np.ndarray, np.ndarray, np.ndarray, List[str]]:
    """Load a COLMAP workspace for fitting.

    Returns (cameras, images [N, H, W, 3] f32 in [0, 1], points_xyz
    [P, 3], points_rgb [P, 3], names) — the point cloud feeds
    diff.init_from_points; ``names`` are the model's image file names
    (for re-exporting refined poses).  ``images_dir`` overrides the
    image root
    (default: ``images`` next to ``sparse``, falling back to the
    workspace root).  All frames must share one resolution after
    ``downscale`` (the fit batches them into a single array).
    """
    root = Path(path)
    model = load_model(root)
    images = model.images
    if max_frames > 0:
        images = images[:max_frames]
    bg = (np.zeros(3, np.float32) if background is None
          else np.asarray(background, np.float32))
    roots = ([root / images_dir] if images_dir
             else [root / "images", root])
    cameras: List[Camera] = []
    frames = []
    shape = None
    for im in images:
        if im.camera_id not in model.cameras:
            raise ColmapError(f"image {im.name}: unknown camera id "
                              f"{im.camera_id}")
        cam = model.cameras[im.camera_id]
        fpath = next((r / im.name for r in roots if (r / im.name).exists()),
                     None)
        if fpath is None:
            raise ColmapError(
                f"image file {im.name} not found under "
                f"{' or '.join(str(r) for r in roots)}")
        imgf = _resize(_read_image(fpath), downscale) / 255.0
        if imgf.ndim == 2:
            imgf = imgf[:, :, None]
        if imgf.shape[2] == 1:
            imgf = np.repeat(imgf, 3, axis=2)
        if imgf.shape[2] == 4:
            a = imgf[..., 3:4]
            imgf = imgf[..., :3] * a + bg * (1.0 - a)
        else:
            imgf = imgf[..., :3]
        if shape is None:
            shape = imgf.shape
        elif imgf.shape != shape:
            raise ColmapError(
                f"{im.name}: image shape {imgf.shape} != first frame "
                f"{shape} — mixed-resolution rigs need --downscale or a "
                f"pre-resized images dir")
        cameras.append(pose_to_camera(im, cam))
        frames.append(np.ascontiguousarray(imgf, np.float32))
    return (cameras, np.stack(frames), model.points_xyz,
            model.points_rgb, [im.name for im in images])


def export_model(
    out_dir,
    cameras: Sequence[Camera],
    image_names: Sequence[str],
    width: int,
    height: int,
    points_xyz: Optional[np.ndarray] = None,
    points_rgb: Optional[np.ndarray] = None,
) -> Path:
    """Write a binary sparse model (``out_dir/sparse/0``) for
    ``cameras`` — one shared PINHOLE intrinsic from the first camera.
    The round-trip partner of load_dataset for tests and interop."""
    if len(cameras) != len(image_names):
        raise ColmapError("one image name per camera required")
    if not cameras:
        raise ColmapError("empty camera list")
    sparse = Path(out_dir) / "sparse" / "0"
    sparse.mkdir(parents=True, exist_ok=True)
    fy = height / (2.0 * math.tan(cameras[0].fov_y * 0.5))
    # tan(fov_x/2) = tan(fov_y/2) * aspect  =>  fx = w / (2 tan(fov_x/2))
    fx = fy * width / (cameras[0].aspect * height)
    intr = ColmapCamera(1, "PINHOLE", width, height,
                        np.array([fx, fy, width / 2.0, height / 2.0]))
    write_cameras_bin(sparse / "cameras.bin", [intr])
    imgs = []
    for i, (cam, name) in enumerate(zip(cameras, image_names)):
        qvec, tvec = camera_to_pose(cam)
        imgs.append(ColmapImage(i + 1, qvec, tvec, 1, str(name)))
    write_images_bin(sparse / "images.bin", imgs)
    if points_xyz is None:
        points_xyz = np.zeros((0, 3), np.float32)
        points_rgb = np.zeros((0, 3), np.float32)
    write_points3d_bin(sparse / "points3D.bin", points_xyz, points_rgb)
    return sparse
