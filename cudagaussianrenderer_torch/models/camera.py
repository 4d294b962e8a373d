"""Camera model and headless controls.

Ports the *math* of the reference's CameraControls
(the CUDA reference's CameraControls.{h,cpp}) — perspective projection,
view = inverse(T * R), scene auto-framing, pointer ray casting, the
drag/orbit/pan state machine — decoupled from GLFW.  Input arrives as a
plain ``InputState`` so the controller is drivable headlessly (scripted
paths, tests) or from any windowing layer.

Also builds the per-frame ``CameraData`` dict of NumPy arrays consumed by
the render pipeline (``render.camera_tensors`` moves it to the device): the view matrix, camera position, the para-perspective fov
cotangents and the linear depth scale/bias mapping view-space
[-near, -far] onto clip depth [-1, 1] (Demo.cpp:376-392).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from ..config import DEFAULT_FAR, DEFAULT_FOV_Y_DEG, DEFAULT_NEAR

UP = np.array([0.0, 1.0, 0.0], np.float32)
RIGHT = np.array([1.0, 0.0, 0.0], np.float32)
BACK = np.array([0.0, 0.0, 1.0], np.float32)


# ---------------------------------------------------------------------------
# Quaternion helpers (w, x, y, z convention, host-side numpy)
# ---------------------------------------------------------------------------

def quat_identity() -> np.ndarray:
    return np.array([1.0, 0.0, 0.0, 0.0], np.float32)


def quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        np.float32,
    )


def quat_from_axis_angle(axis: np.ndarray, angle: float) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    axis = axis / np.linalg.norm(axis)
    h = 0.5 * angle
    return np.concatenate([[np.cos(h)], np.sin(h) * axis]).astype(np.float32)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix from a unit quaternion (w, x, y, z)."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


def quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Unit quaternion (w, x, y, z) from a rotation matrix."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z], np.float32)
    return q / np.linalg.norm(q)


def quat_look_at(forward: np.ndarray, up: np.ndarray = UP) -> np.ndarray:
    """Rotation whose local -Z axis points along ``forward``
    (glm::quatLookAt convention, CameraControls.cpp:143)."""
    f = np.asarray(forward, np.float32)
    f = f / np.linalg.norm(f)
    back = -f
    right = np.cross(up, back)
    nr = np.linalg.norm(right)
    if nr < 1e-8:  # forward parallel to up
        right = RIGHT
    else:
        right = right / nr
    true_up = np.cross(back, right)
    m = np.stack([right, true_up, back], axis=1)  # columns = basis vectors
    return quat_from_matrix(m)


def _project_on_plane(v: np.ndarray, n: np.ndarray) -> np.ndarray:
    # Reference quirk kept intact: projectOnPlane subtracts the *scalar*
    # dot(n, v) rather than dot(n, v) * n (CameraControls.cpp:20-23).
    # With n = (0,1,0) or another axis this coincides with the intended
    # projection only by accident of usage in removeRoll; we reproduce the
    # mathematically-correct projection, which matches observable behavior
    # for the axis-aligned vectors removeRoll feeds it.
    return v - np.dot(n, v) * n


def remove_roll(q: np.ndarray) -> np.ndarray:
    """Re-orthogonalize a rotation so its right axis stays horizontal
    (CameraControls.cpp:29-41)."""
    m = quat_to_matrix(q)
    right, up_v, _fwd = m[:, 0], m[:, 1], m[:, 2]
    right = _project_on_plane(right, UP)
    right = right / np.linalg.norm(right)
    up_v = up_v - np.dot(up_v, right) * right
    up_v = up_v / np.linalg.norm(up_v)
    forward = np.cross(right, up_v)
    return quat_from_matrix(np.stack([right, up_v, forward], axis=1))


def ray_plane_intersection(
    origin: np.ndarray, direction: np.ndarray, plane: np.ndarray
) -> Optional[float]:
    """t of ray/plane hit, or None if parallel (CameraControls.cpp:3-13)."""
    denom = float(np.dot(direction, plane[:3]))
    if denom == 0.0:
        return None
    return -(float(np.dot(origin, plane[:3])) + float(plane[3])) / denom


def make_plane(normal: np.ndarray, point: np.ndarray) -> np.ndarray:
    return np.concatenate([normal, [-float(np.dot(normal, point))]]).astype(np.float32)


# ---------------------------------------------------------------------------
# Camera
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Camera:
    """Perspective camera pose + intrinsics (host side).

    ``rotation`` is a (w, x, y, z) quaternion; the camera looks down its
    local -Z axis, matching the reference's right-handed convention.
    """

    position: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3, np.float32))
    rotation: np.ndarray = dataclasses.field(default_factory=quat_identity)
    fov_y: float = np.radians(DEFAULT_FOV_Y_DEG)
    near: float = DEFAULT_NEAR
    far: float = DEFAULT_FAR
    aspect: float = 1.0

    def view(self) -> np.ndarray:
        """World->view: inverse(translate(position) @ rot)
        (CameraControls.cpp:79-86)."""
        r = quat_to_matrix(self.rotation)
        v = np.eye(4, dtype=np.float32)
        v[:3, :3] = r.T
        v[:3, 3] = -r.T @ np.asarray(self.position, np.float32)
        return v

    def projection(self) -> np.ndarray:
        """OpenGL-style perspective matrix (glm::perspective,
        CameraControls.cpp:88-91)."""
        f = 1.0 / np.tan(self.fov_y * 0.5)
        n, fa = self.near, self.far
        p = np.zeros((4, 4), np.float32)
        p[0, 0] = f / self.aspect
        p[1, 1] = f
        p[2, 2] = -(fa + n) / (fa - n)
        p[2, 3] = -2.0 * fa * n / (fa - n)
        p[3, 2] = -1.0
        return p

    def view_projection(self) -> np.ndarray:
        return self.projection() @ self.view()

    def fov_cotangent(self) -> np.ndarray:
        """(cot_x, cot_y) of the half-fov (Demo.cpp:383-385)."""
        cot_y = 1.0 / np.tan(self.fov_y * 0.5)
        return np.array([cot_y / self.aspect, cot_y], np.float32)

    def depth_scale_bias(self) -> np.ndarray:
        """Linear view-Z -> clip-depth map: -near -> -1, -far -> +1
        (Demo.cpp:386-392)."""
        scale = -2.0 / (self.far - self.near)
        bias = -(self.far + self.near) / (self.far - self.near)
        return np.array([scale, bias], np.float32)

    def camera_data(self) -> dict:
        """The per-frame dict the pipeline consumes — the analog of the
        reference's CameraData constant struct (GaussianRender.cuh:17-26)."""
        return dict(
            view=self.view(),
            position=np.asarray(self.position, np.float32),
            fov_cotangent=self.fov_cotangent(),
            depth_scale_bias=self.depth_scale_bias(),
            aspect=np.float32(self.aspect),
        )

    def world_ray(self, pointer_px: np.ndarray, screen_size: np.ndarray):
        """Pointer position (pixels, y-down) -> world ray
        (CameraControls.cpp:98-113)."""
        vp_inv = np.linalg.inv(self.view_projection())
        clip = (np.asarray(pointer_px, np.float32) / screen_size) * 2.0 - 1.0
        clip[1] *= -1.0
        frm = vp_inv @ np.array([clip[0], clip[1], -1.0, 1.0], np.float32)
        to = vp_inv @ np.array([clip[0], clip[1], 1.0, 1.0], np.float32)
        frm = frm[:3] / frm[3]
        to = to[:3] / to[3]
        d = to - frm
        return frm, d / np.linalg.norm(d)

    def framed(self, bounds_min, bounds_max) -> "Camera":
        """Place the camera to view a scene AABB — setBounds
        (CameraControls.cpp:132-146)."""
        bmin = np.asarray(bounds_min, np.float32)
        bmax = np.asarray(bounds_max, np.float32)
        with np.errstate(invalid="ignore"):  # inf bounds -> NaN, guarded below
            size = bmax - bmin
            center = bmin + size * 0.5
        max_size = float(size.max())
        if not np.isfinite(max_size) or max_size <= 0.0:
            # Degenerate bounds (single-splat scene, or inf/NaN bounds):
            # view the center from unit distance instead of letting the
            # zero offset normalize to a NaN pose.
            max_size = 1.0
            center = np.where(np.isfinite(center), center, 0.0).astype(
                np.float32
            )
        offset = np.array([0.0, max_size * 0.5, max_size * 0.5], np.float32)
        offset /= np.linalg.norm(offset)
        dist = np.sqrt(2.0) * max_size * 0.5 / np.tan(self.fov_y * 0.5)
        return dataclasses.replace(
            self,
            position=center + offset * dist,
            rotation=quat_look_at(-offset, UP),
        )


# ---------------------------------------------------------------------------
# Headless interactive controls
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class InputState:
    """One frame of input, the headless stand-in for GLFW polling."""

    pointer: Tuple[float, float] = (0.0, 0.0)
    buttons: str = "none"  # "none" | "left" | "middle" | "right"
    # WASD+QE movement in camera-local axes (x right, y up, z back).
    move: Tuple[float, float, float] = (0.0, 0.0, 0.0)


class CameraController:
    """The reference's drag/orbit/pan state machine, headless
    (CameraControls.cpp:148-253).

    Left drag rotates in place; middle drag orbits the anchor point (the
    pointer ray's hit on the scene floor plane); right drag pans in the
    camera plane; WASD flies at a speed scaled to the scene size.
    """

    _MODES = {"none": "none", "left": "drag", "middle": "orbit", "right": "pan"}

    def __init__(self, screen_size: Tuple[float, float], camera: Optional[Camera] = None):
        self.screen_size = np.asarray(screen_size, np.float32)
        self.camera = camera or Camera(aspect=float(screen_size[0] / screen_size[1]))
        self.speed = 1.0
        self.mode = "none"
        self._buttons = "none"
        self._pointer_valid = False
        self._pointer = np.zeros(2, np.float32)
        self.anchor = np.zeros(3, np.float32)
        self.floor_plane = make_plane(UP, np.zeros(3, np.float32))
        self._pan_start: Optional[np.ndarray] = None

    def set_bounds(self, bounds_min, bounds_max) -> None:
        bmin = np.asarray(bounds_min, np.float32)
        bmax = np.asarray(bounds_max, np.float32)
        size = bmax - bmin
        center = bmin + size * 0.5
        self.speed = float(size.max()) * 0.02
        self.camera = self.camera.framed(bmin, bmax)
        self.floor_plane = make_plane(UP, center)
        self.anchor = center

    def update(self, inputs: InputState, dt: float) -> Camera:
        cam = self.camera
        if inputs.buttons != self._buttons:
            self.mode = self._MODES[inputs.buttons]
            if self.mode == "pan":
                self._pan_start = None
            self._buttons = inputs.buttons

        pointer = np.asarray(inputs.pointer, np.float32)
        origin, direction = cam.world_ray(pointer.copy(), self.screen_size)
        delta = pointer - self._pointer if self._pointer_valid else np.zeros(2, np.float32)
        self._pointer_valid = True

        fov = cam.fov_y
        if self.mode == "none":
            t = ray_plane_intersection(origin, direction, self.floor_plane)
            if t is not None:
                self.anchor = origin + direction * t
        elif self.mode == "drag":
            yaw_pitch = (
                np.array([fov * cam.aspect, fov], np.float32) * delta / self.screen_size
            )
            yaw = quat_from_axis_angle(UP, yaw_pitch[0])
            pitch = quat_from_axis_angle(RIGHT, yaw_pitch[1])
            cam = dataclasses.replace(
                cam, rotation=remove_roll(quat_mul(quat_mul(cam.rotation, yaw), pitch))
            )
        elif self.mode == "orbit":
            yaw_pitch = (
                np.array([fov * cam.aspect, fov], np.float32) * delta / self.screen_size
            )
            right = quat_to_matrix(cam.rotation) @ RIGHT
            pitch_rot = quat_from_axis_angle(right, -yaw_pitch[1])
            yaw_rot = quat_from_axis_angle(UP, -yaw_pitch[0])
            delta_rot = quat_mul(yaw_rot, pitch_rot)
            rotation = remove_roll(quat_mul(delta_rot, cam.rotation))
            anchor_to_cam = quat_to_matrix(delta_rot) @ (cam.position - self.anchor)
            cam = dataclasses.replace(
                cam, rotation=rotation, position=self.anchor + anchor_to_cam
            )
        elif self.mode == "pan":
            plane = make_plane(quat_to_matrix(cam.rotation) @ BACK, self.anchor)
            t = ray_plane_intersection(origin, direction, plane)
            if t is not None:
                hit = origin + direction * t
                if self._pan_start is not None:
                    cam = dataclasses.replace(cam, position=cam.position - (hit - self._pan_start))
                else:
                    self._pan_start = hit

        move = np.asarray(inputs.move, np.float32) * self.speed
        cam = dataclasses.replace(
            cam, position=cam.position + quat_to_matrix(cam.rotation) @ (move * dt)
        )
        self._pointer = pointer
        self.camera = cam
        return cam


# ---------------------------------------------------------------------------
# Scripted camera paths (for benchmarks / fly-throughs)
# ---------------------------------------------------------------------------

def orbit_cameras(
    bounds_min,
    bounds_max,
    num_frames: int,
    *,
    fov_y: float = np.radians(DEFAULT_FOV_Y_DEG),
    aspect: float = 1.0,
    elevation: float = 0.5,
) -> list:
    """A circle of cameras orbiting the scene AABB center, each framed like
    ``Camera.framed`` but swept around the up axis."""
    bmin = np.asarray(bounds_min, np.float32)
    bmax = np.asarray(bounds_max, np.float32)
    size = bmax - bmin
    center = bmin + size * 0.5
    max_size = float(size.max())
    dist = np.sqrt(2.0) * max_size * 0.5 / np.tan(fov_y * 0.5)
    cams = []
    for i in range(num_frames):
        theta = 2.0 * np.pi * i / max(1, num_frames)
        offset = np.array(
            [np.sin(theta), elevation, np.cos(theta)], np.float32
        )
        offset /= np.linalg.norm(offset)
        cams.append(
            Camera(
                position=center + offset * dist,
                rotation=quat_look_at(-offset, UP),
                fov_y=fov_y,
                aspect=aspect,
            )
        )
    return cams
