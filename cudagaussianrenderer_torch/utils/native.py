"""ctypes binding of the native C++ scene loader (native/libgsply.so).

The port's own binding of the repository's host-side .ply parser
(native/src/gsply.cc, shared with the JAX package, which binds it in its
utils/native.py): it streams a file and transforms it into the planar
layout in one pass, and ply.load_gaussian_ply falls back to the
pure-Python importer when the library is absent.  The library is built
with ``make -C native`` at first use (tried once a process, under a file
lock, so that parallel test workers do not build it over one another).
"""

from __future__ import annotations

import ctypes
import fcntl
import pathlib
import subprocess
from typing import Optional

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_LIB_PATH = _NATIVE_DIR / "libgsply.so"

_lib = None
_build_attempted = False


class _GsplyScene(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_long),
        ("sh_degree", ctypes.c_int),
        ("sh_coeffs", ctypes.c_int),
        ("means", ctypes.POINTER(ctypes.c_float)),
        ("scales", ctypes.POINTER(ctypes.c_float)),
        ("quats", ctypes.POINTER(ctypes.c_uint32)),
        ("opacities", ctypes.POINTER(ctypes.c_float)),
        ("colors", ctypes.POINTER(ctypes.c_float)),
        ("sh", ctypes.POINTER(ctypes.c_float)),
        ("bounds_min", ctypes.c_float * 3),
        ("bounds_max", ctypes.c_float * 3),
        ("error", ctypes.c_char * 256),
    ]


def _build() -> None:
    """``make -C native``, once a process; the Makefile's lock keeps a
    second process from building while the first one does."""
    global _build_attempted
    _build_attempted = True
    try:
        with open(_NATIVE_DIR / "Makefile", "rb") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            if not _LIB_PATH.exists():
                subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                               capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        pass


def _load_library():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and not _build_attempted:
        _build()
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.gsply_load.argtypes = [ctypes.c_char_p, ctypes.POINTER(_GsplyScene)]
    lib.gsply_load.restype = ctypes.c_int
    lib.gsply_release.argtypes = [ctypes.POINTER(_GsplyScene)]
    lib.gsply_release.restype = None
    _lib = lib
    return lib


def native_available() -> bool:
    return _load_library() is not None


def load_scene_native(path) -> Optional[dict]:
    """Load a .ply via the native library.

    Returns a dict of numpy arrays in the planar layout (``means``,
    ``scales``, ``colors`` [3, N], ``quats`` [N] uint32, ``opacities``
    [N], ``sh`` [3, K, N] or None, ``sh_degree``, ``bounds_min``,
    ``bounds_max``), or None when the library is unavailable.  Raises
    ValueError on parse errors, with the Python importer's messages.
    """
    lib = _load_library()
    if lib is None:
        return None
    raw = _GsplyScene()
    rc = lib.gsply_load(str(path).encode(), ctypes.byref(raw))
    if rc != 0:
        raise ValueError(raw.error.decode(errors="replace"))
    try:
        n = raw.count
        k = raw.sh_coeffs

        def arr(ptr, shape):
            return np.ctypeslib.as_array(ptr, shape=shape).copy()

        return dict(
            means=arr(raw.means, (3, n)),
            scales=arr(raw.scales, (3, n)),
            quats=arr(raw.quats, (n,)),
            opacities=arr(raw.opacities, (n,)),
            colors=arr(raw.colors, (3, n)),
            sh=arr(raw.sh, (3, k, n)) if raw.sh_degree > 0 else None,
            sh_degree=raw.sh_degree,
            bounds_min=tuple(raw.bounds_min),
            bounds_max=tuple(raw.bounds_max),
        )
    finally:
        lib.gsply_release(ctypes.byref(raw))
