"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so each build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/lib<name>-<hash>.so csrc/<name>.cu

``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them; ``kernel`` returns one exported C function with its ctypes
signature, building first if needed.  Libraries go to ``_build/`` beside
this package's sources (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited kernel is never served from a stale
library.  Each C entry point launches on the stream it is given and
returns ``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

SOURCES = ("edges", "interleave", "emit", "raster", "stack", "compact", "stamp", "splat", "sort")
BASE_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)
# The emit kernel must round every float op of its packers separately, as
# the JAX package and the plain PyTorch version do: no contraction into
# fused multiply-adds.  So must the per-splat kernel, whose columns equal
# the plain path's bit for bit.
EXTRA_FLAGS = {"emit": ("--fmad=false",), "splat": ("--fmad=false",)}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def flags(name: str):
    """The nvcc flags of kernel source ``name``."""
    return BASE_FLAGS + EXTRA_FLAGS.get(name, ())


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    h.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> Dict[str, dict]:
    """Compile every kernel source not yet built, in parallel.

    Returns {name: {"seconds": wall time or 0.0 when cached, "log": the
    compiler's output (ptxas register and shared-memory report)}}.
    Raises with the compiler's output when any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    result = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        out = _lib_path(name)
        if out.exists():
            result[name] = {"seconds": 0.0, "log": "cached"}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *flags(name), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            out,
        )
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return result


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    path = _lib_path(name)
    if not path.exists():
        build_all()
    lib = ctypes.CDLL(str(path))
    lib.gsr_error_string.argtypes = [ctypes.c_int]
    lib.gsr_error_string.restype = ctypes.c_char_p
    return lib


def kernel(name: str, symbol: str, argtypes):
    """The exported C function ``symbol`` of kernel library ``name``, with
    its ctypes signature set (every entry point returns an int error)."""
    fn = getattr(_library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = _library(name).gsr_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({code})")


def stream_handle(t: torch.Tensor) -> int:
    """The current PyTorch stream on ``t``'s device, as a raw handle."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype, device, shape=None) -> None:
    """Validate a kernel argument: device, dtype, contiguity, shape."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def dispatch_device(t: torch.Tensor) -> str:
    """'cpu' or 'cuda' for a kernel wrapper's input; anything else raises."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


P = ctypes.c_void_p
I32 = ctypes.c_int
I64 = ctypes.c_longlong
F32 = ctypes.c_float
