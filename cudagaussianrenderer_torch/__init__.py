"""cudagaussianrenderer_torch — the Gaussian-splat renderer on PyTorch and CUDA.

The port of ``cudagaussianrenderer_tpu`` to one NVIDIA Hopper card.  The
stage functions keep the JAX package's names, planar layouts and outputs;
its eight Pallas kernels become CUDA C++ kernels under ``csrc/`` (built
with nvcc at first use, see utils/cuda_build.py).  The default frame:

  K1 csrc/edges.cu       ops.ranges.tile_edges        tile ranges
  K2 csrc/interleave.cu  ops.expand.interleave_rows   emit row array
  K3 csrc/emit.cu        ops.expand.emit_slots        pair-list emission
  K4 csrc/raster.cu      ops.raster.rasterize_tiles   tile blending

The banded frame (``RenderConfig(sort_bands=G)``), besides K1 and K4:

  K5 csrc/interleave.cu  ops.banded.interleave_rows_padded  source row array
  K6 csrc/stack.cu       ops.banded.stack_rows              prefix row array
  K7 csrc/compact.cu     ops.banded.compact_rows            band compaction
  K8 csrc/emit.cu        ops.expand.emit_slots_banded       banded emission

Each wrapper runs its kernel for CUDA tensors and its plain PyTorch
version for CPU tensors.  Entry points default to the card; pass
``device="cpu"`` to run on the CPU.

Scenes come from a trained 3DGS ``.ply`` (``load_gaussian_ply``, through
the native loader in native/ when it builds), an antimatter15 ``.splat``
(``splatfile``; ``load_scene`` picks by extension) or ``random_scene``;
``scene_ops`` edits them and ``utils.png`` writes frames.  Posed-image
datasets (a NeRF-synthetic ``transforms.json`` or a COLMAP workspace) load
with ``load_posed`` (``dataset``, ``colmap``); ``diff.ssim`` scores frames
against them.

The command line is ``python -m cudagaussianrenderer_torch.cli`` (or
``gsplat-torch``), the JAX package's CLI: ``render``, ``orbit``,
``bench``, ``interactive``, ``serve`` (``viewer``: the live viewer, an HTTP
server whose loop thread renders on the card), ``convert``, ``merge``,
``eval`` and ``compare``, each with ``--device {cuda,cpu}``.  ``fit`` and
``render --depth`` wait for the differentiable path.

The bench, ``python -m cudagaussianrenderer_torch.bench``, replays one
frame captured as a CUDA graph for each orbit camera (``render_frame_tensors``
is the frame's device part).  Quick start::

    from cudagaussianrenderer_torch import Camera, RenderConfig, Renderer, load_scene
    scene = load_scene("scene.ply")
    cam = Camera(aspect=1.0).framed(scene.bounds_min, scene.bounds_max)
    image = Renderer(scene, RenderConfig()).render(cam)  # [1024,1024,4] u8
"""

from .config import RenderConfig
from .dataset import load_posed
from .models.camera import Camera, CameraController, InputState, orbit_cameras
from .models.scene import GaussianScene, random_scene, scene_from_arrays, scene_from_numpy
from .ply import load_gaussian_ply, write_gaussian_ply
from .render import Renderer, render_frame, render_frame_multipass
from .splatfile import load_scene

__all__ = [
    "Camera",
    "CameraController",
    "GaussianScene",
    "InputState",
    "RenderConfig",
    "Renderer",
    "load_gaussian_ply",
    "load_posed",
    "load_scene",
    "orbit_cameras",
    "random_scene",
    "render_frame",
    "render_frame_multipass",
    "scene_from_arrays",
    "scene_from_numpy",
    "write_gaussian_ply",
]

__version__ = "0.1.0"
