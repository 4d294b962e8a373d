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
``device="cpu"`` to run on the CPU.  On the card ``Renderer.render``
replays one CUDA graph of the frame per capacity key, as the JAX
``Renderer`` reuses one jitted frame per key.

Scenes come from a trained 3DGS ``.ply`` (``load_gaussian_ply``, through
the native loader in native/ when it builds), an antimatter15 ``.splat``
(``splatfile``; ``load_scene`` picks by extension) or ``random_scene``;
``scene_ops`` edits them and ``utils.png`` writes frames.  Posed-image
datasets (a NeRF-synthetic ``transforms.json`` or a COLMAP workspace) load
with ``load_posed`` (``dataset``, ``colmap``); ``diff.ssim`` scores frames
against them.

The differentiable path (``diff``): ``render_diff`` renders a frame as a
function of unconstrained splat parameters (``DiffSplats``, from
``from_scene``, ``random_init`` or ``init_from_points``) that autograd
differentiates; its pair structure comes from kernels K1-K3 under
``torch.no_grad()``.  ``fit`` trains them against posed images (the 3DGS
recipe: Adam or ``diff.tx_3dgs``, density control, pose and exposure
refinement), with ``save_checkpoint``/``load_checkpoint`` in the JAX
package's ``.npz`` layout and ``to_scene`` back to a renderable scene.

The command line is ``python -m cudagaussianrenderer_torch.cli`` (or
``gsplat-torch``), the JAX package's CLI: ``render``, ``orbit``,
``bench``, ``interactive``, ``serve`` (``viewer``: the live viewer, an HTTP
server whose loop thread renders on the card), ``convert``, ``merge``,
``eval``, ``compare`` and ``fit`` (``render --depth`` writes the expected
depth map of the differentiable path), each with ``--device {cuda,cpu}``.

The JAX repository's ``__graft_entry__.py`` is ``graft_entry``: ``entry()`` gives
one capturable frame's function and its example arguments, and
``dryrun_multichip(n)`` checks a sharded frame and a data-parallel step on
n ranks (``python -m cudagaussianrenderer_torch.graft_entry [multichip
N]``).

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
from .diff import (
    DiffSplats,
    fit,
    from_scene,
    init_from_points,
    load_checkpoint,
    random_init,
    render_diff,
    save_checkpoint,
    to_scene,
)
from .models.camera import Camera, CameraController, InputState, orbit_cameras
from .models.scene import GaussianScene, random_scene, scene_from_arrays, scene_from_numpy
from .ply import load_gaussian_ply, write_gaussian_ply
from .render import Renderer, render_frame, render_frame_multipass
from .splatfile import load_scene

__all__ = [
    "Camera",
    "CameraController",
    "DiffSplats",
    "GaussianScene",
    "InputState",
    "RenderConfig",
    "Renderer",
    "fit",
    "from_scene",
    "init_from_points",
    "load_checkpoint",
    "load_gaussian_ply",
    "load_posed",
    "load_scene",
    "orbit_cameras",
    "random_init",
    "random_scene",
    "render_diff",
    "render_frame",
    "render_frame_multipass",
    "save_checkpoint",
    "scene_from_arrays",
    "scene_from_numpy",
    "to_scene",
    "write_gaussian_ply",
]

__version__ = "0.1.0"
