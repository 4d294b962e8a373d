"""Multi-device rendering and data-parallel fitting over torch.distributed.

``launch.spawn`` starts one process a card (NCCL; gloo on the CPU) and
``distributed.make_mesh``/``make_mesh_2d`` name the ranks' axes; then
``DistributedRenderer`` renders tile-row-sharded frames (and batches,
frame-parallel on a 2-D mesh) and ``train.fit_dp`` fits with one view a
rank.  ``distributed.render_band`` is one rank's band of a balanced frame
on one device, with no process group.
"""

from .distributed import (
    DistributedRenderer,
    Mesh,
    make_mesh,
    make_mesh_2d,
    render_band,
    render_frame_sharded,
    render_frames_sharded,
    render_frames_tilesharded,
    shard_scene,
    stack_cameras,
)
from .launch import init_rank, spawn
from .train import fit_dp, make_train_step_dp, view_batch

__all__ = [
    "DistributedRenderer",
    "Mesh",
    "fit_dp",
    "init_rank",
    "make_mesh",
    "make_mesh_2d",
    "make_train_step_dp",
    "render_band",
    "render_frame_sharded",
    "render_frames_sharded",
    "render_frames_tilesharded",
    "shard_scene",
    "spawn",
    "stack_cameras",
    "view_batch",
]
