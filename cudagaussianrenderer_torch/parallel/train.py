"""Data-parallel fitting over torch.distributed: one view a rank.

3DGS training is data-parallel over views: each rank renders and
differentiates its own camera against its own target image, and one
all-reduce of the gradients turns the ranks' views into one step of a
replicated optimizer.  The splat model is small next to a view's
activations, so parameters and optimizer state are replicated whole; the
pair structure, the k_max gather and the blend stay on their rank.

The step's loss is diff.fit's (diff.view_loss: render_diff, then L2, L1
and D-SSIM); its one collective is an all-reduce (SUM) of one flat buffer
holding every gradient leaf and the loss, divided by the rank count.  On
the card the step is compiled as the JAX package jits it: DPStepGraphs,
two CUDA graphs a step with the all-reduce inside the second.
diff.fit stays the path with density control, pose and exposure
refinement and checkpoints; fit_dp is the throughput path for many views
on many cards.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderConfig
from ..diff import (
    Adam, DiffSplats, GraphedStep, apply_updates, loss_grads, target_tensor, tree_leaves,
    tree_map, tree_unflatten, view_loss,
)
from ..render import CAMERA_FLOATS, camera_array, camera_views
from .distributed import SHARDED_CAPTURE_MODE, Mesh


def view_batch(cameras_data, targets, device=None):
    """Camera.camera_data() dicts and their target images ([H, W, >=3],
    uint8 or float in [0, 1]) stacked on a leading view axis: (a dict of
    NumPy arrays [B, ...], float32 RGB [B, H, W, 3] on ``device``)."""
    cams = {k: np.stack([np.asarray(c[k]) for c in cameras_data]) for k in cameras_data[0]}
    return cams, torch.stack([target_tensor(t, device) for t in targets])


def _flat(tensors):
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat, like):
    out, off = [], 0
    for t in like:
        out.append(flat[off:off + t.numel()].view_as(t))
        off += t.numel()
    return out


class DPStepGraphs(GraphedStep):
    """The data-parallel step (the JAX package's ``jax.jit(shard_map(
    shard_step))``) as diff.GraphedStep's two graphs: S builds the
    structure of each of the rank's views, B blends them, takes the mean
    of their losses and its gradients, all-reduces them (the step's one
    collective, inside the graph, as a DistributedRenderer's frame holds
    its collectives) and applies ``tx``.

    ``step(params, opt_state, cams_batch, targets_batch) -> (params,
    opt_state, loss)``: every rank passes the same batch (a multiple of
    the rank count along the axis, from view_batch) and the same
    replicated parameters and state; rank i trains on the i-th contiguous
    share of the views (the mean of its views' losses), the gradients and
    the loss are averaged over the ranks, and ``tx`` (an object with
    init/update, as diff.Adam) updates every replica alike.  The returned
    loss is the mean over the batch's views, a 0-d tensor on the device
    (the JAX step returns it as an array).  The returned parameters and
    state are this step's static buffers: the next call updates them in
    place, and passing them back costs no copy.

    Each rank keys B on its own profiles.  Ranks whose keys differ stay
    matched: every B holds one all-reduce of the same size, and a
    capture's side-stream warm-up skips it, so every rank runs exactly one
    all-reduce a step whichever way its key runs."""

    def __init__(self, config: RenderConfig, capacity: int, k_max: int, tx, mesh: Mesh, *,
                 axis: str = "dp", l1_weight: float = 0.8, ssim_weight: float = 0.2,
                 l2_weight: float = 0.0, remat: Optional[bool] = None):
        self.n_dev = mesh.shape[axis]
        self.mesh, self.axis, self.tx = mesh, axis, tx
        self.group = mesh.group(axis)
        self.weights = (l1_weight, ssim_weight, l2_weight)
        self._layout = None
        self.params = self.opt_state = None
        super().__init__(config, capacity, k_max, 0, mesh.device, remat=remat,
                         error_mode=SHARDED_CAPTURE_MODE)

    def _inputs(self, per: int, image_shape) -> None:
        """Static inputs for ``per`` views of ``image_shape`` (new ones,
        and no graphs, when either changes)."""
        if self._layout == (per, image_shape):
            return
        self._layout = (per, image_shape)
        self._cams = torch.zeros((per, CAMERA_FLOATS), dtype=torch.float32, device=self.dev)
        self._targets = torch.zeros((per,) + image_shape, dtype=torch.float32, device=self.dev)
        self._structure_buffers(per)

    def key(self):
        """What the JAX jit retraces on: the splat count and SH width, the
        capacity, k_max and config, the loss weights, remat, the views a
        rank takes and the image shape."""
        p = self.params
        return (int(p.means.shape[-1]), None if p.sh is None else int(p.sh.shape[1]),
                self.capacity, self.k_max, self.config, self.weights, self.remat) + self._layout

    def _state(self) -> list:
        return tree_leaves((self.params, self.opt_state))

    def _structure_cameras(self) -> list:
        return [camera_views(c) for c in self._cams]

    def _step_body(self, profiles, effects: bool = True):
        dev = self.dev
        l1_weight, ssim_weight, l2_weight = self.weights
        p = tree_map(lambda a: a.detach().requires_grad_(True), self.params)
        loss = 0.0
        for v, cam in enumerate(self._structure_cameras()):
            lv, _ = view_loss(p, cam, self._targets[v], self.config, self.capacity, self.k_max,
                              l1_weight=l1_weight, ssim_weight=ssim_weight, l2_weight=l2_weight,
                              remat=self.remat, structure=self.structures[v],
                              profile=profiles[v], device=dev)
            loss = loss + lv
        loss = loss / len(profiles)
        leaves = tree_leaves(p)
        grads = loss_grads(loss, leaves)
        with torch.no_grad():
            if isinstance(loss, torch.Tensor):
                loss_t = loss.detach().reshape(1)
            else:
                loss_t = torch.full((1,), float(loss), dtype=torch.float32, device=dev)
            flat = _flat(grads + [loss_t])
            if effects:
                # The step's one collective: the mean of the gradients and loss.
                dist.all_reduce(flat, dist.ReduceOp.SUM, group=self.group)
            flat = flat / self.n_dev
            mean = _unflat(flat, grads + [loss_t])
            params = tree_map(torch.detach, p)
            updates, opt_state = self.tx.update(tree_unflatten(params, mean[:-1]),
                                                self.opt_state, params)
            if effects:
                self._commit(tree_leaves((apply_updates(params, updates), opt_state)))
        return (mean[-1].reshape(()),)

    def __call__(self, params, opt_state, cams_batch, targets_batch):
        batch = targets_batch.shape[0]
        if batch % self.n_dev != 0:
            raise ValueError(f"{batch} views do not split over {self.n_dev} ranks")
        per = batch // self.n_dev
        first = self.mesh.index(self.axis) * per
        self._inputs(per, tuple(targets_batch.shape[1:]))
        self._bind(params=params, opt_state=opt_state)
        self._cams.copy_(torch.from_numpy(np.stack([
            camera_array({k: a[v] for k, a in cams_batch.items()})
            for v in range(first, first + per)])))
        self._targets.copy_(targets_batch[first:first + per])
        loss, = self._step(self._step_body)
        return self.params, self.opt_state, loss


def make_train_step_dp(
    config: RenderConfig,
    capacity: int,
    k_max: int,
    tx,
    mesh: Mesh,
    *,
    axis: str = "dp",
    l1_weight: float = 0.8,
    ssim_weight: float = 0.2,
    l2_weight: float = 0.0,
    remat: Optional[bool] = None,
):
    """The data-parallel training step (a DPStepGraphs: CUDA graphs on the
    card, eager on the CPU), with its rank count."""
    step = DPStepGraphs(config, capacity, k_max, tx, mesh, axis=axis, l1_weight=l1_weight,
                        ssim_weight=ssim_weight, l2_weight=l2_weight, remat=remat)
    return step, step.n_dev


def _broadcast_params(params, mesh: Mesh, axis: str, src: int = 0):
    """Every rank's parameters made those of the rank at coordinate ``src``
    of ``axis``, in one broadcast of a flat buffer."""
    leaves = tree_leaves(params)
    flat = _flat([x.detach() for x in leaves]).contiguous()
    group = mesh.group(axis)
    dist.broadcast(flat, dist.get_global_rank(group, src), group=group)
    return tree_unflatten(params, [x.clone() for x in _unflat(flat, leaves)])


def fit_dp(
    params: DiffSplats,
    cameras_data,
    targets,
    config: RenderConfig,
    *,
    capacity: int,
    k_max: int,
    mesh: Mesh,
    axis: str = "dp",
    steps: int = 100,
    learning_rate: float = 5e-3,
    tx=None,
    l1_weight: float = 0.8,
    ssim_weight: float = 0.2,
    l2_weight: float = 0.0,
    remat: Optional[bool] = None,
    log_every: int = 0,
):
    """Data-parallel fit: each step trains on as many views as ranks
    (round-robin over the dataset in groups of the rank count; a view
    count that does not divide is cycled up to the next multiple, so every
    view trains).  The parameters start as rank 0's on every rank and stay
    bit-identical replicas.  ``tx`` defaults to diff.Adam(learning_rate)
    (diff.tx_3dgs works too).  The step is make_train_step_dp's
    (DPStepGraphs: graphed on the card, eager on the CPU); each step's
    mean loss is read back after it.

    Returns (params on the mesh's device, losses: np.ndarray [steps], the
    view mean of each step).
    """
    if tx is None:
        tx = Adam(learning_rate)
    n_dev = mesh.shape[axis]
    dev = mesh.device
    n_views = len(cameras_data)
    if n_views % n_dev != 0:
        need = -(-n_views // n_dev) * n_dev
        order = [i % n_views for i in range(need)]
        cameras_data = [cameras_data[i] for i in order]
        targets = [targets[i] for i in order]
        n_views = need
    step, _ = make_train_step_dp(
        config, capacity, k_max, tx, mesh, axis=axis, l1_weight=l1_weight,
        ssim_weight=ssim_weight, l2_weight=l2_weight, remat=remat,
    )
    params = _broadcast_params(tree_map(lambda a: a.detach().to(dev), params), mesh, axis)
    opt_state = tx.init(params)
    losses = np.zeros(steps, np.float32)
    batches = [view_batch(cameras_data[g:g + n_dev], targets[g:g + n_dev], dev)
               for g in range(0, n_views, n_dev)]
    for i in range(steps):
        params, opt_state, loss = step(params, opt_state, *batches[i % len(batches)])
        losses[i] = loss = float(loss)
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"dp step {i:5d}  loss {loss:.6f}", flush=True)
    return params, losses
