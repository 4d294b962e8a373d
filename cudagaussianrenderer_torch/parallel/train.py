"""Data-parallel fitting over torch.distributed: one view a rank.

3DGS training is data-parallel over views: each rank renders and
differentiates its own camera against its own target image, and one
all-reduce of the gradients turns the ranks' views into one step of a
replicated optimizer.  The splat model is small next to a view's
activations, so parameters and optimizer state are replicated whole; the
pair structure, the k_max gather and the blend stay on their rank.

The step's loss is diff.fit's (diff.view_loss: render_diff, then L2, L1
and D-SSIM); its one collective is an all-reduce (SUM) of one flat buffer
holding every gradient leaf and the loss, divided by the rank count.
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
    Adam, DiffSplats, _camera, apply_updates, loss_grads, target_tensor, tree_leaves, tree_map,
    tree_unflatten, view_loss,
)
from .distributed import Mesh


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
    """The data-parallel training step, with its rank count.

    ``step(params, opt_state, cams_batch, targets_batch) -> (params,
    opt_state, loss)``: every rank passes the same batch (a multiple of the
    rank count along ``axis``, from view_batch) and the same replicated
    parameters and state; rank i trains on the i-th contiguous share of
    the views (the mean of its views' losses), the gradients and the loss
    are averaged over the ranks in one all-reduce, and ``tx`` (an object
    with init/update, as diff.Adam) updates every replica alike.  The
    returned loss is the mean over the batch's views, a float.
    """
    n_dev = mesh.shape[axis]
    group = mesh.group(axis)
    dev = mesh.device

    def step(params, opt_state, cams_batch, targets_batch):
        batch = targets_batch.shape[0]
        if batch % n_dev != 0:
            raise ValueError(f"{batch} views do not split over {n_dev} ranks")
        per = batch // n_dev
        first = mesh.index(axis) * per
        p = tree_map(lambda a: a.detach().requires_grad_(True), params)
        loss = 0.0
        for v in range(first, first + per):
            cam = _camera({k: a[v] for k, a in cams_batch.items()}, dev)
            lv, _ = view_loss(p, cam, targets_batch[v].to(dev), config, capacity, k_max,
                              l1_weight=l1_weight, ssim_weight=ssim_weight,
                              l2_weight=l2_weight, remat=remat, device=dev)
            loss = loss + lv
        loss = loss / per
        leaves = tree_leaves(p)
        grads = loss_grads(loss, leaves)
        with torch.no_grad():
            loss_t = torch.as_tensor(loss, dtype=torch.float32, device=dev).detach().reshape(1)
            flat = _flat(grads + [loss_t])
            # The step's one collective: the mean of the gradients and loss.
            dist.all_reduce(flat, dist.ReduceOp.SUM, group=group)
            flat = flat / n_dev
            mean = _unflat(flat, grads + [loss_t])
            params = tree_map(torch.detach, p)
            updates, opt_state = tx.update(tree_unflatten(params, mean[:-1]), opt_state, params)
            params = apply_updates(params, updates)
        return params, opt_state, float(mean[-1])

    return step, n_dev


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
    (diff.tx_3dgs works too).

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
    n_groups = n_views // n_dev
    for i in range(steps):
        g = (i % n_groups) * n_dev
        cams_b, tgts_b = view_batch(cameras_data[g:g + n_dev], targets[g:g + n_dev], dev)
        params, opt_state, loss = step(params, opt_state, cams_b, tgts_b)
        losses[i] = loss
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"dp step {i:5d}  loss {loss:.6f}", flush=True)
    return params, losses
