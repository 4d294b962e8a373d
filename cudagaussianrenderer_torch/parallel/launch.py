"""Start the ranks of a multi-device run: one process a rank, one card a
process, over torch.distributed.

``spawn(fn, world, device, *args)`` starts ``world`` processes on this
host, joins each to one process group (NCCL on ``cuda``, gloo on
``cpu``) through a file store in a temporary directory, runs
``fn(*args)`` in each, and returns their results in rank order.  Nothing
falls back: on ``cuda`` each rank takes the card of its index, and asking
for more ranks than there are cards raises before any process starts; a
rank that raises, or a group that fails to form, makes ``spawn`` raise.

Under ``torchrun`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK`` and ``MASTER_ADDR``/``MASTER_PORT``), a script calls
``init_rank`` itself:

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    init_rank(rank, world, "cuda")          # init_method "env://"
    mesh = make_mesh()                      # parallel.distributed
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist

from ..utils import cuda_build
from ..utils.device import resolve_device


def init_rank(rank: int, world: int, device, init_method: str = "env://",
              local_rank=None) -> torch.device:
    """Join this process to the default process group as ``rank`` of
    ``world``: NCCL with the card ``local_rank`` (default: the
    ``LOCAL_RANK`` variable, else ``rank``) made current on ``cuda``,
    gloo on ``cpu``.  On ``cuda`` rank 0 builds the kernel libraries while
    the others wait at a barrier, so that one nvcc runs for each source.
    Returns this rank's device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", rank))
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants card {local_rank}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        kw = dict(backend="nccl", device_id=dev)
    elif dev.type == "cpu":
        kw = dict(backend="gloo")
    else:
        raise ValueError(f"no process-group backend for device {dev}")
    dist.init_process_group(init_method=init_method, world_size=world, rank=rank, **kw)
    if dev.type == "cuda":
        if rank == 0:
            cuda_build.build_all()
        dist.barrier()
    return dev


def _run_rank(rank, fn, world, device_type, init_method, out_dir, args):
    init_rank(rank, world, device_type, init_method, local_rank=rank)
    try:
        result = fn(*args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device, *args) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, each a rank of one
    process group on ``device`` ("cuda": NCCL, a card a rank; "cpu":
    gloo), and return each rank's result, in rank order.

    ``fn`` must be importable by name (a module-level function), and its
    arguments and result picklable (tensors on the CPU).  Raises when
    ``device`` is ``cuda`` and fewer than ``world`` cards are visible, and
    when any rank raises."""
    dev = resolve_device(device)
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(
            f"{world} ranks need {world} CUDA devices, one a rank (NCCL takes one card a "
            f"process), but {torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="gsr_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        torch.multiprocessing.spawn(
            _run_rank, args=(fn, world, dev.type, init_method, tmp, args), nprocs=world,
            join=True)
        results = []
        for r in range(world):
            # Written by the ranks above, in this run's private directory.
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
