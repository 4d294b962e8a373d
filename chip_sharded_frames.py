#!/usr/bin/env python3
"""The graphed sharded frame on every card of one host.

Run from the root of a checkout on a machine with one or more NVIDIA cards:

    python3 chip_sharded_frames.py [--ranks N]

It starts one NCCL rank a card (parallel.launch.spawn; default: every
visible card) and, for each case of CASES (torch.cuda.graph's
capture_error_mode for the rank's frame, uniform or balanced bands), runs
a DistributedRenderer on the bench's scene (1M splats, SH 0, 1024x1024)
through PASSES passes of 8 orbit cameras: a key's first frame eager, its
second captured with its collectives as one CUDA graph, later ones
replayed.  Before each frame every rank meets at a barrier and waits for
its card, so each frame's host-clock time (readback included) is that
frame alone.  A replayed frame must equal the eager frame of its camera
and key, byte for byte, wherever both ran.  A traced pass of replays gives
rank 0's device busy time a frame and the NCCL kernels' part of it.

One JSON line a case (rank 0's numbers), then the card's name and power
limit.  Without a CUDA device it exits non-zero and prints no result.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# (capture_error_mode, balanced bands)
CASES = (("thread_local", False), ("thread_local", True), ("global", True))
PASSES = 3


def rank(mode, balanced):
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from cudagaussianrenderer_torch import RenderConfig, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.parallel import DistributedRenderer, make_mesh
    from cudagaussianrenderer_torch.parallel import distributed

    # The case's capture mode for every capture of this process.
    distributed.SHARDED_CAPTURE_MODE = mode
    mesh = make_mesh()
    scene = random_scene(1_000_000, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                         device=mesh.device)
    r = DistributedRenderer(scene, RenderConfig(screen_size=1024, balanced_bands=balanced),
                            mesh=mesh)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 8)
    r.render(cams[0])  # sizes the capacity from the candidates
    eager, frames = {}, []
    for p in range(PASSES):
        for i, c in enumerate(cams):
            dist.barrier()
            torch.cuda.synchronize()
            key = r._key()
            t0 = time.perf_counter()
            img = r.render(c)
            ms = (time.perf_counter() - t0) * 1e3
            equal = None
            if r.last_method == "eager":
                eager[(i, key)] = img
            elif (i, key) in eager:
                equal = bool(np.array_equal(img, eager[(i, key)]))
            frames.append((r.last_method, ms, key, equal))
    dist.barrier()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for c in cams:
            r.render(c)
        torch.cuda.synchronize()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by = {m: [f[1] for f in frames if f[0] == m] for m in ("eager", "capture", "replay")}
    return dict(
        capture_error_mode=mode, balanced=balanced, ranks=dist.get_world_size(),
        ms={m: None if not v else float(np.median(v)) for m, v in by.items()},
        frames={m: len(v) for m, v in by.items()},
        replay_ms_range=[min(by["replay"]), max(by["replay"])] if by["replay"] else None,
        replays_checked=sum(f[3] is not None for f in frames),
        replays_equal=sum(f[3] is True for f in frames),
        keys=sorted({f[2] for f in frames}),
        traced_busy_ms=sum(e.self_device_time_total for e in device) / 1e3 / len(cams),
        traced_nccl_ms=sum(e.self_device_time_total for e in device
                           if "nccl" in e.key.lower()) / 1e3 / len(cams),
        memory_reserved_gib=torch.cuda.memory_reserved() / 2**30,
    )


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=0, help="NCCL ranks (default: every card)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_sharded_frames: no CUDA device", file=sys.stderr)
        return 1
    from cudagaussianrenderer_torch.parallel import launch

    ranks = args.ranks or torch.cuda.device_count()
    ok = True
    for mode, balanced in CASES:
        t0 = time.perf_counter()
        res = launch.spawn(rank, ranks, "cuda", mode, balanced)[0]
        res["seconds"] = time.perf_counter() - t0
        ok &= res["replays_equal"] == res["replays_checked"] > 0
        print(json.dumps(res), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
          .stdout.strip().splitlines()[0], flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
