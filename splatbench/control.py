"""The control of the check: the reference in the precision next below the
configuration's (bfloat16 for float32, ``BELOW``), put in the program's
place.

    python3 -m splatbench.control --workload <cell> --seeds 11 12 13 [--frames 0 61 180 333]

For each seed it makes the cell's scene and path as a run does, renders
each of ``--frames`` poses by the reference in float64 and in bfloat16,
and holds the bfloat16 frame against the float64 one with the run's
numbers (``check.frame_numbers``, the bfloat16 pair count in the place of
the program's candidates).  It prints each seed's worst numbers and, last,
whether the run's limits call each seed's control correct: the control has
to come out not correct.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
# Poses of the control by default: the start, a quarter turn of the
# turntable on, the fly-through's nearest (0.8 of the framed distance),
# and one more.
FRAMES = (0, 30, 180, 333)
# The precision next below each that a configuration may state.
BELOW = {"float32": "bfloat16"}


def control_numbers(root: Path, workload: str, seed: int, frames, device) -> Dict[str, float]:
    """The worst numbers of the bfloat16 reference against the float64 one
    over ``frames`` poses of ``workload`` at ``seed``."""
    import torch

    from splatbench import check
    from splatbench.poses import PosePath
    from splatbench.reference import frame as reference
    from splatbench.run import load_cell
    from splatbench.scene import make_scene

    spec = load_cell(root, workload)
    config = spec["config"]
    below = getattr(torch, BELOW[config["frame"]["precision"]])
    screen, fcfg = config["screen"], config["frame"]
    scene = make_scene(config["scene"], seed, torch.device(device))
    path = PosePath(spec["traffic"], config, seed)
    kw = dict(depth_bits=int(fcfg["depth_bits"]), chunk=int(fcfg["raster_chunk"]),
              eps=float(fcfg["transmittance_eps"]))
    numbers: List[Dict[str, float]] = []
    for k in frames:
        pose = path.pose(k)
        ref = reference.render(scene, pose, screen, **kw)
        low = reference.render(scene, pose, screen, dtype=below, **kw)
        numbers.append(check.frame_numbers(low.image.cpu().numpy(), ref.image.cpu().numpy(),
                                           low.pairs, ref.pairs, int(screen["tile"])))
    return check.worst(numbers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, nargs="+", default=list(FRAMES))
    args = ap.parse_args(argv)
    from splatbench import check
    from splatbench.run import load_cell

    limits = load_cell(ROOT, args.workload)["config"]["limits"]
    for seed in args.seeds:
        nums = control_numbers(ROOT, args.workload, seed, args.frames, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed, "control": nums,
                          "correct": check.verdict(nums, limits)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
