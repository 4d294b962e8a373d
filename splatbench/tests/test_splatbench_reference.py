"""The plain reference against the program's frame on the CPU (the
kernels' plain versions), at small sizes."""

import numpy as np
import pytest
import torch

from splatbench import check, program
from splatbench.poses import PosePath
from splatbench.reference import frame as reference
from splatbench.scene import make_scene

CONFIG = {"camera": {"fov_y_deg": 60.0, "near": 0.1, "far": 100.0},
          "screen": {"width": 160, "height": 112, "tile": 16},
          "scene": {"splats": 20000, "sh_degree": 3, "extent": 4.0,
                    "scale_range": [0.002, 0.053]},
          "frame": {"precision": "float32", "falloff": "gaussian",
                    "opacity_aware_extents": True, "center_sampled_runs": True,
                    "depth_bits": 19, "raster_chunk": 128, "transmittance_eps": 0.02}}
PATH = {"azimuth_frames": 120, "phase": "seed", "distance": {"base": 1.05, "amp": 0.25,
        "frames": 240}, "elevation": {"base": 0.5, "amp": 0.2, "frames": 370}, "wander": 0.1}


@pytest.mark.parametrize("seed,k", [(3, 0), (2**31 + 17, 60), (40000000001, 180)])
def test_reference_matches_program_frame(seed, k):
    scene = make_scene(CONFIG["scene"], seed, "cpu")
    pose = PosePath(PATH, CONFIG, seed).pose(k)
    r = program.renderer(scene, CONFIG["screen"], CONFIG["frame"], "cpu")
    image = r.render(program.camera(pose))
    ref = reference.render(scene, pose, CONFIG["screen"])
    nums = check.frame_numbers(image, ref.image.numpy(), r.last_candidates, ref.pairs, 16)
    # Both blend the same pairs in the same order in float32 against
    # float64; the program's packed attributes (8-bit colour and opacity,
    # 12-bit conic) stay within a few levels.
    assert nums["mean_abs"] < 0.5
    assert nums["bad_share"] == 0.0
    assert nums["coverage_missing"] == 0.0
    assert nums["pairs_missing"] == 0.0
    # The program rounds its tile runs outward: a few more pairs, never fewer.
    assert ref.pairs <= r.last_candidates <= ref.pairs * 1.002
    assert 0 < ref.pairs_blended <= ref.pairs


def test_reference_counts_every_tile_a_splat_meets():
    """One splat straddling a tile corner lands in the four tiles around
    it, and the frame is black outside them."""
    screen = {"width": 64, "height": 64, "tile": 16}
    scene = dict(means=torch.tensor([[0.0], [0.0], [0.0]]),
                 scales=torch.full((3, 1), 0.2), quats=torch.tensor([0x7F7F7FFF], dtype=torch.int64)
                 .to(torch.int32), opacities=torch.tensor([0.9]), sh=torch.zeros(3, 1, 1),
                 sh_degree=0)
    pose = dict(position=[0.0, 0.0, 10.0], target=[0.0, 0.0, 0.0], fov_y=np.radians(60.0),
                aspect=1.0, near=0.1, far=100.0)
    ref = reference.render(scene, pose, screen)
    covered = ref.image[::16, ::16, 3].numpy() > 0
    assert covered.sum() == ref.pairs == 4
    assert covered[1:3, 1:3].all()


def test_control_is_not_correct(tmp_path):
    """The reference in bfloat16 in the program's place, as
    ``python3 -m splatbench.control`` runs it at a cell's size, fails the
    configuration's limits."""
    import json

    from splatbench.control import control_numbers
    from splatbench.tests.tiny import tiny_root

    root = tiny_root(tmp_path, splats=20_000)
    limits = json.loads((root / "splatbench/configs/tiny.json").read_text())["limits"]
    for cell in ("tiny.turntable", "tiny.flythrough"):
        nums = control_numbers(root, cell, 2**31 + 3, (0, 3), "cpu")
        assert not check.verdict(nums, limits), nums
