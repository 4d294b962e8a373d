"""The last two scenes of tests/test_edge_cases.py through the port's
Renderer (the checks: test_torch_edge_cases.py): one splat larger than the
frustum (:66) and 128 splats on one depth plane (:87)."""

import pytest

from test_torch_edge_cases import check_scene
from torch_port_cases import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("name", ["huge-splat", "depth-plane"])
def test_edge_scene_matches_golden_and_jax(name):
    check_scene(name)
