"""The checks (c) and (d) of tests/test_torch_sharded_graph.py on a gloo
group of 4 ranks: the capacity keys against the JAX DistributedRenderer's,
and the renderer's frames against render_frames_tilesharded's, byte for
byte (sharded_graph_checks.py).  128x128, 350 splats, SH degree 3."""

import pytest

import sharded_graph_checks as checks
from torch_port_cases import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", params=[4], ids=["4-ranks"])
def group(request):
    return checks.spawn_group(request.param)


def test_capacity_keys_follow_the_jax_renderer(group):
    """(c) The key each frame ran at and the capacity after it, frame by
    frame, against the JAX DistributedRenderer; every rank the same."""
    checks.capacity_keys_follow_the_jax_renderer(group)


@pytest.mark.parametrize("mesh,balanced", [("1d", False), ("1d", True), ("2d", False)],
                         ids=["1d-uniform", "1d-balanced", "2d"])
def test_renderer_frames_equal_tilesharded_frames(group, mesh, balanced):
    """(d) Cameras visited in the order REVISITS: every ``render`` and
    ``render_batch`` frame equals render_frames_tilesharded's frame of its
    camera at the same capacity, byte for byte, on every rank."""
    checks.renderer_frames_equal_tilesharded_frames(group, mesh, balanced)
