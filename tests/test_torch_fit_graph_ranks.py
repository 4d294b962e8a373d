"""The data-parallel step's graph cache across ranks
(parallel.train.DPStepGraphs), driven on the CPU with a stand-in for the
capture (tests/torch_port_cases.py:graph_cache_on_cpu) in a 2-rank gloo
group.  Each rank keys its step on its own block profiles, so ranks visit
other keys at other steps; every step of each rank must still run exactly
one all-reduce (a capture's warm-up runs none), or the ranks' collectives
would no longer match.
"""

import numpy as np

from cudagaussianrenderer_torch.parallel import launch

from torch_port_cases import dp_graph_ranks_case, one_torch_thread  # noqa: F401 (an autouse fixture)


def test_dp_steps_of_ranks_with_other_keys_stay_matched():
    """Two gloo ranks whose views give their step graphs other block
    profiles, so other keys visited at other steps: every step of each rank
    still runs one all-reduce, and the graphed run equals the eager run,
    on every rank alike."""
    ranks = launch.spawn(dp_graph_ranks_case, 2, "cpu", 6)
    for r in ranks:
        (got, got_l), (want, want_l) = r["graphed"], r["eager"]
        assert got_l == want_l
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert "replay" in r["graphed_methods"] and "capture" in r["graphed_methods"]
    for a, b in zip(ranks[0]["graphed"][0], ranks[1]["graphed"][0]):
        np.testing.assert_array_equal(a, b)
    assert ranks[0]["graphed_profiles"] != ranks[1]["graphed_profiles"]

