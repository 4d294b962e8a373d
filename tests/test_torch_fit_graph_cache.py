"""diff.fit and parallel.fit_dp through their graph caches' path
(diff.GraphedStep), driven on the CPU with a stand-in for the capture
(tests/torch_port_cases.py:graph_cache_on_cpu), against the eager loops
they run on the CPU: bit-equal parameters, optimizer state and losses.

The fit runs 12 steps with pose and exposure refinement, depth, the SH
warm-up and tx_3dgs, and a densify after its sixth step, which drops the
cache: the graphs of the first six steps go with their pool, and the last
six capture their own.  The eager loops are held against the JAX package
by tests/test_torch_diff_fit.py and tests/test_torch_parallel_gloo.py.
"""

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_torch.parallel import launch

from torch_port_cases import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    fit_dp_graph_case, fit_graph_case, graph_cache_on_cpu, one_torch_thread,
)

STEPS, DENSIFY_EVERY = 12, 6


def fit_run(tmp_path, name):
    init, cd, targets, config = fit_graph_case()
    depth = [np.where(np.arange(32)[:, None] % 3 == 0, np.nan, 5.0 + 0.01 * np.arange(32))
             .astype(np.float32) * np.ones((32, 32), np.float32) for _ in cd]
    ck = tmp_path / f"{name}.npz"
    stats = {}
    out = diff.fit(init, cd, targets, config, capacity=4096, k_max=64, steps=STEPS,
                   tx=diff.tx_3dgs(8.0, STEPS), l1_weight=0.8, ssim_weight=0.2, l2_weight=0.0,
                   depth_weight=0.05, depth_targets=depth, densify_every=DENSIFY_EVERY,
                   densify_until=DENSIFY_EVERY, densify_args=dict(grad_threshold=1e-5),
                   optimize_cameras=True, optimize_exposure=True, sh_warmup_every=4,
                   checkpoint_every=STEPS, checkpoint_path=ck, device="cpu", stats=stats)
    with np.load(ck) as z:
        saved = {k: z[k] for k in z.files}
    return out, saved, stats


def test_fit_through_the_graph_cache_equals_the_eager_loop(tmp_path):
    torch.manual_seed(0)
    want, want_ck, want_stats = fit_run(tmp_path, "eager")
    with graph_cache_on_cpu() as g:
        got, got_ck, stats = fit_run(tmp_path, "graphed")
    (p, losses, cam, exp), (wp, wlosses, wcam, wexp) = got, want
    np.testing.assert_array_equal(losses, wlosses)
    for a, b in zip(diff.tree_leaves((p, cam, exp)), diff.tree_leaves((wp, wcam, wexp))):
        assert torch.equal(a, b)
    assert sorted(got_ck) == sorted(want_ck) and any(k.startswith("o_") for k in got_ck)
    for k in got_ck:
        np.testing.assert_array_equal(got_ck[k], want_ck[k], err_msg=k)
    assert p.means.shape[-1] != 40  # the densify changed the splat count
    # Eager: every step eager, nothing kept.  The cache's path: in each
    # window of 6 steps S and B eager, captured, then replayed; the densify
    # dropped the first window's graphs.
    assert want_stats["step"] == {"eager": STEPS} and want_stats["structure"] == {"eager": STEPS}
    assert stats["resets"] == 2 and stats["graphs"] == 2
    assert stats["structure"] == {"eager": 2, "capture": 2, "replay": 8}
    assert stats["step"]["capture"] >= 2 and stats["step"].get("replay", 0) >= 2
    assert sum(stats["step"].values()) == STEPS
    assert g.captures.count(("global", True)) == stats["step"]["capture"]
    assert g.captures.count(("global", False)) == 2
    assert stats["chunk_tiles_run"] >= stats["chunk_tiles_exact"] > 0


def test_fit_dp_through_the_graph_cache_equals_the_eager_loop():
    """fit_dp in a world-size-1 gloo group, and three make_train_step_dp
    steps (eager, capture, replay) whose first call binds other
    parameters."""
    out = launch.spawn(fit_dp_graph_case, 1, "cpu", 8)[0]
    (got, got_l), (want, want_l) = out["graphed"], out["eager"]
    np.testing.assert_array_equal(got_l, want_l)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # Every capture of the data-parallel step in the sharded frame's mode;
    # B's with a warm-up that skips its all-reduce.
    assert set(out["captures"]) == {("thread_local", True), ("thread_local", False)}
    assert out["methods"] == ["eager", "capture", "replay"]
    assert out["report"]["step"] == {"eager": 1, "capture": 1, "replay": 1}
    states, eager = out["steps"]
    for s, w in zip(states, eager):
        for a, b in zip(s, w):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_splats", [40, 41])
def test_graphed_step_rebinds_by_layout(n_splats):
    """GraphedStep._bind copies state of the same layout into the static
    buffers and keeps the graphs; state of another layout takes new
    buffers and drops them."""
    init, cd, targets, config = fit_graph_case()
    tx = diff.Adam(1e-3)
    step = diff.FitStepGraphs(
        config, 4096, 64, params=init, opt_state=tx.init(init), tx=tx, extras={},
        extra_state={}, extra_txs={}, n_views=1, image_shape=(32, 32), l1_weight=0.0,
        ssim_weight=0.0, l2_weight=1.0, depth_weight=0.0, use_depth=False, sh_bands=None,
        remat=None, device="cpu")
    before = [x for x in diff.tree_leaves(step.params)]
    assert all(a is not b for a, b in zip(before, diff.tree_leaves(init)))
    step._graphs = {"key": None}
    new = diff.random_init(n_splats, (-1, -1, -1), (1, 1, 1), seed=3, sh_degree=1,
                           device="cpu")
    step.load(new, tx.init(new))
    for a, b in zip(diff.tree_leaves(step.params), diff.tree_leaves(new)):
        assert torch.equal(a, b) and a is not b
    same = n_splats == 40
    assert (step._graphs == {"key": None}) == same
    assert all((a is b) == same for a, b in zip(diff.tree_leaves(step.params), before))


def test_step_reuses_the_cheapest_covering_key():
    """On the card B reuses a key made at the same static key whose profiles
    cover the exact ones block by block and blend at most a quarter more
    chunk-tiles than the exact ones rounded up; else it rounds them up.  On
    the CPU it blends the exact ones."""
    init, cd, targets, config = fit_graph_case()
    config = type(config)(screen_size=128)
    tx = diff.Adam(1e-3)
    step = diff.FitStepGraphs(
        config, 4096, 2048, params=init, opt_state=tx.init(init), tx=tx, extras={},
        extra_state={}, extra_txs={}, n_views=1, image_shape=(128, 128), l1_weight=0.0,
        ssim_weight=0.0, l2_weight=1.0, depth_weight=0.0, use_depth=False, sh_bands=None,
        remat=None, device="cpu")
    step.tile_batch = 16  # four blocks of 16 tiles
    key = step.key()
    assert step._cover(key, ((11, 4, 1, 1),)) == ((11, 4, 1, 1),)
    step.device = torch.device("cuda")
    step._visited = {("step", (key, ((12, 4, 2, 1),))), ("step", (key, ((12, 6, 2, 1),))),
                     ("step", (key, ((16,) * 4,))), ("step", ("other", ((20,) * 4,))),
                     ("structure", key)}
    assert step._cover(key, ((11, 4, 1, 1),)) == ((12, 4, 2, 1),)
    assert step._cover(key, ((12, 5, 1, 0),)) == ((12, 6, 2, 1),)
    assert step._cover(key, ((11, 7, 1, 1),)) == ((12, 7, 1, 1),)  # (16,) * 4 costs too much
    assert step._cover(key, ((17, 4, 1, 1),)) == ((16, 4, 1, 1),)  # capped at k_max's 16
    assert step._cover(key, ((3, 1, 1, 1),)) == ((3, 1, 1, 1),)
    assert step._chunk_tiles(((12, 4, 2, 1),)) == 19 * 16
