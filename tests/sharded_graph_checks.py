"""The checks (c) and (d) of tests/test_torch_sharded_graph.py on a gloo
group, shared by that file (2 ranks) and test_torch_sharded_graph_4ranks.py
(4 ranks), so that each file runs about 30 s on one worker: a spawn of the
group ~10 s, the JAX DistributedRenderer key oracles ~9 s a case."""

import functools

import numpy as np

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch.parallel import launch
from cudagaussianrenderer_tpu.parallel import distributed as jd

import torch_port_cases as cases
from torch_port_cases import GRAPH_SEED, GRAPH_SIZE, GRAPH_SPLATS, REVISITS, SHARDED_KEY_CASES


def spawn_group(n):
    """(n, every rank's sharded_graph_cases result) of an n-rank gloo group."""
    return n, launch.spawn(cases.sharded_graph_cases, n, "cpu", n)


def on_every_rank(ranks, key):
    def eq(a, b):
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(eq(a[k], b[k]) for k in a)
        if isinstance(a, np.ndarray):
            return a.dtype == b.dtype and np.array_equal(a, b)
        return a == b

    assert all(eq(r[key], ranks[0][key]) for r in ranks[1:]), f"{key} differs between ranks"
    return ranks[0][key]


@functools.lru_cache(maxsize=None)
def jax_key_sequence(n, balanced, adaptive, start):
    """The JAX DistributedRenderer of the same scene, config and start on an
    n-device mesh: its key (``_get_fn``'s capacity) and capacity a frame."""
    scene = jx.random_scene(GRAPH_SPLATS, seed=GRAPH_SEED, sh_degree=3)
    cfg = jx.RenderConfig(screen_size=GRAPH_SIZE, balanced_bands=balanced,
                          capacity=None if adaptive else start)
    r = jd.DistributedRenderer(scene, cfg, mesh=jd.make_mesh(n))
    r.capacity = start
    keys, after, get_fn = [], [], r._get_fn

    def counted(batched):
        keys.append((r.capacity, batched))
        return get_fn(batched)

    r._get_fn = counted
    for cam in jx.orbit_cameras(scene.bounds_min, scene.bounds_max, 6):
        r.render(cam)
        after.append(r.capacity)
    assert set(keys) == set(r._fns)
    return [k for k, _ in keys], after


def capacity_keys_follow_the_jax_renderer(group):
    """(c) The key each frame ran at and the capacity after it, frame by
    frame, against the JAX DistributedRenderer; every rank the same."""
    n, ranks = group
    seqs = on_every_rank(ranks, "keys")
    assert set(seqs) == {c[0] for c in SHARDED_KEY_CASES if c[1] == n}
    for name, ranks_n, balanced, adaptive, start in SHARDED_KEY_CASES:
        if ranks_n != n:
            continue
        keys, after = seqs[name]
        want_keys, want_after = jax_key_sequence(n, balanced, adaptive, start)
        assert keys == want_keys, name
        assert after == want_after, name
        assert len(set(keys)) == 2 and keys[0] == start  # the case walks keys


def renderer_frames_equal_tilesharded_frames(group, mesh, balanced):
    """(d) Cameras visited in the order REVISITS: every ``render`` frame and
    every ``render_batch`` frame (4 cameras; on the 2-D mesh, 2x1 on two
    ranks and 2x2 on four, two a frame group) equals
    render_frames_tilesharded's frame of its camera at the same capacity,
    byte for byte, on every rank.  The static camera ends holding the last
    camera of the rank's share of the batch."""
    n, ranks = group
    scene = cases.graph_scene()
    cams = pt.orbit_cameras(scene.bounds_min, scene.bounds_max, 3)
    tiles = n if mesh == "1d" else n // 2
    for rank, result in enumerate(ranks):
        got = result[(mesh, balanced)]
        want = got["want"]
        assert want.shape == (len(REVISITS), GRAPH_SIZE, GRAPH_SIZE, 4)
        assert want[..., 3].max() == 255
        np.testing.assert_array_equal(got["render"], want, err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["batch"], want[:4], err_msg=f"rank {rank}")
        np.testing.assert_array_equal(got["want"], ranks[0][(mesh, balanced)]["want"])
        cap, after = got["capacity"]
        assert cap == after
        last = 3 if mesh == "1d" else 2 * (rank // tiles) + 1
        np.testing.assert_array_equal(
            got["camera"], pt.render.camera_array(cams[REVISITS[last]].camera_data()))
