"""The port's scene editing (cudagaussianrenderer_torch.scene_ops) against
the JAX package's (cudagaussianrenderer_tpu.scene_ops): every operation on
the same seeded scene gives the same scene bit for bit, and the same
errors."""

import numpy as np
import pytest

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
from cudagaussianrenderer_torch import scene_ops as pops
from cudagaussianrenderer_tpu import scene_ops as jops

from torch_port_cases import assert_same_scene


def _scenes(n=40, seed=0, sh_degree=0, **kw):
    """The same random scene in both packages (bit-equal, tests/test_torch_scene.py)."""
    return (pt.random_scene(n, seed=seed, sh_degree=sh_degree, device="cpu", **kw),
            jx.random_scene(n, seed=seed, sh_degree=sh_degree, **kw))


def _padded(n=40, seed=0, sh_degree=0):
    """Scenes padded past their count: the ops see only the true splats."""
    p, j = _scenes(n, seed, sh_degree)
    return p.pad_to_multiple(64), j.pad_to_multiple(64)


OPS = {
    "take": lambda m, s: m.take(s, [1, 4, 7, 30, 4]),
    "take-numpy-indices": lambda m, s: m.take(s, np.array([39, 0, 12])),
    "crop": lambda m, s: m.crop(s, (-2, -2, -2), (2, 2, 2)),
    "crop-thin": lambda m, s: m.crop(s, (-4, -0.3, -4), (4, 0.7, 4)),
    "filter-0.5": lambda m, s: m.filter_opacity(s, 0.5),
    "filter-0.1": lambda m, s: m.filter_opacity(s, 0.1),
    "decimate-importance": lambda m, s: m.decimate(s, 10),
    "decimate-random": lambda m, s: m.decimate(s, 10, mode="random", seed=1),
    "decimate-above-count": lambda m, s: m.decimate(s, 100),
    "transform-similarity": lambda m, s: m.transform(s, translate=(1, 2, 3), scale=2.0),
    "transform-negative-scale": lambda m, s: m.transform(s, translate=(0.5, 0, -1), scale=-0.75),
    "transform-rotation": lambda m, s: m.transform(
        s, rotate_xyzw=np.array([0.1, -0.4, 0.3, 0.85]), scale=1.5, translate=(0, 1, 0)),
    "transform-rotation-90z": lambda m, s: m.transform(
        s, rotate_xyzw=np.array([0, 0, np.sqrt(0.5), np.sqrt(0.5)])),
}


@pytest.mark.parametrize("sh_degree", [0, 2])
@pytest.mark.parametrize("op", list(OPS))
def test_op_matches_jax(op, sh_degree):
    p, j = _padded(sh_degree=sh_degree)
    got, want = OPS[op](pops, p), OPS[op](jops, j)
    assert_same_scene(got, want)
    assert got.device.type == "cpu"


def test_decimate_keeps_the_top_scores():
    p, _ = _scenes(40)
    d = pops.decimate(p, 10)
    op = p.opacities.numpy()
    score = op * np.cbrt(p.scales.numpy().prod(axis=0))
    want = np.sort(np.argsort(-score, kind="stable")[:10])
    np.testing.assert_array_equal(d.means.numpy(), p.means.numpy()[:, want])
    assert pops.decimate(p, 100) is p


def test_merge_promotes_sh_like_jax():
    pa, ja = _scenes(10, seed=1, sh_degree=0)
    pb, jb = _scenes(6, seed=2, sh_degree=2)
    got, want = pops.merge([pa, pb.pad_to_multiple(16)]), jops.merge([ja, jb.pad_to_multiple(16)])
    assert_same_scene(got, want)
    assert got.count == 16 and got.sh_degree == 2
    sh = got.sh.numpy()
    assert np.all(sh[:, 1:, :10] == 0)
    np.testing.assert_array_equal(sh[:, :, 10:], pb.sh.numpy())
    got0 = pops.merge([pa, pa])
    assert_same_scene(got0, jops.merge([ja, ja]))
    assert got0.sh is None


def test_transform_rotation_composes():
    means = np.array([[1.0, 0.0, 0.0]], np.float32)
    scales = np.full((1, 3), 0.5, np.float32)
    quats = np.array([[0.0, 0.0, 0.0, 1.0]], np.float32)
    p = pt.scene_from_arrays(means, scales, quats, np.array([0.7], np.float32), device="cpu")
    j = jx.scene_from_arrays(means, scales, quats, np.array([0.7], np.float32))
    h = np.sqrt(0.5)
    got = pops.transform(p, rotate_xyzw=np.array([0, 0, h, h]))
    assert_same_scene(got, jops.transform(j, rotate_xyzw=np.array([0, 0, h, h])))
    np.testing.assert_allclose(got.means.numpy()[:, 0], [0.0, 1.0, 0.0], atol=1e-6)


ERRORS = {
    "empty-crop": lambda m, s: m.crop(s, (100, 100, 100), (101, 101, 101)),
    "decimate-mode": lambda m, s: m.decimate(s, 5, mode="best"),
    "decimate-zero": lambda m, s: m.decimate(s, 0),
    "merge-nothing": lambda m, s: m.merge([]),
    "transform-scale-0": lambda m, s: m.transform(s, scale=0.0),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_errors_match_jax(case):
    p, j = _scenes(10)
    with pytest.raises(ValueError) as got:
        ERRORS[case](pops, p)
    with pytest.raises(ValueError) as want:
        ERRORS[case](jops, j)
    assert str(got.value) == str(want.value)
