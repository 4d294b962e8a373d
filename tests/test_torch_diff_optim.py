"""The port's optimizers and checkpoints against the JAX package's: Adam
against optax.adam and tx_3dgs against the JAX tx_3dgs over three steps,
the optimizer state's leaves in jax.tree_util.tree_leaves order, and
checkpoints written by either package read by the other.  The counterparts
of tests/test_diff.py's test_tx_3dgs_per_parameter_rates and
test_checkpoint_roundtrip_fields.

Both optimizers run the same f32 arithmetic in the same order; the bias
correction's power b^count may round differently in the two libraries, so
updates and moments are held within OPT_RTOL."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from cudagaussianrenderer_torch import diff
from cudagaussianrenderer_tpu import diff as jdiff

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

OPT_RTOL, OPT_ATOL = 1e-6, 1e-12
CPU = "cpu"


def _params(rng, n=16, k=4):
    a = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    return dict(means=a(3, n), log_scales=a(3, n), quats=a(4, n), opacity_logits=a(n),
                colors=a(3, n), sh=None if k == 0 else a(3, k, n))


def _pair(d):
    """The same parameters (or gradients) as the JAX and the port's DiffSplats."""
    return (jdiff.DiffSplats(**{k: None if v is None else jnp.asarray(v) for k, v in d.items()}),
            diff.DiffSplats(**{k: None if v is None else torch.from_numpy(v.copy())
                               for k, v in d.items()}))


def _assert_trees_close(got, want):
    g, w = diff.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert a.shape == b.shape and a.numpy().dtype == b.dtype
        np.testing.assert_allclose(a.numpy(), b, rtol=OPT_RTOL, atol=OPT_ATOL)


@pytest.mark.parametrize("k", [0, 4], ids=["no-sh", "sh"])
@pytest.mark.parametrize("which", ["adam", "3dgs"])
def test_optimizer_matches_jax_over_three_steps(which, k):
    """Updates and the whole state after each of three steps, from the same
    gradients: Adam(5e-3) against optax.adam(5e-3), tx_3dgs against the JAX
    tx_3dgs (a short run, so the position rate decays within it)."""
    rng = np.random.default_rng(1)
    jp, pp = _pair(_params(rng, k=k))
    if which == "adam":
        jtx, ptx = optax.adam(5e-3), diff.Adam(5e-3)
    else:
        jtx, ptx = jdiff.tx_3dgs(7.5, 3), diff.tx_3dgs(7.5, 3)
    js, ps = jtx.init(jp), ptx.init(pp)
    for _ in range(3):
        jg, pg = _pair(_params(rng, k=k))
        ju, js = jtx.update(jg, js, jp)
        pu, ps = ptx.update(pg, ps, pp)
        _assert_trees_close(pu, ju)
        _assert_trees_close(ps, js)
        jp, pp = optax.apply_updates(jp, ju), diff.apply_updates(pp, pu)
    _assert_trees_close(pp, jp)


def test_tx_3dgs_per_parameter_rates():
    """Each parameter group steps at its own rate: unit gradients give
    first-step magnitudes equal to the schedule's rates, and the position
    rate decays to final_ratio x by the last step."""
    n, k, extent, steps = 8, 4, 10.0, 100
    params = diff.DiffSplats(means=torch.zeros(3, n), log_scales=torch.zeros(3, n),
                             quats=torch.zeros(4, n), opacity_logits=torch.zeros(n),
                             colors=torch.zeros(3, n), sh=torch.zeros(3, k, n))
    ones = diff.tree_map(torch.ones_like, params)
    tx = diff.tx_3dgs(extent, steps)
    state = tx.init(params)
    upd, state = tx.update(ones, state, params)
    assert float(upd.means.abs().max()) == pytest.approx(1.6e-4 * extent, rel=1e-4)
    assert float(upd.opacity_logits.abs().max()) == pytest.approx(5e-2, rel=1e-4)
    assert float(upd.quats.abs().max()) == pytest.approx(1e-3, rel=1e-4)
    assert float(upd.log_scales.abs().max()) == pytest.approx(5e-3, rel=1e-4)
    assert float(upd.colors.abs().max()) == pytest.approx(2.5e-3, rel=1e-4)
    sh = upd.sh.abs().numpy()
    assert sh[:, 0].max() == pytest.approx(2.5e-3, rel=1e-4)
    assert sh[:, 1:].max() == pytest.approx(2.5e-3 / 20.0, rel=1e-4)
    assert float(upd.means.max()) < 0
    for _ in range(steps):
        upd, state = tx.update(ones, state, params)
    assert float(upd.means.abs().max()) == pytest.approx(1.6e-4 * extent * 0.01, rel=1e-3)
    assert float(upd.opacity_logits.abs().max()) == pytest.approx(5e-2, rel=1e-4)
    # The sh=None branch runs too.
    p2 = params._replace(sh=None, colors=torch.full((3, n), 0.5))
    tx2 = diff.tx_3dgs(extent, 3)
    upd2, _ = tx2.update(diff.tree_map(torch.ones_like, p2), tx2.init(p2), p2)
    assert upd2.sh is None


@pytest.mark.parametrize("which", ["adam", "3dgs"])
def test_opt_state_leaves_in_optax_order(which):
    """The port's state flattens to the JAX state's jax.tree_util.tree_leaves,
    leaf for leaf (shape, dtype, value) — the order the checkpoint's o_<i>
    keys follow: step count, first moments, second moments (then tx_3dgs's
    own count)."""
    rng = np.random.default_rng(3)
    jp, pp = _pair(_params(rng, k=4))
    jtx, ptx = ((optax.adam(1e-2), diff.Adam(1e-2)) if which == "adam"
                else (jdiff.tx_3dgs(3.0, 10), diff.tx_3dgs(3.0, 10)))
    jg, pg = _pair(_params(rng, k=4))
    _, js = jtx.update(jg, jtx.init(jp), jp)
    _, ps = ptx.update(pg, ptx.init(pp), pp)
    want = jax.tree_util.tree_leaves(js)
    got = diff.tree_leaves(ps)
    assert len(got) == len(want) == (13 if which == "adam" else 14)
    assert got[0].dtype == torch.int32 and int(got[0]) == 1
    _assert_trees_close(ps, js)


def test_checkpoint_roundtrip_fields(tmp_path):
    """save/load keep every DiffSplats leaf (SH included), the step and the
    pose deltas; the optimizer state needs the matching optimizer."""
    p = diff.random_init(12, (-1, -1, -1), (1, 1, 1), seed=0, sh_degree=1, device=CPU)
    d = diff.CameraDeltas(dr=torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 3)).astype(np.float32)),
        dt=torch.ones((3, 3)))
    tx = diff.Adam(1e-2)
    path = tmp_path / "ck.npz"
    diff.save_checkpoint(path, p, step=7, opt_state=tx.init(p), camera_deltas=d)
    ck = diff.load_checkpoint(path, tx=tx, device=CPU)
    assert ck["step"] == 7 and ck["opt_state"] is not None and ck["exposure"] is None
    for name in p._fields:
        a, b = getattr(p, name), getattr(ck["params"], name)
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(ck["camera_deltas"].dr, d.dr)
    assert diff.load_checkpoint(path, device=CPU)["opt_state"] is None
    # A bare path saves and loads the same file (np.savez appends .npz).
    diff.save_checkpoint(tmp_path / "ck2", p, step=1)
    assert (tmp_path / "ck2.npz").exists()
    assert diff.load_checkpoint(tmp_path / "ck2", device=CPU)["step"] == 1


@pytest.mark.parametrize("which", ["adam", "3dgs"])
def test_checkpoints_cross_between_packages(tmp_path, which):
    """A checkpoint of either package (parameters, step, optimizer state
    after two steps, pose deltas, exposure) reads in the other to the same
    arrays, and both write the same keys."""
    rng = np.random.default_rng(5)
    jp, pp = _pair(_params(rng, k=4))
    jtx, ptx = ((optax.adam(1e-2), diff.Adam(1e-2)) if which == "adam"
                else (jdiff.tx_3dgs(3.0, 10), diff.tx_3dgs(3.0, 10)))
    js, ps = jtx.init(jp), ptx.init(pp)
    for _ in range(2):
        jg, pg = _pair(_params(rng, k=4))
        _, js = jtx.update(jg, js, jp)
        _, ps = ptx.update(pg, ps, pp)
    dr = rng.normal(size=(2, 3)).astype(np.float32)
    gain = rng.uniform(0.8, 1.2, (2, 3)).astype(np.float32)
    jdiff.save_checkpoint(tmp_path / "jax.npz", jp, step=2, opt_state=js,
                          camera_deltas=jdiff.CameraDeltas(jnp.asarray(dr), jnp.asarray(-dr)),
                          exposure=jdiff.Exposure(jnp.asarray(gain), jnp.asarray(gain - 1)))
    diff.save_checkpoint(tmp_path / "port.npz", pp, step=2, opt_state=ps,
                         camera_deltas=diff.CameraDeltas(torch.from_numpy(dr),
                                                         torch.from_numpy(-dr)),
                         exposure=diff.Exposure(torch.from_numpy(gain),
                                                torch.from_numpy(gain - 1)))
    with np.load(tmp_path / "jax.npz") as zj, np.load(tmp_path / "port.npz") as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for key in zj.files:
            assert zj[key].dtype == zp[key].dtype and zj[key].shape == zp[key].shape, key

    got = diff.load_checkpoint(tmp_path / "jax.npz", tx=ptx, device=CPU)
    want = jdiff.load_checkpoint(tmp_path / "port.npz", tx=jtx)
    for a, b in ((got, jdiff.load_checkpoint(tmp_path / "jax.npz", tx=jtx)),
                 (diff.load_checkpoint(tmp_path / "port.npz", tx=ptx, device=CPU), want)):
        assert a["step"] == b["step"] == 2
        for key in ("params", "camera_deltas", "exposure", "opt_state"):
            assert a[key] is not None and b[key] is not None, key
            _assert_trees_close(a[key], b[key])
