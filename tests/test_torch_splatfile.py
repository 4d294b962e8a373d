"""The port's .splat reader and writer (cudagaussianrenderer_torch.splatfile)
against the JAX package's on the same scenes and bytes: the same records
written, the same scenes loaded bit for bit, the same errors."""

import io

import numpy as np
import pytest

import cudagaussianrenderer_torch as pt
import cudagaussianrenderer_tpu as jx
import cudagaussianrenderer_tpu.splatfile as jsf
from cudagaussianrenderer_torch import splatfile as psf
from cudagaussianrenderer_torch.utils.quantize import decode_quat_xyzw

from torch_port_cases import assert_same_scene


def _write(mod, scene):
    buf = io.BytesIO()
    mod.write_splat(buf, scene)
    assert buf.tell() == scene.count * psf.RECORD_BYTES
    return buf.getvalue()


@pytest.mark.parametrize("sh_degree", [0, 2])
def test_write_matches_jax_bytes(sh_degree):
    """SH beyond DC has no place in the format: both keep the baked colour."""
    got = _write(psf, pt.random_scene(64, seed=7, sh_degree=sh_degree, device="cpu"))
    assert got == _write(jsf, jx.random_scene(64, seed=7, sh_degree=sh_degree))


def test_load_matches_jax():
    data = _write(jsf, jx.random_scene(64, seed=7))
    got = psf.load_splat(io.BytesIO(data), device="cpu")
    assert_same_scene(got, jsf.load_splat(io.BytesIO(data)))
    assert got.sh is None and got.sh_degree == 0 and got.device.type == "cpu"


def test_roundtrip_preserves_fields():
    scene = pt.random_scene(64, seed=7, device="cpu")
    back = psf.load_splat(io.BytesIO(_write(psf, scene)), device="cpu")
    np.testing.assert_array_equal(back.means.numpy(), scene.means.numpy())
    np.testing.assert_array_equal(back.scales.numpy(), scene.scales.numpy())
    m = back.means.numpy()
    np.testing.assert_allclose(back.bounds_min, m.min(axis=1), rtol=1e-6)
    np.testing.assert_allclose(back.bounds_max, m.max(axis=1), rtol=1e-6)
    np.testing.assert_allclose(back.colors.numpy(), np.clip(scene.colors.numpy(), 0, 1),
                               atol=0.5 / 255.0 + 1e-7)
    np.testing.assert_allclose(back.opacities.numpy(), scene.opacities.numpy(),
                               atol=0.5 / 255.0 + 1e-7)
    q0, q1 = decode_quat_xyzw(scene.quats.numpy()), decode_quat_xyzw(back.quats.numpy())
    q0 /= np.maximum(np.linalg.norm(q0, axis=1, keepdims=True), 1e-30)
    q1 /= np.maximum(np.linalg.norm(q1, axis=1, keepdims=True), 1e-30)
    assert np.abs(np.sum(q0 * q1, axis=1)).min() > 1.0 - 4.0 / 128.0


def test_second_roundtrip_is_stable():
    once = psf.load_splat(io.BytesIO(_write(psf, pt.random_scene(32, seed=3, device="cpu"))),
                          device="cpu")
    twice = psf.load_splat(io.BytesIO(_write(psf, once)), device="cpu")
    for f in ("means", "scales", "opacities", "colors"):
        np.testing.assert_array_equal(getattr(once, f).numpy(), getattr(twice, f).numpy())


def _bad_records():
    nan = np.zeros(32, np.uint8)
    nan[:4] = np.frombuffer(np.float32(np.nan).tobytes(), np.uint8)
    neg = np.zeros(32, np.uint8)
    neg[12:16] = np.frombuffer(np.float32(-1.0).tobytes(), np.uint8)
    return {"empty": (b"", "Empty"), "ragged": (b"\x00" * 33, "multiple"),
            "nan-position": (nan.tobytes(), "finite"), "negative-scale": (neg.tobytes(), "scale")}


@pytest.mark.parametrize("name", list(_bad_records()))
def test_rejects_malformed_input_like_jax(name):
    data, match = _bad_records()[name]
    with pytest.raises(psf.SplatError, match=match) as got:
        psf.load_splat(io.BytesIO(data), device="cpu")
    with pytest.raises(jsf.SplatError) as want:
        jsf.load_splat(io.BytesIO(data))
    assert str(got.value) == str(want.value)


def test_load_scene_by_extension(tmp_path):
    scene = jx.random_scene(20, seed=4, sh_degree=1)
    splat = tmp_path / "s.splat"
    jsf.write_splat(splat, scene)
    assert_same_scene(psf.load_scene(splat, device="cpu"), jsf.load_scene(splat))
    ply = tmp_path / "s.ply"
    rng = np.random.default_rng(1)
    pt.write_gaussian_ply(ply, rng.normal(size=(8, 3)).astype(np.float32),
                          rng.normal(size=(8, 3)).astype(np.float32) - 2,
                          rng.normal(size=(8, 4)).astype(np.float32),
                          rng.normal(size=8).astype(np.float32),
                          rng.normal(size=(8, 3)).astype(np.float32))
    assert_same_scene(pt.load_scene(ply, device="cpu"), jx.load_scene(ply))
