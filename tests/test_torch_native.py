"""The port's binding of the native C++ loader (native/libgsply.so, through
cudagaussianrenderer_torch.utils.native) against the JAX package's binding
of the same library, and against the port's Python importer with the JAX
suite's own tolerance (tests/test_native.py).  Every case skips when the
library cannot be built here, as tests/test_native.py does."""

import numpy as np
import pytest

import cudagaussianrenderer_tpu.ply as jply
from cudagaussianrenderer_torch import ply as pply
from cudagaussianrenderer_torch.utils.native import native_available

from torch_port_cases import assert_same_scene


@pytest.fixture
def native():
    # Decided in the test, never at import: each worker imports this file.
    if not native_available():
        pytest.skip("libgsply.so not built (make -C native)")


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    n, degree = 64, 2
    path = tmp_path_factory.mktemp("scenes") / "scene.ply"
    pply.write_gaussian_ply(
        path,
        rng.normal(size=(n, 3)).astype(np.float32) * 2,
        rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2,
        rng.normal(size=(n, 4)).astype(np.float32),
        rng.normal(size=n).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 3, (degree + 1) ** 2 - 1)).astype(np.float32) * 0.2,
    )
    return path


def _native_pair(path):
    return (pply.load_gaussian_ply(path, use_native=True, device="cpu"),
            jply.load_gaussian_ply(path, use_native=True))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_native_matches_jax_native(native, tmp_path, degree):
    rng = np.random.default_rng(degree)
    n = 40
    path = tmp_path / f"deg{degree}.ply"
    pply.write_gaussian_ply(
        path, rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 3)).astype(np.float32) - 2, rng.normal(size=(n, 4)).astype(np.float32),
        rng.normal(size=n).astype(np.float32), rng.normal(size=(n, 3)).astype(np.float32),
        rng.normal(size=(n, 3, (degree + 1) ** 2 - 1)).astype(np.float32) if degree else None)
    got, want = _native_pair(path)
    assert_same_scene(got, want)
    assert got.sh_degree == degree and got.device.type == "cpu"


def test_native_matches_python(native, scene_file):
    """The JAX suite's rule: quaternions and counts exact, float fields
    within rtol 1e-6, bounds within 1e-5."""
    nat = pply.load_gaussian_ply(scene_file, use_native=True, device="cpu")
    py = pply.load_gaussian_ply(scene_file, use_native=False, device="cpu")
    assert nat.count == py.count
    assert nat.sh_degree == py.sh_degree == 2
    for f in ("means", "scales", "opacities", "colors", "sh"):
        np.testing.assert_allclose(getattr(nat, f).numpy(), getattr(py, f).numpy(), rtol=1e-6,
                                   err_msg=f)
    np.testing.assert_array_equal(nat.quats.numpy(), py.quats.numpy())
    np.testing.assert_allclose(nat.bounds_min, py.bounds_min, rtol=1e-5)
    np.testing.assert_allclose(nat.bounds_max, py.bounds_max, rtol=1e-5)
    assert_same_scene(nat, jply.load_gaussian_ply(scene_file, use_native=True))


def _same_native_error(path):
    with pytest.raises(pply.PlyError) as got:
        pply.load_gaussian_ply(path, use_native=True, device="cpu")
    with pytest.raises(jply.PlyError) as want:
        jply.load_gaussian_ply(path, use_native=True)
    assert str(got.value) == str(want.value)
    return str(got.value)


def test_native_error_messages(native, tmp_path):
    bad = tmp_path / "bad.ply"
    bad.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                    b"property float x\nend_header\n" + b"\x00" * 4)
    assert "Required property absent" in _same_native_error(bad)


@pytest.mark.parametrize("count,match", [
    (b"9223372036854775807", "ends early"),
    (b"99999999999999999999", "Malformed vertex count"),
    (b"garbage", "Malformed vertex count"),
    (b"-5", "Malformed vertex count"),
    (b"0", "declares zero vertices"),
])
def test_native_rejects_hostile_and_malformed_counts(native, scene_file, tmp_path, count, match):
    bad = tmp_path / "bad_count.ply"
    bad.write_bytes(scene_file.read_bytes().replace(b"element vertex 64",
                                                    b"element vertex " + count))
    assert match in _same_native_error(bad)


def test_native_truncated_body_keeps_message(native, scene_file, tmp_path):
    bad = tmp_path / "truncated.ply"
    good = scene_file.read_bytes()
    bad.write_bytes(good[: len(good) - 64])
    assert "ends early" in _same_native_error(bad)


def test_native_long_comment_line(native, scene_file, tmp_path):
    marker = b"format binary_little_endian 1.0\n"
    bad = tmp_path / "long_comment.ply"
    bad.write_bytes(scene_file.read_bytes().replace(
        marker, marker + b"comment " + b"y" * 600 + b"element vertex 0\n"))
    got, want = _native_pair(bad)
    assert got.count == 64
    assert_same_scene(got, want)


def test_zero_norm_quat_parity(native, tmp_path):
    n = 4
    rng = np.random.default_rng(3)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    quats[1] = 0.0
    path = tmp_path / "zero_quat.ply"
    pply.write_gaussian_ply(path, rng.normal(size=(n, 3)).astype(np.float32),
                            rng.normal(size=(n, 3)).astype(np.float32), quats,
                            rng.normal(size=n).astype(np.float32),
                            rng.normal(size=(n, 3)).astype(np.float32), None)
    got, want = _native_pair(path)
    assert_same_scene(got, want)
    np.testing.assert_array_equal(
        got.quats.numpy(), pply.load_gaussian_ply(path, use_native=False, device="cpu").quats.numpy())
