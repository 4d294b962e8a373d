"""The port's .ply importer and exporter (cudagaussianrenderer_torch.ply)
against the JAX package's (cudagaussianrenderer_tpu.ply) on the same bytes:
header validation, the typed transform (activations, SH inference and
reorder, 8-bit rotations, bounds), error classes and messages.  Loaded
scenes must be bit-equal; these run the Python importer (streams always
take it; tests/test_torch_native.py covers the native one)."""

import io
import re

import numpy as np
import pytest

import cudagaussianrenderer_tpu.ply as jply
from cudagaussianrenderer_torch import ply as pply
from cudagaussianrenderer_torch.models.scene import SH_C0
from cudagaussianrenderer_torch.utils.quantize import decode_quat_xyzw

from torch_port_cases import assert_same_scene


def _raw(n=16, degree=0, seed=0):
    rng = np.random.default_rng(seed)
    raw = dict(
        means=rng.normal(size=(n, 3)).astype(np.float32) * 2.0,
        scales_log=rng.normal(size=(n, 3)).astype(np.float32) * 0.3 - 2.0,
        quats=rng.normal(size=(n, 4)).astype(np.float32),
        opacity=rng.normal(size=n).astype(np.float32),
        f_dc=rng.normal(size=(n, 3)).astype(np.float32),
        f_rest=None,
    )
    if degree > 0:
        raw["f_rest"] = rng.normal(size=(n, 3, (degree + 1) ** 2 - 1)).astype(np.float32) * 0.2
    return raw


def _bytes(raw, extra=None, writer=pply.write_gaussian_ply):
    buf = io.BytesIO()
    writer(buf, raw["means"], raw["scales_log"], raw["quats"], raw["opacity"], raw["f_dc"],
           raw["f_rest"], extra_properties=extra)
    return buf.getvalue()


def _both(call, data):
    """call(module, stream) for the port and the JAX package on the same
    bytes: (port result, JAX result)."""
    return call(pply, io.BytesIO(data)), call(jply, io.BytesIO(data))


def _load(mod, stream):
    return mod.load_gaussian_ply(stream, device="cpu") if mod is pply else mod.load_gaussian_ply(stream)


def _same_error(call, data):
    """Both packages raise their PlyError with the same message."""
    with pytest.raises(pply.PlyError) as got:
        call(pply, io.BytesIO(data))
    with pytest.raises(jply.PlyError) as want:
        call(jply, io.BytesIO(data))
    assert str(got.value) == str(want.value)
    return str(got.value)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_writer_writes_the_jax_bytes(degree):
    raw = _raw(n=12, degree=degree, seed=degree)
    extra = {"nx": np.arange(12, dtype=np.float32)}
    assert _bytes(raw, extra) == _bytes(raw, extra, writer=jply.write_gaussian_ply)


HEADERS = {
    "big-endian": (b"ply\nformat binary_big_endian 1.0\nelement vertex 1\nproperty float x\n"
                   b"end_header\n", "binary_little_endian"),
    "duplicate": (b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                  b"property float x\nproperty float x\nend_header\n", "declared twice"),
    "non-float": (b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                  b"property uchar red\nend_header\n", "only float"),
    "missing-end": (b"ply\nformat binary_little_endian 1.0\nelement vertex 1\nproperty float x\n",
                    "end_header.*not found"),
    "negative-count": (b"ply\nformat binary_little_endian 1.0\nelement vertex -3\n"
                       b"property float x\nend_header\n", "Malformed vertex count"),
    "blank-line": (b"ply\n\nformat binary_little_endian 1.0\n", "Blank line"),
    "other-element": (b"ply\nformat binary_little_endian 1.0\nelement face 3\n", "only 'vertex'"),
}


@pytest.mark.parametrize("name", list(HEADERS))
def test_header_errors_match(name):
    data, match = HEADERS[name]
    msg = _same_error(lambda mod, f: mod.parse_header(f), data)
    assert re.search(match, msg)


def test_header_ignores_comments():
    data = (b"ply\ncomment made by nobody\nformat binary_little_endian 1.0\n"
            b"element vertex 0\nproperty float x\nend_header\n")
    got, want = _both(lambda mod, f: mod.parse_header(f), data)
    assert got == want == (["x"], 0)


def test_columns_match():
    raw = _raw(n=8)
    (gcols, gn), (wcols, wn) = _both(lambda mod, f: mod.parse_ply_columns(f), _bytes(raw))
    assert gn == wn == 8 and list(gcols) == list(wcols)
    for name in gcols:
        np.testing.assert_array_equal(gcols[name], wcols[name])
    np.testing.assert_array_equal(gcols["x"], raw["means"][:, 0])


def test_sh_degree_inference_matches():
    for extra in (0, 9, 24, 45, 72):
        assert pply.infer_sh_degree(extra) == jply.infer_sh_degree(extra)
    _same_error(lambda mod, f: mod.infer_sh_degree(10), b"")


def test_activations_and_quantization():
    raw = _raw(n=32, seed=3)
    got, want = _both(_load, _bytes(raw))
    assert_same_scene(got, want)
    assert got.count == 32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.means.numpy().T, raw["means"], rtol=1e-6)
    np.testing.assert_allclose(got.scales.numpy().T, np.exp(raw["scales_log"]), rtol=1e-6)
    np.testing.assert_allclose(got.opacities.numpy(), 1.0 / (1.0 + np.exp(-raw["opacity"])),
                               rtol=1e-5)
    np.testing.assert_allclose(got.colors.numpy().T, raw["f_dc"] * SH_C0 + 0.5, rtol=1e-5)
    qn = raw["quats"] / np.linalg.norm(raw["quats"], axis=1, keepdims=True)
    np.testing.assert_allclose(decode_quat_xyzw(got.quats.numpy()), qn[:, [1, 2, 3, 0]],
                               atol=2.0 / 255.0 + 1e-6)


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_reorder_matches(degree):
    raw = _raw(n=8, degree=degree, seed=7)
    got, want = _both(_load, _bytes(raw))
    assert_same_scene(got, want)
    assert got.sh_degree == degree
    if degree:
        k = (degree + 1) ** 2
        assert got.sh.shape == (3, k, 8)
        sh = np.transpose(got.sh.numpy(), (2, 1, 0))
        np.testing.assert_array_equal(sh[:, 0, :], raw["f_dc"])
        for c in range(3):
            np.testing.assert_array_equal(sh[:, 1:, c], raw["f_rest"][:, c, :])


def test_zero_norm_quaternion_matches():
    raw = _raw(n=4, seed=3)
    raw["quats"][1] = 0.0
    got, want = _both(_load, _bytes(raw))
    assert_same_scene(got, want)
    assert np.isfinite(got.means.numpy()).all()


def test_missing_required_property_matches():
    data = (b"ply\nformat binary_little_endian 1.0\nelement vertex 0\n"
            b"property float x\nproperty float y\nend_header\n")
    assert "Required property absent" in _same_error(_load, data)


def test_bad_sh_count_matches():
    extra = {f"f_rest_{i}": np.zeros(4, np.float32) for i in range(5)}
    assert "does not complete an SH degree" in _same_error(_load, _bytes(_raw(n=4), extra))


def test_empty_vertex_element_matches():
    data = _bytes(_raw(n=1)).replace(b"element vertex 1", b"element vertex 0")
    assert "declares zero vertices" in _same_error(
        _load, data[: data.index(b"end_header\n") + 11])


def test_truncated_body_matches():
    data = _bytes(_raw(n=8))
    assert "ends early" in _same_error(_load, data[:-5])


class _DribbleStream(io.RawIOBase):
    """read() returns at most 7 bytes a call, like a raw or pipe stream."""

    def __init__(self, data):
        self._buf = io.BytesIO(data)

    def read(self, n=-1):
        return self._buf.read(min(n, 7) if n is not None and n >= 0 else 7)

    def readline(self, *a):
        return self._buf.readline(*a)


def test_short_read_streams_load_fully():
    data = _bytes(_raw(n=16, degree=1))
    got = pply.load_gaussian_ply(_DribbleStream(data), device="cpu")
    assert_same_scene(got, jply.load_gaussian_ply(_DribbleStream(data)))
    assert got.count == 16


def test_file_path_without_native_matches(tmp_path):
    path = tmp_path / "scene.ply"
    path.write_bytes(_bytes(_raw(n=20, degree=2, seed=4)))
    assert_same_scene(pply.load_gaussian_ply(path, use_native=False, device="cpu"),
                      jply.load_gaussian_ply(path, use_native=False))
