"""The port's PNG writer and reader (cudagaussianrenderer_torch.utils.png):
the JAX package's bytes, read back bit for bit by itself and by PIL."""

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch.utils import png as ppng
from cudagaussianrenderer_tpu.utils import png as jpng


@pytest.mark.parametrize("shape", [(48, 64, 4), (16, 128, 3), (9, 7)], ids=["rgba", "rgb", "gray"])
@pytest.mark.parametrize("level", [6, 0])
def test_encode_matches_jax_and_reads_back(tmp_path, shape, level):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape, dtype=np.uint8)
    data = ppng.encode_png(img, level=level)
    assert data == jpng.encode_png(img, level=level)
    back = ppng.read_png(data)
    np.testing.assert_array_equal(back.reshape(img.shape), img)
    np.testing.assert_array_equal(jpng.read_png(data), back)
    path = tmp_path / "x.png"
    ppng.write_png(path, torch.from_numpy(img))
    np.testing.assert_array_equal(ppng.read_png(path).reshape(img.shape), img)


def test_pil_reads_the_port_png(tmp_path):
    PIL = pytest.importorskip("PIL.Image")
    img = np.zeros((16, 128, 3), np.uint8)
    img[:, ::2, 1] = 255
    path = tmp_path / "y.png"
    ppng.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(PIL.open(path)), img)


def test_reader_undoes_every_filter():
    """PIL writes rows with filters 1-4; the reader undoes them all."""
    PIL = pytest.importorskip("PIL.Image")
    import io

    img = np.random.default_rng(1).integers(0, 256, (12, 10, 4), dtype=np.uint8)
    img[:, :5] = img[:, :1]  # smooth runs, so that PIL picks filters besides 0
    buf = io.BytesIO()
    PIL.fromarray(img).save(buf, format="PNG", optimize=True)
    np.testing.assert_array_equal(ppng.read_png(buf.getvalue()), img)


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        ppng.encode_png(np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError):
        ppng.encode_png(np.zeros((4, 4, 2), np.uint8))
    with pytest.raises(ValueError):
        ppng.read_png(b"not a png at all")
