"""The port's graft entry (cudagaussianrenderer_torch.graft_entry.entry)
against the JAX repository's __graft_entry__.entry on the CPU: the same
scene and camera, field by field, and the port's frame against the jitted
JAX ``fn`` (its Pallas kernels in interpret mode) by the suite's image rule
(at most 2% of pixels more than 8 levels off).  Also: the entry raises
where CUDA is absent and the caller did not ask for the CPU, its command
line renders the frame on the CPU, and the module imports neither jax nor
the JAX package."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch import graft_entry

import torch_port_cases as cases
from torch_port_cases import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_entry():
    spec = importlib.util.spec_from_file_location("__graft_entry__", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.entry()


@pytest.fixture(scope="module")
def port_entry():
    return graft_entry.entry(device="cpu")


def test_example_args_equal_the_jax_entry(jax_entry, port_entry):
    (_, (jscene, jcam)), (_, (pscene, pcam)) = jax_entry, port_entry
    cases.assert_same_scene(pscene, jscene)
    assert pscene.padded_count == 4096 and pscene.sh_degree == 2
    assert set(pcam) == set(jcam)
    for k, v in jcam.items():
        want = np.asarray(v, np.float32)
        got = pcam[k].numpy()
        assert got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-7, atol=0, err_msg=k)


def test_entry_frame_matches_the_jitted_jax_fn(jax_entry, port_entry):
    (jfn, jargs), (pfn, pargs) = jax_entry, port_entry
    want = np.asarray(jax.jit(jfn)(*jargs))
    got = pfn(*pargs)
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    got = got.numpy()
    assert got.shape == want.shape == (256, 256, 4)
    assert got[..., 3].max() == 255 and got[..., :3].max() > 0
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    print(f"entry frame against the JAX fn: max diff {int(diff.max())} levels, "
          f"{float((diff > cases.PIX_TOL).any(axis=-1).mean()):.4f} of pixels past "
          f"{cases.PIX_TOL}")
    cases.image_close(got, want, "the entry frame against the JAX fn")


def test_entry_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graft_entry.main([])


def test_main_renders_the_entry_frame_on_the_cpu(capsys):
    assert graft_entry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "entry: (256, 256, 4)"


def test_graft_entry_imports_no_jax():
    code = ("import sys, cudagaussianrenderer_torch.graft_entry; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cudagaussianrenderer_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)
