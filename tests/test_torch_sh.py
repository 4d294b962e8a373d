"""The port's ops/sh.py:sh_basis against the repository's three references
of the real SH basis: the associated-Legendre oracle of the port's
golden.py (tests/test_sh.py's tolerance), the JAX sh_basis on NumPy, and
the symbolic basis of tools/sh_codegen.py (tests/test_sh_codegen.py's
bound)."""

import pathlib
import sys

import numpy as np
import pytest
import torch

from cudagaussianrenderer_torch.golden import oracle_sh_basis
from cudagaussianrenderer_torch.ops.sh import num_sh_coeffs, sh_basis
from cudagaussianrenderer_tpu.ops import sh as jax_sh


def unit_dirs(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_sh_basis_matches_legendre_oracle(degree):
    dirs = unit_dirs(512, 42)
    got = sh_basis(torch.from_numpy(dirs.astype(np.float32)), degree)
    assert got.shape == (512, num_sh_coeffs(degree)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), oracle_sh_basis(dirs, degree), rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("degree", [0, 2, 4])
def test_sh_basis_matches_jax_sh_basis(degree):
    """Same float32 directions, batched [4, 64, 3]: the port's basis within
    1e-6 of the JAX one on NumPy."""
    dirs = unit_dirs(256, 7).astype(np.float32).reshape(4, 64, 3)
    got = sh_basis(torch.from_numpy(dirs), degree).numpy()
    want = jax_sh.sh_basis(dirs, degree, xp=np)
    assert got.shape == want.shape == (4, 64, num_sh_coeffs(degree))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sh_basis_matches_symbolic_codegen():
    """The port's table against tools/sh_codegen.py's sympy basis up to
    degree 4, as check_against_table holds the JAX table: max error below
    1e-5 over 128 unit directions."""
    sp = pytest.importorskip("sympy")
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
    import sh_codegen

    dirs = unit_dirs(128, 0)
    table = sh_basis(torch.from_numpy(dirs), 4).numpy()
    worst = 0.0
    rows = sh_codegen.generate(4)
    assert len(rows) == num_sh_coeffs(4)
    for i, (_, expr) in enumerate(rows):
        fn = sp.lambdify((sh_codegen.X, sh_codegen.Y, sh_codegen.Z), expr, "math")
        sym = np.array([fn(*p) for p in dirs])
        worst = max(worst, float(np.max(np.abs(sym - table[:, i]))))
    assert worst < 1e-5, worst
