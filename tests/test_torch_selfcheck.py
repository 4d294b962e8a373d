"""The port's selfcheck (cudagaussianrenderer_torch.tools.selfcheck), on the
CPU with the kernels' plain versions: every case passes through
smoke_batch's ``selfcheck`` target, a frame that drifts makes it exit 1,
and its cases are the JAX tools/tpu_selfcheck.py's (that script imports
jax and reconfigures the compilation cache at import, so its case list is
read from its source, not imported)."""

import ast
from pathlib import Path

import numpy as np
import torch

from cudagaussianrenderer_torch.tools import selfcheck, smoke_batch

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

ROOT = Path(__file__).resolve().parent.parent


def jax_cases():
    """(name, case) of the JAX script's ``cases`` list, by its source."""
    tree = ast.parse((ROOT / "tools" / "tpu_selfcheck.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "cases":
            src = ast.unparse(node.value)
            # A list of dict(...) calls and products of literals, from the repo.
            return eval(src, {"__builtins__": {}, "dict": dict})
    raise AssertionError("no case list in tools/tpu_selfcheck.py")


def test_cases_are_the_jax_selfchecks():
    assert [name for name, _ in selfcheck.CASES] == [name for name, _ in jax_cases()]
    for (_, got), (name, want) in zip(selfcheck.CASES, jax_cases()):
        assert got == want, name
    name, case = selfcheck.BALANCED
    assert case == dict(n=500, seed=2, cfg=dict(screen_size=128), capacity=16384, n_dev=2)


def test_selfcheck_passes_on_the_cpu(capsys):
    smoke_batch.run("selfcheck", torch.device("cpu"))
    out = capsys.readouterr().out
    assert "PASS" in out and out.count(" ok") == len(selfcheck.CASES) + 1


def test_selfcheck_exits_one_on_drift(monkeypatch, capsys):
    """One case's oracle frame with its red channel inverted drifts."""
    golden = selfcheck.golden_render

    def inverted(*args, **kw):
        frame = golden(*args, **kw).copy()
        frame[..., 0] = 255 - frame[..., 0]
        return frame

    monkeypatch.setattr(selfcheck, "CASES", selfcheck.CASES[:1])
    monkeypatch.setattr(selfcheck, "golden_render", inverted)
    assert selfcheck.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "DRIFT" in out and "FAILED: ['gaussian 128px', 'balanced bands 2-dev 128px']" in out


def test_compare_counts_pixels_past_the_tolerance():
    want = np.zeros((4, 4, 4), np.uint8)
    got = want.copy()
    got[0, 0, 1] = 9
    got[1, 1, 2] = 8
    assert selfcheck.compare(got, want, 8) == (1 / 16, 9)
