"""cudagaussianrenderer_torch.tools.smoke_batch on the CPU: each target is
one test and must finish without a failed line, at 2,000 splats, 256² and
16,384 slots (the bench and suite config 1 scaled alike: 64² and a tenth
of their splats): the JAX smoke's 20,000 splats at 1024² take ~1 s a
frame here.  The ``selfcheck`` target runs in test_torch_selfcheck.py, where
it is also the selfcheck's own passing test."""

import pytest
import torch

from cudagaussianrenderer_torch.tools import smoke_batch

from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)

TARGETS = [t for t in smoke_batch.TARGETS if t != "selfcheck"]


def test_targets_are_every_measure_subcommand_and_the_tools():
    assert smoke_batch.TARGETS == smoke_batch.measure.COMMANDS + ("bench", "suite1", "selfcheck")
    assert len(smoke_batch.measure.COMMANDS) == 11


@pytest.mark.parametrize("target", TARGETS)
def test_smoke_target_runs_on_the_cpu(target, capsys):
    code = smoke_batch.main(["--device", "cpu", "--n", "2000", "--capacity", "16384",
                             "--size", "256", target])
    out = capsys.readouterr().out
    assert code == 0, out[-3000:]
    assert f"SMOKE {target} DONE" in out and "FAILED" not in out


def test_a_failing_target_makes_the_exit_code_one(monkeypatch, capsys):
    def broken(*args, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(smoke_batch.bench, "main", broken)
    assert smoke_batch.main(["--device", "cpu", "bench"]) == 1
    assert "SMOKE bench FAILED: RuntimeError: boom" in capsys.readouterr().out


def test_the_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        smoke_batch.main(["sort"])
