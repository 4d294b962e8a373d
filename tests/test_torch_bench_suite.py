"""The port's bench suite (cudagaussianrenderer_torch.tools.bench_suite)
against the JAX package's tools/bench_suite.py: config 2's synth_ply and
config 6's opacities bit-equal, and configs 1 and 2 small on the CPU
(tests/bench_suite_cases.py holds the checks; the other configs are in
test_torch_bench_suite_{sh,falloff,alpha}.py)."""

import numpy as np
import pytest

from cudagaussianrenderer_torch.tools import bench_suite as port_suite

from bench_suite_cases import check_config, jax_scene, jax_suite
from torch_port_cases import assert_same_scene


def test_synth_ply_is_bit_equal_to_the_jax_suite():
    assert_same_scene(port_suite.synth_ply(2000, 1, device="cpu"), jax_suite.synth_ply(2000, 1))


def test_realistic_opacities_equal_the_jax_suite():
    n = 5000
    want = np.asarray(jax_scene(6, n).opacities)
    np.testing.assert_array_equal(port_suite.realistic_opacities(n), want)


@pytest.mark.parametrize("config", [1, 2])
def test_config_line_matches_jax(config, capsys):
    check_config(config, capsys)


def test_suite_refuses_unknown_configs():
    with pytest.raises(SystemExit):
        port_suite.main(["7", "--device", "cpu"])
