"""The port's bench suite against the JAX package's tools/bench_suite.py,
config(s) 3,5 small on the CPU (the checks: tests/bench_suite_cases.py)."""

import pytest

from bench_suite_cases import check_config


@pytest.mark.parametrize("config", [3,5])
def test_config_line_matches_jax(config, capsys):
    check_config(config, capsys)
