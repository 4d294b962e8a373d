"""RenderConfig fields away from their defaults, layout cases: the port's
frame against the JAX package's (tests/config_field_cases.py)."""

import pytest

from config_field_cases import LAYOUT_CASES, check_config_frame
from torch_port_cases import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize("name,cfg_kw,scene_kw,shows", LAYOUT_CASES,
                         ids=[c[0] for c in LAYOUT_CASES])
def test_config_frame_matches_jax(name, cfg_kw, scene_kw, shows):
    check_config_frame(name, cfg_kw, scene_kw, shows)
