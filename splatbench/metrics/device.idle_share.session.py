"""device.idle_share in the cells of viewer sessions, which report
session_frame_ms: the same reader (splatbench/spans.py)."""

from splatbench.spans import read_idle_share as read  # noqa: F401
