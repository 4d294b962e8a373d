"""The device's idle share of the window's replayed frames outside the
traced stretch, %: 1 - their device time (the program's first stamp of a
frame to its last, plus the device time of a traced frame's readback
copies) over their host spans (the whole Renderer.render call).  It also writes the traced stretch's longest idle
gaps to standard error, each with the program span that covers it
(splatbench/overlay.py)."""

from splatbench.spans import read_idle_share as read  # noqa: F401
