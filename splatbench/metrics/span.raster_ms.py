"""Device ms a replayed window frame of stage F (pack_pair_data and K4):
the program's stamps around it (the frame record's
``renderDepthBuffer``), over the window's replayed frames outside the
traced stretch (splatbench/spans.py)."""

from splatbench import spans


def read(r):
    return spans.stage_ms(r, "renderDepthBuffer")
