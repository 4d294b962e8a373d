"""Device ms a replayed window frame of stage C (ops/binning.py: the torch
half, then K2 and K3): the program's stamps around it (the frame
record's ``buildTileList``), over the window's replayed frames outside
the traced stretch (splatbench/spans.py)."""

from splatbench import spans


def read(r):
    return spans.stage_ms(r, "buildTileList")
