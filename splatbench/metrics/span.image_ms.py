"""Device ms a replayed window frame of stage tiles_to_image (the u8
image): the program's stamps around it (the frame record's
``tilesToImage``), over the window's replayed frames outside the traced
stretch (splatbench/spans.py)."""

from splatbench import spans


def read(r):
    return spans.stage_ms(r, "tilesToImage")
