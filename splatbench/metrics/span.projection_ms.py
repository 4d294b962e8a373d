"""Device ms a replayed window frame of stage B (ops/projection.py): the
program's stamps around it (the frame record's ``evaluateClipData``),
over the window's replayed frames outside the traced stretch
(splatbench/spans.py)."""

from splatbench import spans


def read(r):
    return spans.stage_ms(r, "evaluateClipData")
