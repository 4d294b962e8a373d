"""Host ms a window frame in the warm-ups and host launches of the frame
loop's captures: the program's capture.warmup (the side-stream frame's
launches), capture.sync (the wait for its device work) and capture.record
(the frame under capture) spans, summed over the window's frames outside
the traced stretch, over those frames."""

from splatbench import spans


def read(r):
    return spans.spans_ms_a_frame(r, ("capture.warmup", "capture.sync", "capture.record"))
