"""Host ms a window frame in the instantiation of the frame loop's
captures: the program's capture.instantiate spans (capture_end), summed
over the window's frames outside the traced stretch, over those frames."""

from splatbench import spans


def read(r):
    return spans.spans_ms_a_frame(r, ("capture.instantiate",))
