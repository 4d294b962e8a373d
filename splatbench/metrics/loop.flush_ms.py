"""Host ms a window frame in the allocator's flush of the frame loop's
captures: the program's capture.flush spans (torch.cuda.graph's __enter__:
the device and pinned-host caches emptied, capture_begin), summed over the
window's frames outside the traced stretch, over those frames."""

from splatbench import spans


def read(r):
    return spans.spans_ms_a_frame(r, ("capture.flush",))
