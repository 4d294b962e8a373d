"""The harness's door to the program's own frame records.

The program keeps a record of each ``Renderer.render`` call
(``cudagaussianrenderer_torch.telemetry.frames()``): its host spans on
``time.perf_counter_ns``, its method, its counters and the device stamps
of its stages.  ``matched`` pairs the window's frames with the last of
those records: the window renders its frames one after another, ``j``
after ``j``, and nothing renders through a Renderer after it, so the last
``len(frames) + len(traced)`` records are the window's, in ``j`` order.
Each pair must agree on the method; a program that keeps no records, too
few of them, or one that disagrees, gives None, and so does every reader
of this file.  The readers read the window's frames outside the traced
stretch, which ran without the profiler.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def program_records():
    """(the records, the program's telemetry module), or None where the
    program keeps no records."""
    try:
        from cudagaussianrenderer_torch import telemetry
    except ImportError:
        return None
    return telemetry.frames(), telemetry


def matched(r) -> Optional[Tuple[np.ndarray, np.ndarray, object]]:
    """(the window's records in ``j`` order, whether each frame was traced,
    the telemetry module), or None."""
    got = program_records()
    if got is None:
        return None
    records, telemetry = got
    window: List[Tuple[dict, bool]] = sorted(
        [(f, False) for f in r.frames] + [(f, True) for f in r.traced], key=lambda ft: ft[0]["j"])
    if not window or len(records) < len(window):
        return None
    records = records[len(records) - len(window):]
    for (f, _), method in zip(window, records["method"]):
        if not 0 <= method < len(telemetry.METHODS) or f["method"] != telemetry.METHODS[method]:
            return None
    return records, np.array([traced for _, traced in window]), telemetry


def untraced(r) -> Optional[Tuple[np.ndarray, object]]:
    """(the records of the window's frames outside the traced stretch, the
    telemetry module), or None where there are none."""
    got = matched(r)
    if got is None:
        return None
    records, traced, telemetry = got
    records = records[~traced]
    return (records, telemetry) if len(records) else None


def _stamped(records: np.ndarray) -> np.ndarray:
    return records["device"][:, 0] >= 0


def stage_ms(r, stage: str) -> Optional[float]:
    """Device ms of ``stage`` (telemetry.STAGES) a replayed untraced
    frame, from its stamps."""
    got = untraced(r)
    if got is None:
        return None
    records, telemetry = got
    keep = _stamped(records) & (records["method"] == telemetry.METHODS.index("replay"))
    if not keep.any():
        return None
    i = telemetry.STAGES.index(stage)
    d = records["device"][keep]
    return float(np.mean(d[:, i + 1] - d[:, i])) / 1e6


def counter_share(r, part: str, whole: str) -> Optional[float]:
    """100 x the sum of counter ``part`` over that of ``whole``, over the
    untraced frames that read their counters back, %."""
    got = untraced(r)
    if got is None:
        return None
    records, telemetry = got
    c = records["counters"]
    p, w = c[:, telemetry.COUNTERS.index(part)], c[:, telemetry.COUNTERS.index(whole)]
    keep = (p >= 0) & (w >= 0)
    total = int(w[keep].sum())
    return 100.0 * int(p[keep].sum()) / total if total > 0 else None


def spans_ms_a_frame(r, names) -> Optional[float]:
    """The host spans ``names`` summed over the untraced frames, over
    those frames: ms a frame."""
    got = untraced(r)
    if got is None:
        return None
    records, telemetry = got
    total = sum(np.maximum(telemetry.span_ns(records, n), 0).sum() for n in names)
    return float(total) / 1e6 / len(records)


# The device records of a frame's readback (the counts and the image to
# the host), which follow its last stamp.
READBACK = r"^Memcpy DtoH"


def idle_share(r) -> Optional[float]:
    """100 x (1 - the frames' device time / their host frame spans), over
    the untraced replayed frames, %.  A frame's device time is its first
    stamp to its last, plus the device time of a traced frame's readback
    (READBACK, from the stretch: an estimate, since a copy to pageable
    memory varies with the host's page faults).  The host's frame span is the
    whole Renderer.render call.  Eager frames and captures are left out:
    their stamps are launched between their kernels as the host gets to
    them, so their stamp spans hold the host's launch time too (the loop.*
    metrics read their host spans)."""
    got = untraced(r)
    if got is None or r.stretch is None or not r.traced:
        return None
    records, telemetry = got
    keep = _stamped(records) & (records["method"] == telemetry.METHODS.index("replay"))
    frame = np.maximum(telemetry.span_ns(records[keep], "frame"), 0)
    if not keep.any() or frame.sum() <= 0:
        return None
    d = records["device"][keep]
    readback_ns = 1e6 * sum(r.stretch.records(READBACK)) / len(r.traced)
    device = float((d[:, -1] - d[:, 0]).sum()) + readback_ns * int(keep.sum())
    return 100.0 * (1.0 - device / float(frame.sum()))


def read_idle_share(r) -> Optional[float]:
    """idle_share, with the traced stretch's longest idle gaps, each with
    the program span over it, written to standard error first."""
    from splatbench import overlay

    overlay.log_gaps(r)
    return idle_share(r)
