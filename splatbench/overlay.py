"""The program's host spans laid over the traced stretch.

The traced stretch (``trace.Stretch``) labels an idle gap of the device by
the innermost profiler event around it: a CUDA runtime call at best.  The
program's own records say what the program was doing then: its host spans
(``spans.matched``) run on ``time.perf_counter_ns``, the trace on the
profiler's clock.  The offset between the two clocks is the one that puts
each traced frame's ``frame`` span end on the end of the harness's
``splatbench.frame`` span around the same call.  A frame's offset is the
clocks' own plus the harness's time after the program's span ends, which
is a few tens of us, but in the stretch's first frame often ~250 us
more (the profiler's).  So the one offset farthest from the median is set
aside; where the others spread by more than MAX_SPREAD_US, the clocks (or
the records' match to the frames) do not agree and nothing is laid over.  Each of the stretch's longest gaps then goes to the
innermost program span that covers its middle, or to OUTSIDE.
"""

from __future__ import annotations

import statistics
import sys
from typing import List, Optional, Tuple

import numpy as np

# The most the traced frames' clock offsets may spread, us.
MAX_SPREAD_US = 200.0
# The gaps laid over, longest first.
GAPS = 10
OUTSIDE = "outside the program"
HARNESS_FRAME = "splatbench.frame"


def clock_offsets_us(stretch, records: np.ndarray, telemetry) -> Optional[List[float]]:
    """The profiler's clock minus the program's at the end of each traced
    frame (``records``, in order), us, or None where their count is not
    the stretch's."""
    ends = sorted(t1 for name, _, t1 in stretch.host if name == HARNESS_FRAME)
    frame = records["host"][:, telemetry.SPANS.index("frame")]
    if not ends or len(ends) != len(records) or (frame[:, 1] < 0).any():
        return None
    return [h - p / 1e3 for h, p in zip(ends, frame[:, 1].tolist())]


def clock_offset_us(stretch, records: np.ndarray, telemetry) -> Optional[float]:
    """The median of clock_offsets_us, or None where there are none or
    they spread by more than MAX_SPREAD_US once the one farthest from
    their median is set aside."""
    offsets = clock_offsets_us(stretch, records, telemetry)
    if offsets is None:
        return None
    median = statistics.median(offsets)
    kept = sorted(offsets, key=lambda o: abs(o - median))[:max(len(offsets) - 1, 1)]
    if max(kept) - min(kept) > MAX_SPREAD_US:
        return None
    return median


def program_spans(records: np.ndarray, telemetry,
                  offset_us: float) -> List[Tuple[str, float, float]]:
    """Every host span of ``records`` on the profiler's clock: (name,
    start us, end us)."""
    out = []
    for host in records["host"]:
        for name, (t0, t1) in zip(telemetry.SPANS, host.tolist()):
            if 0 <= t0 <= t1:
                out.append((name, t0 / 1e3 + offset_us, t1 / 1e3 + offset_us))
    return out


def gaps(stretch, records: np.ndarray, telemetry) -> Optional[List[Tuple[float, float, str, str]]]:
    """The stretch's GAPS longest idle gaps, longest first: (start us from
    the first device record, seconds, the innermost program span over the
    gap's middle or OUTSIDE, the profiler's own label), or None where the
    clocks cannot be matched."""
    offset = clock_offset_us(stretch, records, telemetry)
    if offset is None:
        return None
    spans = program_spans(records, telemetry, offset)
    merged: List[Tuple[float, float]] = []
    for _, t0, t1 in stretch.device:
        if merged and t0 <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
        else:
            merged.append((t0, t1))
    found = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:]) if b > a),
                   reverse=True)[:GAPS]
    out = []
    for length, a, b in found:
        mid = 0.5 * (a + b)
        over = [s for s in spans if s[1] <= mid <= s[2]]
        name = min(over, key=lambda s: s[2] - s[1])[0] if over else OUTSIDE
        label = min((h for h in stretch.host if h[1] <= mid <= h[2]),
                    key=lambda h: h[2] - h[1], default=(OUTSIDE,))[0]
        out.append((a - merged[0][0], length / 1e6, name, label))
    return out


def log_gaps(r) -> None:
    """Write the traced stretch's longest gaps, each with its program span,
    to standard error (nothing where the stretch or the records are
    missing)."""
    from splatbench import spans

    if r.stretch is None:
        return
    got = spans.matched(r)
    if got is None:
        print("[splatbench] idle gaps: no program records to lay over the trace", file=sys.stderr)
        return
    records, traced, telemetry = got
    found = gaps(r.stretch, records[traced], telemetry)
    if found is None:
        offsets = clock_offsets_us(r.stretch, records[traced], telemetry)
        said = "none" if offsets is None else ", ".join(
            f"{o - offsets[0]:+.1f}" for o in offsets)
        print(f"[splatbench] idle gaps: the traced frames' clock offsets, one set aside, spread "
              f"by more than {MAX_SPREAD_US} us (us from the first: {said}); not laid over",
              file=sys.stderr)
        return
    for i, (at_us, seconds, name, label) in enumerate(found, 1):
        print(f"[splatbench] idle gap {i}: {seconds * 1e3:.4f} ms at +{at_us / 1e3:.3f} ms: "
              f"program span {name} (profiler: {label[:80]})", file=sys.stderr)
