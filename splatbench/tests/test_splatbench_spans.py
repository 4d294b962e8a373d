"""The readers of the program's frame records (splatbench/spans.py and the
metrics that use it) and the gap overlay (splatbench/overlay.py), on a
hand-made Reading and hand-made records."""

import numpy as np
import pytest

from cudagaussianrenderer_torch import telemetry
from splatbench import overlay, run, spans
from splatbench.tests.tiny import REPO
from splatbench.trace import Stretch

READERS = ("span.sh_ms", "span.projection_ms", "span.binning_ms", "span.sort_ms",
           "span.ranges_ms", "span.raster_ms", "span.image_ms", "raster.blended_share",
           "device.idle_share", "device.idle_share.session", "loop.flush_ms",
           "loop.record_ms", "loop.instantiate_ms")
MS = 1_000_000


def record(method, t0, stage_ms=(1, 2, 3, 4, 5, 6, 7), host_ms=None, counters=(100, 80, 60)):
    """One record of ``method`` whose frame starts at ``t0`` ns: its stages
    ``stage_ms`` end to end on the device, and the host spans ``host_ms``
    ({name: (start ms, end ms)} from t0)."""
    rec = np.full(1, -1, telemetry.RECORD)[0]
    rec["method"] = telemetry.METHODS.index(method)
    bounds = np.concatenate([[0], np.cumsum(stage_ms)]) * MS
    rec["device"] = 5_000 * MS + t0 + bounds
    spans_ms = {"frame": (0, sum(stage_ms) + 2)} if host_ms is None else host_ms
    for name, (a, b) in spans_ms.items():
        rec["host"][telemetry.SPANS.index(name)] = (t0 + a * MS, t0 + b * MS)
    rec["counters"] = counters
    return rec


class Reading:
    def __init__(self, frames, traced, stretch=None):
        self.frames, self.traced, self.stretch = frames, traced, stretch
        self.screen, self.card = {"tile": 16, "width": 32, "height": 32}, None


def window(methods, traced_at=()):
    """A Reading of window frames j = 0, 1, ... with ``methods``, those at
    ``traced_at`` traced, and records that match them (after one set-up
    record)."""
    frames = [dict(j=j, method=m) for j, m in enumerate(methods) if j not in traced_at]
    traced = [dict(j=j, method=m) for j, m in enumerate(methods) if j in traced_at]
    capture = {"frame": (0, 60), "capture": (1, 50), "capture.warmup": (1, 20),
               "capture.sync": (20, 25), "capture.flush": (25, 30), "capture.record": (30, 45),
               "capture.instantiate": (45, 50), "replay": (50, 51), "readback": (51, 59)}
    recs = [record("eager", 0)]
    for j, m in enumerate(methods):
        recs.append(record(m, (j + 1) * 100 * MS, host_ms=capture if m == "capture" else None))
    return Reading(frames, traced), np.array(recs, telemetry.RECORD)


@pytest.fixture
def program(monkeypatch):
    """Hand the readers the records of ``program.records``."""
    box = {}
    monkeypatch.setattr(spans, "program_records",
                        lambda: None if box["records"] is None else (box["records"], telemetry))
    return box


def readbacks(ms_each, frames=1):
    """A stretch of ``frames`` traced frames, each with two readback copies
    of ``ms_each`` ms, and an input copy, a kernel and a copy on the device
    that are no readback."""
    us = 1e3 * ms_each
    device = []
    for i in range(frames):
        t = 1e5 * i
        device += [("Memcpy HtoD (Pinned -> Device)", t, t + us), ("kernel", t + us, t + 9e4),
                   ("Memcpy DtoH (Device -> Pageable)", t + 8.9e4, t + 8.9e4 + us),
                   ("Memcpy DtoD (Device -> Device)", t + 9e4, t + 9.5e4),
                   ("Memcpy DtoH (Device -> Pageable)", t + 9.5e4, t + 9.5e4 + us)]
    return Stretch(device, [], wall_s=1.0)


def read_all(reading):
    return {name: run.load_reader(REPO, name)(reading) for name in READERS}


def test_readers_read_the_window_records(program):
    r, program["records"] = window(["replay", "capture", "replay", "eager"], traced_at=(2,))
    r.stretch = readbacks(0.5)
    got = read_all(r)
    assert got["span.sh_ms"] == 1.0 and got["span.image_ms"] == 7.0  # the untraced replay
    assert got["raster.blended_share"] == 75.0
    # The untraced replay: device 29 ms (28 of stages, 1 of readback) against host 30 ms.
    assert got["device.idle_share"] == pytest.approx(100 * (1 - 29 / 30))
    assert got["device.idle_share.session"] == got["device.idle_share"]
    assert got["loop.flush_ms"] == pytest.approx(5 / 3)
    assert got["loop.record_ms"] == pytest.approx(39 / 3)
    assert got["loop.instantiate_ms"] == pytest.approx(5 / 3)


def test_idle_share_reads_replays_and_the_traced_readbacks(program):
    """The idle share reads the untraced replays alone, with the traced
    frames' readback a frame added to each; without a stretch, or
    without an untraced replay, it is None."""
    r, program["records"] = window(["replay", "eager", "replay", "replay", "capture"],
                                   traced_at=(2, 3))
    r.stretch = readbacks(1.0, frames=2)
    # One untraced replay: device 28 + 2 ms against host 30 ms.
    assert spans.idle_share(r) == pytest.approx(0.0)
    r.stretch = None
    assert spans.idle_share(r) is None
    r, program["records"] = window(["eager", "replay", "capture"], traced_at=(1,))
    r.stretch = readbacks(1.0)
    assert spans.idle_share(r) is None


def test_readers_give_none_on_a_mismatched_method(program):
    r, records = window(["replay", "capture", "replay", "eager"], traced_at=(2,))
    records["method"][-2] = telemetry.METHODS.index("eager")
    program["records"] = records
    assert set(read_all(r).values()) == {None}


def test_readers_give_none_without_records(program):
    r, records = window(["replay", "replay", "replay"])
    program["records"] = records[-2:]
    assert set(read_all(r).values()) == {None}
    program["records"] = None  # a program that keeps no records
    assert set(read_all(r).values()) == {None}


def stretch_over(records, offsets_us, device):
    """A Stretch whose harness frame spans end where each traced record's
    frame span ends, moved by ``offsets_us``."""
    frame = records["host"][:, telemetry.SPANS.index("frame")]
    host = [(overlay.HARNESS_FRAME, a / 1e3 + off - 5, b / 1e3 + off)
            for (a, b), off in zip(frame.tolist(), offsets_us)]
    return Stretch(device, host + [("cudaGraphLaunch", 0.0, 1e12)], wall_s=1.0)


def test_gaps_go_to_the_program_span_over_them():
    _, records = window(["capture", "replay"])
    records = records[1:]
    base = 7.0e6  # the profiler's clock minus the program's, us
    t = records["host"][0, telemetry.SPANS.index("capture.flush"), 0] / 1e3 + base
    f1 = records["host"][1, telemetry.SPANS.index("frame"), 1] / 1e3 + base
    device = [("k", t - 9000, t - 4000), ("k", t + 6000, f1 + 100),  # a gap over the flush
              ("k", f1 + 600, f1 + 700)]  # and one after the last frame
    s = stretch_over(records, [base + 3, base + 9], device)
    found = overlay.gaps(s, records, telemetry)
    assert [(name, round(sec * 1e3, 3), label) for _, sec, name, label in found] == [
        ("capture.flush", 10.0, overlay.HARNESS_FRAME), (overlay.OUTSIDE, 0.5, "cudaGraphLaunch")]


def test_gaps_refuse_clocks_that_spread():
    """The frames' clock offsets may spread by 0.2 ms once the one farthest
    from their median is set aside (the stretch's first frame, whose
    harness span often ends later), and not more."""
    _, records = window(["replay"] * 5)
    records = records[1:]
    device = [("k", 0.0, 1.0), ("k", 2.0, 3.0)]
    for offsets, agree in (([0.0, 150.0, 200.0, 180.0, 50.0], True),
                           ([300.0, 50.0, 0.0, 200.0, 100.0], True),  # the first set aside
                           ([0.0, 150.0, 260.0, 180.0, 50.0], False),
                           ([300.0, -100.0, 0.0, 200.0, 100.0], False)):  # two apart
        found = overlay.gaps(stretch_over(records, offsets, device), records, telemetry)
        assert (found is not None) == agree, offsets
    # A traced frame the stretch lacks.
    assert overlay.gaps(stretch_over(records[:4], [0.0] * 4, device), records, telemetry) is None
