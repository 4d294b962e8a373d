"""The traced stretch: a torch.profiler trace of a few frames of the
window, reduced to device time by name, busy time, idle gaps and the
host's activity in each gap.

Device records are the trace's CUDA-side events (kernels, copies, sets);
busy time is the union of their intervals; an idle gap is a stretch of the
traced wall time with no device record, labelled by the innermost host
event that covers its middle.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# Records that move or set memory rather than compute.
COPY_NAMES = re.compile(r"^(Memcpy|Memset|memcpy|memset)")
# The harness's own host spans, which the trace also shows on the device's
# timeline as annotations: no device work.
OWN_SPANS = "splatbench."
# Device operations and idle gaps the result line keeps.
BREAKDOWN_ENTRIES = 10


class Stretch:
    """What one traced stretch left: device records (name, start, end in
    us), host records (name, start, end), and its wall time."""

    def __init__(self, device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]], wall_s: float):
        self.device = sorted(device, key=lambda r: r[1])
        self.host = host
        self.wall_s = wall_s

    @classmethod
    def from_profile(cls, prof, wall_s: float) -> "Stretch":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type != DeviceType.CUDA:
                host.append(span)
            elif not e.name.startswith(OWN_SPANS):
                device.append(span)
        return cls(device, host, wall_s)

    def device_ms(self) -> Dict[str, float]:
        """Device ms of each record name, summed."""
        out: Dict[str, float] = {}
        for name, t0, t1 in self.device:
            out[name] = out.get(name, 0.0) + (t1 - t0) / 1e3
        return out

    def records(self, pattern: str) -> List[float]:
        """Device ms of each record whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return [(t1 - t0) / 1e3 for name, t0, t1 in self.device if rx.search(name)]

    def _union(self) -> List[Tuple[float, float]]:
        merged: List[Tuple[float, float]] = []
        for _, t0, t1 in self.device:
            if merged and t0 <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], t1))
            else:
                merged.append((t0, t1))
        return merged

    def busy_s(self) -> float:
        """Seconds in which some device record ran."""
        return sum(t1 - t0 for t0, t1 in self._union()) / 1e6

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The longest gaps between device records, (what the host was doing,
        seconds), longest first."""
        merged = self._union()
        gaps = sorted(((b - a, a, b) for (_, a), (b, _) in zip(merged, merged[1:]) if b > a),
                      reverse=True)[:BREAKDOWN_ENTRIES]
        return [(self._host_at(0.5 * (a + b)), length / 1e6) for length, a, b in gaps]

    def _host_at(self, t: float) -> str:
        best: Optional[Tuple[str, float, float]] = None
        for span in self.host:
            if span[1] <= t <= span[2] and (best is None or span[2] - span[1] < best[2] - best[1]):
                best = span
        return best[0] if best else "host outside any traced call"

    def breakdown(self) -> Dict[str, list]:
        ops = sorted(self.device_ms().items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
        return {"device_ops": [[name, ms / 1e3] for name, ms in ops],
                "idle_gaps": [[name, s] for name, s in self.idle_gaps()]}
