"""The port's frame records: what each ``Renderer.render`` call did, and when.

Every call leaves one record, a fixed-size numeric row in a store that
keeps the last STORE_FRAMES frames of the process, whichever Renderer
rendered them (the store outlives its Renderers).  A record carries the
renderer's id, a process-wide sequence number, the capacity key, the
method (``eager``, ``capture`` or ``replay``), the host spans of the call,
the frame's counters and the device stamps of its stages.

Host spans, on ``time.perf_counter_ns``, each inside its parent (SPANS,
PARENTS); a span the call did not pass through reads -1:

  frame                  the whole call
    inputs               the camera and band rows into the static tensors
    eager                the frame run eagerly (a key's first visit; the CPU)
    capture              the key's second visit, captured as a CUDA graph:
      capture.warmup     the frame on a side stream (render.capture_frame)
      capture.sync       torch.cuda.synchronize before the capture
      capture.flush      torch.cuda.graph's __enter__: the allocator's
                         device and pinned-host caches emptied, capture_begin
      capture.record     the frame under capture (host launches only)
      capture.instantiate  capture_end
    replay               graph.replay(), a capture's first replay included
    readback             the counts and the image to the host

Device stamps: ``render.render_frame_tensors`` stamps the STAMPS
boundaries of the STAGES.  On the card a stamp is a one-thread kernel
(``frame_stamp_kernel``, csrc/stamp.cu) that writes the card's nanosecond
clock into the frame's row of its renderer's device ring (RING_ROWS rows);
a captured graph holds the stamps, so a replay writes them with no host
call.  The row comes with the frame's inputs (Renderer copies it to the
device with the camera), so a capture's warm-up writes the row that its
first replay then overwrites.  ``frames()`` copies each ring once, when it
is called; a record older than RING_ROWS frames of its renderer has lost
its row and reads -1.  On the CPU a stamp is ``perf_counter_ns``, written
into the record when the frame ends.

On a flat frame, stages A-C's per-splat work is one kernel
(ops.splat.splat_columns) between stamps 0 and 1: the first STAGES span
reads that kernel (colour, projection and the per-splat binning), the
second only the gap between two stamps, and the third stage C's prefix
sum with kernels K2 and K3.  A banded frame runs A, B and C apart, one a
span.

A frame's device span is its first stamp to its last: the frame's
kernels, and not the copies of its inputs and its readback around them
(a reader that wants those takes their device time from a trace).  On an
eager frame, and on the warm-up of a capture, the stamps are launched
between the frame's other kernels as the host gets to them, so there the
span also holds the host's launch time: only a replayed frame's span is
the device's own.

Counters (COUNTERS): candidate pairs, pairs listed (the candidates the
capacity kept) and pairs blended (K4's counter: the pairs each tile
blended before its exit), read back with the frame's counts; -1 where the
call read no counts (``check_saturation=False``).

The stage-D path (``sort_path``, an index into ops.sorting.SORT_PATHS):
``kernel`` where the frame sorted through csrc/sort.cu, ``torch`` where it
sorted with torch.sort.  An eager frame and a capture note the path they
ran; a replay notes the path its graph holds, the one its capture ran.

No profiler annotation is made: a trace shows the stamps as
``frame_stamp_kernel`` records, and nothing else of the records.
"""

from __future__ import annotations

import itertools
import time
import weakref
from typing import Dict, Optional

import numpy as np
import torch

from .ops.sorting import SORT_PATHS
from .utils import cuda_build as cb

SPANS = ("frame", "inputs", "eager", "capture", "replay", "readback", "capture.warmup",
         "capture.sync", "capture.flush", "capture.record", "capture.instantiate")
PARENTS = ("", "frame", "frame", "frame", "frame", "frame", "capture", "capture", "capture",
           "capture", "capture")
(FRAME, INPUTS, EAGER, CAPTURE, REPLAY, READBACK, CAPTURE_WARMUP, CAPTURE_SYNC, CAPTURE_FLUSH,
 CAPTURE_RECORD, CAPTURE_INSTANTIATE) = range(len(SPANS))
# The stages between the frame's device stamps: the reference's six names
# (render.STAGE_NAMES; F holds pack_pair_data) and the image's assembly.
STAGES = ("evaluateSphericalHarmonics", "evaluateClipData", "buildTileList", "sortTileList",
          "evaluateTileRanges", "renderDepthBuffer", "tilesToImage")
# The stages' boundaries.
STAMPS = len(STAGES) + 1
METHODS = ("eager", "capture", "replay")
COUNTERS = ("candidates", "pairs", "blended")
STORE_FRAMES = 16384
RING_ROWS = 8192

RECORD = np.dtype([
    ("renderer", np.int64), ("seq", np.int64), ("key", np.int64, (2,)), ("method", np.int64),
    ("ring", np.int64), ("host", np.int64, (len(SPANS), 2)),
    ("counters", np.int64, (len(COUNTERS),)), ("device", np.int64, (STAMPS,)),
    ("sort_path", np.int64),
])
# A record as int64 words, and where each field starts among them.
WORDS = RECORD.itemsize // 8
_AT = {name: RECORD.fields[name][1] // 8 for name in RECORD.names}
_HOST, _DEVICE, _COUNTERS = _AT["host"], _AT["device"], _AT["counters"]
_METHOD = {name: i for i, name in enumerate(METHODS)}

_perf_ns = time.perf_counter_ns
_renderer_ids = itertools.count(1)
_frame_seq = itertools.count()


class Store:
    """The last ``frames`` records of the process: a [frames, WORDS] int64
    array, written a row at a time and read as RECORD rows."""

    def __init__(self, frames: int = STORE_FRAMES):
        self.words = np.full((frames, WORDS), -1, np.int64)
        self.n = 0  # records committed so far

    def __len__(self) -> int:
        return len(self.words)

    def commit(self, words: np.ndarray) -> None:
        """Store one record (a [WORDS] int64 row) under the next sequence
        number."""
        words[_AT["seq"]] = next(_frame_seq)
        self.words[self.n % len(self.words)] = words
        self.n += 1

    def last(self, count: int) -> np.ndarray:
        """The last ``count`` records (fewer where fewer were kept), oldest
        first, as a RECORD array of their own."""
        count = min(count, self.n, len(self.words))
        rows = self.words[np.arange(self.n - count, self.n) % len(self.words)]
        return rows.view(RECORD).reshape(count)


STORE = Store()
# Renderer id -> (a weak reference to its recorder, its device ring): a
# ring stays while its recorder lives or the store holds one of its frames.
_RINGS: Dict[int, tuple] = {}


class StampRing:
    """A renderer's stamps.  On the card, a [RING_ROWS, STAMPS] int64 device
    ring, allocated here, outside every graph's memory pool, written at the
    row that the device float ``row_input`` names; on the CPU, the stamps
    of the frame in flight.  ``count`` is the frames committed so far; the
    frame in flight takes row count % RING_ROWS (``row``)."""

    def __init__(self, device, row_input: Optional[torch.Tensor] = None):
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.count = 0
        if self.cuda:
            self.rows = torch.full((RING_ROWS, STAMPS), -1, dtype=torch.int64, device=self.device)
            self.row_input = row_input
            self._fn = None
        else:
            self.host = np.full(STAMPS, -1, np.int64)

    @property
    def row(self) -> int:
        return self.count % RING_ROWS

    def stamp(self, column: int) -> None:
        """Stamp boundary ``column`` of the frame in flight."""
        if not self.cuda:
            self.host[column] = _perf_ns()
            return
        # An eager frame stamps in its serial host path: the library, the
        # pointers and the raw stream come without a torch.cuda.Stream.
        if self._fn is None:
            self._fn = cb.kernel("stamp", "gsr_frame_stamp",
                                 [cb.P, cb.P, cb.I32, cb.I32, cb.I32, cb.P])
            self._args = (self.rows.data_ptr(), self.row_input.data_ptr(), RING_ROWS, STAMPS)
            self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
                lambda index: torch.cuda.current_stream(index).cuda_stream)
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        code = self._fn(*self._args, column, self._stream(index))
        if code:
            cb.check("stamp", code)

    def read(self) -> np.ndarray:
        """The ring's rows on the host, in one copy."""
        return self.rows.cpu().numpy()


class _NoRecord:
    """The recorder of a frame that keeps no record."""

    def begin(self, span: int) -> None:
        pass

    def end(self, span: int) -> None:
        pass

    def switch(self, ended: int, begun: int) -> None:
        pass


NO_RECORD = _NoRecord()


class FrameRecorder:
    """One Renderer's side of the records: its id, its stamp ring, and the
    record of the frame in flight (a [WORDS] int64 row), committed to STORE
    when the frame ends; a call that raises commits nothing.  On the card
    ``row_input`` is the device float, copied with the frame's inputs, that
    names the frame's ring row (``row``)."""

    def __init__(self, device, row_input: Optional[torch.Tensor] = None):
        self.id = next(_renderer_ids)
        self.ring = StampRing(device, row_input)
        self.stamp = self.ring.stamp
        self.words = np.full(WORDS, -1, np.int64)
        self.words[_AT["renderer"]] = self.id
        if self.ring.cuda:
            _prune()
            _RINGS[self.id] = (weakref.ref(self), self.ring)

    @property
    def row(self) -> int:
        """The ring row of the frame in flight."""
        return self.ring.row

    def begin_frame(self) -> None:
        """A frame begins: its spans and counters read -1 until set (the
        host spans and the counters lie side by side in the row)."""
        self.words[_HOST:_DEVICE] = -1
        self.words[_HOST + 2 * FRAME] = _perf_ns()

    def begin(self, span: int) -> None:
        self.words[_HOST + 2 * span] = _perf_ns()

    def end(self, span: int) -> None:
        self.words[_HOST + 2 * span + 1] = _perf_ns()

    def switch(self, ended: int, begun: int) -> None:
        """End span ``ended`` and begin ``begun`` at the same instant."""
        t = _perf_ns()
        self.words[_HOST + 2 * ended + 1] = t
        self.words[_HOST + 2 * begun] = t

    def end_frame(self, method: str, key, counters=None, sort_path=None) -> None:
        """End the frame span and commit, with ``key`` (an int or a pair of
        ints), ``counters`` (COUNTERS, or None where the frame read none)
        and ``sort_path`` (a name of SORT_PATHS, or None where unknown)."""
        w = self.words
        w[_HOST + 2 * FRAME + 1] = _perf_ns()
        w[_AT["method"]] = _METHOD[method]
        w[_AT["sort_path"]] = -1 if sort_path is None else SORT_PATHS.index(sort_path)
        w[_AT["ring"]] = self.ring.count
        if isinstance(key, tuple):
            w[_AT["key"]], w[_AT["key"] + 1] = key
        else:
            w[_AT["key"]] = key
        if counters is not None:
            w[_COUNTERS: _COUNTERS + len(COUNTERS)] = counters
        if not self.ring.cuda:
            w[_DEVICE: _DEVICE + STAMPS] = self.ring.host
        STORE.commit(w)
        self.ring.count += 1

    def last(self) -> Optional[np.void]:
        """This renderer's last record, with its device stamps, or None."""
        n = min(STORE.n, len(STORE))
        for back in range(1, n + 1):
            words = STORE.words[(STORE.n - back) % len(STORE)]
            if words[_AT["renderer"]] == self.id:
                rec = words.copy().view(RECORD)[0]
                if self.ring.cuda:
                    rec["device"] = self.ring.rows[int(rec["ring"]) % RING_ROWS].cpu().numpy()
                return rec
        return None


def _prune() -> None:
    """Drop the rings whose recorder is gone and of which the store holds
    no frame."""
    dead = [rid for rid, (ref, _) in _RINGS.items() if ref() is None]
    if dead:
        kept = set(np.unique(STORE.last(len(STORE))["renderer"]).tolist())
        for rid in dead:
            if rid not in kept:
                del _RINGS[rid]


def frames() -> np.ndarray:
    """The records kept, oldest first, as a RECORD array: each card ring
    read in one copy, its stamps set into its renderer's records."""
    out = STORE.last(len(STORE))
    for rid in np.unique(out["renderer"]).tolist():
        entry = _RINGS.get(rid)
        if entry is None:
            continue
        ring = entry[1]
        rows = ring.read()
        sel = np.flatnonzero(out["renderer"] == rid)
        seq = out["ring"][sel]
        kept = seq >= ring.count - RING_ROWS
        out["device"][sel[kept]] = rows[seq[kept] % RING_ROWS]
    return out


def span_ns(records: np.ndarray, name: str) -> np.ndarray:
    """Each record's span ``name``, ns; -1 where it has none."""
    h = records["host"][:, SPANS.index(name)]
    return np.where((h[:, 0] >= 0) & (h[:, 1] >= h[:, 0]), h[:, 1] - h[:, 0], -1)


def stage_ns(records: np.ndarray) -> np.ndarray:
    """[n, len(STAGES)] device ns of each stage; -1 where the record has no
    stamps."""
    d = records["device"]
    return np.where(d[:, :1] >= 0, np.diff(d, axis=1), -1)


def device_span_ns(records: np.ndarray) -> np.ndarray:
    """Each record's device span (its first stamp to its last), ns; -1
    without stamps."""
    d = records["device"]
    return np.where(d[:, 0] >= 0, d[:, -1] - d[:, 0], -1)


def summary(rec: np.void) -> Dict:
    """One record as plain numbers: method, key, host ms of each span it
    has, device ms of each stage and of the frame, its counters and its
    stage-D path."""
    one = np.asarray([rec], RECORD)
    host = {name: float(ns) / 1e6 for name in SPANS if (ns := span_ns(one, name)[0]) >= 0}
    stamped = bool(one["device"][0, 0] >= 0)
    span = int(device_span_ns(one)[0])
    return {
        "renderer": int(rec["renderer"]), "seq": int(rec["seq"]),
        "key": [int(k) for k in rec["key"]], "method": METHODS[int(rec["method"])],
        "host_ms": host,
        "stage_ms": ({name: float(v) / 1e6 for name, v in zip(STAGES, stage_ns(one)[0])}
                     if stamped else {}),
        "device_ms": float(span) / 1e6 if span >= 0 else None,
        **{name: int(v) for name, v in zip(COUNTERS, rec["counters"])},
        "sort_path": SORT_PATHS[rec["sort_path"]] if rec["sort_path"] >= 0 else None,
    }
