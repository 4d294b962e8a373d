"""The JAX repository's measurement harness (tools/measure.py) on the port:
one stage, or one piece of a stage, timed alone on one device.

    python -m cudagaussianrenderer_torch.tools.measure <subcommand>
        [--n N] [--capacity C] [--reps R] [--size S] [--device cuda|cpu]

Subcommands (the JAX tool's eleven):

  sort        the flat sort of the packed key with 0-3 payload words
              (ops.sorting.sort_pairs), and the batched [g, C/g] form of
              the banded path (ops.banded.sort_pairs_banded)
  gather      the (key, index) sort alone, a 3-row gather by a random
              permutation, the two fused, an int32 key against the int64
  reorder     a 1-key + 8-payload splat reorder, the (key, index) sort,
              and the JAX tool's [g, N] count matrix + row cumsum
  extents     candidates per camera with opacity-aware extents off and
              on, and the two frames (render.render_frame_tensors)
  emit        K2 + K3 alone (ops.expand.emit_pairs), then build_tile_pairs
  raster      K4 + tiles_to_image at raster_chunk 128 and 256
  bandsort    the flat frame against the banded one at G = 4, 8, 16, the
              flat against the banded pair-list build at G = 16, and
              render.reorder_scene_by_tile_row
  shardsim    the worst tile-row band of 2 and 4 cards over 8 orbit
              cameras: its exact per-card program timed on one card, and
              the projected N-card frame
  shardbal    the same for balanced bands (parallel.distributed.render_band)
  trainscale  a single-view fit step at (10k, 256²), (50k, 512²) and
              (100k, 512²), eager and graphed (diff.FitStepGraphs)
  dpstep      the data-parallel fit step (parallel.train.make_train_step_dp)
              in a world-size-1 process group, eager and graphed

Method.  The JAX tool runs REPS salted reps of a body inside one
``lax.scan`` dispatch and takes the best of 3.  Here REPS calls of the body
are captured into one CUDA graph (render.capture_frame: one eager run under
the sync debug mode "error", a warm-up on a side stream, the capture), the
graph is replayed, and the best of 3 replays on the host clock, each
between two synchronises, gives ms/rep; a profiler trace of one more replay
gives the device ms/rep (bench.device_ms_by_name, every kernel and copy
summed).  The salt is a static [REPS] float tensor on the device that the
body reads, refilled on the device before each replay, so each rep sorts or
blends other data.  "net" subtracts a graphed trivial body (the JAX tool's
dispatch baseline).  A body that cannot be captured (it copies from the
host or reads a count back) is listed as such by its caller and timed with
CUDA events around REPS eager calls (``method: "events"``); a capturable
body whose capture fails is a failed line, never an events line.  The
training steps (trainscale, dpstep) are timed whole, steady steps on the
host clock, each step's loss read back as the fit reads it: the step
graphed as diff.fit and fit_dp run it on the card (its two CUDA graphs a
step, "cuda_graph" when every timed step replayed) beside its eager twin
(EagerFitStep, EagerDPStep: the same bodies run eagerly, "eager"), with
the device busy time and idle share of a traced pair of steps.  On the
CPU (``--device cpu``) the REPS calls run eagerly on the host clock
(``method: "eager"``, no device ms): a smoke test of the tool, not a
device measurement.

The JAX tool prints FAILED for a line that raises and carries on; so does
this one, and the process then exits 1.

Scene and camera: ``random_scene(n, seed=0, min_scale=0.002,
max_scale=0.053, extent=4.0)`` padded to 4,096 splats (the bench's), orbit
camera 0 of 8.  The defaults are the JAX tool's shapes: 1,000,000 splats at
1024², pair-list capacity 4,587,520 (the JAX tool's bench bucket; the
port's bench probe gives 3,698,688 for this scene over 8 cameras) and
REPS = 8.

Each subcommand prints the JAX tool's text lines, then one JSON line with
its numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .. import bench, diff
from ..config import RenderConfig
from ..models.camera import orbit_cameras
from ..models.scene import random_scene
from ..ops.banded import build_tile_pairs_banded, sort_pairs_banded
from ..ops.binning import (
    TilePairs, build_tile_pairs, emit_columns, splat_row_packs, splat_tile_rects,
)
from ..ops.expand import emit_pairs
from ..ops.geometry import as_u32_i64
from ..ops.projection import project_splats
from ..ops.raster import pack_pair_data, rasterize_tiles, tiles_to_image
from ..ops.sorting import sort_pairs
from ..parallel.train import DPStepGraphs
from ..render import (
    _band_rows_tensor, _frame_pairs, camera_flat, camera_tensors, capture_frame,
    render_frame_tensors, reorder_scene_by_tile_row, round_capacity, uniform_band_rows,
)
from ..utils.device import resolve_device

REPS = 8
BENCH_N = 1_000_000
BENCH_CAPACITY = 4_587_520
BENCH_SIZE = 1024
# The capacity grain of the JAX tool's probes.
PROBE_GRAIN = 1024
# The cameras a shard or extents probe runs over (the JAX tool's).
PROBE_CAMERAS = 8
# What a card's band gathers from the others: the clip buffer's 10 rows,
# 3 colours and the opacity, 14 float32 a splat (the JAX tool's count).
GATHER_BYTES_PER_SPLAT = 14 * 4
# NVLink between the H100 SXM cards of one host, each way (NVIDIA's data
# sheet: 900 GB/s both ways together); the JAX tool bounds its gather by
# the TPU's inter-chip link instead.
NVLINK_BYTES_PER_S = 450e9
LINK = "NVLink 450 GB/s each way (H100 SXM data sheet)"
# trainscale's rows: (splats, screen size).
TRAIN_ROWS = ((10_000, 256), (50_000, 512), (100_000, 512))


def _log(msg: str) -> None:
    print(msg, flush=True)


def bench_scene(n: int, dev: torch.device, sh_degree: int = 0):
    """The bench's scene: ``n`` splats at its scales, padded to 4,096."""
    return random_scene(n, seed=0, min_scale=0.002, max_scale=0.053, extent=4.0,
                        sh_degree=sh_degree, device=dev).pad_to_multiple(4096)


def bench_cameras(scene, n: int = PROBE_CAMERAS) -> list:
    return orbit_cameras(scene.bounds_min, scene.bounds_max, n)


def bench_camera(scene, dev: torch.device, idx: int = 0, n: int = PROBE_CAMERAS):
    """Orbit camera ``idx`` of ``n`` as the stages take it, on ``dev``."""
    return camera_tensors(bench_cameras(scene, n)[idx].camera_data(), dev)


def salted_camera(cam: Dict[str, torch.Tensor], s) -> Dict[str, torch.Tensor]:
    """``cam`` with its view's x translation moved by s * 1e-6 (the JAX
    tool's salt), on the device: no host copy inside a captured body."""
    view = cam["view"].clone()
    view[0, 3] = view[0, 3] + s * 1e-6
    return dict(cam, view=view)


def consume(*tensors) -> torch.Tensor:
    """A float32 scalar that reads the first element of every tensor, so
    that each rep's outputs are made."""
    return sum(t.reshape(-1)[0].to(torch.float32) for t in tensors) * 1e-9


def capacity_for(candidates: int, headroom: float) -> int:
    """The JAX tool's probe capacity: candidates times ``headroom``, up to
    whole PROBE_GRAIN slots."""
    return -(-int(candidates * headroom) // PROBE_GRAIN) * PROBE_GRAIN


# ---------------------------------------------------------------------------
# The harness
# ---------------------------------------------------------------------------


class Harness:
    """Times bodies ``body(salt, *args) -> tensor`` REPS calls at a time on
    ``dev`` (see the module's Method), prints a line each, and keeps a
    record each in ``lines``; ``failed`` names the lines that raised."""

    def __init__(self, dev: torch.device, reps: int = REPS):
        if reps < 1:
            raise ValueError(f"reps must be >= 1, got {reps}")
        self.dev, self.reps = dev, reps
        self.cuda = dev.type == "cuda"
        self._ramp = torch.arange(reps, dtype=torch.float32, device=dev)
        self.salt = self._ramp.clone()
        self.lines: List[dict] = []
        self.failed: List[str] = []
        self.base: Optional[float] = None

    def _set_salt(self, it: int) -> None:
        # A fill on the device: the captured body reads this tensor.
        torch.add(self._ramp, float(it * self.reps), out=self.salt)

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def _graphed(self, body, args):
        """ms/rep of the best of 3 replays, the trace by name, setup s."""

        def reps_call():
            acc = torch.zeros((), dtype=torch.float32, device=self.dev)
            for i in range(self.reps):
                acc = acc + body(self.salt[i], *args)
            return acc

        t0 = time.perf_counter()
        self._set_salt(0)
        graph, out = capture_frame(reps_call, self.dev)
        self._sync()
        setup = time.perf_counter() - t0
        best = float("inf")
        for it in range(1, 4):
            self._set_salt(it)
            self._sync()
            t0 = time.perf_counter()
            graph.replay()
            self._sync()
            best = min(best, time.perf_counter() - t0)
        trace = bench.device_ms_by_name(graph.replay)
        del graph, out
        return best, trace, setup

    def _eager(self, body, args, capturable):
        """The REPS calls eagerly: events on the card, the host clock on the
        CPU.  A capturable body reads the device salt, another a host float."""

        def reps_call(it):
            if capturable:
                self._set_salt(it)
                return sum(body(self.salt[i], *args) for i in range(self.reps))
            return sum(body(float(it * self.reps + i), *args) for i in range(self.reps))

        t0 = time.perf_counter()
        reps_call(0)
        self._sync()
        setup = time.perf_counter() - t0
        best = float("inf")
        for it in range(1, 4):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                reps_call(it)
                end.record()
                end.synchronize()
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                reps_call(it)
                best = min(best, time.perf_counter() - t0)
        trace = bench.device_ms_by_name(lambda: reps_call(4)) if self.cuda else None
        return best, trace, setup

    def timed(self, name: str, body: Callable, *args, capturable: bool = True,
              show_net: bool = True) -> Optional[float]:
        """Time ``body`` and print its line (and, with ``show_net``, its net
        line).  Returns ms/rep, or None when the line failed."""
        try:
            if self.cuda and capturable:
                method = "cuda_graph"
                best, trace, setup = self._graphed(body, args)
            else:
                method = "events" if self.cuda else "eager"
                best, trace, setup = self._eager(body, args, capturable)
        except Exception as e:  # noqa: BLE001 - the JAX tool's FAILED line; main exits 1
            msg = f"{type(e).__name__}: {str(e)[:200]}"
            _log(f"{name:44s} FAILED: {msg}")
            self.failed.append(name)
            self.lines.append(dict(name=name, failed=msg))
            return None
        finally:
            if self.cuda:
                torch.cuda.empty_cache()
        ms = best * 1e3 / self.reps
        device_ms = None if not trace else sum(trace.values()) / self.reps
        net = ms - self.base if self.base is not None else None
        rec = dict(name=name, ms_per_rep=ms, net_ms=net, device_ms=device_ms, method=method,
                   setup_s=setup)
        # The trace by kernel name stays in the record and out of the JSON line.
        rec["trace"] = trace
        self.lines.append(rec)
        dev_txt = "not measured" if device_ms is None else f"{device_ms:.4f} ms"
        _log(f"{name:44s} {ms:9.3f} ms/rep  ({method}, device {dev_txt}, setup {setup:5.1f}s)")
        if show_net:
            _log(f"{'':44s} net {_fmt(net)} ms")
        return ms

    def dispatch_baseline(self) -> Optional[float]:
        """A trivial body, timed like the others: what "net" subtracts."""
        x = torch.ones((8, 128), dtype=torch.float32, device=self.dev)
        self.base = self.timed("dispatch baseline", lambda s, x: torch.sum(x) + s, x,
                               show_net=False)
        return self.base

    def net(self, ms: Optional[float]) -> float:
        return ms - self.base if (ms is not None and self.base is not None) else float("nan")


def _fmt(v) -> str:
    return "      nan" if v is None else f"{v:9.3f}"


# ---------------------------------------------------------------------------
# sort, gather, reorder: the sort and its gathers, alone
# ---------------------------------------------------------------------------


def sort_keys_and_payloads(capacity: int, dev: torch.device, words: int = 3):
    """The JAX tool's sort inputs: a key below 2^31 (so a packed key word
    whose int32 bit pattern is its value) and ``words`` random 32-bit
    payload words, as int32 tensors (CPU torch has no shifts of uint32)."""
    rng = np.random.default_rng(0)
    key = torch.from_numpy(rng.integers(0, 1 << 31, capacity, dtype=np.uint32).astype(np.int32))
    payloads = [torch.from_numpy(rng.integers(0, 1 << 32, capacity, dtype=np.uint32)
                                 .view(np.int32)) for _ in range(words)]
    return key.to(dev), [p.to(dev) for p in payloads], rng


def _pairs(key: torch.Tensor, payloads) -> TilePairs:
    """A pair list of one packed key word with ``payloads`` as its
    attribute words, as the sort stage takes it."""
    return TilePairs(keys=(key,), values=key, attrs=tuple(payloads), num_candidates=None,
                     num_pairs=None)


def sort_flat(key: torch.Tensor, payloads):
    """The frame's sort stage (sort_pairs): on the card the key sorted as
    uint32 with int32 slot payloads, the payload words gathered by the
    sorted slots (csrc/sort.cu); on the CPU one torch.sort of the key as
    int64, then a gather of each payload word by its permutation."""
    keys, _, attrs = sort_pairs(_pairs(key, payloads))
    return keys[0], attrs


def sort_batched(key: torch.Tensor, payloads, g: int):
    """The banded path's sort: [g, C/g], each row sorted on its own, and the
    payloads gathered per row (sort_pairs_banded)."""
    keys, _, attrs = sort_pairs_banded(_pairs(key, payloads), g)
    return keys[0], attrs


def sort_key_index(key: torch.Tensor):
    """The (key, index) sort alone: torch.sort of the key as int64."""
    return torch.sort(as_u32_i64(key))


def gather_rows(perm: torch.Tensor, payloads):
    """Each payload word gathered by the permutation ``perm`` (int64)."""
    return [p[perm] for p in payloads]


def sort_gather_stacked(key: torch.Tensor, rows: torch.Tensor):
    """The (key, index) sort, then one gather of the stacked [3, C] rows."""
    sorted_key, perm = torch.sort(as_u32_i64(key))
    return sorted_key, rows.index_select(1, perm)


def sort_i32(key: torch.Tensor, payloads):
    """The sort with the key as int32 (its value is below 2^31) instead of
    int64, and the same gathers."""
    sorted_key, perm = torch.sort(key)
    return sorted_key, [p[perm] for p in payloads]


def _flat(out):
    """(key, [words]) -> (key, *words), for consume."""
    return (out[0], *out[1])


def cmd_sort(h: Harness, capacity: int = BENCH_CAPACITY) -> dict:
    key, payloads, _ = sort_keys_and_payloads(capacity, h.dev)
    h.dispatch_baseline()
    for words in range(4):
        h.timed(f"flat sort + {words} payload gathers @{capacity}",
                lambda s, k, *ps: consume(*_flat(sort_flat(k ^ s.to(torch.int32), ps))),
                key, *payloads[:words])
    for g in (8, 16, 32, 64, 128):
        seg = capacity // g
        if seg * g != capacity:
            continue
        h.timed(f"batched [{g},{seg}] + 3 payload gathers",
                lambda s, k, *ps, _g=g: consume(*_flat(sort_batched(k ^ s.to(torch.int32), ps,
                                                                     _g))),
                key, *payloads)
    return {}


def cmd_gather(h: Harness, capacity: int = BENCH_CAPACITY) -> dict:
    key, payloads, rng = sort_keys_and_payloads(capacity, h.dev)
    perm = torch.from_numpy(rng.permutation(capacity)).to(h.dev)
    rows = torch.stack(payloads)
    h.dispatch_baseline()
    h.timed(f"flat sort + 3 payload gathers @{capacity}",
            lambda s, k, *ps: consume(*_flat(sort_flat(k ^ s.to(torch.int32), ps))), key,
            *payloads)
    h.timed("(key, idx) sort alone",
            lambda s, k: consume(*sort_key_index(k ^ s.to(torch.int32))), key)
    h.timed("gather 3 i32 rows by random perm",
            lambda s, pm, *ps: consume(*gather_rows((pm + s.to(torch.int64)) % capacity, ps)),
            perm, *payloads)
    h.timed("(key, idx) sort + stacked 3-row gather (fused)",
            lambda s, k, r: consume(*sort_gather_stacked(k ^ s.to(torch.int32), r)), key, rows)
    h.timed("flat sort + 3 payload gathers, i32 key",
            lambda s, k, *ps: consume(*_flat(sort_i32(k ^ s.to(torch.int32), ps))), key,
            *payloads)
    return {}


def reorder_inputs(n: int, dev: torch.device):
    """The JAX tool's reorder inputs: a [0, 64) band key as int64, six
    float32 and two 32-bit columns (key + means + scales + quat + rgba)."""
    rng = np.random.default_rng(0)
    band = torch.from_numpy(rng.integers(0, 64, n, dtype=np.int64))
    f32cols = [torch.from_numpy(rng.random(n, dtype=np.float32)) for _ in range(6)]
    u32cols = [torch.from_numpy(rng.integers(0, 1 << 32, n, dtype=np.uint32).view(np.int32))
               for _ in range(2)]
    counts = torch.from_numpy(rng.integers(0, 8, n).astype(np.float32))
    y0 = torch.from_numpy(rng.integers(0, 64, n).astype(np.float32))
    return (band.to(dev), [c.to(dev) for c in f32cols + u32cols], counts.to(dev), y0.to(dev))


def reorder_sort(band: torch.Tensor, cols):
    """A splat reorder by a band key: one sort, a gather a column."""
    sorted_band, perm = torch.sort(band)
    return sorted_band, [c[perm] for c in cols]


def count_matrix_cumsum(counts: torch.Tensor, y0: torch.Tensor, g: int, s=0.0):
    """The JAX tool's banded-count building block: each splat's count in the
    row of its band (64 tile rows over ``g`` bands), zero elsewhere, then
    an inclusive cumsum along each row.  Returns the [g, N] sums."""
    bids = torch.floor(y0 / (64 // g))
    mat = torch.stack([torch.where(bids == float(b), counts + s * 1e-9, 0.0) for b in range(g)])
    return torch.cumsum(mat, dim=1)


def cmd_reorder(h: Harness, n: int = BENCH_N) -> dict:
    band, cols, counts, y0 = reorder_inputs(n, h.dev)
    idx = torch.arange(n, device=h.dev)
    h.dispatch_baseline()
    h.timed(f"reorder 1key+8payload @{n}",
            lambda s, k, *cs: consume(*_flat(reorder_sort(k ^ s.to(torch.int64), cs))), band,
            *cols)
    h.timed(f"reorder 1key+1idx @{n}",
            lambda s, k, i: consume(*_flat(reorder_sort(k ^ s.to(torch.int64), (i,)))), band, idx)
    for g in (8, 16, 32, 64):
        h.timed(f"count-matrix+cumsum [{g},{n}]",
                lambda s, c, y, _g=g: torch.sum(count_matrix_cumsum(c, y, _g, s)[:, -1]) * 1e-9,
                counts, y0)
    return {}


# ---------------------------------------------------------------------------
# extents, emit, raster: stages B-F at the bench's workload
# ---------------------------------------------------------------------------


def candidate_counts(scene, cams, config: RenderConfig, dev: torch.device,
                     row_band=None) -> List[int]:
    """Each camera's exact candidate pairs (project_splats ->
    splat_tile_rects -> splat_row_packs), read back in one copy."""
    counts = []
    for c in cams:
        cam = camera_tensors(c.camera_data(), dev)
        clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                              opacities=scene.opacities)
        rects = splat_tile_rects(clip, config, row_band=row_band)
        counts.append(splat_row_packs(clip, rects, config).counts.sum())
    return [int(x) for x in torch.stack(counts).cpu()]


def extents_counts(scene, cams, size: int, dev: torch.device) -> dict:
    """Per-camera candidates with opacity-aware extents off ("exact") and on
    ("aware"), and the frames' capacity from the exact ones (x 1.02)."""
    out = {}
    for name, flag in (("exact", False), ("aware", True)):
        cfg = RenderConfig(screen_size=size, opacity_aware_extents=flag)
        out[name] = candidate_counts(scene, cams, cfg, dev)
    out["capacity"] = capacity_for(max(out["exact"]), 1.02)
    return out


def _frame_body(config, capacity, band_rows=None, compact_capacity=0):
    def body(s, scene, cam):
        img, aux = render_frame_tensors(scene, salted_camera(cam, s), config, capacity,
                                        band_rows=band_rows, compact_capacity=compact_capacity)
        return (torch.sum(img[::64, ::64, 0].to(torch.float32)) * 1e-9
                + aux["num_pairs"].to(torch.float32) * 1e-12)

    return body


def cmd_extents(h: Harness, n: int = BENCH_N, size: int = BENCH_SIZE) -> dict:
    scene = bench_scene(n, h.dev)
    cams = bench_cameras(scene)
    counts = extents_counts(scene, cams, size, h.dev)
    for name, key in (("exact 3-sigma", "exact"), ("opacity-aware", "aware")):
        per = counts[key]
        _log(f"{name:20s} candidates: max {max(per)} mean {sum(per) // len(per)} per-cam {per}")
    cap = counts["capacity"]
    cam0 = camera_tensors(cams[0].camera_data(), h.dev)
    for name, flag in (("frame exact 3-sigma", False), ("frame opacity-aware", True)):
        cfg = RenderConfig(screen_size=size, opacity_aware_extents=flag)
        h.timed(name, _frame_body(cfg, cap), scene, cam0, show_net=False)
    return dict(candidates=counts)


def cmd_emit(h: Harness, n: int = BENCH_N, capacity: int = BENCH_CAPACITY,
             size: int = BENCH_SIZE) -> dict:
    cfg = RenderConfig(screen_size=size)
    scene = bench_scene(n, h.dev)
    cam = bench_camera(scene, h.dev)
    h.dispatch_baseline()
    clip = project_splats(scene.means, scene.scales, scene.quats, cam, cfg,
                          opacities=scene.opacities)
    cols, incl = emit_columns(clip, scene.colors, scene.opacities, cfg)
    cols = tuple(c.contiguous() for c in cols)

    def emit_body(s, incl, *cols):
        salted = (*cols[:2], cols[2] + s * 1e-9, *cols[3:])  # salt cx
        out = emit_pairs(salted, incl, capacity, cfg)
        return torch.sum(out[0][:128].to(torch.float32)) * 1e-9

    h.timed("emit kernels K2+K3 (committed)", emit_body, incl, *cols)
    _log(f"{'':44s} (the JAX WINDOW / BLOCKS_PER_STEP / limb variants are TPU knobs; the "
         "port's design variants: chip_kernel_variants.py --kernels emit-raster --variants)")

    def build_body(s, clip, colors, opacities):
        p = build_tile_pairs(clip._replace(cx=clip.cx + s * 1e-9), colors, opacities, cfg,
                             capacity)
        return (p.keys[0][0].to(torch.float32) * 1e-9
                + p.num_pairs.to(torch.float32) * 1e-12)

    h.timed("build_tile_pairs end-to-end", build_body, clip, scene.colors, scene.opacities)
    return dict(candidates=int(incl[-1]))


def cmd_raster(h: Harness, n: int = BENCH_N, capacity: int = BENCH_CAPACITY,
               size: int = BENCH_SIZE) -> dict:
    scene = bench_scene(n, h.dev)
    cam = bench_camera(scene, h.dev)
    h.dispatch_baseline()
    pairs, attrs, starts, counts = _frame_pairs(scene, cam, RenderConfig(screen_size=size),
                                                capacity)
    for name, chunk in (("chunk=128 (prod)", 128), ("chunk=256", 256)):
        cfg = RenderConfig(screen_size=size, raster_chunk=chunk)

        def body(s, a0, a1, a2, st, ct, _cfg=cfg):
            data = pack_pair_data((a0, a1, a2 ^ s.to(torch.int32)), _cfg.raster_chunk)
            img = tiles_to_image(rasterize_tiles(data, st, ct, _cfg), _cfg)
            return torch.sum(img[::64, ::64, 0].to(torch.float32))

        h.timed(name, body, *attrs, starts, counts)
    _log(f"{'':44s} (the JAX SCAN_LIMBS / QUAD_BF16 variants are TPU knobs: no lines)")
    return dict(candidates=int(pairs.num_candidates))


# ---------------------------------------------------------------------------
# bandsort: the flat frame against the banded one
# ---------------------------------------------------------------------------


def compact_capacity_for(padded: int, g: int) -> int:
    """The JAX tool's compacted-splat capacity: 3 x the padded splats, in
    whole groups of g x 1,024."""
    return -(-3 * padded // (g * 1024)) * (g * 1024)


def cmd_bandsort(h: Harness, n: int = BENCH_N, capacity: int = BENCH_CAPACITY,
                 size: int = BENCH_SIZE) -> dict:
    scene = bench_scene(n, h.dev)
    cams = bench_cameras(scene, 32)
    cam_data = cams[0].camera_data()
    cam0 = camera_tensors(cam_data, h.dev)
    flat_cfg = RenderConfig(screen_size=size)
    h.dispatch_baseline()
    h.timed("frame flat", _frame_body(flat_cfg, capacity), scene, cam0)
    for g in (4, 8, 16):
        cfg = dataclasses.replace(flat_cfg, sort_bands=g)
        rows = _band_rows_tensor(uniform_band_rows(cfg), cfg, h.dev)
        ccap = compact_capacity_for(scene.padded_count, g)
        h.timed(f"frame banded G={g}", _frame_body(cfg, capacity, rows, ccap), scene, cam0)

    cfg16 = dataclasses.replace(flat_cfg, sort_bands=16)
    rows16 = _band_rows_tensor(uniform_band_rows(cfg16), cfg16, h.dev)
    ccap16 = compact_capacity_for(scene.padded_count, 16)
    cap16 = round_capacity(capacity, h.dev, bands=16)
    clip = project_splats(scene.means, scene.scales, scene.quats, cam0, flat_cfg,
                          opacities=scene.opacities)

    def flat_build(s, cl, colors, opacities):
        p = build_tile_pairs(cl._replace(cx=cl.cx + s * 1e-9), colors, opacities, flat_cfg,
                             capacity)
        return p.keys[0][0].to(torch.float32) * 1e-9 + p.num_pairs.to(torch.float32) * 1e-12

    def banded_build(s, cl, colors, opacities):
        p, _, splats = build_tile_pairs_banded(
            cl._replace(cx=cl.cx + s * 1e-9), colors, opacities, cfg16, cap16, rows16,
            compact_capacity=ccap16)
        return (p.keys[0][0].to(torch.float32) * 1e-9
                + p.num_pairs.to(torch.float32) * 1e-12
                + torch.max(splats).to(torch.float32) * 1e-12)

    h.timed("buildTileList flat", flat_build, clip, scene.colors, scene.opacities)
    h.timed("buildTileList banded G=16", banded_build, clip, scene.colors, scene.opacities)

    def reorder_body(s, sc):
        # The camera goes to the device inside reorder_scene_by_tile_row (a
        # host copy): this body is not capturable.
        view = np.array(cam_data["view"], np.float32)
        view[0, 3] += np.float32(s * 1e-6)
        out = reorder_scene_by_tile_row(sc, dict(cam_data, view=view), flat_cfg)
        return torch.sum(out.means[:, :128]) * 1e-9 + out.opacities[0] * 1e-12

    h.timed(f"reorder_scene_by_tile_row @{scene.count}", reorder_body, scene,
            capturable=False)
    return {}


# ---------------------------------------------------------------------------
# shardsim, shardbal: the worst band of N cards, on one card
# ---------------------------------------------------------------------------


def shardsim_worst(scene, cams, config: RenderConfig, n_dev: int,
                   dev: torch.device) -> tuple:
    """The JAX tool's probe for uniform bands: over every band of ``n_dev``
    equal tile-row bands and every camera, the largest (candidates, band's
    first row); returns (candidates, first row, capacity at x 1.005)."""
    rows = config.tiles_y // n_dev
    worst = (0, 0)
    for b in range(n_dev):
        for c in candidate_counts(scene, cams, config, dev, row_band=(b * rows, (b + 1) * rows)):
            worst = max(worst, (c, b * rows))
    cand, lo = worst
    return cand, lo, capacity_for(cand, 1.005)


def shardbal_worst(scene, cams, config: RenderConfig, n_dev: int,
                   dev: torch.device) -> tuple:
    """The JAX tool's probe for balanced bands: each camera's equal-work
    bounds (parallel.distributed._band_bounds of _band_weights), each
    band's candidates; over the cameras the largest (candidates, band);
    returns (candidates, band, capacity at x 1.02)."""
    from ..parallel.distributed import _balanced_rows, _band_bounds, _band_weights

    max_rows = _balanced_rows(config, n_dev)
    worst = (0, 0)
    for c in cams:
        cam = camera_tensors(c.camera_data(), dev)
        clip = project_splats(scene.means, scene.scales, scene.quats, cam, config,
                              opacities=scene.opacities)
        bounds = _band_bounds(_band_weights(clip, config), n_dev, max_rows)
        per = torch.stack([
            splat_row_packs(clip, splat_tile_rects(clip, config, row_band=(bounds[j],
                                                                         bounds[j + 1])),
                            config).counts.sum()
            for j in range(n_dev)]).cpu().numpy()
        j = int(per.argmax())
        worst = max(worst, (int(per[j]), j))
    cand, band = worst
    return cand, band, capacity_for(cand, 1.02)


def link_ms(nbytes: float, n_dev: int) -> float:
    """The ms a card needs to receive (n-1)/n of ``nbytes`` over NVLink."""
    return nbytes * (n_dev - 1) / n_dev / NVLINK_BYTES_PER_S * 1e3


def _projection_line(net: float, n_dev: int, **parts) -> float:
    total = net + sum(parts.values())
    terms = "".join(f" + {k} {v:5.3f}" for k, v in parts.items())
    _log(f"{'':44s} net {net:7.3f} ms{terms} ms ({LINK}) -> projected {n_dev}-card "
         f"{total:6.3f} ms/frame ({1e3 / total:5.1f} FPS)")
    return total


def cmd_shardsim(h: Harness, n: int = BENCH_N, size: int = BENCH_SIZE) -> dict:
    """The per-card program of the tile-row-sharded frame (parallel.
    distributed's uniform bands), for the worst band, on this one card:
    projection over every splat (the real rank projects 1/n and gathers the
    rest: a deliberate overestimate, as in the JAX tool), then stages C-F
    on the band (render_frame_multipass's pass).  The gather cannot run on
    one card; it is bounded at NVLink's rate."""
    scene = bench_scene(n, h.dev)
    config = RenderConfig(screen_size=size)
    cams = bench_cameras(scene)
    cam0 = camera_tensors(cams[0].camera_data(), h.dev)
    h.dispatch_baseline()
    out = {}
    for n_dev in (2, 4):
        cand, lo, capacity = shardsim_worst(scene, cams, config, n_dev, h.dev)
        rows = config.tiles_y // n_dev
        band_tiles = rows * config.tiles_x
        sl = slice(lo * config.tiles_x, lo * config.tiles_x + band_tiles)
        cap = round_capacity(capacity, h.dev)

        def frame(s, sc, cam, _lo=lo, _rows=rows, _sl=sl, _cap=cap, _bt=band_tiles):
            _, attrs, starts, counts = _frame_pairs(sc, salted_camera(cam, s), config, _cap,
                                                    row_band=(_lo, _lo + _rows))
            tiles = rasterize_tiles(pack_pair_data(attrs, config.raster_chunk),
                                    starts[_sl].contiguous(), counts[_sl].contiguous(), config,
                                    num_tiles=_bt, tile_row_offset=_lo)
            return torch.sum(tiles_to_image(tiles, config)[::64, ::64, 0].to(torch.float32))

        m = h.timed(f"worst shard of {n_dev} (band row {lo}, cap {capacity})", frame, scene,
                    cam0, show_net=False)
        gather = link_ms(scene.padded_count * GATHER_BYTES_PER_SPLAT, n_dev)
        total = _projection_line(h.net(m), n_dev, **{"gather bound": gather})
        out[str(n_dev)] = dict(candidates=cand, band_lo=lo, capacity=capacity,
                               gather_bound_ms=gather, projected_ms=total)
    return dict(shards=out, link=LINK)


def cmd_shardbal(h: Harness, n: int = BENCH_N, size: int = BENCH_SIZE) -> dict:
    """``shardsim`` for balanced bands: the worst band's exact per-card
    program, parallel.distributed.render_band_tensors (bounds from the
    band weights on the device, the 2x-uniform raster buffer with its
    tiles past the band masked, the band placed into a full frame), and the
    frame's reduce-scatter bounded at NVLink's rate beside the gather."""
    from ..parallel.distributed import render_band_tensors

    scene = bench_scene(n, h.dev)
    config = RenderConfig(screen_size=size)
    cams = bench_cameras(scene)
    cam0 = camera_tensors(cams[0].camera_data(), h.dev)
    frame_bytes = config.screen_h * config.screen_w * 4  # RGBA u8
    h.dispatch_baseline()
    out = {}
    for n_dev in (2, 4):
        cand, band, capacity = shardbal_worst(scene, cams, config, n_dev, h.dev)

        def frame(s, sc, cam, _n=n_dev, _b=band, _cap=capacity):
            full, _ = render_band_tensors(sc, salted_camera(cam, s), config, _cap, _n, _b)
            return torch.sum(full[::64, ::64, 0].to(torch.float32))

        m = h.timed(f"balanced worst shard of {n_dev} (dev {band}, cap {capacity})", frame,
                    scene, cam0, show_net=False)
        gather = link_ms(scene.padded_count * GATHER_BYTES_PER_SPLAT, n_dev)
        scatter = link_ms(frame_bytes, n_dev)
        total = _projection_line(h.net(m), n_dev, gather=gather, scatter=scatter)
        out[str(n_dev)] = dict(candidates=cand, band=band, capacity=capacity,
                               gather_bound_ms=gather, scatter_bound_ms=scatter,
                               projected_ms=total)
    return dict(shards=out, link=LINK)


# ---------------------------------------------------------------------------
# trainscale, dpstep: the fit step
# ---------------------------------------------------------------------------


def trainscale_setup(n_splats: int, size: int, dev: torch.device) -> dict:
    """One trainscale row's inputs: ``random_scene(n_splats, seed=3)``, its
    orbit camera 0 rendered by Renderer.render as the target, the scene's
    own parameters, capacity round_capacity(16 n) and k_max = max(256,
    2 x the largest tile's pairs)."""
    from ..render import Renderer

    scene = random_scene(n_splats, seed=3, device=dev)
    config = RenderConfig(screen_size=size)
    cam = orbit_cameras(scene.bounds_min, scene.bounds_max, 1)[0]
    target = torch.from_numpy(
        Renderer(scene, config, device=dev).render(cam)[..., :3].astype(np.float32) / 255.0
    ).to(dev)
    params = diff.from_scene(scene)
    cd = cam.camera_data()
    capacity = round_capacity(16 * n_splats, dev)
    structure = diff.build_structure(params, cd, config, capacity, device=dev)
    k_max = max(256, 2 * diff.max_tile_count(structure))
    return dict(config=config, target=target, params=params, camera=cd,
                camera_row=camera_flat(camera_tensors(cd, dev)), capacity=capacity, k_max=k_max)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Eager:
    """A diff.GraphedStep whose bodies run eagerly on the card, as the
    port's training steps ran before they were graphed: the eager twin
    that the graphed step is timed and held against."""

    def _run(self, kind, key, body, warmup=None):
        self._keys.add((kind, key))
        self.last_method = "eager"
        self.methods[kind]["eager"] += 1
        return body()


class EagerFitStep(Eager, diff.FitStepGraphs):
    pass


class EagerDPStep(Eager, DPStepGraphs):
    pass


def fit_step_pair(s: dict, dev: torch.device) -> dict:
    """A trainscale row's step (diff.view_loss's 0.8 L1 + 0.2 (1 - SSIM),
    diff.Adam(1e-3), one view) graphed (diff.FitStepGraphs) and eager
    (EagerFitStep), each from the row's parameters."""
    tx = diff.Adam(1e-3)
    kw = dict(params=s["params"], opt_state=tx.init(s["params"]), tx=tx, extras={},
              extra_state={}, extra_txs={}, n_views=1, image_shape=tuple(s["target"].shape[:2]),
              l1_weight=0.8, ssim_weight=0.2, l2_weight=0.0, depth_weight=0.0, use_depth=False,
              sh_bands=None, remat=None, device=dev)
    return {name: cls(s["config"], s["capacity"], s["k_max"], **kw)
            for name, cls in (("eager", EagerFitStep), ("graphed", diff.FitStepGraphs))}


def timed_steps(dev: torch.device, run, steps: int, *, trace_steps: int = 2) -> dict:
    """``run(i)`` (one training step that returns its loss tensor) ``steps``
    times on the host clock, from a synchronise to one after the last
    loss's readback; then, on the card, ``trace_steps`` more in a profiler
    trace: device busy ms a step (every kernel and copy summed) and the
    idle share of the timed steps."""
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(steps):
        loss = run(i)
    loss = float(loss)
    ms = (time.perf_counter() - t0) * 1e3 / steps
    busy = None
    if dev.type == "cuda":
        def traced():
            for i in range(trace_steps):
                float(run(steps + i))

        b = bench.device_busy_ms(traced)
        busy = None if b is None else b / trace_steps
    return dict(ms_per_step=ms, loss=loss, device_busy_ms=busy,
                idle_share=None if busy is None else max(0.0, 1.0 - busy / ms))


def step_counts(dev: torch.device, warm_eager: int, warm_graphed: int, timed: int) -> tuple:
    """(warm-up steps of the eager twin, of the graphed step, timed steps):
    on the card enough for the eager twin to settle and for every key of
    the graphed step to be captured; on the CPU, where both run eagerly
    and the times mean nothing, 1, 1 and at most 2."""
    if dev.type == "cuda":
        return warm_eager, warm_graphed, timed
    return 1, 1, min(timed, 2)


def step_methods(step, before: dict) -> dict:
    """How a GraphedStep's step graph ran since its counts were ``before``."""
    after = step.methods["step"]
    return {k: after[k] - before.get(k, 0) for k in after if after[k] - before.get(k, 0)}


def method_of(ran: dict) -> str:
    """A timed line's method: "cuda_graph" when every step replayed,
    "eager" when every one ran eagerly, else the counts."""
    if set(ran) == {"replay"}:
        return "cuda_graph"
    return "eager" if set(ran) == {"eager"} else "mixed " + json.dumps(ran)


def cmd_trainscale(h: Harness, rows=TRAIN_ROWS) -> dict:
    """A single-view fit step (render_diff, 0.8 L1 + 0.2 (1 - SSIM),
    diff.Adam(1e-3)) at growing splat counts and sizes, eager and graphed
    side by side: the eager twin 2 warm-up steps, the graphed step 3 (its
    key eager, captured, replayed), then 8 timed steps of each on the host
    clock, each ending with the loss read back, and 2 traced ones (device
    busy ms a step, idle share); on the CPU one warm-up step and 2 timed
    each.  The graphed line's method is
    "cuda_graph" only if all of its timed steps replayed."""
    out = []
    for n_splats, size in rows:
        if h.dev.type == "cuda":
            # memory_reserved then holds this row's steps, graphs and cache.
            torch.cuda.empty_cache()
        s = trainscale_setup(n_splats, size, h.dev)
        pair = fit_step_pair(s, h.dev)
        cam = s["camera_row"]
        row = dict(splats=n_splats, size=size, k_max=s["k_max"], capacity=s["capacity"])
        warm_eager, warm_graphed, timed = step_counts(h.dev, 2, 3, 8)
        for name, warm in (("eager", warm_eager), ("graphed", warm_graphed)):
            step = pair[name]

            def run(i, step=step):
                return step.step(cam, s["target"], None, 0, 0)[0]

            for i in range(warm):
                run(i)
            before = dict(step.methods["step"])
            timing = timed_steps(h.dev, run, timed)
            ran = step_methods(step, before)
            rep = step.report()
            row[name] = dict(timing, method=method_of(ran), step_methods=ran, keys=rep["keys"],
                             captures=rep["step"].get("capture", 0),
                             memory_reserved=rep.get("memory_reserved"))
            h.lines.append(dict(name=f"train step {n_splats} @ {size}^2 {name}",
                                ms_per_rep=timing["ms_per_step"], splats=n_splats, size=size,
                                k_max=s["k_max"], capacity=s["capacity"], **row[name]))
            _log(f"{n_splats} splats @ {size}^2 {name}: k_max={s['k_max']} "
                 f"capacity={s['capacity']} step={timing['ms_per_step']:.1f} ms "
                 f"({row[name]['method']}) loss={timing['loss']:.4f}")
        row["loss"] = timing["loss"]
        out.append(row)
        del pair
    return dict(rows=out)


def dpstep_rank(size: int, n_scene: int, n_init: int, steps: int) -> dict:
    """One rank of dpstep (importable by name, for parallel.launch.spawn):
    the JAX tool's setup on this rank's device; the eager twin of
    make_train_step_dp's step (EagerDPStep) 1 + 4 settle steps and the
    graphed step (DPStepGraphs) 9 (each of the 4 views' keys eager, then
    captured), then ``steps`` timed of each on the host clock (each loss
    read back) and 2 traced; on the CPU 1 settle step each and at most 2
    timed."""
    from ..parallel.distributed import make_mesh
    from ..parallel.train import view_batch
    from ..render import Renderer

    mesh = make_mesh(axis="dp")
    dev = mesh.device
    scene = random_scene(n_scene, seed=7, device=dev)
    config = RenderConfig(screen_size=size)
    r = Renderer(scene, config, device=dev)
    cams = orbit_cameras(scene.bounds_min, scene.bounds_max, 4)
    targets = [r.render(c)[..., :3].astype(np.float32) / 255.0 for c in cams]
    cd = [c.camera_data() for c in cams]
    params = diff.random_init(n_init, scene.bounds_min, scene.bounds_max, seed=0, scale=0.05,
                              device=dev)
    tx = diff.Adam(5e-3)
    batches = [view_batch(cd[i:i + 1], targets[i:i + 1], dev) for i in range(4)]
    out = dict(backend=torch.distributed.get_backend())
    warm_eager, warm_graphed, steps = step_counts(dev, 5, 9, steps)
    for name, cls, warm in (("eager", EagerDPStep, warm_eager),
                            ("graphed", DPStepGraphs, warm_graphed)):
        step = cls(config, 65536, 512, tx, mesh)
        state = [params, tx.init(params)]

        def run(i, step=step, state=state):
            state[0], state[1], loss = step(*state, *batches[i % 4])
            return loss

        for i in range(warm):
            run(i)
        before = dict(step.methods["step"])
        timing = timed_steps(dev, run, steps)
        ran = step_methods(step, before)
        rep = step.report()
        out[name] = dict(timing, method=method_of(ran), step_methods=ran, keys=rep["keys"],
                         captures=rep["step"].get("capture", 0),
                         memory_reserved=rep.get("memory_reserved"))
    return out


def cmd_dpstep(h: Harness, size: int = 256, n_scene: int = 3000, n_init: int = 2000,
               steps: int = 16) -> dict:
    """The data-parallel fit step of a 1-rank group (NCCL on the card, gloo
    on the CPU), through parallel.launch.spawn: the exact per-rank program
    of an N-card data-parallel fit, its all-reduce a loopback; eager and
    graphed side by side."""
    from ..parallel.launch import spawn

    res = spawn(dpstep_rank, 1, h.dev.type, size, n_scene, n_init, steps)[0]
    for name in ("eager", "graphed"):
        r = res[name]
        _log(f"dp train step (group of 1, {res['backend']}) {name}: {r['ms_per_step']:.1f} "
             f"ms/step ({r['method']}), loss {r['loss']:.4f}")
        h.lines.append(dict(name=f"dp train step (group of 1) {name}",
                            ms_per_rep=r["ms_per_step"], backend=res["backend"], **r))
    return dict(dpstep=res)


# ---------------------------------------------------------------------------
# The command line
# ---------------------------------------------------------------------------

COMMANDS = ("sort", "gather", "reorder", "extents", "emit", "raster", "bandsort", "shardsim",
            "shardbal", "trainscale", "dpstep")


def run(cmd: str, dev: torch.device, *, n: int = BENCH_N, capacity: int = BENCH_CAPACITY,
        reps: int = REPS, size: int = BENCH_SIZE, train_rows=TRAIN_ROWS,
        dp_kw: Optional[dict] = None) -> dict:
    """Run subcommand ``cmd`` and print its lines and its JSON line.  Returns
    the JSON object, with each line's trace by kernel name added
    (``lines[i]["trace"]``: device ms summed over the traced REPS calls;
    None off the card)."""
    h = Harness(dev, reps)
    calls = {
        "sort": lambda: cmd_sort(h, capacity),
        "gather": lambda: cmd_gather(h, capacity),
        "reorder": lambda: cmd_reorder(h, n),
        "extents": lambda: cmd_extents(h, n, size),
        "emit": lambda: cmd_emit(h, n, capacity, size),
        "raster": lambda: cmd_raster(h, n, capacity, size),
        "bandsort": lambda: cmd_bandsort(h, n, capacity, size),
        "shardsim": lambda: cmd_shardsim(h, n, size),
        "shardbal": lambda: cmd_shardbal(h, n, size),
        "trainscale": lambda: cmd_trainscale(h, train_rows),
        "dpstep": lambda: cmd_dpstep(h, **(dp_kw or {})),
    }
    if cmd not in calls:
        raise ValueError(f"unknown subcommand {cmd!r}: one of {', '.join(COMMANDS)}")
    numbers = calls[cmd]()
    result = dict(measure=cmd, reps=reps, n=n, capacity=capacity, size=size,
                  baseline_ms=h.base, lines=h.lines, failed=h.failed, **numbers,
                  device=bench.device_line(dev))
    printed = dict(result, lines=[{k: v for k, v in ln.items() if k != "trace"}
                                  for ln in h.lines])
    print(json.dumps(printed), flush=True)
    return result


def main(argv=None) -> int:
    """Parse the command line and run one subcommand; returns the exit code:
    1 if a line failed, else 0."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("subcommand", choices=COMMANDS)
    ap.add_argument("--n", type=int, default=BENCH_N, help="splats of the bench scene")
    ap.add_argument("--capacity", type=int, default=BENCH_CAPACITY, help="pair-list slots")
    ap.add_argument("--reps", type=int, default=REPS, help="calls a timed run")
    ap.add_argument("--size", type=int, default=BENCH_SIZE, help="screen size of the frames")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {bench.device_line(dev)}", flush=True)
    result = run(args.subcommand, dev, n=args.n, capacity=args.capacity, reps=args.reps,
                 size=args.size)
    return 1 if result["failed"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
