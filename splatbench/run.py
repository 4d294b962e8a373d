"""The port's benchmark: one cell of BENCHMARK.json, one run.

    python3 -m splatbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<name>.json``: the scene, the
screen, the camera, the frame's parameters, the limits of the check) and
a traffic mix (``traffic/<name>.json``: the parameters of the one camera
path generator, ``poses.PosePath``).  The run makes the scene on the card
from the seed, builds the program's ``Renderer`` as a viewer does, renders
the mix's warm-up poses (set-up), then renders one pose after another
through ``Renderer.render`` for ``--seconds`` seconds, each frame timed on
the host clock from the call to the image on the host.  A mix with
sessions opens the scene in a new ``Renderer`` at the start of each
(``Viewer``).

After the window it reads the peak of device memory, frees the program,
and holds a sample of the frames (drawn from the seed; the first frame of
each way the frame loop ran, eager, captured or replayed, the frame with
the most candidate pairs, and random ones) against the plain reference
(``check``).  With ``--trace 1`` a few frames in the middle of the window
run under torch.profiler, and the per-layer metrics (one reader each in
``metrics/<name>.py``) read that stretch and the frame loop's records.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit).  Without a card, or with fewer cards than the cell asks for, it
exits with code 3 and prints no result; if the JAX package or JAX was
loaded, with code 4.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
# Top-level module names that may not be loaded in a run.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "cudagaussianrenderer_tpu")
# Frames of the window traced with --trace 1, from its middle on.
TRACE_FRAMES = 6
# Random frames of the window judged besides the first of each method and
# the heaviest.
RANDOM_JUDGED = 2
# Window frames among which the nearest pose and the random ones are drawn.
SCAN_FRAMES = 240
METHODS = ("eager", "capture", "replay")
# The frame keys of a configuration and the values of each that both the
# program (RenderConfig) and the reference implement.  A configuration
# that states another value is refused, so that no key is left unread.
FRAME_CHOICES = {"precision": ("float32",), "falloff": ("gaussian",),
                 "opacity_aware_extents": (True,), "center_sampled_runs": (True,)}


def process_start() -> float:
    """The process's start on the time.time() clock (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


T_PROCESS = process_start()


def log(msg: str) -> None:
    print(f"[splatbench +{time.time() - T_PROCESS:7.1f}s] {msg}", file=sys.stderr, flush=True)


def load_cell(root: Path, name: str) -> Dict:
    """The cell ``name`` of ``root``'s BENCHMARK.json, with its
    configuration, traffic mix and the metrics it reports."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    for key, values in FRAME_CHOICES.items():
        if config["frame"].get(key) not in values:
            raise SystemExit(f"{entry['file']}: frame {key} = {config['frame'].get(key)!r}; "
                             f"the program and the reference are run with {values} only")
    traffic = json.loads((root / "splatbench" / "traffic" / f"{cell['traffic']}.json").read_text())
    per_layer = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    end_to_end = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    return dict(cell=cell, config=config, traffic=traffic, per_layer=per_layer,
                end_to_end=end_to_end)


def load_reader(root: Path, metric: str):
    """``metrics/<metric>.py``'s ``read``, loaded by path."""
    path = root / "splatbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"splatbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_loaded() -> List[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class Reading:
    """What the per-layer readers read: the window's frames outside the
    traced stretch, the traced frames (with the reference's counts), the
    stretch, the screen and the card."""

    frames: List[Dict]
    traced: List[Dict]
    stretch: Optional[object]
    screen: Dict
    card: Optional[Dict]


class Sample:
    """The frames the check judges.  Set, before the window, from the seed
    and the path: the window frames with the nearest pose (the most pairs)
    and RANDOM_JUDGED random ones among its first SCAN_FRAMES frames (its
    first session's, where sessions are shorter: each flies the same
    poses); met as the run goes: the first frame of each method in the
    window (in set-up where the window has none).  A judged frame's image
    is copied into buffers made and touched before the window, so the
    harness holds none of the program's arrays, and a frame's record holds
    plain numbers only."""

    def __init__(self, seed: int, viewer: "Viewer", shape, slots: int):
        rng = np.random.default_rng([int(seed), 0x6A75])
        span = range(min(SCAN_FRAMES, viewer.session or SCAN_FRAMES))
        nearest = min(span, key=lambda j: viewer.path.distance_at(viewer.pose_index(j)))
        self.targets = {nearest, *(int(k) for k in rng.choice(span, RANDOM_JUDGED, replace=False))}
        self.buffers = np.zeros((slots, *shape), np.uint8)
        self.free = list(range(slots))
        self.first = {"setup": {}, "window": {}}
        self.picked: List[Dict] = []

    def _keep(self, rec: Dict, image) -> None:
        if "slot" not in rec and self.free:
            rec["slot"] = self.free.pop()
            np.copyto(self.buffers[rec["slot"]], image)
            self.picked.append(rec)

    def offer(self, rec: Dict, image, window: bool) -> None:
        if image is None:
            return
        first = self.first["window" if window else "setup"]
        if rec["method"] not in first:
            first[rec["method"]] = rec
            self._keep(rec, image)
        if window and rec["j"] in self.targets:
            self._keep(rec, image)

    def judged(self) -> List[Dict]:
        """The frames held: the set-up's first of a method only where the
        window has none."""
        window_methods = set(self.first["window"])
        return [r for r in self.picked
                if not (r["stage"] == "setup" and r["method"] in window_methods)]

    def image(self, rec: Dict) -> np.ndarray:
        return self.buffers[rec["slot"]]


class Viewer:
    """The program as a viewer drives it: a Renderer over the cell's scene
    (``open``, a new one at the start of each session where the mix has
    sessions) and the path frame each frame shows."""

    def __init__(self, open_renderer, path, traffic: Dict):
        self.open = open_renderer
        self.path = path
        self.session = int(traffic.get("session_frames", 0))
        self.start = int(traffic["warmup"]["poses"])
        self.renderer = open_renderer()

    def pose_index(self, j: int) -> int:
        """The path frame that window frame ``j`` shows."""
        return j % self.session if self.session else self.start + j

    def setup_frame(self, k: int) -> tuple:
        return frame(self.renderer, self.path, k, None, "setup")

    def window_frame(self, j: int, stage: str = "window") -> tuple:
        """Window frame ``j`` (a session's first opens the scene anew, the
        old Renderer dropped first): (record, image or None)."""
        if self.session and j % self.session == 0:
            self.renderer = None
            self.renderer = self.open()
        return frame(self.renderer, self.path, self.pose_index(j), j, stage)


def frame(renderer, path, k: int, j: Optional[int], stage: str) -> tuple:
    """Path frame ``k`` (window frame ``j``) through Renderer.render:
    (record, image or None)."""
    from splatbench import program

    cam = program.camera(path.pose(k))
    capacity = int(renderer.capacity)
    rec = dict(k=k, j=j, stage=stage, capacity=capacity)
    t0 = time.perf_counter()
    try:
        image = renderer.render(cam)
    except Exception as exc:  # a frame that raises counts as failed
        log(f"frame {k} raised: {exc!r}")
        return dict(rec, method="raised", ms=(time.perf_counter() - t0) * 1e3, candidates=0,
                    truncated=True), None
    ms = (time.perf_counter() - t0) * 1e3
    return dict(rec, method=renderer.last_method, ms=ms, candidates=int(renderer.last_candidates),
                truncated=bool(renderer.last_truncated)), image


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda") -> Dict:
    """One run of ``workload``; returns the result object (without the
    process guards of ``main``)."""
    import torch

    from splatbench import check, program
    from splatbench.poses import PosePath
    from splatbench.reference import frame as reference
    from splatbench.scene import make_scene

    spec = load_cell(root, workload)
    config, traffic = spec["config"], spec["traffic"]
    screen, fcfg = config["screen"], config["frame"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    log(f"{workload}: seed {seed}, {seconds} s, trace {int(trace)}, {dev}")

    scene = make_scene(config["scene"], seed, dev)
    path = PosePath(traffic, config, seed)
    viewer = Viewer(lambda: program.renderer(scene, screen, fcfg, dev), path, traffic)
    log("scene made, renderer built")
    warm = traffic["warmup"]
    n_warm = int(warm["poses"])
    slots = 2 * len(METHODS) + 1 + RANDOM_JUDGED
    sample = Sample(seed, viewer, (screen["height"], screen["width"], 4), slots)

    # Set-up: the mix's warm-up poses.
    for p in range(int(warm["passes"])):
        methods = []
        for k in range(n_warm):
            rec, image = viewer.setup_frame(k)
            methods.append(rec["method"])
            sample.offer(rec, image, window=False)
        log(f"warm-up pass {p}: " + ", ".join(f"{m} {methods.count(m)}" for m in METHODS))
        if warm.get("until_replayed") and all(m == "replay" for m in methods):
            break
    if cuda:
        torch.cuda.synchronize(dev)

    # The window.
    t_window = time.time()
    setup_s = t_window - T_PROCESS
    t0 = time.perf_counter()
    frames: List[Dict] = []
    traced: List[Dict] = []
    prof = stretch = None
    j = 0
    while time.perf_counter() - t0 < seconds:
        if trace and not traced and time.perf_counter() - t0 >= seconds / 2:
            traced, prof, traced_wall = traced_stretch(viewer, j, cuda)
            j += len(traced)
            continue
        rec, image = viewer.window_frame(j)
        frames.append(rec)
        sample.offer(rec, image, window=True)
        del image
        j += 1
    window_s = time.perf_counter() - t0
    done = [f for f in frames + traced if f["method"] != "raised"]
    failed = sum(1 for f in frames + traced if f["truncated"])
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    log(f"window: {len(frames) + len(traced)} frames in {window_s:.3f} s, "
        + ", ".join(f"{m} {sum(f['method'] == m for f in frames + traced)}"
                    for m in (*METHODS, "raised")) + f", {failed} failed")

    for m in (*METHODS, "raised"):
        ms = [f["ms"] for f in frames if f["method"] == m]
        if ms:
            log(f"  {m}: {len(ms)} frames, ms median {np.median(ms):.3f}, mean {np.mean(ms):.3f}, "
                f"max {max(ms):.3f}, sum {sum(ms):.1f}")
    if frames:
        log("  every frame: ms " + ", ".join(
            f"p{q} {np.percentile([f['ms'] for f in frames], q):.3f}" for q in (50, 90, 95, 99)))
    cands = [f["candidates"] for f in frames + traced]
    if cands:
        log(f"window candidates: {min(cands)} to {max(cands)}; "
            f"capacity now {viewer.renderer.capacity}")
    if prof is not None:
        last = traced[-1]
        per_frame = (kernels_a_frame(viewer.renderer, path.pose(last["k"]), last["capacity"])
                     if cuda else None)
        stretch = read_stretch(prof, traced_wall, traced, per_frame)

    # Free the program, then hold the sample against the reference.
    viewer.renderer = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    kw = dict(depth_bits=int(fcfg["depth_bits"]), chunk=int(fcfg["raster_chunk"]),
              eps=float(fcfg["transmittance_eps"]))
    judged = sample.judged()
    numbers = []
    for rec in judged:
        ref = reference.render(scene, path.pose(rec["k"]), screen, **kw)
        nums = check.frame_numbers(sample.image(rec), ref.image.cpu().numpy(), rec["candidates"],
                                   ref.pairs, int(screen["tile"]))
        numbers.append(nums)
        log(f"judged frame {rec['k']} ({rec['stage']}, {rec['method']}): candidates "
            f"{rec['candidates']}, reference pairs {ref.pairs}, blended {ref.pairs_blended}, "
            + ", ".join(f"{n} {v:.6g}" for n, v in nums.items()))
    for rec in traced:
        ref = reference.render(scene, path.pose(rec["k"]), screen, **kw)
        rec["pairs"], rec["pairs_blended"] = ref.pairs, ref.pairs_blended
    log(f"reference: {len(judged)} frames judged, {len(traced)} traced counted, "
        f"{time.perf_counter() - t_ref:.3f} s")
    limits = config["limits"]
    raised = any(f["method"] == "raised" for f in frames + traced)
    worst = check.worst(numbers) if numbers else {n: None for n in check.NUMBERS}
    correct = bool(numbers) and not raised and check.verdict(worst, limits)

    result = {"correct": correct, "attempted": len(frames) + len(traced), "failed": failed}
    metrics = {}
    if not trace:
        for m in spec["end_to_end"]:
            value = END_TO_END[m["name"]](done, window_s, setup_s)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        card = None
        if cuda:
            from splatbench import peaks

            card = peaks.card()
        reading = Reading(frames=frames, traced=traced, stretch=stretch, screen=screen, card=card)
        for m in spec["per_layer"]:
            value = load_reader(root, m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    if trace and stretch is not None:
        result["device"]["busy_s"] = stretch.busy_s()
        result["device"]["window_s"] = stretch.wall_s
        result["breakdown"] = stretch.breakdown()
    result["checks"] = check.report(worst, limits)
    return result


def mean_frame_ms(done: List[Dict], window_s: float, setup_s: float) -> Optional[float]:
    """The window's wall time over the frames it completed, ms."""
    return window_s * 1e3 / len(done) if done else None


def frame_p95_ms(done: List[Dict], window_s: float, setup_s: float) -> Optional[float]:
    """The 95th percentile of the window's frame latencies, ms."""
    return float(np.percentile([f["ms"] for f in done], 95)) if done else None


# The end-to-end metrics, from the window's completed frames, its wall
# seconds and the set-up's.  ``session_frame_ms`` is ``frame_ms`` in the
# cells whose traffic has sessions: a name of its own, so that it holds a
# bound of its own.
END_TO_END = {
    "frame_ms": mean_frame_ms,
    "frame_p95_ms": frame_p95_ms,
    "session_frame_ms": mean_frame_ms,
    "setup_s": lambda done, window_s, setup_s: setup_s,
}


def traced_stretch(viewer: Viewer, j0: int, cuda: bool):
    """TRACE_FRAMES window frames from ``j0`` under torch.profiler: (their
    records, the profile, its wall seconds).  The profile is read after
    the window, and the frames are not judged (no image is copied inside
    the stretch): the reference only counts their pairs."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    recs = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(j0, j0 + TRACE_FRAMES):
            with record_function("splatbench.frame"):
                rec, image = viewer.window_frame(j, "traced")
            recs.append(rec)
            del image
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return recs, prof, wall


def read_stretch(prof, wall: float, traced: List[Dict], kernels_a_frame: Optional[int]):
    """The Stretch of a profile, logged: every device record name with its
    time, and the kernel records seen against those expected (a frame
    launches ``kernels_a_frame``; a captured frame runs twice)."""
    from splatbench.trace import COPY_NAMES, Stretch

    stretch = Stretch.from_profile(prof, wall)
    log(f"traced stretch: {len(traced)} frames in {wall:.3f} s, {len(stretch.device)} device "
        f"records, busy {stretch.busy_s():.4f} s")
    for name, v in sorted(stretch.device_ms().items(), key=lambda kv: -kv[1]):
        count = sum(1 for r in stretch.device if r[0] == name)
        log(f"  device {v:10.4f} ms {count:6d} records  {name[:160]}")
    if kernels_a_frame:
        seen = sum(1 for r in stretch.device if not COPY_NAMES.search(r[0]))
        runs = sum(2 if f["method"] == "capture" else 1 for f in traced)
        log(f"trace completeness: {seen} kernel records seen of {runs * kernels_a_frame} "
            f"expected ({kernels_a_frame} a frame, {runs} frame runs)")
    return stretch


def kernels_a_frame(renderer, pose, capacity: int) -> int:
    """Kernel records in a trace of one stand-alone eager frame at
    ``capacity``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from splatbench import program
    from splatbench.trace import COPY_NAMES

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        program.eager_frame(renderer, pose, capacity)
        torch.cuda.synchronize()
    return sum(1 for e in prof.events()
               if e.device_type == DeviceType.CUDA and not COPY_NAMES.search(e.name))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    log("torch imported")
    spec = load_cell(ROOT, args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"splatbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"splatbench: modules loaded that the run may not load: {bad}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
