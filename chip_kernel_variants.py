#!/usr/bin/env python3
"""Time the emit (K3) and raster (K4) kernels alone on one GPU, and the
design variants that were tried for them.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_kernel_variants.py              # the kernels as committed
    python3 chip_kernel_variants.py --variants   # and the variants below

Every time is device time from a torch.profiler trace (the kernels alone,
without the host's enqueue gaps), at the main path's shapes (1M splats
SH-3, 1024x1024, camera 0 of chip_smoke.py) and on the huge-splat
1024x1024 scene.  K4 is also timed with the early exit disabled
(transmittance_eps = -1): every sorted pair is then blended, lists are
~890 pairs deep, and the rate is the inner loop's own, free of per-tile
set-up; with that the tiles are also run heaviest first and lightest first.

The first part uses only the package's public wrappers and chip_smoke.py's
device_busy_ms, so a copy of this file placed in a checkout of an earlier
commit times that commit's kernels (the baseline of a comparison).  A
variant is the committed source with a few lines replaced, built into a
temporary directory and called through ctypes; each is held against the
plain PyTorch version beside its time.  The replacements follow the inner
loops as committed: one whose old text is no longer in the source raises,
and is then brought up to date or dropped.
"""

import argparse
import ctypes
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# name -> [(old text, new text), ...] applied to csrc/raster.cu
K4_VARIANTS = {
    "committed": [],
    "8 pixels a thread": [
        ("tile_size % 4 == 0", "tile_size % 8 == 0"),
        ("raster_kernel<4, true> : raster_kernel<4, false>",
         "raster_kernel<8, true> : raster_kernel<8, false>"),
        ("(wide ? 4 : 1)", "(wide ? 8 : 1)"),
    ],
    "2 pixels a thread": [
        ("tile_size % 4 == 0", "tile_size % 2 == 0"),
        ("raster_kernel<4, true> : raster_kernel<4, false>",
         "raster_kernel<2, true> : raster_kernel<2, false>"),
        ("(wide ? 4 : 1)", "(wide ? 2 : 1)"),
    ],
    "pair loop unrolled 2": [("#pragma unroll 4\n      for (int k = lo;",
                              "#pragma unroll 2\n      for (int k = lo;")],
    "pair loop not unrolled": [("#pragma unroll 4\n      for (int k = lo;",
                                "#pragma unroll 1\n      for (int k = lo;")],
    "opacity multiplied, not folded": [
        ("kGaussian ? log2f(opacity) : opacity", "opacity"),
        ("kGaussian ? fmaf(co.x * dy, dy, co.y) : (co.x * dy) * dy", "(co.x * dy) * dy"),
        ("? ex2_approx(fminf(m, co.y))", "? co.y * ex2_approx(fminf(m, 0.0f))"),
    ],
    # The clamp as a free saturation of the last multiply-add instead of a
    # min on the half-rate pipe: the conic carries -log2(e)/128, so
    # sat(m) covers exponents 0 .. -128, and one more FMA scales it back
    # and adds log2(opacity).
    "clamp by saturation": [
        ("const float fold = kGaussian ? 1.4426950408889634f : 1.0f;",
         "const float fold = kGaussian ? -1.4426950408889634f / 128.0f : 1.0f;"),
        ("kGaussian ? fmaf(co.x * dy, dy, co.y) : (co.x * dy) * dy", "(co.x * dy) * dy"),
        ("const float m = fmaf(fmaf(ge.z, dx, t1), dx, t2);",
         "const float m = kGaussian ? __saturatef(fmaf(fmaf(ge.z, dx, t1), dx, t2))\n"
         "                                    : fmaf(fmaf(ge.z, dx, t1), dx, t2);"),
        ("? ex2_approx(fminf(m, co.y))", "? ex2_approx(fmaf(m, -128.0f, co.y))"),
    ],
    # Block b takes tile order[b], read from a second half of the starts
    # array (this script appends the tiles sorted by list length, longest
    # first): what starting the long lists first would be worth.
    "longest lists first": [
        ("const int tile = blockIdx.x;", "const int tile = starts[gridDim.x + blockIdx.x];"),
    ],
    # Wrong pictures, timing only: what the special-function unit costs.
    "no ex2 (timing only)": [("? ex2_approx(fminf(m, co.y))", "? fminf(m, co.y)")],
    # 2^x on the FMA pipe for the first of a thread's four pixels.
    "polynomial ex2 for 1 pixel of 4": [
        ("template <int kPx, bool kGaussian>\n__global__",
         "__device__ __forceinline__ float ex2_poly(float x) {\n"
         "  x = fmaxf(x, -126.0f);\n"
         "  const float t = x + 12582912.0f;\n"
         "  const float f = x - (t - 12582912.0f);\n"
         "  float p = 1.3333558146e-3f;\n"
         "  p = fmaf(p, f, 9.6181291076e-3f);\n"
         "  p = fmaf(p, f, 5.5504108665e-2f);\n"
         "  p = fmaf(p, f, 2.4022650696e-1f);\n"
         "  p = fmaf(p, f, 6.9314718056e-1f);\n"
         "  p = fmaf(p, f, 1.0f);\n"
         "  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));\n"
         "}\n\n"
         "template <int kPx, bool kGaussian>\n__global__"),
        ("? ex2_approx(fminf(m, co.y))",
         "? (p < 1 ? ex2_poly(fminf(m, co.y)) : ex2_approx(fminf(m, co.y)))"),
    ],
}

# name -> replacements applied to csrc/emit.cu
K3_VARIANTS = {
    "committed": [],
    "no occupancy hint": [("__launch_bounds__(kThreads, kBlocksPerSm)",
                           "__launch_bounds__(kThreads)")],
    "8 blocks an SM": [("constexpr int kBlocksPerSm = 6;", "constexpr int kBlocksPerSm = 8;")],
    "128 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 128;")],
    "512 threads a block": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
                            ("constexpr int kBlocksPerSm = 6;", "constexpr int kBlocksPerSm = 2;")],
}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the design variants")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_kernel_variants: no CUDA device", file=sys.stderr)
        return 1

    from cudagaussianrenderer_torch import RenderConfig, Renderer, orbit_cameras, random_scene
    from cudagaussianrenderer_torch.models.camera import Camera
    from cudagaussianrenderer_torch.ops import expand, raster
    from cudagaussianrenderer_torch.ops.binning import emit_columns
    from cudagaussianrenderer_torch.ops.projection import project_splats
    from cudagaussianrenderer_torch.render import _frame_pairs, _splat_colors, camera_tensors
    from cudagaussianrenderer_torch.utils import cuda_build as cb
    from chip_smoke import device_busy_ms

    dev = torch.device("cuda")
    print(ROOT, flush=True)
    print("card:", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip(), flush=True)

    def device_ms(call, reps=30):
        call()
        torch.cuda.synchronize()
        busy = device_busy_ms(lambda: [call() for _ in range(reps)])
        if busy is None:
            raise RuntimeError("the profiler trace holds no device time")
        return busy / reps

    def setup(scene, cam, cfg, cap):
        c = camera_tensors(cam.camera_data(), dev)
        clip = project_splats(scene.means, scene.scales, scene.quats, c, cfg,
                              opacities=scene.opacities)
        cols, incl = emit_columns(clip, _splat_colors(scene, c), scene.opacities, cfg)
        rows = expand.interleave_rows(incl, tuple(x.contiguous() for x in cols), cap + 1)
        _, attrs, starts, counts = _frame_pairs(scene, c, cfg, cap)
        return dict(cfg=cfg, cap=cap, rows=rows, starts=starts.contiguous(),
                    counts=counts.contiguous(),
                    pair_data=raster.pack_pair_data(attrs, cfg.raster_chunk))

    cfg = RenderConfig()
    scene = Renderer(random_scene(1_000_000, seed=0, min_scale=0.002, max_scale=0.053,
                                  extent=4.0, sh_degree=3, device=dev), cfg).scene
    hcfg = RenderConfig(screen_size=1024)
    hscene = random_scene(192, seed=9, min_scale=0.3, max_scale=1.6, extent=3.0,
                          device=dev).pad_to_multiple(256)
    cases = {
        "main path": setup(scene, orbit_cameras(scene.bounds_min, scene.bounds_max, 8)[0],
                           cfg, 3932160),
        "huge splats": setup(hscene, Camera(aspect=1.0).framed(hscene.bounds_min,
                                                                hscene.bounds_max),
                             hcfg, 524288),
    }

    print("== the kernels of this checkout, through their wrappers (device ms)")
    for name, c in cases.items():
        for _ in range(2):
            k3 = device_ms(lambda: expand.emit_slots(c["rows"], c["cap"], c["cfg"]))
            k4 = device_ms(lambda: raster.rasterize_tiles(
                c["pair_data"], c["starts"], c["counts"], c["cfg"]))
            print(f"  {name}: K3 emit {k3:.4f}, K4 raster {k4:.4f}", flush=True)
    if not args.variants:
        return 0

    for c in cases.values():
        stats = {}
        c["tiles"] = raster._raster_torch(c["pair_data"], c["starts"], c["counts"], c["cfg"],
                                          c["cfg"].total_tiles, 0, stats)
        c["evals"] = stats["pairs_blended"] * c["cfg"].pixels_per_tile
        c["words"] = expand._emit_torch(c["rows"], c["cap"], c["cfg"])
    # Removed at the end, or by its finalizer when a variant raises.
    tmp = tempfile.TemporaryDirectory(prefix="gsr_variants_")
    scratch = Path(tmp.name)

    def build(source, tag, replacements, symbol, argtypes):
        text = (cb.CSRC / f"{source}.cu").read_text()
        for old, new in replacements:
            if old not in text:
                raise RuntimeError(f"variant {tag!r}: {old!r} is not in csrc/{source}.cu")
            text = text.replace(old, new)
        src = scratch / f"{source}_{len(list(scratch.iterdir()))}.cu"
        src.write_text(text)
        lib = src.with_suffix(".so")
        proc = subprocess.run(
            [cb.nvcc_path(), *cb.flags(source), f"-I{cb.CSRC}", "-o", str(lib), str(src)],
            capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"variant {tag!r} does not build:\n{proc.stdout}{proc.stderr}")
        regs = [line.split("Used ")[1].split(" registers")[0]
                for line in (proc.stdout + proc.stderr).splitlines() if "registers" in line]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn, regs

    def raster_call(fn, c, out, eps=None, order=None):
        cfg_ = c["cfg"]
        starts, counts = c["starts"], c["counts"]
        if order is not None:
            starts, counts = starts[order].contiguous(), counts[order].contiguous()

        def call():
            code = fn(c["pair_data"].data_ptr(), c["pair_data"].shape[1], starts.data_ptr(),
                      counts.data_ptr(), cfg_.total_tiles, cfg_.tiles_x, cfg_.tile_size, 0,
                      2.0 / cfg_.screen_w, 2.0 / cfg_.screen_h, cfg_.raster_chunk,
                      cfg_.transmittance_eps if eps is None else eps, 1, 0, out.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"launch failed: {code}")
        return call

    print("== K4 variants (device ms; 'no exit' blends every sorted pair)")
    k4_args = [cb.P, cb.I64, cb.P, cb.P, cb.I32, cb.I32, cb.I32, cb.I32, cb.F32, cb.F32,
               cb.I32, cb.F32, cb.I32, cb.I32, cb.P, cb.P]
    m = cases["main path"]
    all_evals = int(m["counts"].sum()) * m["cfg"].pixels_per_tile
    heavy = torch.argsort(m["counts"], descending=True)
    for tag, repl in K4_VARIANTS.items():
        fn, regs = build("raster", tag, repl, "gsr_raster", k4_args)
        line = f"  {tag}: registers {regs[-1]}"
        for name, c in cases.items():
            out = torch.empty_like(c["tiles"])
            if tag == "longest lists first":
                c = dict(c, starts=torch.cat(
                    [c["starts"], torch.argsort(c["counts"], descending=True).to(torch.int32)]))
            ms = device_ms(raster_call(fn, c, out))
            err = float((out - c["tiles"]).abs().max())
            line += (f"; {name} {ms:.4f} ({c['evals'] / ms / 1e9:.3f} G evaluations/ms, "
                     f"max err {err:.1e})")
        if tag == "longest lists first":
            print(line, flush=True)
            continue
        out = torch.empty_like(m["tiles"])
        no_exit = device_ms(raster_call(fn, m, out, eps=-1.0), 10)
        first = device_ms(raster_call(fn, m, out, eps=-1.0, order=heavy), 10)
        last = device_ms(raster_call(fn, m, out, eps=-1.0, order=heavy.flip(0)), 10)
        line += (f"; no exit {no_exit:.4f} ({all_evals / no_exit / 1e9:.3f} G evaluations/ms), "
                 f"heaviest tiles first {first:.4f}, lightest first {last:.4f}")
        print(line, flush=True)

    print("== K3 variants (device ms)")
    k3_args = [cb.P, cb.I64, cb.I32, cb.I32, cb.I32, cb.I32, cb.I32] + [cb.P] * 7
    for tag, repl in K3_VARIANTS.items():
        fn, regs = build("emit", tag, repl, "gsr_emit", k3_args)
        line = f"  {tag}: registers {regs[-1]}"
        for name, c in cases.items():
            outs = [torch.empty(c["cap"], dtype=torch.int32, device=dev) for _ in range(6)]

            def call():
                code = fn(c["rows"].data_ptr(), c["rows"].shape[1], c["cap"],
                          expand.emit_block(c["cap"]), 1, c["cfg"].tiles_x,
                          c["cfg"].sentinel_tile, *[o.data_ptr() for o in outs],
                          torch.cuda.current_stream().cuda_stream)
                if code:
                    raise RuntimeError(f"launch failed: {code}")
            ms = device_ms(call)
            equal = all(torch.equal(a, b) for a, b in zip(outs, c["words"]))
            line += f"; {name} {ms:.4f} (six words equal: {equal})"
        print(line, flush=True)
    tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
