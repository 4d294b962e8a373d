"""Every measurement entry point of the port run once at smoke sizes (the
JAX repository's tools/smoke_batch.py): the CPU rehearsal of chip_smoke.py's
phase 14, which runs the same entry points on the card at full width.

    python -m cudagaussianrenderer_torch.tools.smoke_batch --device cpu
    python -m cudagaussianrenderer_torch.tools.smoke_batch --device cpu sort emit

Targets: the eleven ``measure`` subcommands, ``bench`` (4 frames),
``suite1`` (bench_suite config 1) and ``selfcheck``.  The defaults are the
JAX smoke's sizes: the ``measure`` targets at ``--n`` splats (20,000) at
``--size``² (1024) with a ``--capacity`` (131,072) slot list and one call
a timed run (REPS = 1), ``reorder`` at 65,536 splats, the bench at 20,000
splats and 256², suite config 1 as it is.  Smaller ``--n`` and ``--size``
scale the bench and the suite's config alike (splats by ``--n`` / 20,000,
screens by ``--size`` / 1024).  ``trainscale`` and ``dpstep`` (which the
JAX smoke leaves out) run one small row.  On the CPU the numbers mean nothing (the kernels' plain versions,
eager, on the host clock): only the exit code and the FAILED lines do.

Prints ``SMOKE <target> DONE`` or ``SMOKE <target> FAILED: ...`` for each
target and exits 1 if any failed.
"""

from __future__ import annotations

import argparse
import sys
import traceback

from . import bench_suite, measure, selfcheck
from .. import bench
from ..utils.device import resolve_device

TARGETS = measure.COMMANDS + ("bench", "suite1", "selfcheck")
SMOKE_N = 20_000
SMOKE_SIZE = 1024
SMOKE_CAPACITY = 131_072  # divisible by 1,024 x 128 (sort's batched shapes)
SMOKE_REORDER_N = 65_536
SMOKE_TRAIN_ROWS = ((2_000, 64),)
SMOKE_DP = dict(size=64, n_scene=1_000, n_init=500, steps=2)


def run(which: str, dev, *, n: int = SMOKE_N, capacity: int = SMOKE_CAPACITY,
        size: int = SMOKE_SIZE) -> None:
    """Run the target ``which``; raise if it fails."""
    if which in measure.COMMANDS:
        result = measure.run(which, dev, n=SMOKE_REORDER_N if which == "reorder" else n,
                             capacity=capacity, reps=1, size=size,
                             train_rows=SMOKE_TRAIN_ROWS, dp_kw=SMOKE_DP)
        if result["failed"]:
            raise RuntimeError(f"failed lines: {result['failed']}")
    elif which == "bench":
        bench.main([str(n), "4", "--size", str(256 * size // SMOKE_SIZE), "--device", dev.type])
    elif which == "suite1":
        bench_suite.main(["1", "--n-scale", str(n / SMOKE_N), "--size-scale",
                          str(size / SMOKE_SIZE), "--device", dev.type])
    elif which == "selfcheck":
        if selfcheck.main(["--device", dev.type]) != 0:
            raise RuntimeError("the selfcheck drifted")
    else:
        raise ValueError(f"unknown smoke target {which!r}: one of {', '.join(TARGETS)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("targets", nargs="*", choices=TARGETS, metavar="target")
    ap.add_argument("--n", type=int, default=SMOKE_N)
    ap.add_argument("--capacity", type=int, default=SMOKE_CAPACITY)
    ap.add_argument("--size", type=int, default=SMOKE_SIZE)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    failures = []
    for t in args.targets or TARGETS:
        print(f"=== smoke {t} ===", flush=True)
        try:
            run(t, dev, n=args.n, capacity=args.capacity, size=args.size)
        except Exception as e:  # noqa: BLE001 - report every target, then exit 1
            traceback.print_exc()
            failures.append(t)
            print(f"SMOKE {t} FAILED: {type(e).__name__}: {e}", flush=True)
            continue
        print(f"SMOKE {t} DONE", flush=True)
    if failures:
        print(f"smoke failures: {failures}", flush=True)
        return 1
    print("smoke all green", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
