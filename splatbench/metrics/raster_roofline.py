"""K4's share of its bound, %.

The work of the blend, from its equations, for each (pixel, pair)
evaluation before the tile's exit:

    d      = p - c                      2  (two subtractions)
    q      = (a dx + b' dy) dx + c dy^2 4  (two fused multiply-adds, with
                                            the dy terms shared by a row)
    alpha  = o exp2(q')                 2  (the exp2, one multiply; the
                                            -1/2 log2(e) folded in a, b', c)
    w      = T alpha                    1
    C     += w rgb                      6  (three fused multiply-adds)
    T     -= w                          1

16 float32 operations, one of them the exp2 that the special-function
units take.  The bound is the largest of the operations at 67 TFLOP/s,
the exp2 at 16 a clock and SM at the card's highest SM clock, and the
bytes (each blended pair's nine float32 attributes read once, each pixel's
8-bit RGBA written once) at 3.35 TB/s.  Evaluations are the reference's
pairs blended before each tile's exit x the tile's pixels, for each
traced frame (a captured frame blends twice: its warm-up and its replay).
The device time is the mean K4 record times the K4 runs, so a record the
trace lost biases nothing."""

from splatbench.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S, ex2_per_s

NAMES = r"\braster(_cluster)?_kernel\b"
OPS_PER_EVAL = 16
BYTES_PER_PAIR = 36
BYTES_PER_PIXEL = 4


def read(r):
    if (r.stretch is None or not r.traced or r.card is None
            or any("pairs_blended" not in f for f in r.traced)):
        return None
    ms = r.stretch.records(NAMES)
    if not ms:
        return None
    npix = r.screen["tile"] ** 2
    pixels = r.screen["width"] * r.screen["height"]
    runs = [2 if f["method"] == "capture" else 1 for f in r.traced]
    evals = sum(n * f["pairs_blended"] * npix for n, f in zip(runs, r.traced))
    nbytes = sum(n * (BYTES_PER_PAIR * f["pairs_blended"] + BYTES_PER_PIXEL * pixels)
                 for n, f in zip(runs, r.traced))
    bound_s = max(OPS_PER_EVAL * evals / F32_FLOP_PER_S, evals / ex2_per_s(r.card),
                  nbytes / HBM_BYTES_PER_S)
    time_s = sum(ms) / len(ms) * sum(runs) / 1e3
    return 100.0 * bound_s / time_s
