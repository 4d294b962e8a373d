"""Stage D's share of its bound, %: the least traffic that sorts the
frame's pairs by a 32-bit key with a 32-bit payload (read and write key
and payload once: 16 B a pair) at the HBM rate, over the sort's device
time (stage.sort_ms's kernels).  Pairs are the reference's count for each
traced frame, whatever key width the program sorts; a captured frame
sorts twice (its warm-up and its replay)."""

import re

from splatbench.peaks import HBM_BYTES_PER_S

NAMES = r"DeviceRadixSort|fill_reverse_indices_kernel|index_elementwise_kernel"
BYTES_PER_PAIR = 16


def read(r):
    if r.stretch is None or not r.traced or any("pairs" not in f for f in r.traced):
        return None
    ms = r.stretch.records(NAMES)
    if not ms:
        return None
    runs = sum((2 if f["method"] == "capture" else 1) * f["pairs"] for f in r.traced)
    bound_s = BYTES_PER_PAIR * runs / HBM_BYTES_PER_S
    return 100.0 * bound_s / (sum(ms) / 1e3)
