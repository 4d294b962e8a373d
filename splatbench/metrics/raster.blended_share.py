"""Share of the listed pairs that K4 blended before each tile's exit, %:
the program's counters (K4's atomic count and the pairs the capacity
kept), summed over the window's frames outside the traced stretch."""

from splatbench import spans


def read(r):
    return spans.counter_share(r, "blended", "pairs")
