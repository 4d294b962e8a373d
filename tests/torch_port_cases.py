"""Cases shared by the port's CPU parity tests against the JAX package and
the card-only kernel tests: clip-data edits for the emit tests (each returns
a function that changes a dict of per-splat clip-data arrays, numpy or
torch, in place) and per-band candidate counts for the band compaction.
Imports neither jax nor the JAX package."""

import numpy as np


def cull_run(lo, hi):
    """Splats [lo, hi) become culled ones (the projection's own marking):
    a run of columns that own no slot."""
    def edit(f):
        f["cx"][lo:hi] = f["cy"][lo:hi] = -128.0
        f["e0"][lo:hi] = f["e1"][lo:hi] = 0.0
    return edit


def widen(*splats):
    """The given splats cover the whole screen, so at 64 tiles across they
    are wider than the 63 tiles a packed run can hold."""
    def edit(f):
        for i in splats:
            f["cx"][i] = f["cy"][i] = f["sin_t"][i] = 0.0
            f["cos_t"][i] = 1.0
            f["e0"][i] = f["e1"][i] = 2.5
    return edit


# The band compaction's corner cases, each a [4, n] table of per-band
# candidate counts for band_prefixes(counts, COMPACT_CG, mc).
COMPACT_CASES = ("empty-band", "exactly-full", "saturated-then-roomy", "kept-mod-4",
                 "dense-in-one-tile")
# Per-band pair capacity of those cases: roomy, so that only the compact
# capacity mc decides what is kept.
COMPACT_CG = 1 << 16


def compact_counts(name, n, mc, seed=0):
    """[4, n] int32 counts (0..6 a column) for one of COMPACT_CASES.

    empty-band: band 1 selects nothing.  exactly-full: band 2 selects
    exactly mc columns.  saturated-then-roomy: band 1 selects 1.5 * mc
    columns, so its last mc / 2 are dropped; band 2 is roomy.  kept-mod-4:
    band g keeps a count that is g modulo 4.  dense-in-one-tile: band g
    selects every column of one run of min(mc - 1, n / 4) neighbours and no
    other, as after a scene reorder by tile row.
    """
    rng = np.random.default_rng(seed)
    bands = 4

    def chosen(k):
        """A row with k random columns of count 1..6."""
        row = np.zeros(n, np.int32)
        row[rng.choice(n, k, replace=False)] = rng.integers(1, 7, k)
        return row

    roomy = max(1, min(mc, n) // 2)
    counts = np.stack([chosen(int(rng.integers(roomy // 2, roomy + 1))) for _ in range(bands)])
    if name == "empty-band":
        counts[1] = 0
    elif name == "exactly-full":
        counts[2] = chosen(mc)
    elif name == "saturated-then-roomy":
        counts[1] = chosen(mc + mc // 2)
    elif name == "kept-mod-4":
        for g in range(bands):
            counts[g] = chosen(roomy // 4 * 4 + g)
    elif name == "dense-in-one-tile":
        w = min(mc - 1, n // bands)
        counts[:] = 0
        for g in range(bands):
            counts[g, g * w:(g + 1) * w] = rng.integers(1, 7, w)
    else:
        raise ValueError(name)
    return counts
