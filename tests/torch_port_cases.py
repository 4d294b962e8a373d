"""Clip-data edits shared by the port's emit tests (CPU parity against the
JAX package, and the card-only kernel tests).  Each returns a function that
changes a dict of per-splat clip-data arrays (numpy or torch) in place.
Imports neither jax nor the JAX package."""


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
