"""Device ms a traced frame of the tile-list kernels: K2 and K3 of stage C
(ops/expand.py) and K1 of stage E (ops/ranges.py)."""

NAMES = r"\bedges_kernel\b|\binterleave_kernel\b|\bemit_kernel\b"


def read(r):
    if r.stretch is None or not r.traced:
        return None
    ms = r.stretch.records(NAMES)
    return sum(ms) / len(r.traced) if ms else None
