"""Device ms a traced frame of stage F's kernel K4 (ops/raster.py)."""

NAMES = r"\braster(_cluster)?_kernel\b"


def read(r):
    if r.stretch is None or not r.traced:
        return None
    ms = r.stretch.records(NAMES)
    return sum(ms) / len(r.traced) if ms else None
