"""Device ms a traced frame of every kernel that none of the stage groups
names: stages A-C's plain torch (ops/sh.py, ops/projection.py,
ops/binning.py), the attribute packing and tiles_to_image.  Copies and
sets (the camera in, the counts and the image out) are left out."""

import re

OTHER_GROUPS = (r"\bedges_kernel\b|\binterleave_kernel\b|\bemit_kernel\b"
                r"|\braster(_cluster)?_kernel\b"
                r"|DeviceRadixSort|fill_reverse_indices_kernel|index_elementwise_kernel")
COPIES = r"^(Memcpy|Memset|memcpy|memset)"


def read(r):
    if r.stretch is None or not r.traced:
        return None
    other, copies = re.compile(OTHER_GROUPS), re.compile(COPIES)
    ms = [(t1 - t0) / 1e3 for name, t0, t1 in r.stretch.device
          if not other.search(name) and not copies.search(name)]
    return sum(ms) / len(r.traced) if ms else None
