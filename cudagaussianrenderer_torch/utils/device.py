"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU
explicitly: ``device=None`` means ``"cuda"``, and a CUDA request without
a card raises instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions of the kernels on the CPU"
        )
    return dev
