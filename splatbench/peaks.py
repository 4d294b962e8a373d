"""Peaks of one NVIDIA H100 SXM, from NVIDIA's data sheet (700 W)."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
# float32 outside the tensor cores.
F32_FLOP_PER_S = 67e12
# The special-function units: 16 exp2 results a clock and SM.
EX2_PER_CLOCK_PER_SM = 16


def card() -> dict:
    """The card's name, power limit, SM count and highest SM clock (MHz),
    as nvidia-smi and torch report them."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    name, power, mhz = (s.strip() for s in out.split(","))
    return dict(name=name, power_limit_w=float(power), max_sm_mhz=float(mhz),
                sms=torch.cuda.get_device_properties(0).multi_processor_count)


def ex2_per_s(info: dict) -> float:
    """exp2 results a second of the whole card at its highest SM clock."""
    return EX2_PER_CLOCK_PER_SM * info["sms"] * info["max_sm_mhz"] * 1e6
