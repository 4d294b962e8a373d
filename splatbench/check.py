"""The comparison that decides ``correct``.

Each judged frame of the program is held against the plain reference
(``reference.frame``) at the same scene and pose.  The numbers, each the
worst over the judged frames:

  * ``mean_abs``      mean |program - reference| over every pixel and the
                      three colour channels, in 8-bit levels;
  * ``bad_share``     share of pixels with a colour channel more than
                      BAD_LEVELS levels off;
  * ``tiles_off``     tiles whose mean |program - reference| (colour
                      channels) exceeds TILE_LEVELS levels, counted: an
                      error confined to a few tiles, which the frame's mean
                      dilutes.  A count and not the worst tile's error: two
                      large splats whose depths lie within rounding of a
                      quantisation level may swap (the program quantises
                      float32 depth, the reference float64), and that can
                      take one tile 20 levels off in a sound run;
  * ``coverage_missing`` share of tiles that hold a pair in the
                      reference's lists (alpha 255) and none in the
                      program's (alpha 0), counted by tile and not with
                      the colour.  The converse is no fault: the program's
                      lists may hold pairs that blend to nothing (below).
  * ``pairs_missing`` (the reference's pairs - the program's candidate
                      pairs) / the reference's pairs, at least 0: pairs
                      the program's lists leave out.  The program may
                      count more, since it rounds each splat's tile runs
                      outward and emits rows past the eighth of a tall
                      splat whole; such pairs blend to nothing.

Each has its limit in the configuration's ``limits``; a frame the program
never returned fails outright.
"""

from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

NUMBERS = ("mean_abs", "bad_share", "tiles_off", "coverage_missing", "pairs_missing")
# A pixel is off where a channel is more than this many levels from the
# reference's (the repo's own per-pixel rule for its golden frames).
BAD_LEVELS = 8
# A tile is off where its mean error is more than this many levels.
TILE_LEVELS = 16


def frame_numbers(image: np.ndarray, ref_image: np.ndarray, candidates: int, ref_pairs: int,
                  tile: int) -> Dict[str, float]:
    """The numbers of one frame: ``image`` and ``ref_image`` [H, W, 4] u8."""
    diff = np.abs(image[..., :3].astype(np.int16) - ref_image[..., :3].astype(np.int16))
    bad = diff.max(-1) > BAD_LEVELS
    h, w = bad.shape
    per_tile = diff.reshape(h // tile, tile, w // tile, tile, 3).mean(axis=(1, 3, 4))
    covered = image[::tile, ::tile, 3] > 0
    ref_covered = ref_image[::tile, ::tile, 3] > 0
    return dict(mean_abs=float(diff.mean()), bad_share=float(bad.mean()),
                tiles_off=int((per_tile > TILE_LEVELS).sum()),
                coverage_missing=float((ref_covered & ~covered).mean()),
                pairs_missing=max(0, int(ref_pairs) - int(candidates)) / max(1, int(ref_pairs)))


def worst(frames: Iterable[Dict[str, float]]) -> Dict[str, float]:
    """Each number's worst (largest) reading over ``frames``."""
    frames = list(frames)
    return {k: max(f[k] for f in frames) for k in NUMBERS}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number read and within its limit."""
    return all(numbers[k] is not None and numbers[k] <= float(limits[k]) for k in NUMBERS)


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """Each number beside its limit, as the result line carries them."""
    return {k: {"value": numbers[k], "limit": float(limits[k])} for k in NUMBERS}
