"""Camera paths: the one generator every traffic mix parameterises.

Frame k of a path looks at the scene's centre, moved by ``wander``, from

    azimuth   theta0 + 2 pi (k mod P) / P                (P = azimuth_frames)
    distance  D (d0 + d1 sin(2 pi k / Pd))                 (distance block)
    elevation e0 + e1 sin(2 pi k / Pe)                     (elevation block)

where D frames the scene's cube as a viewer's auto-framing does
(sqrt(2) * edge / 2 / tan(fov_y / 2)) and the offset from the centre is
(sin theta, elevation, cos theta) normalised.  ``wander`` moves the
look-at point by a smooth sum of sinusoids within that share of the
half-extent on each axis.  With ``"phase": "seed"`` theta0 and the
wander's phases come from the seed, so a seed walks the same poses from
another start; with a number theta0 is that angle (radians) and the
phases are fixed, so every seed walks the same path.  A path
whose terms are constant but the azimuth repeats its poses exactly every
P frames.

``warmup`` says what set-up renders: ``poses`` poses from frame 0,
``passes`` times over, stopping early once a pass replayed every frame
where ``until_replayed`` is set.  The window then goes on from frame
``poses``, unless ``session_frames`` is set: then the window is a run of
viewer sessions, each of which opens the scene in a new Renderer (an
empty graph cache, the first capacity) and flies frames 0 to
``session_frames`` - 1 of the path, and set-up's renderer is dropped.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

# Periods (frames) of the wander's sinusoids, one set an axis.
WANDER_PERIODS = ((517.0, 311.0, 193.0), (431.0, 277.0, 157.0), (389.0, 233.0, 139.0))


class PosePath:
    """Poses of one traffic mix over one configuration, for one seed."""

    def __init__(self, traffic: Dict, config: Dict, seed: int):
        self.traffic = traffic
        cam = config["camera"]
        self.fov_y = math.radians(float(cam["fov_y_deg"]))
        self.near, self.far = float(cam["near"]), float(cam["far"])
        self.aspect = config["screen"]["width"] / config["screen"]["height"]
        half = float(config["scene"]["extent"])
        self.half = half
        self.distance = math.sqrt(2.0) * (2.0 * half) * 0.5 / math.tan(self.fov_y * 0.5)
        phase = traffic.get("phase", "seed")
        rng = np.random.default_rng([int(seed) if phase == "seed" else 0, 0x7072])
        self.theta0 = float(rng.uniform(0.0, 2.0 * math.pi)) if phase == "seed" else float(phase)
        self.wander_phase = rng.uniform(0.0, 2.0 * math.pi, (3, 3))

    @staticmethod
    def _wave(block: Dict, k: int) -> float:
        return float(block["base"]) + float(block.get("amp", 0.0)) * math.sin(
            2.0 * math.pi * k / float(block.get("frames", 1)))

    def distance_at(self, k: int) -> float:
        """Frame ``k``'s distance from the look-at point."""
        return self.distance * self._wave(self.traffic["distance"], k)

    def pose(self, k: int) -> Dict:
        """Frame ``k``'s pose: position, target, fov_y, aspect, near, far."""
        t = self.traffic
        period = int(t["azimuth_frames"])
        theta = self.theta0 + 2.0 * math.pi * (k % period) / period
        elev = self._wave(t["elevation"], k)
        dist = self.distance_at(k)
        offset = np.array([math.sin(theta), elev, math.cos(theta)])
        offset /= np.linalg.norm(offset)
        share = float(t.get("wander", 0.0))
        target = np.zeros(3)
        if share:
            for axis, periods in enumerate(WANDER_PERIODS):
                waves = [math.sin(2.0 * math.pi * k / p + ph)
                         for p, ph in zip(periods, self.wander_phase[axis])]
                target[axis] = share * self.half * sum(waves) / len(waves)
        return dict(position=(target + offset * dist).tolist(), target=target.tolist(),
                    fov_y=self.fov_y, aspect=self.aspect, near=self.near, far=self.far)
