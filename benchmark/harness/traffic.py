"""The general traffic generator: what each frame's inputs are.

A cell's traffic file gives the camera path and any per-frame motion as
parameters; `--seed` draws where on the path the run starts and the
renderer's noise salt. Frame k (counted from the first warm-up frame) has
one pose and one set of vertex positions whatever the seed, so every seed
covers the same poses in another order.

Camera (`camera`): a look-at camera on a circle of `radius` around
`center`, at height `height`, with a vertical field of view `fov_deg`,
stepping `step_rad` a frame back and forth over the arc `arc_rad` centred
on `phase0_rad`. The seed picks the starting step of the sweep.

Motion (`motion`, optional): every vertex of the scene's vertex group
`group` moves along `axis` by `amplitude * sin(step_rad * (start + k))`
from its rest position.
"""

from __future__ import annotations

import math

import numpy as np

U64 = (1 << 64) - 1


def seed_rng(seed: int, stream: int = 0) -> np.random.Generator:
    """An independent generator per (seed, stream); any integer seed."""
    return np.random.default_rng([int(seed) & U64, stream])


class Traffic:
    def __init__(self, params: dict, spec: dict, out_w: int, out_h: int, seed: int):
        self.p = params
        self.cam = params["camera"]
        self.aspect = float(out_w) / float(out_h)
        rng = seed_rng(seed)
        self.rng_salt = int(rng.integers(0, 1 << 32))
        self.half = max(1, int(round(float(self.cam["arc_rad"]) / float(self.cam["step_rad"]))))
        self.cycle = 2 * self.half
        self.start = int(rng.integers(0, self.cycle))
        self.motion = params.get("motion")
        if self.motion is not None:
            first, count = spec["groups"][self.motion["group"]]
            self.rest = np.array(spec["mesh"]["positions"], np.float32)
            self.moving = slice(int(first), int(first) + int(count))

    def angle(self, k: int) -> float:
        c = (self.start + k) % self.cycle
        step = float(self.cam["step_rad"])
        off = step * c if c <= self.half else step * (self.cycle - c)
        return float(self.cam["phase0_rad"]) - 0.5 * step * self.half + off

    def pose(self, k: int) -> tuple:
        """(origin, target, up, vfov_degrees, aspect) of frame k."""
        a = self.angle(k)
        cx, cy, cz = (float(x) for x in self.cam["center"])
        r = float(self.cam["radius"])
        origin = (cx + r * math.sin(a), float(self.cam["height"]), cz + r * math.cos(a))
        return origin, (cx, cy, cz), (0.0, 1.0, 0.0), float(self.cam["fov_deg"]), self.aspect

    def positions(self, k: int):
        """The mesh's vertex positions of frame k, or None when static."""
        if self.motion is None:
            return None
        m = self.motion
        moved = self.rest.copy()
        moved[self.moving, int(m["axis"])] += np.float32(
            float(m["amplitude"]) * math.sin(float(m["step_rad"]) * (self.start + k)))
        return moved
