"""The final scene of Peter Shirley's *Ray Tracing in One Weekend*
(raytracing.github.io, "A Final Render"): a lambert ground sphere of
radius 1000 at (0, -1000, 0), albedo 0.5; a grid of radius-0.2 spheres at
(a + 0.9u, 0.2, b + 0.9v) for a, b in [-grid, grid), skipping any within
0.9 of (4, 0.2, 0), 80% lambert (albedo random x random), 15% metal
(albedo in [0.5, 1)) and 5% glass (ior 1.5); and three radius-1 spheres:
glass 1.5 at (0, 1, 0), lambert (0.4, 0.2, 0.1) at (-4, 1, 0) and metal
(0.7, 0.6, 0.5) at (4, 1, 0). No triangles. Parameters: `seed`, `grid`
(11 in the book: 22 x 22 candidates, about 485 spheres in all).

Departures from the book:
- the renderer has no fuzzy metal: a metal sphere is a mirror with its
  albedo as its colour, and the fuzz the book draws (in [0, 0.5)) is
  drawn and dropped;
- no defocus: the book's camera has an aperture of 0.1 focused at 10, the
  renderer's camera is a pinhole;
- the renderer's sun is added to the book's white-to-(0.5, 0.7, 1.0) sky;
- numpy's generator (`default_rng(seed)`, one `random()` per draw, in the
  book's order of draws) in place of the book's `random_double`, so the
  layout is the book's in kind, not sphere for sphere.

Each sphere's albedo is its own: the three materials (lambert, mirror,
glass) have a kd of 0, which the renderer reads as "take the sphere's".
"""

from __future__ import annotations

import numpy as np

LAMBERT, MIRROR, GLASS = 0, 1, 2


def build(params: dict) -> dict:
    rng = np.random.default_rng(int(params["seed"]))
    grid = int(params["grid"])
    materials = [dict(kd=(0.0, 0.0, 0.0), two_sided=0, shading=LAMBERT, ior=1.0),
                 dict(kd=(0.0, 0.0, 0.0), two_sided=0, shading=MIRROR, ior=1.0),
                 dict(kd=(0.0, 0.0, 0.0), two_sided=0, shading=GLASS, ior=1.5)]

    def sphere(center, radius, albedo, kind):
        return dict(center=tuple(float(c) for c in center), radius=float(radius),
                    albedo=tuple(float(c) for c in albedo), material=kind, shading=kind,
                    ior=1.5 if kind == GLASS else 1.0)

    spheres = [sphere((0.0, -1000.0, 0.0), 1000.0, (0.5, 0.5, 0.5), LAMBERT)]
    keep_out = np.array([4.0, 0.2, 0.0])
    for a in range(-grid, grid):
        for b in range(-grid, grid):
            choose = rng.random()
            center = np.array([a + 0.9 * rng.random(), 0.2, b + 0.9 * rng.random()])
            if np.linalg.norm(center - keep_out) <= 0.9:
                continue
            if choose < 0.8:
                albedo = rng.random(3) * rng.random(3)
                spheres.append(sphere(center, 0.2, albedo, LAMBERT))
            elif choose < 0.95:
                albedo = 0.5 + 0.5 * rng.random(3)
                rng.random()  # the book's fuzz, which the renderer has not
                spheres.append(sphere(center, 0.2, albedo, MIRROR))
            else:
                spheres.append(sphere(center, 0.2, (1.0, 1.0, 1.0), GLASS))
    spheres += [sphere((0.0, 1.0, 0.0), 1.0, (1.0, 1.0, 1.0), GLASS),
                sphere((-4.0, 1.0, 0.0), 1.0, (0.4, 0.2, 0.1), LAMBERT),
                sphere((4.0, 1.0, 0.0), 1.0, (0.7, 0.6, 0.5), MIRROR)]
    return dict(materials=materials,
                mesh=dict(positions=np.zeros((0, 3), np.float32),
                          tris=np.zeros((0, 3), np.int32), tri_mat=np.zeros((0,), np.int32)),
                spheres=spheres, groups={})
