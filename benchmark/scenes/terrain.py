"""The large-mesh terrain: a displaced height-field grid of rolling hills
(grass, and rock where a triangle is steep) and two spheres, a frozen copy
of the repository's procedural generator. Parameters: `grid_x`,
`grid_z`, `extent`; grid_x * grid_z * 2 triangles (1,048,576 at 1024 x
512). The spheres take their materials' kd and lambert shading.
"""

from __future__ import annotations

import numpy as np


def _height(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    h = (0.55 * np.sin(0.9 * x) * np.cos(0.7 * z)
         + 0.25 * np.sin(2.3 * x + 1.1) * np.sin(1.9 * z + 0.3)
         + 0.10 * np.sin(5.1 * x + 2.0) * np.cos(4.7 * z + 1.7))
    return h.astype(np.float32)


def build(params: dict) -> dict:
    grid_x, grid_z = int(params["grid_x"]), int(params["grid_z"])
    extent = float(params["extent"])
    mat = lambda kd, shading=0: dict(kd=kd, two_sided=0, shading=shading, ior=1.0)
    materials = [mat((0.35, 0.55, 0.25)), mat((0.45, 0.42, 0.40)), mat((0.9, 0.9, 0.9), 1)]
    grass, rock, mirror = 0, 1, 2
    xs = np.linspace(-extent, extent, grid_x + 1, dtype=np.float32)
    zs = np.linspace(-extent * grid_z / grid_x, extent * grid_z / grid_x, grid_z + 1,
                     dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    pos = np.stack([gx, _height(gx, gz), gz], axis=-1).reshape(-1, 3)
    ix, iz = np.meshgrid(np.arange(grid_x, dtype=np.int32), np.arange(grid_z, dtype=np.int32),
                         indexing="ij")
    v00 = (ix * (grid_z + 1) + iz).reshape(-1)
    ncell = v00.shape[0]
    tris = np.empty((2 * ncell, 3), np.int32)
    tris[:ncell, 0] = v00
    tris[:ncell, 1] = v00 + (grid_z + 1)
    tris[:ncell, 2] = tris[:ncell, 1] + 1
    tris[ncell:, 0] = v00
    tris[ncell:, 1] = tris[:ncell, 2]
    tris[ncell:, 2] = v00 + 1
    c0, c1, c2 = pos[tris[:, 0], 1], pos[tris[:, 1], 1], pos[tris[:, 2], 1]
    steep = (np.maximum.reduce([c0, c1, c2]) - np.minimum.reduce([c0, c1, c2])) > 0.035
    spheres = [dict(center=(0.0, 1.6, 0.0), radius=0.9, albedo=(0.9, 0.9, 0.9),
                    material=mirror, shading=0, ior=1.0),
               dict(center=(2.4, 1.2, 1.8), radius=0.6, albedo=(0.8, 0.3, 0.2),
                    material=rock, shading=0, ior=1.0)]
    return dict(materials=materials,
                mesh=dict(positions=pos, tris=tris,
                          tri_mat=np.where(steep, rock, grass).astype(np.int32)),
                spheres=spheres, groups={})
