"""Procedural large-mesh scene (port of models/terrain.py; BASELINE config 5).

A displaced height-field grid plus two spheres: 1,048,576 triangles at the
default grid, enough to exercise the HBM-streaming kernels K4/K5
(ops/cuda/stream.py) at Sponza scale without shipping an asset. Built with
coarse leaves (64 triangles, SAH) as the streaming prep expects.
"""

from __future__ import annotations

import numpy as np

from ilgpu_raytracing_tpu_torch.models.materials import SHADING_MIRROR, Material
from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder


def _height(x: np.ndarray, z: np.ndarray) -> np.ndarray:
    """Deterministic rolling-hills height field."""
    h = (
        0.55 * np.sin(0.9 * x) * np.cos(0.7 * z)
        + 0.25 * np.sin(2.3 * x + 1.1) * np.sin(1.9 * z + 0.3)
        + 0.10 * np.sin(5.1 * x + 2.0) * np.cos(4.7 * z + 1.7)
    )
    return h.astype(np.float32)


def build_terrain_scene(
    grid_x: int = 1024,
    grid_z: int = 512,
    extent: float = 24.0,
    blas_leaf_size: int = 64,
    bvh_method: str = "sah",
    device="cuda",
):
    """(builder, scene) with grid_x*grid_z*2 triangles (default 1,048,576),
    committed on `device`."""
    b = SceneBuilder(blas_leaf_size=blas_leaf_size, bvh_method=bvh_method)

    m_grass = b.add_material(Material(kd=(0.35, 0.55, 0.25)))
    m_rock = b.add_material(Material(kd=(0.45, 0.42, 0.40)))
    m_mirror = b.add_material(
        Material(kd=(0.9, 0.9, 0.9), shading=SHADING_MIRROR)
    )

    xs = np.linspace(-extent, extent, grid_x + 1, dtype=np.float32)
    zs = np.linspace(-extent * grid_z / grid_x, extent * grid_z / grid_x,
                     grid_z + 1, dtype=np.float32)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")  # (X+1, Z+1)
    gy = _height(gx, gz)
    pos = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)

    # two triangles per cell, split along alternating diagonals, filled
    # column-wise into one preallocated index table
    ix, iz = np.meshgrid(
        np.arange(grid_x, dtype=np.int32),
        np.arange(grid_z, dtype=np.int32),
        indexing="ij",
    )
    v00 = (ix * (grid_z + 1) + iz).reshape(-1)
    ncell = v00.shape[0]
    tris = np.empty((2 * ncell, 3), np.int32)
    tris[:ncell, 0] = v00
    tris[:ncell, 1] = v00 + (grid_z + 1)  # v10
    tris[:ncell, 2] = tris[:ncell, 1] + 1  # v11
    tris[ncell:, 0] = v00
    tris[ncell:, 1] = tris[:ncell, 2]  # v11
    tris[ncell:, 2] = v00 + 1  # v01

    # material by slope: steep cells are rock
    c0 = pos[tris[:, 0], 1]
    c1 = pos[tris[:, 1], 1]
    c2 = pos[tris[:, 2], 1]
    steep = (np.maximum.reduce([c0, c1, c2])
             - np.minimum.reduce([c0, c1, c2])) > 0.035
    tri_mat = np.where(steep, m_rock, m_grass).astype(np.int32)

    b.add_mesh_instance(pos, tris, tri_mat=tri_mat)

    s0 = b.add_sphere((0.0, 1.6, 0.0), 0.9, (0.9, 0.9, 0.9), m_mirror)
    s1 = b.add_sphere((2.4, 1.2, 1.8), 0.6, (0.8, 0.3, 0.2), m_rock)
    b.add_sphere_instance([s0, s1])

    return b, b.commit(device)


def terrain_camera(width: int, height: int):
    from ilgpu_raytracing_tpu_torch.models.camera import Camera

    return Camera.look_at(
        (6.5, 4.2, 9.5), (0.0, 0.6, 0.0), (0.0, 1.0, 0.0),
        55.0, width / float(height),
    )
