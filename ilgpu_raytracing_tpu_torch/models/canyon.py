"""Canyon: an occlusion-structured scene for ReSTIR reuse characterization
(port of models/canyon.py).

Two tall walls flanking a narrow floor slot, sun low behind the left wall so
most floor/wall pixels see the sun occluded (the courtyard-banner lighting
class the reference's ReSTIR targets, RTRay.cs:327-543), and a strongly
peaked sky gradient so the *unshadowed* RIS target varies sharply across
each pixel's hemisphere. On wall pixels (normals horizontal) cosine
candidates rarely land in the bright sky band, so candidates-only RIS has
high selection variance; temporal+spatial reuse grows the effective
candidate count M and cuts exactly that variance term.

The JAX package's tests/test_restir_win.py measures with it where reuse
wins (few fresh candidates, sky-structured target) and documents where it
does not (the 8+1-candidate default on smooth lighting, where
candidates-only RIS is already near-converged and reuse only adds
UCW-chain noise).
"""

from __future__ import annotations

import numpy as np

from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.cornell import _quad_grid
from ilgpu_raytracing_tpu_torch.models.materials import Material
from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder


def build_canyon_scene(tess: int = 4, blas_leaf_size: int = 8, device="cuda"):
    """(builder, scene): floor slot between two tall lambert walls."""
    b = SceneBuilder(blas_leaf_size=blas_leaf_size)
    m_floor = b.add_material(Material(kd=(0.55, 0.52, 0.48)))
    m_left = b.add_material(Material(kd=(0.6, 0.45, 0.35)))
    m_right = b.add_material(Material(kd=(0.45, 0.5, 0.6)))

    verts = []
    tris = []
    mats = []

    def add_quad(p00, p10, p01, mat):
        v, t = _quad_grid(p00, p10, p01, tess)
        base = sum(x.shape[0] for x in verts)
        verts.append(v)
        tris.append(t + base)
        mats.append(np.full((t.shape[0],), mat, np.int32))

    w, h, zl = 1.5, 6.0, 8.0
    # floor strip y=0, x in [-w, w], z in [-zl, zl]
    add_quad((-w, 0, -zl), (w, 0, -zl), (-w, 0, zl), m_floor)
    # left wall x=-w (faces +x), right wall x=+w (faces -x)
    add_quad((-w, 0, -zl), (-w, 0, zl), (-w, h, -zl), m_left)
    add_quad((w, 0, -zl), (w, h, -zl), (w, 0, zl), m_right)

    b.add_mesh_instance(
        np.concatenate(verts).astype(np.float32),
        np.concatenate(tris).astype(np.int32),
        tri_mat=np.concatenate(mats),
    )
    return b, b.commit(device)


def canyon_camera(width: int, height: int) -> Camera:
    """Inside the slot, looking down it with both walls and floor visible."""
    return Camera.look_at(
        origin=np.array([0.0, 1.6, -6.5], np.float32),
        target=np.array([0.0, 1.2, 2.0], np.float32),
        up=np.array([0.0, 1.0, 0.0], np.float32),
        vfov_degrees=70.0,
        aspect=float(width) / float(max(1, height)),
    )
