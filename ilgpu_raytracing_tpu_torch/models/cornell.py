"""Procedural triangle-mesh scenes: Cornell box + tessellated primitives.

The reference's only mesh source is OBJ loading (Sponza,
Scene.cs:654-674); a procedural Cornell box (BASELINE config 3) gives the
test/bench suite a triangle scene with no asset dependency, and the
tessellation knob scales triangle counts up to the ~1M-tri bench config.
"""

from __future__ import annotations

import numpy as np

from ilgpu_raytracing_tpu_torch.models.materials import Material
from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder


def _quad_grid(p00, p10, p01, tess: int):
    """Tessellated parallelogram: corner p00, edges to p10 and p01.
    Returns (verts (n,3), tris (m,3))."""
    p00 = np.asarray(p00, np.float32)
    eu = np.asarray(p10, np.float32) - p00
    ev = np.asarray(p01, np.float32) - p00
    t = tess
    us, vs = np.meshgrid(
        np.linspace(0, 1, t + 1, dtype=np.float32),
        np.linspace(0, 1, t + 1, dtype=np.float32),
        indexing="ij",
    )
    verts = p00[None, :] + us.reshape(-1, 1) * eu[None, :] + vs.reshape(-1, 1) * ev[None, :]
    idx = np.arange((t + 1) * (t + 1)).reshape(t + 1, t + 1)
    a = idx[:-1, :-1].reshape(-1)
    b = idx[1:, :-1].reshape(-1)
    c = idx[:-1, 1:].reshape(-1)
    d = idx[1:, 1:].reshape(-1)
    tris = np.concatenate(
        [np.stack([a, b, d], -1), np.stack([a, d, c], -1)]
    ).astype(np.int32)
    return verts.astype(np.float32), tris


def _uv_sphere(center, radius, n_theta: int, n_phi: int):
    """Tessellated UV sphere. Returns (verts, tris)."""
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)[:-1]
    T, PH = np.meshgrid(th, ph, indexing="ij")
    x = np.sin(T) * np.cos(PH)
    y = np.cos(T)
    z = np.sin(T) * np.sin(PH)
    verts = (
        np.stack([x, y, z], -1).reshape(-1, 3) * radius
        + np.asarray(center, np.float32)
    ).astype(np.float32)
    idx = np.arange((n_theta + 1) * n_phi).reshape(n_theta + 1, n_phi)
    tris = []
    for i in range(n_theta):
        a = idx[i]
        b = idx[i + 1]
        a2 = np.roll(a, -1)
        b2 = np.roll(b, -1)
        tris.append(np.stack([a, b, b2], -1))
        tris.append(np.stack([a, b2, a2], -1))
    return verts, np.concatenate(tris).astype(np.int32)


def build_cornell_scene(
    tess: int = 8,
    sphere_tess: tuple[int, int] = (16, 24),
    blas_leaf_size: int = 4,
    bvh_method: str = "median",
    device="cuda",
):
    """Cornell box (open front, +z toward the viewer) with two interior
    blocks and one tessellated sphere -- all triangles, one mesh instance.

    Returns (builder, scene). Triangle count ~ 12*tess^2 + sphere tris.
    """
    b = SceneBuilder(blas_leaf_size=blas_leaf_size, bvh_method=bvh_method)
    # two-sided: procedural winding varies per face; the standard two-sided
    # normal flip (SceneDeviceViews.cs:222) orients shading normals toward
    # the viewer everywhere
    m_white = b.add_material(Material(kd=(0.73, 0.73, 0.73), two_sided=True))
    m_red = b.add_material(Material(kd=(0.65, 0.05, 0.05), two_sided=True))
    m_green = b.add_material(Material(kd=(0.12, 0.45, 0.15), two_sided=True))

    all_v: list[np.ndarray] = []
    all_t: list[np.ndarray] = []
    all_m: list[np.ndarray] = []

    def add_quad(p00, p10, p01, mat, t=tess):
        v, tr = _quad_grid(p00, p10, p01, t)
        base = sum(x.shape[0] for x in all_v)
        all_v.append(v)
        all_t.append(tr + base)
        all_m.append(np.full((tr.shape[0],), mat, np.int32))

    s = 1.0  # half size; box spans [-1,1]^2, z in [-1,1]
    add_quad((-s, -s, -s), (s, -s, -s), (-s, -s, s), m_white)  # floor
    add_quad((-s, s, -s), (-s, s, s), (s, s, -s), m_white)  # ceiling
    add_quad((-s, -s, -s), (-s, s, -s), (s, -s, -s), m_white)  # back (z=-1)
    add_quad((-s, -s, -s), (-s, -s, s), (-s, s, -s), m_red)  # left
    add_quad((s, -s, -s), (s, s, -s), (s, -s, s), m_green)  # right

    # two boxes (axis-aligned, 5 faces each -- bottom face omitted)
    def add_box(cmin, cmax, mat, t):
        x0, y0, z0 = cmin
        x1, y1, z1 = cmax
        add_quad((x0, y1, z0), (x1, y1, z0), (x0, y1, z1), mat, t)  # top
        add_quad((x0, y0, z1), (x1, y0, z1), (x0, y1, z1), mat, t)  # front
        add_quad((x0, y0, z0), (x0, y1, z0), (x1, y0, z0), mat, t)  # back
        add_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z0), mat, t)  # left
        add_quad((x1, y0, z0), (x1, y1, z0), (x1, y0, z1), mat, t)  # right

    add_box((-0.65, -1.0, -0.6), (-0.15, 0.2, -0.1), m_white, max(2, tess // 2))
    add_box((0.15, -1.0, -0.35), (0.65, -0.4, 0.15), m_white, max(2, tess // 2))

    sv, st = _uv_sphere((0.4, -0.15, -0.1), 0.25, *sphere_tess)
    base = sum(x.shape[0] for x in all_v)
    all_v.append(sv)
    all_t.append(st + base)
    all_m.append(np.full((st.shape[0],), m_white, np.int32))

    verts = np.concatenate(all_v)
    tris = np.concatenate(all_t)
    mats = np.concatenate(all_m)
    b.add_mesh_instance(verts, tris, tri_mat=mats)
    return b, b.commit(device)


def cornell_camera(width: int, height: int):
    from ilgpu_raytracing_tpu_torch.models.camera import Camera

    return Camera.look_at(
        (0.0, 0.0, 3.4), (0.0, 0.0, 0.0), (0, 1, 0), 40.0,
        float(width) / float(max(1, height)),
    )
