"""The Cornell box as the renderer's bench builds it: an open-front box
(white floor, ceiling and back wall, red left and green right wall), two
white blocks and a tessellated white sphere, all triangles of one mesh,
every material two-sided. A frozen copy of the repository's procedural
generator, so the scene cannot change under the benchmark.

Parameters: `tess` (wall grid), `sphere_tess` ([n_theta, n_phi]). The
vertex group `sphere` is the sphere's (n_theta + 1) * n_phi grid vertices,
the last of the mesh.
"""

from __future__ import annotations

import numpy as np


def _quad_grid(p00, p10, p01, tess: int):
    p00 = np.asarray(p00, np.float32)
    eu = np.asarray(p10, np.float32) - p00
    ev = np.asarray(p01, np.float32) - p00
    us, vs = np.meshgrid(np.linspace(0, 1, tess + 1, dtype=np.float32),
                         np.linspace(0, 1, tess + 1, dtype=np.float32), indexing="ij")
    verts = p00[None, :] + us.reshape(-1, 1) * eu[None, :] + vs.reshape(-1, 1) * ev[None, :]
    idx = np.arange((tess + 1) * (tess + 1)).reshape(tess + 1, tess + 1)
    a, b = idx[:-1, :-1].reshape(-1), idx[1:, :-1].reshape(-1)
    c, d = idx[:-1, 1:].reshape(-1), idx[1:, 1:].reshape(-1)
    tris = np.concatenate([np.stack([a, b, d], -1), np.stack([a, d, c], -1)]).astype(np.int32)
    return verts.astype(np.float32), tris


def _uv_sphere(center, radius, n_theta: int, n_phi: int):
    th = np.linspace(0, np.pi, n_theta + 1)
    ph = np.linspace(0, 2 * np.pi, n_phi + 1)[:-1]
    T, PH = np.meshgrid(th, ph, indexing="ij")
    xyz = np.stack([np.sin(T) * np.cos(PH), np.cos(T), np.sin(T) * np.sin(PH)], -1)
    verts = (xyz.reshape(-1, 3) * radius + np.asarray(center, np.float32)).astype(np.float32)
    idx = np.arange((n_theta + 1) * n_phi).reshape(n_theta + 1, n_phi)
    tris = []
    for i in range(n_theta):
        a, b = idx[i], idx[i + 1]
        a2, b2 = np.roll(a, -1), np.roll(b, -1)
        tris.append(np.stack([a, b, b2], -1))
        tris.append(np.stack([a, b2, a2], -1))
    return verts, np.concatenate(tris).astype(np.int32)


def build(params: dict) -> dict:
    tess = int(params["tess"])
    n_theta, n_phi = (int(x) for x in params["sphere_tess"])
    mat = lambda kd: dict(kd=kd, two_sided=1, shading=0, ior=1.0)
    materials = [mat((0.73, 0.73, 0.73)), mat((0.65, 0.05, 0.05)), mat((0.12, 0.45, 0.15))]
    white, red, green = 0, 1, 2
    all_v, all_t, all_m = [], [], []

    def add_quad(p00, p10, p01, m, t=tess):
        v, tr = _quad_grid(p00, p10, p01, t)
        base = sum(x.shape[0] for x in all_v)
        all_v.append(v)
        all_t.append(tr + base)
        all_m.append(np.full((tr.shape[0],), m, np.int32))

    s = 1.0
    add_quad((-s, -s, -s), (s, -s, -s), (-s, -s, s), white)  # floor
    add_quad((-s, s, -s), (-s, s, s), (s, s, -s), white)  # ceiling
    add_quad((-s, -s, -s), (-s, s, -s), (s, -s, -s), white)  # back
    add_quad((-s, -s, -s), (-s, -s, s), (-s, s, -s), red)  # left
    add_quad((s, -s, -s), (s, s, -s), (s, -s, s), green)  # right

    def add_box(cmin, cmax, t):
        x0, y0, z0 = cmin
        x1, y1, z1 = cmax
        add_quad((x0, y1, z0), (x1, y1, z0), (x0, y1, z1), white, t)
        add_quad((x0, y0, z1), (x1, y0, z1), (x0, y1, z1), white, t)
        add_quad((x0, y0, z0), (x0, y1, z0), (x1, y0, z0), white, t)
        add_quad((x0, y0, z0), (x0, y0, z1), (x0, y1, z0), white, t)
        add_quad((x1, y0, z0), (x1, y1, z0), (x1, y0, z1), white, t)

    add_box((-0.65, -1.0, -0.6), (-0.15, 0.2, -0.1), max(2, tess // 2))
    add_box((0.15, -1.0, -0.35), (0.65, -0.4, 0.15), max(2, tess // 2))
    sv, st = _uv_sphere((0.4, -0.15, -0.1), 0.25, n_theta, n_phi)
    first = sum(x.shape[0] for x in all_v)
    all_v.append(sv)
    all_t.append(st + first)
    all_m.append(np.full((st.shape[0],), white, np.int32))
    positions = np.concatenate(all_v)
    return dict(materials=materials,
                mesh=dict(positions=positions, tris=np.concatenate(all_t),
                          tri_mat=np.concatenate(all_m)),
                spheres=[], groups={"sphere": (first, sv.shape[0])})
