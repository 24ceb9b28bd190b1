"""Procedurally generated Sponza-class OBJ asset (port of
models/sponza_like.py).

The reference's flagship workload is a multi-material OBJ with MTL
materials, diffuse textures, and alpha-cutout banners loaded through
MeshLoaderOBJ.cs:67-272 + Scene.cs:144-256. No asset ships with this repo,
so this module WRITES an equivalent scene to disk -- a courtyard with a
tile-textured floor, colored columns, walls, and perforated hanging
banners (map_Kd + map_d) -- and loads it back through the REAL parser path
(models/obj_loader.add_obj_instance), exercising mtllib/usemtl dispatch,
texture loading, per-corner UVs, and the alpha-cutout pipeline end to end.

Deterministic: same bytes every run, and the same bytes as the JAX
package's module writes, so golden tests can rely on it. Its textures are
TGA, so loading it needs no PIL.
"""

from __future__ import annotations

import os

import numpy as np

from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.obj_loader import add_obj_instance
from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder


def _write_tga(path: str, rgba: np.ndarray) -> None:
    """Uncompressed 32-bit TGA, bottom-left origin (the common case the
    reference's loader handles, MeshLoaderOBJ.cs texture path)."""
    h, w = rgba.shape[:2]
    hdr = bytearray(18)
    hdr[2] = 2  # uncompressed truecolor
    hdr[12] = w & 0xFF
    hdr[13] = (w >> 8) & 0xFF
    hdr[14] = h & 0xFF
    hdr[15] = (h >> 8) & 0xFF
    hdr[16] = 32
    hdr[17] = 8  # 8 alpha bits, bottom-left origin
    bgra = rgba[::-1, :, [2, 1, 0, 3]]  # bottom-up rows, BGRA order
    with open(path, "wb") as f:
        f.write(bytes(hdr))
        f.write(np.ascontiguousarray(bgra, dtype=np.uint8).tobytes())


def _tile_texture(n: int = 64) -> np.ndarray:
    """Stone-tile diffuse texture (opaque)."""
    y, x = np.mgrid[0:n, 0:n]
    tile = (((x // 16) + (y // 16)) % 2).astype(np.float32)
    mortar = ((x % 16 < 1) | (y % 16 < 1)).astype(np.float32)
    base = 150 + 40 * tile
    rgb = np.stack([base, base - 8, base - 18], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    out = np.concatenate(
        [rgb, np.full((n, n, 1), 255.0)], axis=-1
    ).astype(np.uint8)
    return out


def _banner_holes(n: int = 64):
    y, x = np.mgrid[0:n, 0:n]
    holes = ((x % 16 > 5) & (x % 16 < 11) & (y % 16 > 5) & (y % 16 < 11))
    ragged = y > (n - 6 - ((x * 7) % 5))
    return holes | ragged


def _banner_texture(n: int = 64) -> np.ndarray:
    """Red banner diffuse -- the Sponza-banner lookalike."""
    y, x = np.mgrid[0:n, 0:n]
    rgb = np.stack(
        [
            np.full((n, n), 165.0),
            np.full((n, n), 28.0) + 20 * ((x // 8 + y // 8) % 2),
            np.full((n, n), 32.0),
        ],
        axis=-1,
    )
    return np.concatenate(
        [rgb, np.full((n, n, 1), 255.0)], axis=-1
    ).astype(np.uint8)


def _banner_mask(n: int = 64) -> np.ndarray:
    """Grayscale cutout mask (map_d reads LUMINANCE, matching the
    reference's alpha path): white fabric, black holes/ragged edge."""
    v = np.where(_banner_holes(n), 0, 255).astype(np.uint8)
    rgba = np.stack([v, v, v, np.full_like(v, 255)], axis=-1)
    return rgba


def write_sponza_like_asset(dirpath: str) -> str:
    """Write courtyard.obj/.mtl + textures into dirpath; returns obj path."""
    os.makedirs(dirpath, exist_ok=True)
    _write_tga(os.path.join(dirpath, "tiles.tga"), _tile_texture())
    _write_tga(os.path.join(dirpath, "banner.tga"), _banner_texture())
    _write_tga(os.path.join(dirpath, "banner_mask.tga"), _banner_mask())

    mtl = """# procedural courtyard materials
newmtl floor
Kd 1.0 1.0 1.0
map_Kd tiles.tga

newmtl column
Kd 0.75 0.71 0.62

newmtl wall
Kd 0.62 0.55 0.46

newmtl banner
Kd 1.0 1.0 1.0
map_Kd banner.tga
map_d banner_mask.tga
d 1.0

newmtl trim
Kd 0.30 0.25 0.20
"""
    with open(os.path.join(dirpath, "courtyard.mtl"), "w") as f:
        f.write(mtl)

    v: list[str] = []
    vt: list[str] = []
    faces: dict[str, list[str]] = {
        "floor": [], "column": [], "wall": [], "banner": [], "trim": []
    }
    nv = 0
    nt = 0

    def quad(mat, p0, p1, p2, p3, uvs=None):
        nonlocal nv, nt
        for p in (p0, p1, p2, p3):
            v.append(f"v {p[0]} {p[1]} {p[2]}")
        if uvs is None:
            uvs = [(0, 0), (1, 0), (1, 1), (0, 1)]
        for u in uvs:
            vt.append(f"vt {u[0]} {u[1]}")
        a, b, c, d = nv + 1, nv + 2, nv + 3, nv + 4
        ta, tb, tc, td = nt + 1, nt + 2, nt + 3, nt + 4
        # quad -> triangle fan, with texcoords (MeshLoaderOBJ fan split)
        faces[mat].append(f"f {a}/{ta} {b}/{tb} {c}/{tc} {d}/{td}")
        nv += 4
        nt += 4

    def box(mat, cx, cz, sx, sz, y0, y1):
        x0, x1 = cx - sx, cx + sx
        z0, z1 = cz - sz, cz + sz
        quad(mat, (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
        quad(mat, (x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1))
        quad(mat, (x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1))
        quad(mat, (x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
        quad(mat, (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))

    # floor 12x8, tiled uv
    quad("floor", (-6, 0, -4), (6, 0, -4), (6, 0, 4), (-6, 0, 4),
         uvs=[(0, 0), (6, 0), (6, 4), (0, 4)])
    # back + side walls
    quad("wall", (-6, 0, -4), (6, 0, -4), (6, 3.2, -4), (-6, 3.2, -4))
    quad("wall", (-6, 0, 4), (-6, 0, -4), (-6, 3.2, -4), (-6, 3.2, 4))
    quad("wall", (6, 0, -4), (6, 0, 4), (6, 3.2, 4), (6, 3.2, -4))
    # columns along the back
    for i, cx in enumerate((-4.5, -1.5, 1.5, 4.5)):
        box("column", cx, -3.2, 0.28, 0.28, 0.0, 2.6)
        box("trim", cx, -3.2, 0.38, 0.38, 2.6, 2.8)
    # hanging banners between columns (two-sided by cutout, single quad)
    for cx in (-3.0, 0.0, 3.0):
        quad("banner", (cx - 0.8, 1.0, -3.0), (cx + 0.8, 1.0, -3.0),
             (cx + 0.8, 2.4, -3.0), (cx - 0.8, 2.4, -3.0))

    obj = ["mtllib courtyard.mtl"]
    obj.extend(v)
    obj.extend(vt)
    for mat, fl in faces.items():
        obj.append(f"usemtl {mat}")
        obj.extend(fl)
    with open(os.path.join(dirpath, "courtyard.obj"), "w") as f:
        f.write("\n".join(obj) + "\n")
    return os.path.join(dirpath, "courtyard.obj")


def build_sponza_like_scene(dirpath: str, blas_leaf_size: int = 8,
                            bvh_method: str = "median", device="cuda"):
    """Write the asset and load it back through the production OBJ path."""
    obj_path = write_sponza_like_asset(dirpath)
    b = SceneBuilder(blas_leaf_size=blas_leaf_size, bvh_method=bvh_method)
    add_obj_instance(b, obj_path)
    scene = b.commit(device)
    return b, scene


def sponza_camera(width: int, height: int):
    return Camera.look_at(
        (0.0, 1.7, 3.6), (0.0, 1.3, -3.0), (0.0, 1.0, 0.0),
        62.0, width / float(height),
    )
