"""A textured, alpha-cutout scene for the CPU tests of the benchmark's OBJ
door and of the reference's texture and mask code: a tile-textured floor,
three walls, four columns with trims, and three hanging banners with a
diffuse map and an alpha-cutout mask (`map_d`), 94 triangles of five
materials and three 64x64 RGBA textures. A frozen copy of the repository's
procedural OBJ asset (`write_sponza_like_asset`): the same quads, textures
and MTL, so the files are the same bytes. It is a test fixture and no
configuration: it stands for no published scene.

Everything comes from one list of quads. `build(params)` (no parameters)
returns the scene spec: `materials` (with `diffuse_tex`, `alpha_tex` and
`alpha_cutoff`; `map_d` makes a material two-sided, as the MTL rules do),
`textures` (RGBA uint8 arrays, in the order the OBJ loader pools them),
`mesh` (`positions`, `tris`, `tri_mat`, and `tri_uv` (T, 3, 2)), no spheres,
no vertex groups, and `obj_files`: each file name with its bytes, the
asset as the program loads it. Triangles follow the OBJ's face order
(faces grouped by material in first-use order), each quad fan-split into
(a, b, c) and (a, c, d), so a triangle id here is the program's.
"""

from __future__ import annotations

import numpy as np

TEX = 64
# (name, kd, diffuse map, alpha map), in the order `usemtl` first uses them;
# a map is an index into TEXTURES
MATERIALS = (
    ("floor", (1.0, 1.0, 1.0), 0, -1),
    ("column", (0.75, 0.71, 0.62), -1, -1),
    ("wall", (0.62, 0.55, 0.46), -1, -1),
    ("banner", (1.0, 1.0, 1.0), 1, 2),
    ("trim", (0.30, 0.25, 0.20), -1, -1),
)
MTL = """# procedural courtyard materials
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
ALPHA_CUTOFF = 0.5  # the loader's default; `d 1.0` leaves it


def _tile_texture(n: int = TEX) -> np.ndarray:
    """Stone tiles with mortar lines, opaque."""
    y, x = np.mgrid[0:n, 0:n]
    tile = (((x // 16) + (y // 16)) % 2).astype(np.float32)
    mortar = ((x % 16 < 1) | (y % 16 < 1)).astype(np.float32)
    base = 150 + 40 * tile
    rgb = np.stack([base, base - 8, base - 18], axis=-1)
    rgb = rgb * (1.0 - 0.45 * mortar[..., None])
    return np.concatenate([rgb, np.full((n, n, 1), 255.0)], axis=-1).astype(np.uint8)


def _banner_texture(n: int = TEX) -> np.ndarray:
    """Red banner cloth with a faint 8-texel check."""
    y, x = np.mgrid[0:n, 0:n]
    rgb = np.stack([np.full((n, n), 165.0),
                    np.full((n, n), 28.0) + 20 * ((x // 8 + y // 8) % 2),
                    np.full((n, n), 32.0)], axis=-1)
    return np.concatenate([rgb, np.full((n, n, 1), 255.0)], axis=-1).astype(np.uint8)


def _banner_mask(n: int = TEX) -> np.ndarray:
    """Grey cutout mask, read as luminance: white cloth, black square holes
    and a ragged lower edge."""
    y, x = np.mgrid[0:n, 0:n]
    holes = (x % 16 > 5) & (x % 16 < 11) & (y % 16 > 5) & (y % 16 < 11)
    ragged = y > (n - 6 - ((x * 7) % 5))
    v = np.where(holes | ragged, 0, 255).astype(np.uint8)
    return np.stack([v, v, v, np.full_like(v, 255)], axis=-1)


TEXTURES = (("tiles.tga", _tile_texture), ("banner.tga", _banner_texture),
            ("banner_mask.tga", _banner_mask))


def _tga(rgba: np.ndarray) -> bytes:
    """Uncompressed 32-bit TGA, bottom-left origin, BGRA rows bottom-up."""
    h, w = rgba.shape[:2]
    hdr = bytearray(18)
    hdr[2] = 2
    hdr[12], hdr[13], hdr[14], hdr[15] = w & 0xFF, (w >> 8) & 0xFF, h & 0xFF, (h >> 8) & 0xFF
    hdr[16], hdr[17] = 32, 8
    return bytes(hdr) + np.ascontiguousarray(rgba[::-1, :, [2, 1, 0, 3]], np.uint8).tobytes()


def quads() -> list[tuple]:
    """(material, four corners, four UVs) of every quad, in the order the
    asset writes their vertices."""
    out = []

    def quad(mat, p0, p1, p2, p3, uvs=((0, 0), (1, 0), (1, 1), (0, 1))):
        out.append((mat, (p0, p1, p2, p3), tuple(uvs)))

    def box(mat, cx, cz, sx, sz, y0, y1):
        x0, x1 = cx - sx, cx + sx
        z0, z1 = cz - sz, cz + sz
        quad(mat, (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0))
        quad(mat, (x1, y0, z1), (x0, y0, z1), (x0, y1, z1), (x1, y1, z1))
        quad(mat, (x0, y0, z1), (x0, y0, z0), (x0, y1, z0), (x0, y1, z1))
        quad(mat, (x1, y0, z0), (x1, y0, z1), (x1, y1, z1), (x1, y1, z0))
        quad(mat, (x0, y1, z0), (x1, y1, z0), (x1, y1, z1), (x0, y1, z1))

    quad("floor", (-6, 0, -4), (6, 0, -4), (6, 0, 4), (-6, 0, 4),
         uvs=((0, 0), (6, 0), (6, 4), (0, 4)))
    quad("wall", (-6, 0, -4), (6, 0, -4), (6, 3.2, -4), (-6, 3.2, -4))
    quad("wall", (-6, 0, 4), (-6, 0, -4), (-6, 3.2, -4), (-6, 3.2, 4))
    quad("wall", (6, 0, -4), (6, 0, 4), (6, 3.2, 4), (6, 3.2, -4))
    for cx in (-4.5, -1.5, 1.5, 4.5):
        box("column", cx, -3.2, 0.28, 0.28, 0.0, 2.6)
        box("trim", cx, -3.2, 0.38, 0.38, 2.6, 2.8)
    for cx in (-3.0, 0.0, 3.0):
        quad("banner", (cx - 0.8, 1.0, -3.0), (cx + 0.8, 1.0, -3.0),
             (cx + 0.8, 2.4, -3.0), (cx - 0.8, 2.4, -3.0))
    return out


def _faces(qs) -> list[tuple[str, int]]:
    """(material, quad index) in the OBJ's face order: grouped by material
    in MATERIALS order, each group in quad order."""
    return [(name, i) for name, *_ in MATERIALS for i, q in enumerate(qs) if q[0] == name]


def obj_text(qs) -> str:
    lines = ["mtllib courtyard.mtl"]
    lines += [f"v {p[0]} {p[1]} {p[2]}" for q in qs for p in q[1]]
    lines += [f"vt {u[0]} {u[1]}" for q in qs for u in q[2]]
    group = None
    for name, i in _faces(qs):
        if name != group:
            lines.append(f"usemtl {name}")
            group = name
        a = 4 * i + 1
        lines.append(f"f {a}/{a} {a + 1}/{a + 1} {a + 2}/{a + 2} {a + 3}/{a + 3}")
    return "\n".join(lines) + "\n"


def build(params: dict) -> dict:
    qs = quads()
    textures = [make() for _, make in TEXTURES]
    files = {"courtyard.obj": obj_text(qs).encode(), "courtyard.mtl": MTL.encode()}
    files.update({name: _tga(t) for (name, _), t in zip(TEXTURES, textures)})
    materials = [dict(kd=kd, two_sided=int(alpha >= 0), shading=0, ior=1.0, diffuse_tex=dtex,
                      alpha_tex=alpha, alpha_cutoff=ALPHA_CUTOFF)
                 for _, kd, dtex, alpha in MATERIALS]
    mat_id = {m[0]: k for k, m in enumerate(MATERIALS)}
    positions = np.array([p for q in qs for p in q[1]], np.float64).astype(np.float32)
    uv = np.array([u for q in qs for u in q[2]], np.float64).astype(np.float32)
    tris, tri_mat = [], []
    for name, i in _faces(qs):
        a, b, c, d = 4 * i, 4 * i + 1, 4 * i + 2, 4 * i + 3
        tris += [(a, b, c), (a, c, d)]
        tri_mat += [mat_id[name]] * 2
    tris = np.array(tris, np.int32)
    return dict(materials=materials, textures=textures,
                mesh=dict(positions=positions, tris=tris,
                          tri_mat=np.array(tri_mat, np.int32), tri_uv=uv[tris]),
                spheres=[], groups={}, obj_files=files)
