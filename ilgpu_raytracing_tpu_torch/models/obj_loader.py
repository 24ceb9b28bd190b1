"""OBJ/MTL/texture loading pipeline, host Python (port of
models/obj_loader.py).

Semantics track the reference loader exactly
(reference MeshLoaderOBJ.cs:67-272):

* `v`/`vt`/`f` with fan triangulation and optional winding flip
  (:124-140); negative (relative) indices (:330-334); `f v/vt/...` forms;
* `usemtl` allocates materials in first-use order; `mtllib` materials merge
  by name (:151-199);
* MTL keys: Kd, map_Kd, map_d (implies TwoSided), d / Tr (< 0.999 =>
  two-sided cutout with cutoff 0.5), Ni (IOR), illum (>=5 glass, >=3
  mirror, else lambert) (:339-440);
* strict no-fallback textures: a missing file clears the material's map
  flags (:212-218, 239-245); texture files dedup by path case-insensitively;
* PNG/JPG decode via PIL to straight (non-premultiplied) RGBA; hand-rolled
  TGA reader (uncompressed + RLE, 8/24/32 bpp, origin flip) (:511-593).
  PIL is imported only when a PNG/JPG is decoded, so a TGA-only asset
  loads where PIL is not installed; a PNG there raises ImportError.

Output is numpy arrays ready for SceneBuilder.add_mesh_instance; triangle
UVs are baked per-corner at load (the committed scene layout bakes them
anyway, see models/scene.py).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from ilgpu_raytracing_tpu_torch.models.materials import (
    SHADING_GLASS,
    SHADING_LAMBERT,
    SHADING_MIRROR,
    Material,
)


@dataclasses.dataclass
class MeshHost:
    positions: np.ndarray  # (V,3) f32, pre-scaled
    triangles: np.ndarray  # (T,3) i32
    tri_uvs: np.ndarray  # (T,3,2) f32 baked per-corner
    tri_material: np.ndarray  # (T,) i32 local material indices
    materials: list[Material]
    textures: list[np.ndarray]  # (H,W,4) uint8 RGBA straight alpha


def _parse_index(tok: str, count_so_far: int) -> int:
    val = int(tok)
    return val - 1 if val > 0 else count_so_far + val


def _load_texture_rgba(path: str) -> np.ndarray | None:
    """Decode PNG/JPG/TGA to (H,W,4) uint8 RGBA; None when missing."""
    if not os.path.exists(path):
        return None
    ext = os.path.splitext(path)[1].lower()
    if ext == ".tga":
        return _load_tga_rgba(path)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGBA"), dtype=np.uint8)


def _load_tga_rgba(path: str) -> np.ndarray:
    """TGA reader: types 2/3 uncompressed + 10 RLE; 8/24/32 bpp; bottom or
    top origin (MeshLoaderOBJ.cs:511-593)."""
    data = np.fromfile(path, dtype=np.uint8)
    id_len = int(data[0])
    cmap_type = int(data[1])
    image_type = int(data[2])
    if cmap_type != 0:
        raise ValueError(f"TGA colorMapType={cmap_type} not supported: {path}")
    w = int(data[12]) | (int(data[13]) << 8)
    h = int(data[14]) | (int(data[15]) << 8)
    depth = int(data[16])
    desc = int(data[17])
    top_origin = (desc & 0x20) != 0
    bpp = {32: 4, 24: 3, 8: 1}.get(depth)
    if bpp is None:
        raise ValueError(f"TGA pixelDepth={depth} not supported: {path}")
    pos = 18 + id_len
    total = w * h
    out = np.empty((total, 4), dtype=np.uint8)

    def expand(px: np.ndarray) -> np.ndarray:
        """bpp-sized BGR(A)/gray pixels -> RGBA rows."""
        n = px.shape[0]
        rgba = np.empty((n, 4), dtype=np.uint8)
        if bpp == 4:
            rgba[:, 0] = px[:, 2]
            rgba[:, 1] = px[:, 1]
            rgba[:, 2] = px[:, 0]
            rgba[:, 3] = px[:, 3]
        elif bpp == 3:
            rgba[:, 0] = px[:, 2]
            rgba[:, 1] = px[:, 1]
            rgba[:, 2] = px[:, 0]
            rgba[:, 3] = 255
        else:
            rgba[:, 0] = rgba[:, 1] = rgba[:, 2] = px[:, 0]
            rgba[:, 3] = 255
        return rgba

    if image_type in (2, 3):
        px = data[pos : pos + total * bpp].reshape(total, bpp)
        out[:] = expand(px)
    elif image_type == 10:
        i = 0
        while i < total:
            packet = int(data[pos])
            pos += 1
            count = (packet & 0x7F) + 1
            count = min(count, total - i)
            if packet & 0x80:  # run
                out[i : i + count] = expand(data[pos : pos + bpp].reshape(1, bpp))
                pos += bpp
            else:  # raw
                out[i : i + count] = expand(
                    data[pos : pos + count * bpp].reshape(count, bpp)
                )
                pos += count * bpp
            i += count
    else:
        raise ValueError(f"TGA imageType={image_type} not supported: {path}")

    img = out.reshape(h, w, 4)
    if not top_origin:
        img = img[::-1]
    return np.ascontiguousarray(img)


def _load_mtl(mtl_path: str, base_dir: str):
    """Returns (materials_by_name, diffuse_paths, alpha_paths)."""
    mats: dict[str, Material] = {}
    diffuse: dict[str, str] = {}
    alpha: dict[str, str] = {}
    cur: str | None = None
    m = Material(kd=(0.8, 0.8, 0.8))

    def flush():
        if cur is not None:
            mats[cur] = m

    with open(mtl_path, "r", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("newmtl "):
                flush()
                cur = line[7:].strip()
                m = Material(kd=(0.8, 0.8, 0.8))
            elif line.startswith("Kd "):
                r, g, b = (float(x) for x in line[3:].split()[:3])
                m = dataclasses.replace(m, kd=(r, g, b))
            elif line.startswith("map_Kd "):
                raw = line[7:].strip()
                if cur is not None:
                    diffuse[cur] = os.path.join(base_dir, raw)
            elif line.startswith("map_d "):
                raw = line[6:].strip()
                if cur is not None:
                    alpha[cur] = os.path.join(base_dir, raw)
                m = dataclasses.replace(m, two_sided=True)
            elif line.startswith("d "):
                d = float(line[2:].split()[0])
                if d < 0.999:
                    m = dataclasses.replace(m, two_sided=True, alpha_cutoff=0.5)
            elif line.startswith("Tr "):
                d = 1.0 - float(line[3:].split()[0])
                if d < 0.999:
                    m = dataclasses.replace(m, two_sided=True, alpha_cutoff=0.5)
            elif line.startswith("Ni "):
                ior = float(line[3:].split()[0])
                m = dataclasses.replace(m, ior=ior if ior > 0 else 1.0)
            elif line.startswith("illum "):
                model = int(float(line[6:].split()[0]))
                shading = (
                    SHADING_GLASS
                    if model >= 5
                    else SHADING_MIRROR if model >= 3 else SHADING_LAMBERT
                )
                m = dataclasses.replace(m, shading=shading)
    flush()
    return mats, diffuse, alpha


def load_obj(path: str, scale: float = 1.0, flip_winding: bool = False,
             verbose: bool = False) -> MeshHost:
    base_dir = os.path.dirname(os.path.abspath(path))
    log = print if verbose else (lambda *a, **k: None)
    log(f"[OBJ] loading '{path}' scale={scale} flip_winding={flip_winding}")

    positions: list[tuple[float, float, float]] = []
    texcoords: list[tuple[float, float]] = []
    tris: list[tuple[int, int, int]] = []
    tri_uv_idx: list[tuple[int, int, int]] = []
    tri_mat: list[int] = []
    mtl_lib: str | None = None
    cur_mtl = -1
    mtl_name_to_index: dict[str, int] = {}
    materials: list[Material] = []

    with open(path, "r", errors="replace") as f:
        for line in f:
            if not line or line[0] == "#":
                continue
            if line.startswith("v "):
                p = line[2:].split()
                positions.append(
                    (float(p[0]) * scale, float(p[1]) * scale, float(p[2]) * scale)
                )
            elif line.startswith("vt "):
                p = line[3:].split()
                texcoords.append((float(p[0]), float(p[1])))
            elif line.startswith("f "):
                fv: list[int] = []
                ft: list[int] = []
                for tok in line[2:].split():
                    parts = tok.split("/")
                    fv.append(_parse_index(parts[0], len(positions)))
                    t = 0
                    if len(parts) > 1 and parts[1]:
                        t = _parse_index(parts[1], len(texcoords))
                    ft.append(t)
                if len(fv) >= 3:
                    for k in range(1, len(fv) - 1):
                        if not flip_winding:
                            tris.append((fv[0], fv[k], fv[k + 1]))
                            tri_uv_idx.append((ft[0], ft[k], ft[k + 1]))
                        else:
                            tris.append((fv[0], fv[k + 1], fv[k]))
                            tri_uv_idx.append((ft[0], ft[k + 1], ft[k]))
                        tri_mat.append(max(0, cur_mtl))
            elif line.startswith("mtllib "):
                rel = line[7:].strip()
                if rel:
                    mtl_lib = os.path.join(base_dir, rel)
            elif line.startswith("usemtl "):
                name = line[7:].strip()
                if name:
                    if name not in mtl_name_to_index:
                        mtl_name_to_index[name] = len(materials)
                        materials.append(Material(kd=(0.8, 0.8, 0.8)))
                    cur_mtl = mtl_name_to_index[name]

    log(
        f"[OBJ] parsed vertices={len(positions)} texcoords={len(texcoords)} "
        f"tris={len(tris)} materials={len(materials)}"
    )

    # merge MTL definitions by name
    diffuse_paths: dict[int, str] = {}
    alpha_paths: dict[int, str] = {}
    if mtl_lib and os.path.exists(mtl_lib):
        mtl_mats, dmap, amap = _load_mtl(mtl_lib, base_dir)
        for name, mat in mtl_mats.items():
            if name not in mtl_name_to_index:
                mtl_name_to_index[name] = len(materials)
                materials.append(mat)
            else:
                materials[mtl_name_to_index[name]] = mat
        for name, p in dmap.items():
            if name in mtl_name_to_index:
                diffuse_paths[mtl_name_to_index[name]] = p
        for name, p in amap.items():
            if name in mtl_name_to_index:
                alpha_paths[mtl_name_to_index[name]] = p

    if not materials:
        materials = [Material(kd=(0.8, 0.8, 0.8))]

    # decode textures with path dedup; missing files clear the map flags
    textures: list[np.ndarray] = []
    tex_index_by_path: dict[str, int] = {}

    def resolve(p: str) -> int:
        key = os.path.normcase(p)
        if key in tex_index_by_path:
            return tex_index_by_path[key]
        img = _load_texture_rgba(p)
        if img is None:
            log(f"[TEX] MISSING '{p}' -- skipping")
            tex_index_by_path[key] = -1
            return -1
        tex_index_by_path[key] = len(textures)
        textures.append(img)
        log(f"[TEX] '{p}' -> idx {tex_index_by_path[key]} [{img.shape[1]}x{img.shape[0]}]")
        return tex_index_by_path[key]

    for mi, p in diffuse_paths.items():
        ti = resolve(p)
        materials[mi] = dataclasses.replace(materials[mi], diffuse_tex=ti)
    for mi, p in alpha_paths.items():
        ti = resolve(p)
        materials[mi] = dataclasses.replace(
            materials[mi],
            alpha_tex=ti,
            two_sided=materials[mi].two_sided or (ti >= 0),
        )

    pos = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
    tri = np.asarray(tris, dtype=np.int32).reshape(-1, 3)
    if texcoords:
        tc = np.asarray(texcoords, dtype=np.float32)
    else:
        tc = np.zeros((1, 2), dtype=np.float32)
    uvi = np.asarray(tri_uv_idx, dtype=np.int32).reshape(-1, 3)
    uvi = np.clip(uvi, 0, tc.shape[0] - 1)
    tri_uvs = tc[uvi]  # (T,3,2) baked
    return MeshHost(
        positions=pos,
        triangles=tri,
        tri_uvs=tri_uvs,
        tri_material=np.asarray(tri_mat, dtype=np.int32),
        materials=materials,
        textures=textures,
    )


def add_obj_instance(builder, path: str, object_to_world=None,
                     scale: float = 1.0, flip_winding: bool = False,
                     verbose: bool = False) -> int:
    """Load an OBJ and append it to a SceneBuilder as one instance,
    remapping materials/textures into the global pools
    (Scene.cs LoadObjInstance:144-256)."""
    mesh = load_obj(path, scale, flip_winding, verbose)
    tex_remap: dict[int, int] = {}
    mat_remap: list[int] = []
    for m in mesh.materials:
        dt = m.diffuse_tex
        at = m.alpha_tex
        if dt >= 0:
            if dt not in tex_remap:
                tex_remap[dt] = builder.add_texture_rgba(mesh.textures[dt])
            dt = tex_remap[dt]
        if at >= 0:
            if at not in tex_remap:
                tex_remap[at] = builder.add_texture_rgba(mesh.textures[at])
            at = tex_remap[at]
        mat_remap.append(
            builder.add_material(
                dataclasses.replace(m, diffuse_tex=dt, alpha_tex=at)
            )
        )
    tri_mat_global = np.asarray(
        [mat_remap[i] for i in mesh.tri_material], dtype=np.int32
    )
    return builder.add_mesh_instance(
        mesh.positions,
        mesh.triangles,
        tri_uvs=mesh.tri_uvs,
        tri_mat=tri_mat_global,
        object_to_world=object_to_world,
    )
