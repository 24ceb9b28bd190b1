"""Scene construction (host, numpy) and the committed device scene
(port of models/scene.py).

`SceneBuilder` assembles primitives, materials and per-instance BLAS on the
host; `commit(device)` produces a `SceneData`; `refit_mesh_instance` moves
one mesh instance's vertices and refits its BLAS and the TLAS into a new
`SceneData`. `SceneData` is a plain dataclass of tensors
with the same fields and layout as the JAX package's pytree: baked
`(v0, e1, e2)` triangle rows, instances split by BLAS type, packed
`(left, first, count, skip)` node fields, 0xAARRGGBB texels (uint32 values
held in int64). `scene_from_numpy` builds the same dataclass from numpy
tables, so a test can feed one scene to both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.models import bvh as bvh_mod
from ilgpu_raytracing_tpu_torch.models.materials import (
    SHADING_GLASS,
    SHADING_LAMBERT,
    SHADING_MIRROR,
    Material,
    materials_to_soa,
)
from ilgpu_raytracing_tpu_torch.utils import telemetry

BLAS_SPHERE_SET = 1
BLAS_TRI_MESH = 2


def identity_affine() -> np.ndarray:
    """Row-major 3x4 affine identity (Affine3x4.cs:3-15)."""
    return np.array(
        [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 0]], dtype=np.float32
    )


def translation_affine(t) -> np.ndarray:
    m = identity_affine()
    m[:, 3] = np.asarray(t, dtype=np.float32)
    return m


def scale_affine(s: float, t=(0, 0, 0)) -> np.ndarray:
    m = identity_affine() * np.float32(s)
    m[:, 3] = np.asarray(t, dtype=np.float32)
    return m


def invert_rigid_or_uniform(m: np.ndarray):
    """Invert a rigid + uniform-scale 3x4 affine; returns (inv, scale)
    (Scene.cs:616-638: scale = mean of column norms)."""
    cols = [m[:, 0], m[:, 1], m[:, 2]]
    s = float(sum(np.linalg.norm(c) for c in cols)) / 3.0
    inv_s = 1.0 / s if s > 0 else 1.0
    r = np.stack([c / max(1e-30, np.linalg.norm(c)) for c in cols], axis=1)
    inv = np.zeros((3, 4), dtype=np.float32)
    inv[:, :3] = r.T * inv_s
    inv[:, 3] = -(inv[:, :3] @ m[:, 3])
    return inv.astype(np.float32), np.float32(s)


def transform_aabb(m: np.ndarray, bmin: np.ndarray, bmax: np.ndarray):
    """World AABB of a transformed AABB via its 8 corners (Scene.cs:560-580)."""
    corners = np.array(
        [
            [bmin[0], bmin[1], bmin[2]],
            [bmax[0], bmin[1], bmin[2]],
            [bmin[0], bmax[1], bmin[2]],
            [bmin[0], bmin[1], bmax[2]],
            [bmax[0], bmax[1], bmin[2]],
            [bmin[0], bmax[1], bmax[2]],
            [bmax[0], bmin[1], bmax[2]],
            [bmax[0], bmax[1], bmax[2]],
        ],
        dtype=np.float32,
    )
    w = corners @ m[:, :3].T + m[:, 3]
    return w.min(axis=0), w.max(axis=0)


# field name -> dtype of its tensor (uint32 texels ride in int64)
_FIELDS = {
    "tlas_bmin": torch.float32, "tlas_bmax": torch.float32,
    "tlas_ifields": torch.int32, "tlas_instance_indices": torch.int32,
    "inst_o2w": torch.float32, "inst_w2o": torch.float32,
    "inst_scale": torch.float32, "inst_bmin": torch.float32,
    "inst_bmax": torch.float32, "inst_blas_root": torch.int32,
    "inst_prim_first": torch.int32, "inst_prim_count": torch.int32,
    "sph_instances": torch.int32, "tri_instances": torch.int32,
    "blas_bmin": torch.float32, "blas_bmax": torch.float32,
    "blas_ifields": torch.int32,
    "sphere_prim_idx": torch.int32, "sph_center": torch.float32,
    "sph_radius": torch.float32, "sph_albedo": torch.float32,
    "sph_shading": torch.int32, "sph_ior": torch.float32,
    "sph_mat": torch.int32,
    "tri_prim_idx": torch.int32, "tri_v0": torch.float32,
    "tri_e1": torch.float32, "tri_e2": torch.float32,
    "tri_uv0": torch.float32, "tri_uv1": torch.float32,
    "tri_uv2": torch.float32, "tri_mat": torch.int32,
    "mat_kd": torch.float32, "mat_diffuse_tex": torch.int32,
    "mat_alpha_tex": torch.int32, "mat_alpha_cutoff": torch.float32,
    "mat_two_sided": torch.int32, "mat_shading": torch.int32,
    "mat_ior": torch.float32,
    "texels": torch.int64, "tex_offset": torch.int32,
    "tex_width": torch.int32, "tex_height": torch.int32,
}


@dataclasses.dataclass
class SceneData:
    """Committed device scene: flat SoA tensors on one device."""

    # --- TLAS (skip-index, over instance world AABBs) ---
    tlas_bmin: torch.Tensor  # (Nt,3) f32
    tlas_bmax: torch.Tensor  # (Nt,3)
    tlas_ifields: torch.Tensor  # (Nt,4) i32: left,first,count,skip
    tlas_instance_indices: torch.Tensor  # (Ni,) i32
    # --- instances (combined storage; type split below) ---
    inst_o2w: torch.Tensor  # (I,3,4) f32
    inst_w2o: torch.Tensor  # (I,3,4)
    inst_scale: torch.Tensor  # (I,)
    inst_bmin: torch.Tensor  # (I,3) world bounds
    inst_bmax: torch.Tensor  # (I,3)
    inst_blas_root: torch.Tensor  # (I,) i32 absolute node index
    inst_prim_first: torch.Tensor  # (I,) i32
    inst_prim_count: torch.Tensor  # (I,) i32
    sph_instances: torch.Tensor  # (Is,) i32
    tri_instances: torch.Tensor  # (It,) i32
    # --- BLAS nodes (all instances concatenated, absolute indices) ---
    blas_bmin: torch.Tensor  # (Nb,3)
    blas_bmax: torch.Tensor  # (Nb,3)
    blas_ifields: torch.Tensor  # (Nb,4) i32
    # --- sphere primitives ---
    sphere_prim_idx: torch.Tensor  # (Ps,) i32 leaf indirection -> sphere id
    sph_center: torch.Tensor  # (S,3)
    sph_radius: torch.Tensor  # (S,)
    sph_albedo: torch.Tensor  # (S,3)
    sph_shading: torch.Tensor  # (S,) i32
    sph_ior: torch.Tensor  # (S,)
    sph_mat: torch.Tensor  # (S,) i32
    # --- triangle primitives (baked) ---
    tri_prim_idx: torch.Tensor  # (Pt,) i32 leaf indirection -> global tri id
    tri_v0: torch.Tensor  # (T,3)
    tri_e1: torch.Tensor  # (T,3)
    tri_e2: torch.Tensor  # (T,3)
    tri_uv0: torch.Tensor  # (T,2)
    tri_uv1: torch.Tensor  # (T,2)
    tri_uv2: torch.Tensor  # (T,2)
    tri_mat: torch.Tensor  # (T,) i32
    # --- materials SoA ---
    mat_kd: torch.Tensor  # (M,3)
    mat_diffuse_tex: torch.Tensor  # (M,) i32, -1 = none
    mat_alpha_tex: torch.Tensor  # (M,) i32
    mat_alpha_cutoff: torch.Tensor  # (M,)
    mat_two_sided: torch.Tensor  # (M,) i32
    mat_shading: torch.Tensor  # (M,) i32
    mat_ior: torch.Tensor  # (M,)
    # --- texture pool ---
    texels: torch.Tensor  # (X,) int64 holding uint32 0xAARRGGBB
    tex_offset: torch.Tensor  # (K,) i32
    tex_width: torch.Tensor  # (K,) i32
    tex_height: torch.Tensor  # (K,) i32
    # --- static metadata ---
    has_alpha: bool = False
    blas_leaf_max: int = 4
    tlas_leaf_max: int = 2

    @property
    def n_spheres(self) -> int:
        return self.sph_center.shape[0]

    @property
    def n_tris(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def to(self, device) -> "SceneData":
        return dataclasses.replace(
            self, **{k: getattr(self, k).to(device) for k in _FIELDS}
        )

    def to_numpy(self) -> dict[str, Any]:
        out: dict[str, Any] = {k: getattr(self, k).cpu().numpy() for k in _FIELDS}
        out.update(has_alpha=self.has_alpha, blas_leaf_max=self.blas_leaf_max,
                   tlas_leaf_max=self.tlas_leaf_max)
        return out


def scene_from_numpy(tables: dict[str, Any], device="cuda") -> SceneData:
    """SceneData from numpy arrays named like the JAX SceneData fields
    (`has_alpha`, `blas_leaf_max`, `tlas_leaf_max` optional)."""
    kw = {}
    for name, dtype in _FIELDS.items():
        a = np.array(tables[name])
        if dtype == torch.int64:
            a = a.astype(np.int64)
        kw[name] = torch.as_tensor(a, dtype=dtype, device=device).contiguous()
    return SceneData(
        **kw,
        has_alpha=bool(tables.get("has_alpha", False)),
        blas_leaf_max=int(tables.get("blas_leaf_max", 4)),
        tlas_leaf_max=int(tables.get("tlas_leaf_max", 2)),
    )


@dataclasses.dataclass
class _Instance:
    type: int
    blas_root: int
    blas_node_count: int
    prim_first: int
    prim_count: int
    o2w: np.ndarray
    w2o: np.ndarray
    scale: float
    bmin: np.ndarray
    bmax: np.ndarray
    vertex_first: int = 0
    vertex_count: int = 0


class SceneBuilder:
    """Host scene assembly + BVH build; `commit(device)` -> SceneData."""

    def __init__(self, blas_leaf_size: int = 4, tlas_leaf_size: int = 2,
                 bvh_method: str = "median"):
        self.blas_leaf_size = blas_leaf_size
        self.tlas_leaf_size = tlas_leaf_size
        self.bvh_method = bvh_method  # "median" (parity) or "sah" (native)
        self.spheres: list[dict[str, Any]] = []
        self.positions = np.zeros((0, 3), dtype=np.float32)
        self.tri_indices = np.zeros((0, 3), dtype=np.int32)
        self.tri_uvs = np.zeros((0, 3, 2), dtype=np.float32)
        self.tri_mat = np.zeros((0,), dtype=np.int32)
        self.materials: list[Material] = []
        self.texels: list[np.ndarray] = []
        self.tex_info: list[tuple[int, int, int]] = []
        self._texel_count = 0
        self.blas_bmin: list[np.ndarray] = []
        self.blas_bmax: list[np.ndarray] = []
        self.blas_ifields: list[np.ndarray] = []
        self._blas_node_count = 0
        self.sphere_prim_idx: list[np.ndarray] = []
        self._sphere_prim_count = 0
        self.tri_prim_idx: list[np.ndarray] = []
        self._tri_prim_count = 0
        self.instances: list[_Instance] = []

    # ---- materials / textures ----

    def add_material(self, mat: Material) -> int:
        self.materials.append(mat.validate())
        return len(self.materials) - 1

    def add_texture_rgba(self, rgba: np.ndarray) -> int:
        """rgba: (H, W, 4) uint8 -> packed uint32 texel block; returns tex id."""
        h, w = rgba.shape[:2]
        r = rgba[..., 0].astype(np.uint32)
        g = rgba[..., 1].astype(np.uint32)
        b = rgba[..., 2].astype(np.uint32)
        a = rgba[..., 3].astype(np.uint32)
        packed = (a << 24) | (r << 16) | (g << 8) | b
        offset = self._texel_count
        self.texels.append(packed.reshape(-1))
        self._texel_count += w * h
        self.tex_info.append((offset, w, h))
        return len(self.tex_info) - 1

    def add_checker_texture(self, w: int, h: int, step: int, c0, c1) -> int:
        """Procedural checker (Scene.cs:98-112). c0/c1: RGBA uint8 tuples."""
        ys, xs = np.mgrid[0:h, 0:w]
        sel = (((xs // step) + (ys // step)) & 1) == 0
        rgba = np.where(
            sel[..., None],
            np.array(c0, dtype=np.uint8),
            np.array(c1, dtype=np.uint8),
        )
        return self.add_texture_rgba(rgba.astype(np.uint8))

    # ---- primitives ----

    def add_sphere(self, center, radius: float, albedo=(1.0, 1.0, 1.0),
                   material: int = 0, shading: int = SHADING_LAMBERT,
                   ior: float = 1.0) -> int:
        self.spheres.append(
            dict(
                center=np.asarray(center, dtype=np.float32),
                radius=float(radius),
                albedo=np.asarray(albedo, dtype=np.float32),
                material=int(material),
                shading=int(shading),
                ior=float(ior),
            )
        )
        return len(self.spheres) - 1

    # ---- instances ----

    def _append_blas(self, nbmin, nbmax, nif, prim_base_list_len):
        """Offset node indices to absolute positions and append to the
        global node pool; returns (blas_root, node_count)."""
        base = self._blas_node_count
        nif = nif.copy()
        inner = nif[:, bvh_mod.LEFT] >= 0
        nif[inner, bvh_mod.LEFT] += base
        skipv = nif[:, bvh_mod.SKIP] >= 0
        nif[skipv, bvh_mod.SKIP] += base
        nif[:, bvh_mod.FIRST] += prim_base_list_len
        self.blas_bmin.append(nbmin)
        self.blas_bmax.append(nbmax)
        self.blas_ifields.append(nif)
        self._blas_node_count += nif.shape[0]
        return base, nif.shape[0]

    def add_sphere_instance(self, sphere_ids, object_to_world=None) -> int:
        """BLAS over a set of spheres + an instance record
        (Scene.cs BuildSphereInstance:323-356)."""
        if object_to_world is None:
            object_to_world = identity_affine()
        o2w = np.asarray(object_to_world, dtype=np.float32)
        ids = np.asarray(sphere_ids, dtype=np.int32)
        centers = np.stack([self.spheres[i]["center"] for i in ids])
        radii = np.array([self.spheres[i]["radius"] for i in ids], dtype=np.float32)
        pbmin, pbmax = bvh_mod.sphere_bounds(centers, radii)
        nbmin, nbmax, nif, order = bvh_mod.build_skip_index_bvh(
            pbmin, pbmax, centers, self.blas_leaf_size, self.bvh_method
        )
        root, count = self._append_blas(nbmin, nbmax, nif, self._sphere_prim_count)
        self.sphere_prim_idx.append(ids[order])
        self._sphere_prim_count += len(order)

        w2o, scale = invert_rigid_or_uniform(o2w)
        wmin, wmax = transform_aabb(o2w, pbmin.min(axis=0), pbmax.max(axis=0))
        self.instances.append(
            _Instance(
                type=BLAS_SPHERE_SET, blas_root=root, blas_node_count=count,
                prim_first=int(ids[0]), prim_count=len(ids), o2w=o2w,
                w2o=w2o, scale=float(scale), bmin=wmin, bmax=wmax,
            )
        )
        return len(self.instances) - 1

    def add_mesh_instance(self, positions: np.ndarray, tri_indices: np.ndarray,
                          tri_uvs: np.ndarray | None = None,
                          tri_mat: np.ndarray | None = None,
                          object_to_world: np.ndarray | None = None) -> int:
        """Append a triangle mesh and build its BLAS (Scene.cs
        LoadObjInstance:144-256 geometry path). positions (V,3), tri_indices
        (T,3) local, tri_uvs (T,3,2) or None, tri_mat (T,) or None."""
        if object_to_world is None:
            object_to_world = identity_affine()
        o2w = np.asarray(object_to_world, dtype=np.float32)
        positions = np.asarray(positions, dtype=np.float32)
        tri_indices = np.asarray(tri_indices, dtype=np.int32)
        T = tri_indices.shape[0]
        if tri_uvs is None:
            tri_uvs = np.zeros((T, 3, 2), dtype=np.float32)
        if tri_mat is None:
            tri_mat = np.zeros((T,), dtype=np.int32)

        def _cat(old, new):
            return new if old.shape[0] == 0 else np.concatenate([old, new])

        base_vertex = self.positions.shape[0]
        base_tri = self.tri_indices.shape[0]
        self.positions = _cat(self.positions, positions)
        self.tri_indices = _cat(
            self.tri_indices,
            tri_indices if base_vertex == 0 else tri_indices + base_vertex,
        )
        self.tri_uvs = _cat(self.tri_uvs, np.asarray(tri_uvs, dtype=np.float32))
        self.tri_mat = _cat(self.tri_mat, np.asarray(tri_mat, dtype=np.int32))

        v0 = positions[tri_indices[:, 0]]
        v1 = positions[tri_indices[:, 1]]
        v2 = positions[tri_indices[:, 2]]
        pbmin, pbmax = bvh_mod.triangle_bounds(v0, v1, v2)
        centroid = (v0 + v1 + v2) / 3.0
        nbmin, nbmax, nif, order = bvh_mod.build_skip_index_bvh(
            pbmin, pbmax, centroid, self.blas_leaf_size, self.bvh_method
        )
        root, count = self._append_blas(nbmin, nbmax, nif, self._tri_prim_count)
        self.tri_prim_idx.append((order + base_tri).astype(np.int32))
        self._tri_prim_count += len(order)

        w2o, scale = invert_rigid_or_uniform(o2w)
        wmin, wmax = transform_aabb(o2w, pbmin.min(axis=0), pbmax.max(axis=0))
        self.instances.append(
            _Instance(
                type=BLAS_TRI_MESH, blas_root=root, blas_node_count=count,
                prim_first=base_tri, prim_count=T, o2w=o2w, w2o=w2o,
                scale=float(scale), bmin=wmin, bmax=wmax,
                vertex_first=base_vertex, vertex_count=positions.shape[0],
            )
        )
        return len(self.instances) - 1

    # ---- commit ----

    def commit(self, device="cuda") -> SceneData:
        n_inst = len(self.instances)
        assert n_inst > 0, "empty scene"

        inst_bmin = np.stack([i.bmin for i in self.instances])
        inst_bmax = np.stack([i.bmax for i in self.instances])
        centroids = 0.5 * (inst_bmin + inst_bmax)
        t_bmin, t_bmax, t_if, t_order = bvh_mod.build_skip_index_bvh(
            inst_bmin, inst_bmax, centroids, self.tlas_leaf_size
        )
        sph_ids = [i for i, ins in enumerate(self.instances) if ins.type == BLAS_SPHERE_SET]
        tri_ids = [i for i, ins in enumerate(self.instances) if ins.type == BLAS_TRI_MESH]

        def cat_or_dummy(lst, shape, dtype=np.float32):
            if lst:
                return np.concatenate(lst).astype(dtype)
            return np.zeros(shape, dtype=dtype)

        # 1-element dummies when absent (Scene.cs:370-377)
        if self.spheres:
            sph = dict(
                sph_center=np.stack([s["center"] for s in self.spheres]),
                sph_radius=np.array([s["radius"] for s in self.spheres], np.float32),
                sph_albedo=np.stack([s["albedo"] for s in self.spheres]),
                sph_shading=np.array([s["shading"] for s in self.spheres], np.int32),
                sph_ior=np.array([s["ior"] for s in self.spheres], np.float32),
                sph_mat=np.array([s["material"] for s in self.spheres], np.int32),
            )
        else:
            sph = dict(
                sph_center=np.zeros((1, 3), np.float32),
                sph_radius=np.zeros((1,), np.float32),
                sph_albedo=np.ones((1, 3), np.float32),
                sph_shading=np.zeros((1,), np.int32),
                sph_ior=np.ones((1,), np.float32),
                sph_mat=np.zeros((1,), np.int32),
            )

        if self.tri_indices.shape[0] > 0:
            tv0 = self.positions[self.tri_indices[:, 0]]
            tv1 = self.positions[self.tri_indices[:, 1]]
            tv2 = self.positions[self.tri_indices[:, 2]]
            tri = dict(
                tri_v0=tv0, tri_e1=tv1 - tv0, tri_e2=tv2 - tv0,
                tri_uv0=self.tri_uvs[:, 0], tri_uv1=self.tri_uvs[:, 1],
                tri_uv2=self.tri_uvs[:, 2], tri_mat=self.tri_mat,
            )
        else:
            z3 = np.zeros((1, 3), np.float32)
            z2 = np.zeros((1, 2), np.float32)
            tri = dict(tri_v0=z3, tri_e1=z3, tri_e2=z3, tri_uv0=z2,
                       tri_uv1=z2, tri_uv2=z2, tri_mat=np.zeros((1,), np.int32))

        msoa = materials_to_soa(self.materials)
        if self.tex_info:
            tex = dict(
                tex_offset=np.array([t[0] for t in self.tex_info], np.int32),
                tex_width=np.array([t[1] for t in self.tex_info], np.int32),
                tex_height=np.array([t[2] for t in self.tex_info], np.int32),
            )
        else:
            tex = dict(tex_offset=np.zeros((1,), np.int32),
                       tex_width=np.zeros((1,), np.int32),
                       tex_height=np.zeros((1,), np.int32))

        tables = dict(
            tlas_bmin=t_bmin, tlas_bmax=t_bmax, tlas_ifields=t_if,
            tlas_instance_indices=t_order,
            inst_o2w=np.stack([i.o2w for i in self.instances]),
            inst_w2o=np.stack([i.w2o for i in self.instances]),
            inst_scale=np.array([i.scale for i in self.instances], np.float32),
            inst_bmin=inst_bmin, inst_bmax=inst_bmax,
            inst_blas_root=np.array([i.blas_root for i in self.instances], np.int32),
            inst_prim_first=np.array([i.prim_first for i in self.instances], np.int32),
            inst_prim_count=np.array([i.prim_count for i in self.instances], np.int32),
            sph_instances=np.array(sph_ids, np.int32),
            tri_instances=np.array(tri_ids, np.int32),
            blas_bmin=cat_or_dummy(self.blas_bmin, (1, 3)),
            blas_bmax=cat_or_dummy(self.blas_bmax, (1, 3)),
            blas_ifields=cat_or_dummy(self.blas_ifields, (1, 4), np.int32),
            sphere_prim_idx=cat_or_dummy(self.sphere_prim_idx, (1,), np.int32),
            tri_prim_idx=cat_or_dummy(self.tri_prim_idx, (1,), np.int32),
            texels=cat_or_dummy(self.texels, (1,), np.uint32),
            has_alpha=bool((msoa["mat_alpha_tex"] >= 0).any()),
            blas_leaf_max=self.blas_leaf_size,
            tlas_leaf_max=self.tlas_leaf_size,
            **sph, **tri, **msoa, **tex,
        )
        return scene_from_numpy(tables, device)


def build_default_scene(blas_leaf_size: int = 4, tlas_leaf_size: int = 2,
                        single_instance: bool = False, device="cuda"):
    """The reference default scene: 2 checker textures, 5 materials, 6
    spheres (ground r=1000, red, green, textured, mirror, glass ior=1.5),
    one instance per sphere or all in one (Scene.cs:83-142). Returns
    (builder, committed scene)."""
    b = SceneBuilder(blas_leaf_size, tlas_leaf_size)
    checker0 = b.add_checker_texture(
        256, 256, 16, (255, 255, 255, 255), (20, 20, 20, 255)
    )
    checker1 = b.add_checker_texture(
        256, 256, 8, (40, 40, 200, 255), (200, 200, 40, 255)
    )
    m_ground = b.add_material(Material(kd=(1, 1, 1), diffuse_tex=checker0))
    m_red = b.add_material(Material(kd=(0.8, 0.3, 0.3)))
    m_green = b.add_material(Material(kd=(0.3, 0.8, 0.3)))
    m_tex = b.add_material(Material(kd=(1, 1, 1), diffuse_tex=checker1))
    m_white = b.add_material(Material(kd=(1, 1, 1)))

    ground = b.add_sphere((0, -1000.5, 0), 1000.0, (1, 1, 1), m_ground)
    s0 = b.add_sphere((-0.9, 0.5, -0.2), 0.5, (0.8, 0.3, 0.3), m_red)
    s1 = b.add_sphere((0.9, 0.35, 0.2), 0.35, (0.3, 0.8, 0.3), m_green)
    s2 = b.add_sphere((0.0, 0.75, 0.6), 0.75, (1, 1, 1), m_tex)
    s_mirror = b.add_sphere((-1.8, 0.5, 0.8), 0.5, (1, 1, 1), m_white, SHADING_MIRROR)
    s_glass = b.add_sphere(
        (1.8, 0.5, -0.8), 0.5, (1, 1, 1), m_white, SHADING_GLASS, ior=1.5
    )
    if single_instance:
        b.add_sphere_instance([ground, s0, s1, s2, s_mirror, s_glass])
    else:
        for sid in (ground, s0, s1, s2, s_mirror, s_glass):
            b.add_sphere_instance([sid])
    return b, b.commit(device)


@telemetry.spanned("refit")
def refit_mesh_instance(builder: SceneBuilder, scene: SceneData, inst_index: int,
                        new_positions: np.ndarray) -> SceneData:
    """Per-frame BVH refit of an animated mesh instance (BASELINE config 4).

    Replaces the instance's vertex positions in the builder's host mirror
    (so refits compound across frames), refits its BLAS bounds bottom-up
    with the topology kept, recomputes the baked triangle rows and the
    instance's world box, rebuilds the small TLAS, and returns a new
    SceneData on `scene`'s device. The input scene's tensors are not
    written: the changed tables are fresh tensors, the others shared.

    Reads `scene.blas_ifields` and `scene.tri_prim_idx` back to the host
    (a synchronizing copy from the card), as the JAX function does. The
    node sweep runs in the native scene core when it is built, else in
    numpy (bvh.refit_bvh); both give the same bits. Spans (utils/telemetry.py):
    `refit`, with `readback`, `refit_bvh`, `tlas` and `upload` inside, the
    read-back's and the upload's host bytes as `bytes`."""
    from ilgpu_raytracing_tpu_torch import native as native_mod

    inst = builder.instances[inst_index]
    assert inst.type == BLAS_TRI_MESH, "refit targets mesh instances"
    new_positions = np.asarray(new_positions, dtype=np.float32)
    assert new_positions.shape == (inst.vertex_count, 3)

    v_slice = slice(inst.vertex_first, inst.vertex_first + inst.vertex_count)
    builder.positions[v_slice] = new_positions

    t_slice = slice(inst.prim_first, inst.prim_first + inst.prim_count)
    tris = builder.tri_indices[t_slice]
    v0 = builder.positions[tris[:, 0]]
    v1 = builder.positions[tris[:, 1]]
    v2 = builder.positions[tris[:, 2]]
    pbmin, pbmax = bvh_mod.triangle_bounds(v0, v1, v2)

    # the instance's node slice, localized: children are absolute node ids,
    # leaf `first` indexes the global tri_prim_idx, whose global tri ids map
    # back to this instance's prim rows
    root, count = inst.blas_root, inst.blas_node_count
    with telemetry.span("readback") as rb:
        nif = scene.blas_ifields[root: root + count].cpu().numpy().copy()
        leaf_order = scene.tri_prim_idx.cpu().numpy()
        rb.add(bytes=nif.nbytes + leaf_order.nbytes)
    inner = nif[:, bvh_mod.LEFT] >= 0
    nif[inner, bvh_mod.LEFT] -= root
    leaf_order_local = leaf_order - inst.prim_first
    with telemetry.span("refit_bvh"):
        refit = native_mod.refit_bvh(nif, leaf_order_local, pbmin, pbmax)
        nb, nx = (bvh_mod.refit_bvh(nif, leaf_order_local, pbmin, pbmax)
                  if refit is None else refit)

    with telemetry.span("tlas"):
        inst.bmin, inst.bmax = transform_aabb(inst.o2w, pbmin.min(axis=0),
                                              pbmax.max(axis=0))
        # the TLAS is rebuilt on the builder's tlas_leaf_size, the bound that
        # commit recorded as tlas_leaf_max, so the scene's metadata still holds
        inst_bmin = np.stack([i.bmin for i in builder.instances])
        inst_bmax = np.stack([i.bmax for i in builder.instances])
        centroids = 0.5 * (inst_bmin + inst_bmax)
        t_bmin, t_bmax, t_if, t_order = bvh_mod.build_skip_index_bvh(
            inst_bmin, inst_bmax, centroids, builder.tlas_leaf_size
        )

    dev = scene.device
    uploaded = 0

    def put(a, dtype=torch.float32):
        nonlocal uploaded
        x = torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)
        uploaded += x.numel() * x.element_size()
        return x

    def patched(full, rows, new):
        out = full.clone()
        out[rows] = put(new)
        return out

    with telemetry.span("upload") as up:
        out = dataclasses.replace(
            scene,
            blas_bmin=patched(scene.blas_bmin, slice(root, root + count), nb),
            blas_bmax=patched(scene.blas_bmax, slice(root, root + count), nx),
            tri_v0=patched(scene.tri_v0, t_slice, v0),
            tri_e1=patched(scene.tri_e1, t_slice, v1 - v0),
            tri_e2=patched(scene.tri_e2, t_slice, v2 - v0),
            inst_bmin=put(inst_bmin),
            inst_bmax=put(inst_bmax),
            tlas_bmin=put(t_bmin),
            tlas_bmax=put(t_bmax),
            tlas_ifields=put(t_if, torch.int32),
            tlas_instance_indices=put(t_order, torch.int32),
        )
        up.add(bytes=uploaded)
    return out
