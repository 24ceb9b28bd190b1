"""The benchmark's only door into the program under test, the PyTorch and
CUDA port `ilgpu_raytracing_tpu_torch`: it hands the program the scene,
the render settings and each frame's camera and vertices through the
public entry (`models.scene.SceneBuilder`, for a textured scene
`models.obj_loader.add_obj_instance`, `runtime.renderer.Renderer`,
`models.scene.refit_mesh_instance`), and reads back only the presented
frame and the state the frame hands on (`Renderer.state`), to judge them.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

# render settings the reference implements and the program is given
# explicitly, so a change of the program's defaults cannot change the work
RENDER_KEYS = (
    "render_scale", "max_ray_pixels", "min_rt_dim", "spp", "max_depth", "eps_n",
    "rr_start_depth", "rr_clamp_lo", "rr_clamp_hi", "safe_color_max",
    "enable_temporal_reuse", "enable_spatial_reuse", "local_candidates",
    "delta_candidates", "restir_reference_weighting", "dedup_sun_shadow",
    "shadow_rr_lum", "shadow_rr_pmin", "spp_pixel_major", "rng_lock_noise", "rng_salt",
    "sun_azimuth", "sun_elevation", "sun_speed_rad_per_sec", "sun_radiance",
    "sky_tint_top", "sky_tint_bottom", "enable_taau", "taa_feedback", "taa_sharpness",
    "progressive_accumulation",
)


def build_scene(spec: dict, build: dict, device):
    """(builder, committed scene) of a scene spec through SceneBuilder. A
    spec with `obj_files` is written to a temporary directory and loaded
    as one instance through the program's OBJ/MTL/TGA loader. A mesh with
    no triangles adds no instance: the spheres' instance is then the
    scene."""
    from ilgpu_raytracing_tpu_torch.models.materials import Material
    from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder

    b = SceneBuilder(blas_leaf_size=int(build["blas_leaf_size"]),
                     bvh_method=build["bvh_method"])
    if "obj_files" in spec:
        from ilgpu_raytracing_tpu_torch.models.obj_loader import add_obj_instance

        with tempfile.TemporaryDirectory() as d:
            for name, data in spec["obj_files"].items():
                with open(os.path.join(d, name), "wb") as f:
                    f.write(data)
            add_obj_instance(b, os.path.join(d, next(n for n in spec["obj_files"]
                                                     if n.endswith(".obj"))))
        return b, b.commit(device)
    for m in spec["materials"]:
        b.add_material(Material(kd=tuple(m["kd"]), two_sided=bool(m["two_sided"]),
                                shading=int(m["shading"]), ior=float(m["ior"])))
    mesh = spec["mesh"]
    if len(mesh["tris"]) == 0 and not spec["spheres"]:
        raise ValueError("a scene spec needs at least one triangle or one sphere; this one "
                         "has neither")
    if len(mesh["tris"]):
        # copies: the builder keeps its arrays and a refit writes into them
        b.add_mesh_instance(np.array(mesh["positions"], np.float32), np.array(mesh["tris"]),
                            tri_mat=np.array(mesh["tri_mat"]))
    if spec["spheres"]:
        ids = [b.add_sphere(s["center"], s["radius"], s["albedo"], s["material"],
                            s["shading"], s["ior"]) for s in spec["spheres"]]
        b.add_sphere_instance(ids)
    return b, b.commit(device)


def camera(pose: tuple):
    from ilgpu_raytracing_tpu_torch.models.camera import Camera

    return Camera.look_at(*pose)


class Program:
    """One Renderer over one scene; each frame sets its inputs and renders."""

    def __init__(self, spec: dict, build: dict, render: dict, out_w: int, out_h: int,
                 first_pose: tuple, device):
        import torch
        from ilgpu_raytracing_tpu_torch.config import RenderConfig
        from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer

        self.builder, scene = build_scene(spec, build, device)
        kw = {k: (tuple(v) if isinstance(v, list) else v) for k, v in render.items()
              if k in RENDER_KEYS}
        self.r = Renderer(out_w, out_h, RenderConfig(**kw), scene, camera(first_pose),
                          device=device)
        self.torch = torch

    def set_positions(self, positions: np.ndarray) -> None:
        """Move the mesh's vertices: refit its BVH and hand the renderer the
        new scene (its kernel tables are prepared again)."""
        from ilgpu_raytracing_tpu_torch.models.scene import refit_mesh_instance

        self.r.set_scene(refit_mesh_instance(self.builder, self.r.scene, 0, positions))

    def render(self, pose: tuple, dt: float):
        """Set the camera and render; returns the packed frame on the device."""
        self.r.set_camera(camera(pose))
        return self.r.render(dt)

    @property
    def state(self):
        return self.r.state

    @property
    def internal_size(self) -> tuple[int, int]:
        return self.r.in_w, self.r.in_h

    @property
    def n_tris(self) -> int:
        return int(self.r.scene.n_tris)


def state_tensors(state) -> dict:
    """The tensors and counters of a FrameState, by the reference's names."""
    res = lambda r: {k: getattr(r, k) for k in ("L", "wi", "pdf", "w", "w_sum", "m",
                                                  "light_id", "W")}
    return dict(res_prev=res(state.res_prev), res_cur=res(state.res_cur),
                taa_color=state.taa_color, taa_obj=state.taa_obj,
                taa_valid=bool(state.taa_valid), accum=state.accum,
                accum_count=int(state.accum_count))
