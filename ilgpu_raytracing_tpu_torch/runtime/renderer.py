"""Frame orchestration (port of runtime/renderer.py).

Per frame: primary visibility -> path trace with ReSTIR -> tone map + pack
-> TAAU upsample (or bilinear blit). The host side handles camera updates,
sun animation, reservoir ping-pong, the noise key, HUD timing and
presentation (device -> host -> PNG).

The Renderer runs on the device it is given -- the card unless the caller
asks for the CPU -- and nowhere else. On CUDA it traces with the
hand-written kernels (K1/K2 wide walks up to 150k triangles, K4/K5
streaming walks up to 4M, K3 counting sort) and refuses what they do not
cover; on the CPU the same wrappers run their plain versions. It never
moves work to another device or swaps a kernel for its plain version on
its own. A caller may set `r.wscene = binary.prepare_binary(r.scene)`
(ops/cuda/binary.py) after construction, as the JAX package's callers set
`r.pscene = traverse_kernel.prepare(scene)`: every trace of the frame then
runs the binary skip-index kernel K6. A scene with alpha cutouts (an OBJ
with `map_d`, models/sponza_like.py) routes by size like any other, and
every trace of its frame peels around the closest-hit kernel of its route,
K1, K4 or K6 (ops/alpha.py): the any-hit kernels do not run on it. Every
RenderConfig setting renders; only `mesh=` (multi-device) is refused.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.scene import SceneData, build_default_scene
from ilgpu_raytracing_tpu_torch.ops import integrator, sky, taa, tonemap, upsample
from ilgpu_raytracing_tpu_torch.ops.cuda import stream as stream_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as wide_mod
from ilgpu_raytracing_tpu_torch.runtime.framestate import FrameState
from ilgpu_raytracing_tpu_torch.runtime.hud import FrameTimingHud
from ilgpu_raytracing_tpu_torch.utils import image, packing


def render_frame(scene: SceneData, camera, prev_camera, state: FrameState,
                 frame: int, noise_key: int, sun_dir, accum_reset: bool,
                 cfg: RenderConfig, in_w: int, in_h: int, out_w: int,
                 out_h: int, tonemap_name: str = "clamp", wscene=None):
    """One frame step. Returns (packed_out (outN,) int64 0xAARRGGBB,
    new_state, aux dict with linear low-res color/depth/obj and eff_rays)."""
    gb = integrator.primary_visibility(
        scene, camera, in_w, in_h, cfg.chunk_pixels, wscene
    )
    color, depth, obj_id, res_cur, eff_rays = integrator.path_trace(
        scene, gb, camera, prev_camera, state.res_prev, state.res_cur,
        frame, noise_key, sun_dir, cfg, in_w, in_h, wscene,
    )

    if cfg.progressive_accumulation:
        accum = color if accum_reset else state.accum + color
        count = 1 if accum_reset else state.accum_count + 1
        display = tonemap.OPERATORS[tonemap_name](accum / float(count))
    else:
        accum, count = state.accum, state.accum_count
        display = tonemap.OPERATORS[tonemap_name](color)
    low_packed = packing.pack_rgba8(display)

    if cfg.enable_taau:
        out_packed, taa_color, taa_obj = taa.resolve_upsample(
            low_packed, obj_id, state.taa_color, state.taa_obj,
            state.taa_valid, in_w, in_h, out_w, out_h,
            cfg.taa_feedback, cfg.taa_sharpness,
        )
        taa_valid = True
    else:
        out_packed = upsample.bilinear_upsample(low_packed, in_w, in_h, out_w, out_h)
        taa_color, taa_obj, taa_valid = state.taa_color, state.taa_obj, state.taa_valid

    new_state = FrameState(
        res_prev=state.res_prev, res_cur=res_cur, taa_color=taa_color,
        taa_obj=taa_obj, taa_valid=taa_valid, accum=accum, accum_count=count,
    )
    # effective rays = alive dispatched trace lanes + one primary per pixel
    aux = dict(color=color, depth=depth, obj_id=obj_id,
               eff_rays=eff_rays + float(in_w * in_h))
    return out_packed, new_state, aux


class Renderer:
    """Host-side frame loop on one explicit device."""

    def __init__(self, out_w: int = 1280, out_h: int = 720,
                 cfg: RenderConfig | None = None, scene: SceneData | None = None,
                 camera: Camera | None = None, tonemap_name: str = "clamp",
                 reference_pose: bool = False, mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "multi-device rendering: ROADMAP Queue 1, multi-device "
                "(parallel/sharding.py)"
            )
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"Renderer: unsupported device {self.device}")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Renderer: no CUDA device; pass device='cpu' to render with "
                "the plain PyTorch versions of the kernels"
            )
        self.cfg = cfg or RenderConfig()
        if scene is None:
            _, scene = build_default_scene(
                self.cfg.blas_leaf_size, self.cfg.tlas_leaf_size,
                single_instance=True, device=self.device,
            )
        self.wscene = None
        self.set_scene(scene)
        self.out_w, self.out_h = out_w, out_h
        self.in_w, self.in_h = self.cfg.internal_resolution(out_w, out_h)
        if camera is None:
            camera = Camera.create(out_w, out_h, 60.0)
            if reference_pose:
                camera = camera.translate([1, 0, -4])
        self.camera = camera
        self.prev_camera = camera
        self.state = FrameState.create(self.in_w * self.in_h, out_w * out_h, self.device)
        self.frame = 0
        self.sun_azimuth = self.cfg.sun_azimuth
        self.sun_elevation = self.cfg.sun_elevation
        self.tonemap_name = tonemap_name
        self.hud = FrameTimingHud()
        self._rng = random.Random(0x5EED)
        self._last_packed = None
        self._last_aux = None
        self._camera_moved = True

    # ---- scene ----

    def _prepare_wscene(self, scene: SceneData) -> None:
        """Kernel tables of the scene: a WideScene up to wide.MAX_TRIS
        triangles, a StreamScene up to stream.MAX_TRIS; above that the
        plain walk on the CPU, and a refusal on CUDA."""
        on_cuda = self.device.type == "cuda"
        if not self.cfg.use_pallas_trace:
            if on_cuda:
                raise RuntimeError(
                    "use_pallas_trace=False on a CUDA device would trace with "
                    "the plain PyTorch walk instead of the kernels; render on "
                    "the CPU for the plain path"
                )
            self.wscene = None
            return
        if wide_mod.supports_scene(scene):
            self.wscene = wide_mod.prepare_scene(scene)
        elif stream_mod.supports_scene(scene):
            # large scenes: the streaming kernels (BASELINE config 5)
            self.wscene = stream_mod.prepare_stream(scene)
        elif on_cuda:
            raise RuntimeError(
                f"scene ({scene.n_tris} tris) exceeds every kernel's limit "
                f"(stream kernel caps at 4M triangles); the plain PyTorch "
                f"walk is not used on the card. Split the scene or reduce "
                f"triangle count."
            )
        else:
            self.wscene = None

    def set_scene(self, scene: SceneData) -> None:
        """Swap the committed scene (moved to the renderer's device) and
        re-prepare the kernel tables. This is also the per-frame entry of
        a refit scene (models/scene.refit_mesh_instance, BASELINE config
        4): the tables are read back, rebuilt on the host and uploaded on
        every call, as the JAX package re-prepares its Pallas scene."""
        self.scene = scene.to(self.device)
        self._prepare_wscene(self.scene)

    # ---- camera ----

    def set_camera(self, camera: Camera) -> None:
        if not np.allclose(camera.origin, self.camera.origin) or not np.allclose(
            camera.lower_left, self.camera.lower_left
        ):
            self._camera_moved = True
        self.camera = camera

    def set_sun(self, speed_rad_per_sec: float | None = None,
                elevation: float | None = None) -> None:
        """SetSunParams (RTRenderer.cs:99-103)."""
        import dataclasses

        if speed_rad_per_sec is not None:
            self.cfg = dataclasses.replace(
                self.cfg, sun_speed_rad_per_sec=speed_rad_per_sec
            )
        if elevation is not None:
            self.sun_elevation = elevation

    def resize(self, out_w: int, out_h: int) -> None:
        """Re-derive internal res, drop history, reset frame index."""
        self.out_w, self.out_h = out_w, out_h
        self.in_w, self.in_h = self.cfg.internal_resolution(out_w, out_h)
        self.state = FrameState.create(self.in_w * self.in_h, out_w * out_h, self.device)
        self.frame = 0
        self._camera_moved = True

    # ---- frame ----

    def render(self, dt: float = 1.0 / 60.0):
        t0 = time.monotonic()
        self.sun_azimuth = sky.advance_sun_azimuth(
            self.sun_azimuth, self.cfg.sun_speed_rad_per_sec, dt
        )
        sun_dir = sky.sun_direction(self.sun_azimuth, self.sun_elevation)
        noise_key = (
            0 if self.cfg.rng_lock_noise == 0 else self._rng.getrandbits(32) | 1
        )
        state = self.state.swapped_reservoirs() if self.frame > 0 else self.state
        packed, new_state, aux = render_frame(
            self.scene, self.camera, self.prev_camera, state, self.frame,
            noise_key, sun_dir, self._camera_moved, self.cfg, self.in_w,
            self.in_h, self.out_w, self.out_h, self.tonemap_name, self.wscene,
        )
        self.state = new_state
        self.prev_camera = self.camera
        self.frame += 1
        self._camera_moved = False
        self._last_packed = packed
        self._last_aux = aux
        self.hud.push(time.monotonic() - t0)
        return packed

    def render_frames(self, n: int, dt: float = 1.0 / 60.0):
        packed = None
        for _ in range(n):
            packed = self.render(dt)
        return packed

    # ---- presentation (device -> host -> surface) ----

    def frame_rgb(self) -> np.ndarray:
        assert self._last_packed is not None, "render() first"
        img = image.packed_to_numpy_rgb(self._last_packed, self.out_w, self.out_h)
        return img[::-1]  # v axis points up

    def save_png(self, path: str) -> None:
        image.save_png(path, np.ascontiguousarray(self.frame_rgb()))
