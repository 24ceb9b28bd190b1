"""Frame orchestration (port of runtime/renderer.py).

Per frame: primary visibility -> path trace with ReSTIR -> tone map + pack
-> TAAU upsample (or bilinear blit). The host side handles camera updates,
sun animation, reservoir ping-pong, the noise key, HUD timing and
presentation (device -> host -> PNG).

The Renderer runs on the device it is given -- the card unless the caller
asks for the CPU -- and nowhere else. ops/route.py chooses the kernels
that trace: on CUDA the hand-written ones (K1/K2 wide walks up to 150k
triangles, K4/K5 streaming walks up to 4M, K3 counting sort), refusing
what they do not cover; on the CPU the same wrappers run their plain
versions. ReSTIR DI runs in one launch a bounce (csrc/restir.cu). The
Renderer never moves work to another device or swaps a kernel for its
plain version on its own. A caller may set `r.wscene =
binary.prepare_binary(r.scene)` (ops/cuda/binary.py) after construction,
as the JAX package's callers set `r.pscene = traverse_kernel.prepare(scene)`:
every trace of the frame then runs the binary skip-index kernel K6. A scene
with alpha cutouts (an OBJ with `map_d`, models/sponza_like.py) routes by
size like any other, and every trace of its frame peels around the
closest-hit kernel of its route, K1, K4 or K6 (ops/alpha.py): the any-hit
kernels do not run on it.

`Renderer(mesh=parallel.sharding.make_mesh(...))` renders over a device
mesh (`render_frame_mesh`): the internal resolution is snapped so both
pixel counts divide the mesh, the FrameState is sharded, and the renderer
replicates the scene and its kernel scene onto the mesh (one copy on each
distinct device); device k runs the whole frame step for its own
contiguous pixel block, tracing against its own copies, after gathering
the full-image G-buffer, `res_prev` and packed low-res frame that ReSTIR's
and TAAU's taps read. The pixel blocks are the only split: no trace
splits its rays. The kernel scene is replicated once per `set_scene`, and
once per kernel scene a caller assigns to `r.wscene`, when the first frame
after the assignment renders. The frame equals the single-device frame
bit for bit. The renderer runs on the mesh's devices; an explicit
`device=` that disagrees with them raises.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.scene import SceneData, build_default_scene
from ilgpu_raytracing_tpu_torch.ops import integrator, route, sky, taa, tonemap, upsample
from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd
from ilgpu_raytracing_tpu_torch.runtime.framestate import FrameState
from ilgpu_raytracing_tpu_torch.runtime.hud import FrameTimingHud
from ilgpu_raytracing_tpu_torch.utils import image, packing, telemetry


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

    low_packed, accum, count = _display(color, state.accum, state.accum_count,
                                        accum_reset, cfg, tonemap_name)
    out_packed, taa_color, taa_obj = _upsample(
        low_packed, obj_id, state.taa_color, state.taa_obj, state.taa_valid,
        cfg, in_w, in_h, out_w, out_h)
    new_state = FrameState(
        res_prev=state.res_prev, res_cur=res_cur, taa_color=taa_color,
        taa_obj=taa_obj, taa_valid=state.taa_valid or cfg.enable_taau,
        accum=accum, accum_count=count,
    )
    # effective rays = alive dispatched trace lanes + one primary per pixel
    aux = dict(color=color, depth=depth, obj_id=obj_id,
               eff_rays=eff_rays + float(in_w * in_h))
    return out_packed, new_state, aux


@telemetry.spanned("display")
def _display(color, accum, accum_count: int, accum_reset: bool,
             cfg: RenderConfig, tonemap_name: str):
    """Progressive accumulation, tone map and pack of low-res pixels.
    Returns (low_packed, accum, accum_count)."""
    if cfg.progressive_accumulation:
        accum = color if accum_reset else accum + color
        accum_count = 1 if accum_reset else accum_count + 1
        display = tonemap.OPERATORS[tonemap_name](accum / float(accum_count))
    else:
        display = tonemap.OPERATORS[tonemap_name](color)
    return packing.pack_rgba8(display), accum, accum_count


@telemetry.spanned("taau")
def _upsample(low_packed, obj_id, taa_color, taa_obj, taa_valid: bool,
              cfg: RenderConfig, in_w: int, in_h: int, out_w: int, out_h: int,
              pixels: slice | None = None):
    """TAAU resolve (or the bilinear blit) of the whole low-res frame into
    the output pixels `pixels` (all when None). Returns (out_packed,
    taa_color, taa_obj), the history unchanged without TAAU."""
    if cfg.enable_taau:
        return taa.resolve_upsample(
            low_packed, obj_id, taa_color, taa_obj, taa_valid, in_w, in_h,
            out_w, out_h, cfg.taa_feedback, cfg.taa_sharpness, pixels)
    out = upsample.bilinear_upsample(low_packed, in_w, in_h, out_w, out_h, pixels)
    return out, taa_color, taa_obj


def replicate_kscene(mesh: shrd.Mesh, kscene) -> shrd.Replicated:
    """One copy of a kernel scene (None: the plain tracer) on each distinct
    device of the mesh, `copies[k]` for block k. The mesh's devices must be
    of the tables' type: no block moves between the card and the CPU."""
    on = shrd.device_of(kscene)
    kinds = {d.type for d in mesh.devices}
    if on is not None and kinds != {on.type}:
        raise ValueError(f"with_mesh: a mesh of {sorted(kinds)} devices for tables "
                         f"on {on}")
    return shrd.replicate(mesh, kscene)


def render_frame_mesh(mesh: shrd.Mesh, scenes: shrd.Replicated, camera,
                      prev_camera, state: FrameState, frame: int, noise_key: int,
                      sun_dir, accum_reset: bool, cfg: RenderConfig, in_w: int,
                      in_h: int, out_w: int, out_h: int, tonemap_name: str = "clamp",
                      kscenes: shrd.Replicated | None = None, device=None):
    """`render_frame` over a pixel-block split: device k of `mesh`
    computes low-res block k (primary, path trace, tone map and pack) and
    output block k (TAAU), tracing against its replicas (`scenes.copies[k]`
    and `kscenes.copies[k]`, `replicate_kscene`; the plain tracer when
    `kscenes` is None), after gathering the full-image G-buffer,
    `res_prev`, packed low-res frame and object ids onto itself. `state` is
    sharded (`shard_state`). The blocks' launches are issued device after
    device from this one thread, each under its device's CUDA scope.
    Returns (packed_out, the new sharded state, aux), the frame and aux
    gathered onto `device` and equal to `render_frame`'s bit for bit. A
    scene or kernel scene that does not lie on its block's device raises
    ValueError before any block launches."""
    device = mesh.devices[0] if device is None else device
    low = shrd.block_slices(in_w * in_h, mesh)
    out = shrd.block_slices(out_w * out_h, mesh)
    kscenes = (None,) * mesh.size if kscenes is None else kscenes.copies
    for k, dev in enumerate(mesh.devices):
        for what, on in (("scene", scenes.copies[k].device),
                         ("kernel scene", shrd.device_of(kscenes[k]))):
            if on not in (None, dev):
                raise ValueError(
                    f"render_frame_mesh: block {k}'s {what} lies on {on}, the block "
                    f"on {dev}; replicate it onto the mesh (with_mesh)")

    def per_block(fn):
        """fn(k, device k) for every block, on device k."""
        parts = []
        for k, dev in enumerate(mesh.devices):
            with shrd.device_scope(dev):
                parts.append(fn(k, dev))
        return parts

    def shards(parts):
        return shrd.PixelShards(shrd.pixel_sharding(mesh), tuple(parts))

    gb = shards(per_block(lambda k, dev: integrator.primary_visibility(
        scenes.copies[k], camera, in_w, in_h, cfg.chunk_pixels, kscenes[k], low[k])))
    traced = per_block(lambda k, dev: integrator.path_trace(
        scenes.copies[k], gb.gather(dev), camera, prev_camera,
        state.res_prev.gather(dev), state.res_cur.blocks[k], frame, noise_key,
        sun_dir, cfg, in_w, in_h, kscenes[k], low[k]))
    cols = list(zip(*traced))
    color, depth, obj_id, res_cur = (shards(x) for x in cols[:4])
    shown = per_block(lambda k, dev: _display(
        color.blocks[k], state.accum.blocks[k], state.accum_count, accum_reset, cfg,
        tonemap_name))
    low_packed = shards(x[0] for x in shown)
    ups = per_block(lambda k, dev: _upsample(
        low_packed.gather(dev), obj_id.gather(dev), state.taa_color.blocks[k],
        state.taa_obj.blocks[k], state.taa_valid, cfg, in_w, in_h, out_w, out_h, out[k]))
    out_packed, taa_color, taa_obj = (shards(x) for x in zip(*ups))
    new_state = FrameState(
        res_prev=state.res_prev, res_cur=res_cur, taa_color=taa_color,
        taa_obj=taa_obj, taa_valid=state.taa_valid or cfg.enable_taau,
        accum=shards(x[1] for x in shown), accum_count=shown[0][2],
    )
    aux = dict(color=color.gather(device), depth=depth.gather(device),
               obj_id=obj_id.gather(device),
               eff_rays=sum(e.to(device) for e in cols[4]) + float(in_w * in_h))
    return out_packed.gather(device), new_state, aux


class Renderer:
    """Host-side frame loop on one explicit device, or over a device mesh
    (`mesh`, parallel/sharding.py)."""

    def __init__(self, out_w: int = 1280, out_h: int = 720,
                 cfg: RenderConfig | None = None, scene: SceneData | None = None,
                 camera: Camera | None = None, tonemap_name: str = "clamp",
                 reference_pose: bool = False, mesh: shrd.Mesh | None = None,
                 device="cuda"):
        self.mesh = mesh
        self.device = torch.device(device)
        if self.device.type not in ("cpu", "cuda"):
            raise ValueError(f"Renderer: unsupported device {self.device}")
        if mesh is not None:
            # the frame is assembled on `device`, which must be a mesh device
            if self.device.index is None and self.device.type == mesh.devices[0].type:
                self.device = mesh.devices[0]
            if self.device not in mesh.devices:
                raise ValueError(
                    f"Renderer: device {device} is not a device of the mesh "
                    f"{mesh.devices}")
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
        self._kscenes = None  # under a mesh: (a kernel scene, its replicas)
        self.set_scene(scene)
        self.out_w, self.out_h = out_w, out_h
        self.in_w, self.in_h = self._internal_resolution(out_w, out_h)
        if camera is None:
            camera = Camera.create(out_w, out_h, 60.0)
            if reference_pose:
                camera = camera.translate([1, 0, -4])
        self.camera = camera
        self.prev_camera = camera
        self.state = self._new_state()
        self.frame = telemetry.REGISTRY.frame = 0  # spans from here on are frame 0's
        self.sun_azimuth = self.cfg.sun_azimuth
        self.sun_elevation = self.cfg.sun_elevation
        self.tonemap_name = tonemap_name
        self.hud = FrameTimingHud()
        self._rng = random.Random(0x5EED)
        self._last_packed = None
        self._last_aux = None
        self._camera_moved = True

    # ---- scene ----

    def set_scene(self, scene: SceneData) -> None:
        """Swap the committed scene (moved to the renderer's device) and
        prepare its kernel tables. This is also the per-frame entry of a
        refit scene (models/scene.refit_mesh_instance, BASELINE config 4):
        a scene that keeps the topology tensors of the one the wide tables
        were prepared from gets them rebuilt on its device
        (`wide.refit_tables`); any other scene, and every scene on the
        streaming route, is prepared in full on the host and uploaded, as
        the JAX package re-prepares its Pallas scene (ops/route.prepare;
        `route.SCENE_TABLES` counts the two paths). Under a mesh the scene
        and the new tables are replicated again."""
        with telemetry.span("set_scene"):
            with telemetry.span("to_device"):
                self.scene = scene.to(self.device)
            self.wscene = route.prepare(self.scene, self.wscene,
                                        self.cfg.use_pallas_trace)
            if self.mesh is not None:
                # block k traces against device k's replicas
                self._scenes = shrd.replicate(self.mesh, self.scene)
                self._kscene_replicas()

    def _kscene_replicas(self) -> shrd.Replicated:
        """`wscene` replicated onto the mesh (`replicate_kscene`), made once
        per kernel scene and kept while `wscene` is the same object: a
        caller's `r.wscene = binary.prepare_binary(r.scene)` is replicated
        when the first frame after the assignment renders."""
        if self._kscenes is None or self._kscenes[0] is not self.wscene:
            self._kscenes = (self.wscene, replicate_kscene(self.mesh, self.wscene))
        return self._kscenes[1]

    def _internal_resolution(self, out_w: int, out_h: int) -> tuple[int, int]:
        """The config's internal resolution; under a mesh snapped so the
        internal pixel count divides it, and the output pixel count must
        (the TAA history is sharded per output pixel)."""
        if self.mesh is None:
            return self.cfg.internal_resolution(out_w, out_h)
        if (out_w * out_h) % self.mesh.size != 0:
            raise ValueError(
                f"output pixel count {out_w}x{out_h} must divide the mesh size "
                f"{self.mesh.size} (TAA history is sharded per-pixel)")
        return shrd.divisible_internal_resolution(self.cfg, out_w, out_h, self.mesh.size)

    def _new_state(self) -> FrameState:
        state = FrameState.create(self.in_w * self.in_h, self.out_w * self.out_h,
                                  self.device)
        return state if self.mesh is None else shrd.shard_state(self.mesh, state)

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
        self.in_w, self.in_h = self._internal_resolution(out_w, out_h)
        self.out_w, self.out_h = out_w, out_h
        self.state = self._new_state()
        self.frame = telemetry.REGISTRY.frame = 0
        self._camera_moved = True

    # ---- frame ----

    def render(self, dt: float = 1.0 / 60.0):
        """Issue one frame (no synchronise); returns its packed output on
        the device. The frame's `frame` span (utils/telemetry.py) also
        gives the HUD its host time."""
        telemetry.REGISTRY.frame = self.frame
        with telemetry.span("frame") as frame_span:
            self.sun_azimuth = sky.advance_sun_azimuth(
                self.sun_azimuth, self.cfg.sun_speed_rad_per_sec, dt
            )
            sun_dir = sky.sun_direction(self.sun_azimuth, self.sun_elevation)
            noise_key = (
                0 if self.cfg.rng_lock_noise == 0 else self._rng.getrandbits(32) | 1
            )
            state = self.state.swapped_reservoirs() if self.frame > 0 else self.state
            args = (self.camera, self.prev_camera, state, self.frame, noise_key,
                    sun_dir, self._camera_moved, self.cfg, self.in_w, self.in_h,
                    self.out_w, self.out_h, self.tonemap_name)
            if self.mesh is None:
                packed, new_state, aux = render_frame(self.scene, *args, self.wscene)
            else:
                packed, new_state, aux = render_frame_mesh(
                    self.mesh, self._scenes, *args, self._kscene_replicas(),
                    device=self.device)
            self.state = new_state
            self.prev_camera = self.camera
            self._camera_moved = False
            self._last_packed = packed
            self._last_aux = aux
        self.frame += 1
        # a scene update before the next render() is stamped with its frame
        telemetry.REGISTRY.frame = self.frame
        self.hud.push(frame_span.seconds)
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
