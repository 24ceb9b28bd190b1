"""ReSTIR DI in one launch (csrc/restir.cu).

`ops/restir.restir_direct` calls `launch` for CUDA tensors: candidates,
temporal and spatial reuse and selection of every lane in one kernel, in
place of the plain body's 1,243-3,564 PyTorch operations. The plain body
stays in ops/restir.py (the CPU path, and the definition the kernel is held
to: bit for bit on the card in chip_smoke.py, through the host build on the
CPU in tests/test_torch_restir_kernel.py).

The previous camera, sun, sky and frame go in as kernel arguments; the
camera origin is read on the device (3 floats), so nothing is copied to or
from the host. A case the kernel does not take raises before the launch;
there is no fall-back to the plain body on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.utils import telemetry

LAUNCHES = telemetry.counter("launches.restir", restir=0)

_state: dict[str, object] = {}

_F3 = ctypes.c_float * 3
_IN = ("state", "active", "en_t", "en_s", "pos", "nrm", "alb", "pixel_idx", "cam_origin")
_REUSE = ("gb_pos", "gb_nrm", "gb_obj", "prev_wi", "prev_w", "prev_w_sum", "prev_m",
          "prev_light_id", "prev_W")
_OUT = ("state_out", "L", "wi", "pdf", "w", "w_sum", "m", "light_id", "W", "ok", "contrib",
        "is_sun")


class _Args(ctypes.Structure):
    """csrc/restir.cu's `Args`, field for field."""

    _fields_ = ([(f, cu.VP) for f in _IN + _REUSE + _OUT]
                + [(f, cu.CI) for f in ("n", "width", "height", "n_res", "reps",
                                        "pixel_major", "local_candidates")]
                + [("frame", ctypes.c_uint32)]
                + [(f, _F3) for f in ("prev_origin", "prev_right", "prev_up", "prev_forward")]
                + [("prev_fov_y", ctypes.c_float), ("prev_aspect", ctypes.c_float)]
                + [(f, _F3) for f in ("sun_dir", "sun_radiance", "sky_top", "sky_bottom")]
                + [("mix_local", ctypes.c_float), ("pdf_delta", ctypes.c_float)])


def library():
    """(CDLL, build seconds) of csrc/restir.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("restir")
        lib.restir_direct.restype = cu.CI
        lib.restir_direct.argtypes = [ctypes.POINTER(_Args), cu.CI, cu.CI, cu.VP]
        lib.restir_args_bytes.restype = cu.CI
        if lib.restir_args_bytes() != ctypes.sizeof(_Args):
            raise RuntimeError(f"restir kernel takes {lib.restir_args_bytes()} bytes of "
                               f"arguments, the wrapper packs {ctypes.sizeof(_Args)}")
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _f3(v) -> ctypes.Array:
    a = np.asarray(v, dtype=np.float32).reshape(3)
    return _F3(*(float(x) for x in a))


def _lanes(name, t, n, dtype, dev, width=None):
    shape = (n,) if width is None else (n, width)
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        got = (t.dtype, tuple(t.shape)) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"restir kernel: {name} must be {dtype} {shape}, got {got}")
    if t.device != dev:
        raise ValueError(f"restir kernel: {name} on {t.device}, the lanes on {dev}")
    return t.contiguous()


def launch(gb, res_prev, state, active, pos, n, albedo, pixel_idx, width: int,
           height: int, frame, prev_cam, cam_origin, sun_dir, sun_radiance, sky_top,
           sky_bottom, enable_temporal, enable_spatial, local_candidates: int,
           mix_local: float, pdf_delta: float, static_reuse: bool,
           reference_weighting: bool, reps: int, reps_pixel_major: bool):
    """One launch of ops/restir.restir_direct's body (its arguments, with
    the candidates' mixture given as `mix_local` and the sun's selection pdf
    `pdf_delta`). Returns (state, [L, wi, pdf, w, w_sum, m, light_id, W],
    ok, contrib, is_sun), all allocated here."""
    dev = pos.device
    nl = pos.shape[0]
    reps = max(1, int(reps))
    if nl >= 1 << 30:
        raise ValueError(f"restir kernel: {nl} lanes overflow its int32 indices")
    if local_candidates < 0:
        raise ValueError(f"restir kernel: local_candidates={local_candidates}")
    args = _Args(n=nl, width=width, height=height, reps=reps,
                 pixel_major=int(bool(reps_pixel_major) and reps > 1),
                 local_candidates=local_candidates, frame=int(frame) & 0xFFFFFFFF,
                 prev_fov_y=float(np.float32(prev_cam.fov_y)),
                 prev_aspect=float(np.float32(prev_cam.aspect)),
                 mix_local=mix_local, pdf_delta=pdf_delta)
    for f, v in (("prev_origin", prev_cam.origin), ("prev_right", prev_cam.right),
                 ("prev_up", prev_cam.up), ("prev_forward", prev_cam.forward),
                 ("sun_dir", sun_dir), ("sun_radiance", sun_radiance),
                 ("sky_top", sky_top), ("sky_bottom", sky_bottom)):
        setattr(args, f, _f3(v))
    if pixel_idx.dtype != torch.int32:
        pixel_idx = pixel_idx.to(torch.int32)
    keep = [
        _lanes("state", state, nl, torch.int64, dev),
        _lanes("active", active, nl, torch.bool, dev),
        _lanes("enable_temporal", enable_temporal, nl, torch.bool, dev),
        _lanes("enable_spatial", enable_spatial, nl, torch.bool, dev),
        _lanes("pos", pos, nl, torch.float32, dev, 3),
        _lanes("n", n, nl, torch.float32, dev, 3),
        _lanes("albedo", albedo, nl, torch.float32, dev, 3),
        _lanes("pixel_idx", pixel_idx, nl, torch.int32, dev),
        _lanes("cam_origin", cam_origin.reshape(-1), 3, torch.float32, dev),
    ]
    if static_reuse:
        if nl % reps:
            raise ValueError(f"restir kernel: {nl} lanes are not {reps} sample views")
        n_res = width * height
        args.n_res = n_res
        keep += [
            _lanes("gb.pos", gb.pos, n_res, torch.float32, dev, 3),
            _lanes("gb.normal", gb.normal, n_res, torch.float32, dev, 3),
            _lanes("gb.obj_id", gb.obj_id, n_res, torch.int32, dev),
            _lanes("res_prev.wi", res_prev.wi, n_res, torch.float32, dev, 3),
            _lanes("res_prev.w", res_prev.w, n_res, torch.float32, dev),
            _lanes("res_prev.w_sum", res_prev.w_sum, n_res, torch.float32, dev),
            _lanes("res_prev.m", res_prev.m, n_res, torch.int32, dev),
            _lanes("res_prev.light_id", res_prev.light_id, n_res, torch.int32, dev),
            _lanes("res_prev.W", res_prev.W, n_res, torch.float32, dev),
        ]
    f32 = dict(dtype=torch.float32, device=dev)
    out = [
        torch.empty((nl,), dtype=torch.int64, device=dev),
        torch.empty((nl, 3), **f32), torch.empty((nl, 3), **f32),
        torch.empty((nl,), **f32), torch.empty((nl,), **f32), torch.empty((nl,), **f32),
        torch.empty((nl,), dtype=torch.int32, device=dev),
        torch.empty((nl,), dtype=torch.int32, device=dev),
        torch.empty((nl,), **f32),
        torch.empty((nl,), dtype=torch.bool, device=dev),
        torch.empty((nl, 3), **f32),
        torch.empty((nl,), dtype=torch.bool, device=dev),
    ]
    for f, t in zip(_IN + (_REUSE if static_reuse else ()) + _OUT, keep + out):
        setattr(args, f, t.data_ptr())
    lib, _ = library()
    err = lib.restir_direct(ctypes.byref(args), int(bool(reference_weighting)),
                            int(bool(static_reuse)), cu.stream_ptr(pos))
    cu.check(lib, "restir", err)
    LAUNCHES["restir"] += 1
    state_out, *fields, ok, contrib, is_sun = out
    return state_out, fields, ok, contrib, is_sun
