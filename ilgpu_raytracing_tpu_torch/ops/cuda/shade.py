"""Deferred hit shading in one launch (csrc/shade.cu).

`ops/traverse.shade_hits` calls `launch` for CUDA tensors: every lane's
surface (position, shading normal, albedo, shading model, ior, object key)
computed in one thread from its hit record and the scene's own tables, in
place of the plain body's PyTorch operations, about 495 a call, which also
rebuild an (n_tris, 19) attribute table each call. The plain body stays in
ops/traverse.py (`shade_hits_plain`: the CPU path, and the definition the
kernel is held to: bit for bit on the card in chip_smoke.py, through the
host build on the CPU in tests/test_torch_shade_kernel.py).

The kernel reads the SceneData tensors in place, so a refit scene's new
edges are read on its first call and no table is cached. Nothing is copied
to or from the host; a case the kernel does not take raises before the
launch, with no fall-back to the plain body on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.utils import telemetry

LAUNCHES = telemetry.counter("launches.shade", shade=0)

_state: dict[str, object] = {}

F32, I32 = torch.float32, torch.int32
# lane inputs: name, dtype, row width (None: one value a lane)
_LANES = (("o", F32, 3), ("d", F32, 3), ("t", F32, None), ("kind", I32, None),
          ("prim", I32, None), ("inst", I32, None), ("bu", F32, None), ("bv", F32, None))
# SceneData tables: name, dtype, row shape, the size their rows count
_TABLES = (
    ("tri_e1", F32, (3,), "n_tris"), ("tri_e2", F32, (3,), "n_tris"),
    ("tri_mat", I32, (), "n_tris"), ("tri_uv0", F32, (2,), "n_tris"),
    ("tri_uv1", F32, (2,), "n_tris"), ("tri_uv2", F32, (2,), "n_tris"),
    ("mat_kd", F32, (3,), "n_mats"), ("mat_diffuse_tex", I32, (), "n_mats"),
    ("mat_two_sided", I32, (), "n_mats"), ("mat_shading", I32, (), "n_mats"),
    ("mat_ior", F32, (), "n_mats"),
    ("sph_center", F32, (3,), "n_spheres"), ("sph_mat", I32, (), "n_spheres"),
    ("sph_albedo", F32, (3,), "n_spheres"), ("sph_shading", I32, (), "n_spheres"),
    ("sph_ior", F32, (), "n_spheres"),
    ("inst_w2o", F32, (3, 4), "n_insts"), ("inst_o2w", F32, (3, 4), "n_insts"),
    ("tex_offset", I32, (), "n_tex"), ("tex_width", I32, (), "n_tex"),
    ("tex_height", I32, (), "n_tex"), ("texels", torch.int64, (), "n_texels"),
)
# the table whose rows give each size
_SIZES = {"n_tris": "tri_e1", "n_mats": "mat_kd", "n_spheres": "sph_center",
          "n_insts": "inst_w2o", "n_tex": "tex_offset", "n_texels": "texels"}
_OUT = ("pos", "normal", "albedo", "shading", "ior", "obj_id")


class _Args(ctypes.Structure):
    """csrc/shade.cu's `Args`, field for field."""

    _fields_ = ([(name, cu.VP) for name, *_ in _LANES + _TABLES]
                + [(name, cu.VP) for name in _OUT]
                + [("n_texels", ctypes.c_int64), ("n", cu.CI)]
                + [(name, cu.CI) for name in ("n_tris", "n_spheres", "n_mats", "n_insts",
                                              "n_tex")])


def library():
    """(CDLL, build seconds) of csrc/shade.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("shade")
        lib.shade_hits.restype = cu.CI
        lib.shade_hits.argtypes = [ctypes.POINTER(_Args), cu.VP]
        lib.shade_args_bytes.restype = cu.CI
        if lib.shade_args_bytes() != ctypes.sizeof(_Args):
            raise RuntimeError(f"shade kernel takes {lib.shade_args_bytes()} bytes of "
                               f"arguments, the wrapper packs {ctypes.sizeof(_Args)}")
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _tensor(name, t, dtype, shape, dev) -> torch.Tensor:
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        got = (t.dtype, tuple(t.shape)) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"shade kernel: {name} must be {dtype} {shape}, got {got}")
    if t.device != dev:
        raise ValueError(f"shade kernel: {name} on {t.device}, the lanes on {dev}")
    return t


def pack(scene, t, kind, prim, inst, bu, bv, o, d):
    """The checked, packed arguments of one launch: (args, outputs, tensors
    the pointers point into). Nothing is launched."""
    dev = o.device
    n = o.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"shade kernel: {n} lanes overflow its int32 indices")
    lanes = dict(o=o, d=d, t=t, kind=kind, prim=prim, inst=inst, bu=bu, bv=bv)
    keep = [_tensor(name, lanes[name], dtype, (n,) if w is None else (n, w), dev).contiguous()
            for name, dtype, w in _LANES]
    sizes = {}
    for size, name in _SIZES.items():
        rows = getattr(scene, name).shape[0]
        if rows < 1:
            raise ValueError(f"shade kernel: scene.{name} has no rows")
        sizes[size] = rows
    for name, dtype, shape, size in _TABLES:
        x = _tensor(f"scene.{name}", getattr(scene, name), dtype,
                    (sizes[size],) + shape, dev)
        if not x.is_contiguous():
            raise ValueError(f"shade kernel: scene.{name} is not contiguous")
        keep.append(x)
    f32 = dict(dtype=F32, device=dev)
    out = (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
           torch.empty((n, 3), **f32), torch.empty((n,), dtype=I32, device=dev),
           torch.empty((n,), **f32), torch.empty((n,), dtype=I32, device=dev))
    args = _Args(n=n, **sizes)
    for (name, *_), x in zip(_LANES + _TABLES, keep):
        setattr(args, name, x.data_ptr())
    for name, x in zip(_OUT, out):
        setattr(args, name, x.data_ptr())
    return args, out, keep


def launch(scene, t, kind, prim, inst, bu, bv, o, d):
    """One launch of ops/traverse.shade_hits_plain's body on the hit record
    (t, kind, prim, inst, bu, bv) of the rays (o, d) over `scene`'s tables.
    Returns (pos, normal, albedo, shading, ior, obj_id), allocated here.
    The lanes are made contiguous (a no-op on the integrator's); the
    tables must be, and hold at least one row each, as SceneData's do.
    No lanes: empty outputs, and nothing launched or counted."""
    args, out, _keep = pack(scene, t, kind, prim, inst, bu, bv, o, d)
    if args.n == 0:
        return out
    lib, _ = library()
    cu.check(lib, "shade", lib.shade_hits(ctypes.byref(args), cu.stream_ptr(o)))
    LAUNCHES["shade"] += 1
    return out
