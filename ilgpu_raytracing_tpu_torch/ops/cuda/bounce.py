"""A bounce's lane updates in two launches (csrc/bounce.cu).

`ops/integrator.scatter` calls `scatter` for CUDA tensors, after ReSTIR:
the material branches, the visibility ray, the reservoir merge, the lambert
sample, Russian roulette and the scatter ray of every lane in one kernel;
`ops/integrator.resolve` calls `resolve` after the traces and hit shading:
the radiance the traces found, the carry moved to the hit surface and the
next bounce's glass draw. Together they replace about 400 PyTorch
operations a bounce. The plain bodies stay in ops/integrator.py
(`scatter_plain`, `resolve_plain`: the CPU path, and the definitions the
kernels are held to: bit for bit on the card in chip_smoke.py, through the
host build on the CPU in tests/test_torch_bounce_kernel.py).

Each call takes its lanes as a dict of named tensors (the `_SCATTER_IN`,
`_RESOLVE_IN` names) and returns its outputs as one, all allocated here.
Nothing is copied to or from the host; a case the kernels do not take
raises ValueError before the launch, with no fall-back to the plain bodies
on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.intersect import T_HIT_MAX
from ilgpu_raytracing_tpu_torch.utils import telemetry

LAUNCHES = telemetry.counter("launches.bounce", scatter=0, resolve=0)

_state: dict[str, object] = {}

F32, I32, I64, BOOL = torch.float32, torch.int32, torch.int64, torch.bool
_F3 = ctypes.c_float * 3

# ops/integrator.PathLanes's lane fields, reservoir fields and the fields
# `resolve` moves to the hit surface
LANE_FIELDS = ("pos", "nrm", "alb", "shade", "ior", "thr", "li", "alive", "view", "state",
               "wrote")
RES_FIELDS = ("L", "wi", "pdf", "w", "w_sum", "m", "light_id", "W")
CARRY_FIELDS = ("pos", "nrm", "alb", "shade", "ior", "view")

# name, dtype, row width (None: one value a lane)
_LANE = {"pos": (F32, 3), "nrm": (F32, 3), "alb": (F32, 3), "shade": (I32, None),
         "ior": (F32, None), "thr": (F32, 3), "li": (F32, 3), "alive": (BOOL, None),
         "view": (F32, 3), "state": (I64, None), "wrote": (BOOL, None)}
_RES = {"L": (F32, 3), "wi": (F32, 3), "pdf": (F32, None), "w": (F32, None),
        "w_sum": (F32, None), "m": (I32, None), "light_id": (I32, None), "W": (F32, None)}
_SCATTER_IN = (tuple((k, *_LANE[k]) for k in LANE_FIELDS)
               + tuple(("cur_" + k, *v) for k, v in _RES.items())
               + (("state_rs", I64, None),)
               + tuple(("out_" + k, *v) for k, v in _RES.items())
               + (("ok", BOOL, None), ("sel_wi", F32, 3), ("contrib", F32, 3),
                  ("is_sun", BOOL, None)))
_SCATTER_OUT = ((("li", F32, 3), ("shadow_o", F32, 3), ("contrib_w", F32, 3),
                 ("q_act", BOOL, None))
                + tuple(("res_" + k, *v) for k, v in _RES.items())
                + (("wrote", BOOL, None), ("new_dir", F32, 3), ("ray_o", F32, 3),
                   ("thr", F32, 3), ("trace_active", BOOL, None), ("state", I64, None)))
_SKY_OUT = (("sky_w", F32, 3), ("sky_act", BOOL, None))
_SCATTER_NAMES = tuple(name for name, *_ in _SCATTER_IN)
_RESOLVE_IN = (("li", F32, 3), ("q_act", BOOL, None), ("contrib_w", F32, 3),
               ("state", I64, None), ("shadow_occ", BOOL, None), ("sky_w", F32, 3),
               ("sky_act", BOOL, None), ("sky_occ", BOOL, None),
               ("trace_active", BOOL, None), ("thr", F32, 3), ("new_dir", F32, 3),
               ("hit_t", F32, None), ("surf_pos", F32, 3), ("surf_nrm", F32, 3),
               ("surf_alb", F32, 3), ("surf_shade", I32, None), ("surf_ior", F32, None)
               ) + tuple((k, *_LANE[k]) for k in CARRY_FIELDS)
# the inputs each mode of `resolve` reads; `shadow_occ` and `sky_occ` may be None
_RESOLVE_SKY = ("li", "q_act", "contrib_w", "state", "shadow_occ", "sky_w", "sky_act",
                "sky_occ")
_RESOLVE_HIT = ("li", "q_act", "contrib_w", "state", "shadow_occ", "trace_active", "thr",
                "new_dir", "hit_t", "surf_pos", "surf_nrm", "surf_alb", "surf_shade",
                "surf_ior") + CARRY_FIELDS
_OPTIONAL = ("shadow_occ", "sky_occ")
_RESOLVE_OUT = (("li", F32, 3), ("alive", BOOL, None), ("state", I64, None)) + tuple(
    (k, *_LANE[k]) for k in CARRY_FIELDS)

# The inputs a lane of csrc/bounce.cu may not read, for `needed_bytes`: of
# each pair (a select) a lane reads one side; an input of `_WITH` only where
# the input it names is given (a queued shadow or sky ray reads neither); a
# `_MASKED` one only behind a mask. Every other input given is read once a
# lane.
_SELECTS = {"scatter": tuple(("out_" + k, "cur_" + k) for k in RES_FIELDS),
            "resolve": tuple(("surf_" + k, k) for k in CARRY_FIELDS if k != "view")}
_WITH = {"scatter": {"is_sun": "sun_occ"},
         "resolve": {"q_act": "shadow_occ", "contrib_w": "shadow_occ", "sky_w": "sky_occ",
                     "sky_act": "sky_occ"}}
_MASKED = {"scatter": (), "resolve": ("shadow_occ", "view")}


class _ScatterArgs(ctypes.Structure):
    """csrc/bounce.cu's `ScatterArgs`, field for field."""

    _fields_ = ([(name, cu.VP) for name, *_ in _SCATTER_IN]
                + [("sun_occ", cu.VP), ("sun_dir", cu.VP)]
                + [("o_" + name, cu.VP) for name, *_ in _SCATTER_OUT + _SKY_OUT]
                + [(f, cu.CI) for f in ("n", "rr_on", "vis_rr", "sky")]
                + [(f, ctypes.c_float) for f in ("eps_n", "inv_lum", "pmin", "rr_lo",
                                                 "rr_hi")]
                + [("sky_top", _F3), ("sky_bottom", _F3)])


class _ResolveArgs(ctypes.Structure):
    """csrc/bounce.cu's `ResolveArgs`, field for field."""

    _fields_ = ([(name, cu.VP) for name, *_ in _RESOLVE_IN]
                + [("o_" + name, cu.VP) for name, *_ in _RESOLVE_OUT]
                + [("n", cu.CI), ("sky", cu.CI), ("hit_max", ctypes.c_float)]
                + [("sky_top", _F3), ("sky_bottom", _F3)])


def library():
    """(CDLL, build seconds) of csrc/bounce.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("bounce")
        for fn, args in (("scatter", _ScatterArgs), ("resolve", _ResolveArgs)):
            entry = getattr(lib, "bounce_" + fn)
            entry.restype = cu.CI
            entry.argtypes = [ctypes.POINTER(args), cu.VP]
            size = getattr(lib, f"bounce_{fn}_args_bytes")
            size.restype = cu.CI
            if size() != ctypes.sizeof(args):
                raise RuntimeError(f"bounce kernel {fn} takes {size()} bytes of arguments, "
                                   f"the wrapper packs {ctypes.sizeof(args)}")
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _f3(v) -> ctypes.Array:
    return _F3(*(float(x) for x in np.asarray(v, dtype=np.float32).reshape(3)))


def _lanes(name, t, n, dtype, width, dev) -> torch.Tensor:
    shape = (n,) if width is None else (n, width)
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        got = (t.dtype, tuple(t.shape)) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"bounce kernel: {name} must be {dtype} {shape}, got {got}")
    if t.device != dev:
        raise ValueError(f"bounce kernel: {name} on {t.device}, the lanes on {dev}")
    return t.contiguous()


def _pack(args, specs, t: dict, names, n: int, dev) -> list:
    """Check the inputs `names` of `specs` in `t` (a missing one raises)
    and point `args` at them; returns the tensors pointed into. A name of
    `_OPTIONAL` may be None (a null pointer)."""
    keep = []
    for name, dtype, width in specs:
        if name not in names or (name in _OPTIONAL and t.get(name) is None):
            continue
        x = _lanes(name, t.get(name), n, dtype, width, dev)
        setattr(args, name, x.data_ptr())
        keep.append(x)
    return keep


def _outputs(args, specs, n: int, dev) -> dict:
    out = {name: torch.empty((n,) if w is None else (n, w), dtype=dtype, device=dev)
           for name, dtype, w in specs}
    for name, x in out.items():
        setattr(args, "o_" + name, x.data_ptr())
    return out


def _count(n: int) -> int:
    if 3 * n >= 1 << 31:
        raise ValueError(f"bounce kernel: {n} lanes overflow its int32 indices")
    return n


def needed_bytes(kind: str, t: dict, out: dict) -> int:
    """A lower bound on the bytes one `kind` ("scatter" | "resolve") launch
    over the inputs `t` moves: its outputs `out` written once and its inputs
    read once a lane, but of a `_SELECTS` pair one side, an input of `_WITH`
    only with the input it names, and a `_MASKED` one not at all."""
    n = next(iter(out.values())).shape[0]
    skip = set(_MASKED[kind]) | {b for _, b in _SELECTS[kind]}
    need = _WITH[kind]
    nb = sum(x.numel() * x.element_size() for x in out.values())
    for name, dtype, width in _SCATTER_IN if kind == "scatter" else _RESOLVE_IN:
        if name in skip or t.get(name) is None or t.get(need.get(name, name)) is None:
            continue
        nb += n * torch.empty((), dtype=dtype).element_size() * (width or 1)
    return nb


def pack_scatter(t: dict, sky: bool, rr_on: bool, vis_rr: bool, eps_n: float,
                 inv_lum: float, pmin: float, rr_lo: float, rr_hi: float, sky_top,
                 sky_bottom):
    """The checked, packed arguments of one `scatter` launch: (args,
    outputs, tensors the pointers point into). Nothing is launched."""
    pos = t.get("pos")
    if not isinstance(pos, torch.Tensor):
        raise ValueError(f"bounce kernel: pos must be a tensor, got {type(pos)}")
    dev, n = pos.device, _count(pos.shape[0])
    args = _ScatterArgs(n=n, rr_on=int(bool(rr_on)), vis_rr=int(bool(vis_rr)),
                        sky=int(bool(sky)), eps_n=eps_n, inv_lum=inv_lum, pmin=pmin,
                        rr_lo=rr_lo, rr_hi=rr_hi, sky_top=_f3(sky_top),
                        sky_bottom=_f3(sky_bottom))
    keep = _pack(args, _SCATTER_IN, t, _SCATTER_NAMES, n, dev)
    if (t.get("sun_occ") is None) != (t.get("sun_dir") is None):
        raise ValueError("bounce kernel: sun_occ and sun_dir come together")
    if t.get("sun_occ") is not None:
        keep.append(_lanes("sun_occ", t["sun_occ"], n, BOOL, None, dev))
        keep.append(_lanes("sun_dir", t["sun_dir"].reshape(-1), 3, F32, None, dev))
        args.sun_occ, args.sun_dir = keep[-2].data_ptr(), keep[-1].data_ptr()
    out = _outputs(args, _SCATTER_OUT + (_SKY_OUT if sky else ()), n, dev)
    return args, out, keep


def scatter(t: dict, sky: bool, rr_on: bool, vis_rr: bool, eps_n: float, inv_lum: float,
            pmin: float, rr_lo: float, rr_hi: float, sky_top, sky_bottom) -> dict:
    """One launch of ops/integrator.scatter_plain's body on the lanes `t`
    (every `_SCATTER_IN` name; `sun_occ` and `sun_dir`, the bounce-0 sun's
    occlusion and direction, None on other bounces). Returns the
    `_SCATTER_OUT` tensors by name, with `sky_w` and `sky_act` when `sky`.
    No lanes: empty outputs, and nothing launched or counted."""
    args, out, _keep = pack_scatter(t, sky, rr_on, vis_rr, eps_n, inv_lum, pmin, rr_lo,
                                    rr_hi, sky_top, sky_bottom)
    if args.n == 0:
        return out
    lib, _ = library()
    cu.check(lib, "bounce", lib.bounce_scatter(ctypes.byref(args), cu.stream_ptr(t["pos"])))
    LAUNCHES["scatter"] += 1
    return out


def pack_resolve(t: dict, sky: bool, sky_top, sky_bottom):
    """The checked, packed arguments of one `resolve` launch: (args,
    outputs, tensors the pointers point into). Nothing is launched."""
    li = t.get("li")
    if not isinstance(li, torch.Tensor):
        raise ValueError(f"bounce kernel: li must be a tensor, got {type(li)}")
    dev, n = li.device, _count(li.shape[0])
    args = _ResolveArgs(n=n, sky=int(bool(sky)), hit_max=float(np.float32(T_HIT_MAX)),
                        sky_top=_f3(sky_top), sky_bottom=_f3(sky_bottom))
    keep = _pack(args, _RESOLVE_IN, t, _RESOLVE_SKY if sky else _RESOLVE_HIT, n, dev)
    out = _outputs(args, _RESOLVE_OUT[:3] if sky else _RESOLVE_OUT, n, dev)
    return args, out, keep


def resolve(t: dict, sky: bool, sky_top, sky_bottom) -> dict:
    """One launch of ops/integrator.resolve_plain's body on the lanes `t`:
    with `sky` the final bounce's sky test (`_RESOLVE_SKY`), else a closest
    hit (`_RESOLVE_HIT`: the scatter trace's `hit_t`, the hit surface and
    the carry); `shadow_occ` and `sky_occ` None where those rays were
    queued. Returns li, alive and state, and without `sky` the carry's
    fields moved to the hit surface, by name. No lanes: empty outputs, and
    nothing launched or counted."""
    args, out, _keep = pack_resolve(t, sky, sky_top, sky_bottom)
    if args.n == 0:
        return out
    lib, _ = library()
    cu.check(lib, "bounce", lib.bounce_resolve(ctypes.byref(args), cu.stream_ptr(t["li"])))
    LAUNCHES["resolve"] += 1
    return out
