"""The bounce-ray sort key in one launch (csrc/sortkey.cu).

`ops/sort._ray_perm` calls `ray_key` for CUDA tensors: each ray's key
(destination treelet, origin Morton code or octant, by what the call is
given) computed in one thread, in place of the plain formulation's PyTorch
operations, which for the treelet key build and reduce an (N, T) float
table. `ops/sort.ray_key_plain` stays the CPU path and the definition the
kernel is held to: bit for bit on the card in chip_smoke.py, through the
host build on the CPU in tests/test_torch_sortkey_kernel.py.

The CUDA path does not synchronize with the host; a case the kernel does
not take raises before the launch, with no fall-back to the plain key.
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.utils import telemetry

MODES = {"octant": 0, "morton": 1, "treelet": 2}

LAUNCHES = telemetry.counter("launches.sortkey", treelet=0, morton=0, octant=0)

_state: dict[str, object] = {}


def library():
    """(CDLL, build seconds) of csrc/sortkey.cu, built at first use."""
    if "lib" not in _state:
        lib, seconds = cu.load_kernel_library("sortkey")
        lib.sortkey_key.restype = cu.CI
        lib.sortkey_key.argtypes = [cu.VP, cu.VP, cu.VP, cu.VP, cu.CI, cu.VP, cu.VP, cu.VP,
                                    cu.CI, cu.CI, cu.VP]
        _state["lib"] = lib
        return lib, seconds
    return _state["lib"], 0.0


def _rows(name, t, dev, shape, dtype=torch.float32):
    if not isinstance(t, torch.Tensor) or t.dtype != dtype or tuple(t.shape) != shape:
        got = (t.dtype, tuple(t.shape)) if isinstance(t, torch.Tensor) else type(t)
        raise ValueError(f"sortkey kernel: {name} must be {dtype} {shape}, got {got}")
    if t.device != dev:
        raise ValueError(f"sortkey kernel: {name} on {t.device}, the rays on {dev}")
    return t.contiguous()


def ray_key(o, d, active, morton_bounds=None, treelet_bounds=None):
    """`ops/sort.ray_key_plain` of the same arguments, an int32 (N,) tensor
    allocated here: the treelet variant with `treelet_bounds` (a (T, 6)
    float32 box table, T >= 1), else the Morton one with `morton_bounds` =
    (bmin, inv_ext) (3 float32 each), else the octant/alive key."""
    dev = o.device
    n = o.shape[0]
    if n >= 1 << 31:
        raise ValueError(f"sortkey kernel: {n} rays overflow its int32 indices")
    o = _rows("o", o, dev, (n, 3))
    d = _rows("d", d, dev, (n, 3))
    active = _rows("active", active, dev, (n,), torch.bool)
    boxes = bmin = inv_ext = None
    n_boxes = 0
    if treelet_bounds is not None:
        n_boxes = treelet_bounds.shape[0]
        if n_boxes < 1:
            raise ValueError("sortkey kernel: an empty box table")
        boxes = _rows("treelet_bounds", treelet_bounds, dev, (n_boxes, 6))
        mode = "treelet"
    elif morton_bounds is not None:
        bmin, inv_ext = (_rows(name, t, dev, (3,)) for name, t in
                         zip(("bmin", "inv_ext"), morton_bounds))
        mode = "morton"
    else:
        mode = "octant"
    return _launch(mode, o, d, active, boxes, n_boxes, bmin, inv_ext)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(mode, o, d, active, boxes, n_boxes, bmin, inv_ext) -> torch.Tensor:
    lib, _ = library()
    n = o.shape[0]
    key = torch.empty((n,), dtype=torch.int32, device=o.device)
    err = lib.sortkey_key(o.data_ptr(), d.data_ptr(), active.data_ptr(), _ptr(boxes),
                          n_boxes, _ptr(bmin), _ptr(inv_ext), key.data_ptr(), n,
                          MODES[mode], cu.stream_ptr(o))
    cu.check(lib, "sortkey", err)
    LAUNCHES[mode] += 1
    return key
