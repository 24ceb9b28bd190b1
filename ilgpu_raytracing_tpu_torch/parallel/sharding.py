"""Image-space data parallelism over a device mesh (port of
`parallel/sharding.py`).

One process drives a mesh of devices with one axis, `"px"`:

* every flat per-pixel array (G-buffer, reservoirs, TAA history,
  accumulation, framebuffer) is split on its leading axis into
  `mesh.size` equal contiguous blocks, block k on `mesh.devices[k]`
  (`shard_pixels`, a `PixelShards` value);
* the scene and its kernel tables are replicated, one copy on each
  distinct device (`replicate`);
* device k runs the whole frame step for its own pixel block. The only
  cross-block traffic is ReSTIR's temporal and spatial taps and TAAU's
  low-res taps, which read the full-image G-buffer, `res_prev` and packed
  low-res frame: `PixelShards.gather(device)` (a `torch.cat` of the blocks
  moved to one device) is the port's all-gather, and the final frame and
  low-res colour are gathered onto the renderer's device.

Pixel counts must divide the mesh size (`check_divisible`,
`divisible_internal_resolution`).

A device may repeat in a mesh: `make_mesh(devices=[torch.device("cpu")] *
8)` or `[torch.device("cuda:0")] * 4` is a simulated mesh, the analog of
XLA's `xla_force_host_platform_device_count`. It runs the split, the
gathers and the per-block launches on one device, so it checks that the
split frame equals the single-device frame; it measures nothing about
scaling across devices.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses

import torch

from ilgpu_raytracing_tpu_torch.utils import telemetry

# Bytes that `PixelShards.gather` copied into a whole ("copied": a one-block
# gather on its own device copies nothing) and, of those, the bytes of
# blocks that lived on another device than the target ("moved").
GATHER_BYTES = telemetry.counter("gather_bytes", copied=0, moved=0)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh; `devices` may repeat a device."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("px",)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct_devices(self) -> tuple[torch.device, ...]:
        return tuple(dict.fromkeys(self.devices))


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a value lies on a mesh: split on the leading axis over `axis`
    ("px"), or one copy on each device (`axis` None)."""

    mesh: Mesh
    axis: str | None


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"make_mesh: unsupported device {d}")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"make_mesh: {d} requested and CUDA is not available")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        if d.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"make_mesh: {d} requested, {torch.cuda.device_count()} CUDA devices")
    return d


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """The first `n_devices` CUDA devices (all when None), or the given
    `devices` (cut to `n_devices`; a CPU mesh is `devices=[cpu] * n`), as a
    mesh with axis "px". A mesh is never moved to the CPU: CUDA devices
    that do not exist raise, and so does a mesh whose devices mix types."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available")
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 1 <= n <= count:
            raise RuntimeError(f"make_mesh: {n} devices requested, {count} CUDA devices")
        devices = [torch.device("cuda", i) for i in range(n)]
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    if not devices:
        raise ValueError("make_mesh: no devices")
    if len({torch.device(d).type for d in devices}) > 1:
        raise ValueError(f"make_mesh: devices of mixed types {devices}")
    return Mesh(tuple(_device(d) for d in devices))


def pixel_sharding(mesh: Mesh) -> Placement:
    """Leading-axis split over "px" for flat per-pixel arrays."""
    return Placement(mesh, "px")


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, None)


def device_scope(device: torch.device):
    """Make `device` CUDA's current device (the hand-written kernels launch
    on the current device, on PyTorch's current stream there); nothing on
    the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def block_slices(n: int, mesh: Mesh) -> list[slice]:
    """The `mesh.size` equal contiguous blocks of n rows."""
    check_divisible(n, mesh)
    m = n // mesh.size
    return [slice(k * m, (k + 1) * m) for k in range(mesh.size)]


def _map_tensors(tree, fn):
    """fn(tree) for a tensor; for a dataclass a shallow copy with fn on
    every tensor field (nested dataclasses included); other values as
    they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = copy.copy(tree)
        for f in dataclasses.fields(tree):
            object.__setattr__(out, f.name, _map_tensors(getattr(tree, f.name), fn))
        return out
    return tree


def to_device(tree, device):
    """A tensor, or a copy of a dataclass of tensors, on `device`."""
    return _map_tensors(tree, lambda x: x.to(device))


def device_of(tree):
    """The device of a tensor, or of a dataclass's first tensor field; None
    for anything else (the plain tracer's kernel scene, None)."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return next((v.device for v in vars(tree).values()
                     if isinstance(v, torch.Tensor)), None)
    return None


def _n_rows(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.shape[0]
    return next(v.shape[0] for v in vars(tree).values() if isinstance(v, torch.Tensor))


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _cat(parts: list[torch.Tensor], device) -> torch.Tensor:
    GATHER_BYTES["moved"] += sum(_nbytes(p) for p in parts if p.device != device)
    if len(parts) == 1:
        if parts[0].device != device:
            GATHER_BYTES["copied"] += _nbytes(parts[0])
        return parts[0].to(device)
    GATHER_BYTES["copied"] += sum(_nbytes(p) for p in parts)
    return torch.cat([p.to(device) for p in parts])


@dataclasses.dataclass
class PixelShards:
    """A per-pixel value split over a mesh: `blocks[k]` (a tensor, or a
    dataclass of tensors such as `Reservoirs` or `GBuffer`) holds rows
    `bounds[k]` of the whole on `mesh.devices[k]`."""

    placement: Placement
    blocks: tuple

    @property
    def mesh(self) -> Mesh:
        return self.placement.mesh

    @property
    def bounds(self) -> list[slice]:
        m = _n_rows(self.blocks[0])
        return [slice(k * m, (k + 1) * m) for k in range(len(self.blocks))]

    def gather(self, device):
        """The whole value on `device` (the port's all-gather)."""
        device = torch.device(device)
        b0 = self.blocks[0]
        if isinstance(b0, torch.Tensor):
            return _cat(list(self.blocks), device)
        out = copy.copy(b0)
        for f in dataclasses.fields(b0):
            if isinstance(getattr(b0, f.name), torch.Tensor):
                object.__setattr__(out, f.name, _cat(
                    [getattr(b, f.name) for b in self.blocks], device))
        return out


@dataclasses.dataclass
class Replicated:
    """One copy of a value on each distinct device of a mesh: `copies[k]`
    lies on `mesh.devices[k]`, the same object for a repeated device."""

    placement: Placement
    copies: tuple


def shard_pixels(mesh: Mesh, tree) -> PixelShards:
    """Split a tensor (or a dataclass of tensors) on its leading axis into
    `mesh.size` equal contiguous blocks, block k on `mesh.devices[k]`."""
    rows = block_slices(_n_rows(tree), mesh)
    return PixelShards(pixel_sharding(mesh), tuple(
        _map_tensors(tree, lambda x, r=r, d=d: x[r].to(d))
        for r, d in zip(rows, mesh.devices)))


def replicate(mesh: Mesh, tree) -> Replicated:
    """One copy of `tree` on each distinct device of the mesh."""
    copies = {d: to_device(tree, d) for d in mesh.distinct_devices}
    return Replicated(replicated(mesh), tuple(copies[d] for d in mesh.devices))


def shard_state(mesh: Mesh, state):
    """FrameState (any dataclass): per-pixel leaves (tensors with a leading
    axis, dataclasses of them) sharded, scalars (`taa_valid`,
    `accum_count`) kept as the host values every device reads."""

    def place(x):
        if (isinstance(x, torch.Tensor) and x.dim() >= 1) or dataclasses.is_dataclass(x):
            return shard_pixels(mesh, x)
        return x

    return dataclasses.replace(state, **{
        f.name: place(getattr(state, f.name)) for f in dataclasses.fields(state)})


def divisible_internal_resolution(cfg, out_w: int, out_h: int, n_devices: int):
    """Internal resolution adjusted so both pixel counts divide the mesh."""
    in_w, in_h = cfg.internal_resolution(out_w, out_h)
    in_h = max(n_devices, (in_h // n_devices) * n_devices)
    return in_w, in_h


def check_divisible(n_pixels: int, mesh: Mesh) -> None:
    n_dev = mesh.size
    if n_pixels % n_dev != 0:
        raise ValueError(
            f"pixel count {n_pixels} not divisible by mesh size {n_dev}; "
            "use divisible_internal_resolution / pad the image"
        )
