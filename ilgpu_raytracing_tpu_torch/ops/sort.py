"""Bounce-ray reordering for traversal coherence (port of ops/sort.py).

Rays are ordered by a stable counting sort over a small key -- (alive,
direction octant, 4-bit origin Morton code), 129 bins with every dead lane
in the tail bin -- so rays that walk the same part of the tree sit next to
each other. Streaming scenes take the destination-treelet key instead
(octant * T + the treelet box the ray enters first, 8T+2 bins). On the
card one launch of csrc/sortkey.cu computes the key; on the CPU the plain
PyTorch formulation below does. Per-lane trace results never depend on the
order; the sorted results are restored to the original lane order
afterwards.
"""

from __future__ import annotations

import dataclasses

import torch

from ilgpu_raytracing_tpu_torch.ops.cuda import sortkey, sortpos
from ilgpu_raytracing_tpu_torch.utils import telemetry

_BINS = 16


def _perm_from_key(key: torch.Tensor, bins: int = _BINS):
    """Stable counting-sort permutation for int keys in [0, bins).

    Returns (perm, pos): sorted[i] = orig[perm[i]]; pos[i] is element i's
    destination and doubles as the inverse permutation. The destinations
    come from K3 (ops/cuda/sortpos.py: the CUDA kernel on a CUDA tensor,
    its one-hot plain version on a CPU tensor)."""
    n = key.shape[0]
    pos = sortpos.counting_pos(key.to(torch.int32).contiguous(), bins)
    perm = torch.empty((n,), dtype=torch.int32, device=key.device)
    perm[pos.long()] = torch.arange(n, dtype=torch.int32, device=key.device)
    return perm, pos


def _morton4(o: torch.Tensor, bmin, inv_ext) -> torch.Tensor:
    """4-bit spatial code of the quantized ray origin: the scene-octant bits
    of all three axes plus the second-level bit of x. Origins outside the
    scene bounds clamp to the boundary cells."""
    q = torch.clamp(((o - bmin) * inv_ext) * 4.0, 0.0, 3.0).to(torch.int32)
    x, y, z = q[:, 0], q[:, 1], q[:, 2]
    return ((x & 2) << 2) | ((y & 2) << 1) | (z & 2) | (x & 1)


def _octant3(d: torch.Tensor) -> torch.Tensor:
    return (
        ((d[:, 0] > 0).to(torch.int32) << 2)
        | ((d[:, 1] > 0).to(torch.int32) << 1)
        | (d[:, 2] > 0).to(torch.int32)
    )


def octant_alive_key(d: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """4-bit key: dead lanes (bit 3) sort after all octants (bits 0-2)."""
    return torch.where(active, _octant3(d), 8)


def _slab_entry(bounds, o, d):
    """(N, T) slab entry t of each ray into each world-space AABB; +inf on
    a miss. Sort-key arithmetic only: the trace results never depend on it."""
    inv = 1.0 / torch.where(d != 0.0, d, torch.full_like(d, 1e-8))
    lo = torch.full((o.shape[0], bounds.shape[0]), 1e-4, dtype=torch.float32,
                    device=o.device)
    hi = torch.full_like(lo, float("inf"))
    for ax in range(3):
        t1 = (bounds[None, :, ax] - o[:, None, ax]) * inv[:, None, ax]
        t2 = (bounds[None, :, 3 + ax] - o[:, None, ax]) * inv[:, None, ax]
        lo = torch.maximum(lo, torch.minimum(t1, t2))
        hi = torch.minimum(hi, torch.maximum(t1, t2))
    return torch.where(hi >= lo, lo, torch.full_like(lo, float("inf")))


def _bins(morton_bounds, treelet_bounds) -> int:
    if treelet_bounds is not None:
        return 8 * treelet_bounds.shape[0] + 2
    return _BINS if morton_bounds is None else 129


def ray_key_plain(o, d, active, morton_bounds, treelet_bounds=None):
    """The int32 key `_ray_perm` sorts by (`_bins` bins).

    With `treelet_bounds` (a (T,6) world-space box table,
    models/bvh.cut_scene_treelets) the key is octant*T + the treelet whose
    slab entry comes first; live rays that miss every box go to bin 8T,
    dead lanes to bin 8T+1. Otherwise, with `morton_bounds` = (bmin,
    inv_ext) the key is octant*16 + morton4 for live lanes and 128 for
    every dead lane (129 bins); without either, the 16-bin octant/alive
    key. The CPU path, and the definition that csrc/sortkey.cu is held to
    bit for bit."""
    if treelet_bounds is not None:
        t_lo = _slab_entry(treelet_bounds, o, d)
        tid = torch.argmin(t_lo, dim=1).to(torch.int32)
        covered = torch.isfinite(torch.amin(t_lo, dim=1))
        groups = 8 * treelet_bounds.shape[0]
        key = torch.where(covered, _octant3(d) * treelet_bounds.shape[0] + tid,
                          groups)
        return torch.where(active, key, groups + 1)
    if morton_bounds is None:
        return octant_alive_key(d, active)
    bmin, inv_ext = morton_bounds
    return torch.where(active, _octant3(d) * 16 + _morton4(o, bmin, inv_ext), 128)


def _ray_perm(o, d, active, morton_bounds, treelet_bounds=None):
    """(perm, pos) ordering rays by (alive, octant[, origin morton |
    destination treelet]): `ray_key_plain`'s key, computed on CUDA tensors
    by one launch of csrc/sortkey.cu (ops/cuda/sortkey.py), sorted by K3."""
    key_fn = sortkey.ray_key if o.device.type == "cuda" else ray_key_plain
    return _perm_from_key(key_fn(o, d, active, morton_bounds, treelet_bounds),
                          _bins(morton_bounds, treelet_bounds))


def _sort_trace_restore(fn, o, d, active, morton_bounds, treelet_bounds):
    """fn(o, d, active) on the rays ordered by `_ray_perm`, its result -- a
    tensor, a tuple of tensors or a dataclass of tensors -- restored to the
    original lane order, each tensor by its own gather. Live lanes sort
    before every dead one, so the sorted active mask is iota < n_alive."""
    perm, pos = _ray_perm(o, d, active, morton_bounds, treelet_bounds)
    n_alive = torch.sum(active.to(torch.int32))
    act_s = torch.arange(o.shape[0], dtype=torch.int32, device=o.device) < n_alive
    pl = perm.long()
    out = fn(o[pl], d[pl], act_s)
    pos_l = pos.long()
    if isinstance(out, torch.Tensor):
        return out[pos_l]
    if isinstance(out, tuple):
        return tuple(x[pos_l] for x in out)
    return dataclasses.replace(
        out, **{f.name: getattr(out, f.name)[pos_l] for f in dataclasses.fields(out)})


@telemetry.spanned("sort")
def sorted_closest(trace_fn, o, d, active, morton_bounds=None, treelet_bounds=None):
    """trace_fn(o, d, active) -> HitRecord on sorted rays (K6 and the alpha
    peel); every field is restored to the original lane order."""
    return _sort_trace_restore(trace_fn, o, d, active, morton_bounds, treelet_bounds)


@telemetry.spanned("sort")
def sorted_closest_packed(trace_fn, decode_fn, o, d, active, morton_bounds=None,
                          treelet_bounds=None):
    """trace_fn(o, d, active) -> packed (t, pp) on sorted rays; the two
    fields are restored to original lane order and decode_fn(t, pp) runs
    there (against the caller's original-order o/d)."""
    return decode_fn(*_sort_trace_restore(trace_fn, o, d, active, morton_bounds,
                                          treelet_bounds))


@telemetry.spanned("sort")
def sorted_shadow(shadow_fn, o, d, active, morton_bounds=None,
                  treelet_bounds=None):
    """shadow_fn(o, d, active) -> (N,) bool on sorted rays, restored."""
    return _sort_trace_restore(shadow_fn, o, d, active, morton_bounds, treelet_bounds)
