"""The trace-kernel route: the one module that knows which kernel traces.

`prepare` gives a scene its kernel scene: the wide tables of K1/K2
(ops/cuda/wide.py) up to wide.MAX_TRIS triangles, rebuilt on the device
when the scene is a refit of the one the previous tables came from; the
streaming tables of K4/K5 (ops/cuda/stream.py) up to stream.MAX_TRIS;
above that the plain walk of ops/traverse.py on the CPU and a refusal on
CUDA. A caller may hand the integrator a BinaryScene (ops/cuda/binary.py)
instead, and every trace then runs K6.

`closest` and `any_hit` dispatch one batch of rays to the kernel scene's
kernels -- the plain walk without one -- and, given a `SortKey`
(`sort_key`), around K3's counting sort (ops/sort.py). On a scene with
alpha cutouts every trace peels around the route's closest-hit kernel
(ops/alpha.py); the plain walk tests the masks in its loop. Each wrapper
runs its CUDA kernel on CUDA tensors and its plain version on CPU tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from ilgpu_raytracing_tpu_torch.models.scene import SceneData
from ilgpu_raytracing_tpu_torch.ops import alpha as alpha_ops
from ilgpu_raytracing_tpu_torch.ops import sort as sort_mod
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.cuda import binary as binary_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import stream as stream_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import wide as wide_mod
from ilgpu_raytracing_tpu_torch.utils import telemetry

# the path each prep took to its kernel tables: a full prep, or the wide
# tables rebuilt from the last ones (wide.refit_tables)
SCENE_TABLES = telemetry.counter("scene_tables", prepared=0, refitted=0)


def prepare(scene: SceneData, prev=None, use_kernels: bool = True):
    """The kernel scene of `scene`, on its device: a WideScene up to
    wide.MAX_TRIS triangles (`prev`'s tables rebuilt when `scene` is a
    refit of the scene they came from), a StreamScene up to
    stream.MAX_TRIS; above that None (the plain walk) on the CPU, and a
    refusal on CUDA. With `use_kernels` off (RenderConfig.use_pallas_trace)
    None on the CPU and a refusal on CUDA. `SCENE_TABLES` counts the two
    paths to the tables."""
    on_cuda = scene.device.type == "cuda"
    if not use_kernels:
        if on_cuda:
            raise RuntimeError(
                "use_pallas_trace=False on a CUDA device would trace with "
                "the plain PyTorch walk instead of the kernels; render on "
                "the CPU for the plain path"
            )
        return None
    if wide_mod.supports_scene(scene):
        refit = wide_mod.refit_tables(prev, scene)
        if refit is not None:
            SCENE_TABLES["refitted"] += 1
            return refit
        kscene = wide_mod.prepare_scene(scene)
    elif stream_mod.supports_scene(scene):
        # large scenes: the streaming kernels (BASELINE config 5)
        kscene = stream_mod.prepare_stream(scene)
    elif on_cuda:
        raise RuntimeError(
            f"scene ({scene.n_tris} tris) exceeds every kernel's limit "
            f"(stream kernel caps at 4M triangles); the plain PyTorch "
            f"walk is not used on the card. Split the scene or reduce "
            f"triangle count."
        )
    else:
        return None
    SCENE_TABLES["prepared"] += 1
    return kscene


@dataclasses.dataclass(frozen=True)
class SortKey:
    """The key bounce batches are sorted by before a trace (ops/sort.py):
    the destination treelet over `treelet` boxes, else the origin Morton
    code over `morton` = (bmin, inv_ext), else (both None) the octant and
    liveness alone."""

    morton: tuple | None = None
    treelet: torch.Tensor | None = None


def sort_key(scene: SceneData, kscene, cfg) -> SortKey | None:
    """How the bounce batches of a frame are sorted, None when they are not
    (`cfg.sort_bounce_rays` off, or the plain walk, which never sorts).
    Streaming scenes take the destination-treelet key
    (`cfg.sort_stream_treelet_key`), the others the origin-Morton key
    (`cfg.sort_origin_morton`) quantized to the scene's instance bounds."""
    if not cfg.sort_bounce_rays or kscene is None:
        return None
    if cfg.sort_stream_treelet_key and isinstance(kscene, stream_mod.StreamScene):
        return SortKey(treelet=kscene.sortkey_bounds)
    if cfg.sort_origin_morton:
        bmin = torch.amin(scene.inst_bmin, dim=0)
        bmax = torch.amax(scene.inst_bmax, dim=0)
        return SortKey(morton=(bmin, 1.0 / torch.clamp(bmax - bmin, min=1e-6)))
    return SortKey()


def _kernels(kscene):
    """(closest, packed, any_hit) of the kernel scene's route: K6 for a
    BinaryScene, K4/K5 for a StreamScene, K1/K2 otherwise. `closest(ks, o,
    d, active)` returns a HitRecord; `packed` is None for K6, else the
    (packed closest, decode) pair of K1/K4's (t, pp) record. Looked up at
    each call, so a caller may wrap a module's wrapper."""
    if isinstance(kscene, binary_mod.BinaryScene):
        return (binary_mod.trace_closest_binary, None,
                binary_mod.shadow_occlusion_binary)
    if isinstance(kscene, stream_mod.StreamScene):
        return (stream_mod.trace_closest_stream,
                (stream_mod.trace_closest_stream_packed, stream_mod.decode_stream_hits),
                stream_mod.shadow_occlusion_stream)
    return (wide_mod.trace_closest_wide,
            (wide_mod.trace_closest_wide_packed, wide_mod.decode_wide_hits),
            wide_mod.shadow_occlusion_wide)


def closest(scene: SceneData, kscene, o, d, active=None, sort: SortKey | None = None):
    """Closest hits as a HitRecord: the kernel scene's closest-hit kernel
    (sorted around K3 when `sort` and `active` are given), the plain walk
    without a kernel scene. K6 and the alpha peel return a whole HitRecord,
    which the sort restores field by field; opaque K1/K4 return the packed
    record, restored as two fields and decoded in the caller's lane
    order."""
    if kscene is None:
        return traverse.trace_closest(scene, o, d, active=active)
    record, packed, _ = _kernels(kscene)
    sorted_ = sort is not None and active is not None
    if scene.has_alpha or packed is None:
        trace = functools.partial(record, kscene)
        if scene.has_alpha:
            trace = functools.partial(alpha_ops.trace_closest_peel, trace, scene)
        if sorted_:
            return sort_mod.sorted_closest(trace, o, d, active, sort.morton, sort.treelet)
        return trace(o, d, active)
    trace, decode = packed
    if sorted_:
        return sort_mod.sorted_closest_packed(
            lambda oo, dd, act: trace(kscene, oo, dd, active=act),
            lambda t, pp: decode(kscene, o, d, t, pp),
            o, d, active, sort.morton, sort.treelet,
        )
    t, pp = trace(kscene, o, d, active=active)
    return decode(kscene, o, d, t, pp)


def any_hit(scene: SceneData, kscene, o, d, t_max, active=None,
            sort: SortKey | None = None):
    """Occlusion within `t_max`, bool (N,): K2, K5 or K6 (sorted around K3
    when `sort` and `active` are given); on an alpha scene the any-hit
    band peeled around the closest-hit kernel; the plain walk without a
    kernel scene. The sorted path needs a scalar t_max (a per-lane limit
    would have to ride the permutation)."""
    if kscene is None:
        return traverse.shadow_occlusion(scene, o, d, t_max, active=active)
    record, _, shadow = _kernels(kscene)
    if scene.has_alpha:
        trace = functools.partial(record, kscene)

        def run(oo, dd, act):
            return alpha_ops.shadow_occlusion_peel(trace, scene, oo, dd, t_max, act)
    else:
        def run(oo, dd, act):
            return shadow(kscene, oo, dd, t_max, active=act)

    if sort is not None and active is not None:
        if not isinstance(t_max, (int, float)):
            raise ValueError("sorted shadow path requires a scalar t_max")
        return sort_mod.sorted_shadow(run, o, d, active, sort.morton, sort.treelet)
    return run(o, d, active)
