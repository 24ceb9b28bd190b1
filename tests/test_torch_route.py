"""The trace-kernel route (ops/route.py) against the wrappers it routes to,
on the CPU with the port alone (the kernels' plain versions, no JAX).

One case per route -- the wide K1/K2, the streaming K4/K5, the binary K6
and the plain walk -- on an opaque scene (the small Cornell box) and an
alpha-cutout one (the courtyard), unsorted and sorted with each key that
`route.sort_key` picks from the config (octant, origin Morton, and on the
streaming route the destination treelet; the plain walk never sorts):

- `route.closest` and `route.any_hit` equal the direct unsorted wrapper
  calls bit for bit (a trace's per-lane result does not depend on the lane
  order, so the sorted dispatch restores exactly the unsorted result);
- a sorted dispatch sorts by the key's bounds, once a trace;
- on the alpha scene the route peels: its closest hits differ from the
  opaque kernel's.
"""

import functools

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene
from ilgpu_raytracing_tpu_torch.models.sponza_like import build_sponza_like_scene
from ilgpu_raytracing_tpu_torch.ops import alpha, route, sort, traverse
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, stream, wide

torch.set_num_threads(1)

N_RAYS = 1024
T_MAX = 3.0
FIELDS = ("t", "kind", "prim", "inst", "bu", "bv")

# route -> (prep, closest HitRecord wrapper, any-hit wrapper)
KERNELS = {
    "wide": (wide.prepare_scene, wide.trace_closest_wide, wide.shadow_occlusion_wide),
    "stream": (stream.prepare_stream, stream.trace_closest_stream,
               stream.shadow_occlusion_stream),
    "binary": (binary.prepare_binary, binary.trace_closest_binary,
               binary.shadow_occlusion_binary),
}
# key -> the config's sort settings
KEYS = {
    "unsorted": dict(sort_bounce_rays=False),
    "octant": dict(sort_origin_morton=False, sort_stream_treelet_key=False),
    "morton": dict(sort_stream_treelet_key=False),
    "treelet": dict(),
}
CASES = [(r, s, k) for r in KERNELS for s in ("opaque", "alpha")
         for k in ("unsorted", "octant", "morton") + (("treelet",) if r == "stream" else ())]
CASES += [("plain", s, k) for s in ("opaque", "alpha") for k in ("unsorted", "morton")]


@pytest.fixture(autouse=True)
def _inference_mode():
    with torch.inference_mode():
        yield


@pytest.fixture(scope="module")
def kscenes(tmp_path_factory):
    """(scene, kernel scene) of a route and surface, each made once."""
    scenes = {
        "opaque": build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                      device="cpu")[1],
        "alpha": build_sponza_like_scene(str(tmp_path_factory.mktemp("courtyard")),
                                         device="cpu")[1],
    }
    assert scenes["alpha"].has_alpha and not scenes["opaque"].has_alpha
    made = {}

    def get(route_name, surface):
        if (route_name, surface) not in made:
            scene = scenes[surface]
            ks = None if route_name == "plain" else KERNELS[route_name][0](scene)
            made[route_name, surface] = (scene, ks)
        return made[route_name, surface]

    return get


def _rays(scene, seed=3):
    """N_RAYS rays from inside the scene's bounds in random directions, 80%
    active."""
    rs = np.random.RandomState(seed)
    lo = torch.amin(scene.inst_bmin, dim=0).numpy()
    hi = torch.amax(scene.inst_bmax, dim=0).numpy()
    o = lo + (hi - lo) * rs.uniform(0.1, 0.9, (N_RAYS, 3))
    d = rs.normal(size=(N_RAYS, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.as_tensor(o.astype(np.float32)), torch.as_tensor(d.astype(np.float32)),
            torch.as_tensor(rs.rand(N_RAYS) < 0.8))


def _kind(morton, treelet):
    if treelet is not None:
        return "treelet"
    return "octant" if morton is None else "morton"


def _direct(route_name, scene, ks, o, d, act):
    """(closest HitRecord, occlusion) of the route's wrappers, unsorted."""
    if ks is None:
        return (traverse.trace_closest(scene, o, d, active=act),
                traverse.shadow_occlusion(scene, o, d, T_MAX, active=act))
    _, closest, any_hit = KERNELS[route_name]
    if not scene.has_alpha:
        return closest(ks, o, d, active=act), any_hit(ks, o, d, T_MAX, active=act)
    trace = functools.partial(closest, ks)
    return (alpha.trace_closest_peel(trace, scene, o, d, act),
            alpha.shadow_occlusion_peel(trace, scene, o, d, T_MAX, act))


@pytest.mark.parametrize("route_name,surface,key", CASES,
                         ids=["-".join(c) for c in CASES])
def test_route_equals_the_direct_wrapper_calls(kscenes, monkeypatch, route_name, surface,
                                               key):
    scene, ks = kscenes(route_name, surface)
    o, d, act = _rays(scene)
    sk = route.sort_key(scene, ks, RenderConfig(**KEYS[key]))
    want_kind = None if route_name == "plain" or key == "unsorted" else key
    assert (None if sk is None else _kind(sk.morton, sk.treelet)) == want_kind

    kinds = []
    real = sort._ray_perm

    def spy(o_, d_, active, morton_bounds, treelet_bounds=None):
        kinds.append(_kind(morton_bounds, treelet_bounds))
        return real(o_, d_, active, morton_bounds, treelet_bounds)

    monkeypatch.setattr(sort, "_ray_perm", spy)
    got = route.closest(scene, ks, o, d, active=act, sort=sk)
    occ = route.any_hit(scene, ks, o, d, T_MAX, active=act, sort=sk)
    assert kinds == ([want_kind] * 2 if want_kind else [])

    want, want_occ = _direct(route_name, scene, ks, o, d, act)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(occ, want_occ)
    assert int(want.hit.sum()) > N_RAYS // 10
    assert 0 < int(want_occ.sum()) < int(act.sum())
    if surface == "alpha" and ks is not None:
        opaque = KERNELS[route_name][1](ks, o, d, active=act)
        assert not torch.equal(opaque.t, want.t)
