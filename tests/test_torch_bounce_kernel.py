"""The bounce kernels' own source (csrc/bounce.cu), run on the CPU.

ops/cuda/host_check.py compiles it for the host with g++ (`-ffp-contract=off`,
a stub `cuda_runtime.h`); here that build is bound in place of the nvcc one
and driven through `ops/integrator.scatter_kernel` and `resolve_kernel` and
the wrapper (`ops/cuda/bounce.py`: ctypes argument layout, input checks,
output allocation) against the plain `scatter_plain` and `resolve_plain`, on
every call of a recorded CPU frame (the leaf-8 Cornell box, a small terrain,
the six default spheres with glass, mirror and lambert, with and without
visibility-ray roulette, the deferred shadow queue, the Cornell box with the
bounce-0 sun trace not deduplicated, the alpha courtyard
whose final bounce keeps the closest hit) and on seeded lanes that reach the
branches' corners (total internal reflection, zero-albedo glass, ior 0 and
-1, dead lanes, the bounce-0 sun substitution with exact and stale wi, the
bounce at `rr_start_depth`, hits at the hit limit). Every output is equal
bit for bit, the RNG state included, but `scatter`'s new_dir, ray_o and
sky_w, held to host_check.BOUNCE_RTOL / BOUNCE_ATOL because PyTorch's CPU
sqrt, rsqrt, cos and sin are not the C library's to the last bit. On the
card chip_smoke.py holds the nvcc build to the plain bodies bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene, cornell_camera
from ilgpu_raytracing_tpu_torch.models.materials import (
    SHADING_GLASS,
    SHADING_LAMBERT,
    SHADING_MIRROR,
)
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import integrator
from ilgpu_raytracing_tpu_torch.ops.cuda import bounce as bounce_kernel
from ilgpu_raytracing_tpu_torch.ops.cuda import host_check
from ilgpu_raytracing_tpu_torch.ops.intersect import T_HIT_MAX
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer
from ilgpu_raytracing_tpu_torch.utils import vec

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build bound as the kernel library for this module only; the
    wrapper's library cache and launch counts are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries((host_check.BOUNCE,),
                                     str(tmp_path_factory.mktemp("bounce_host")))
    saved = (cu.load_kernel_library, cu.stream_ptr, dict(bounce_kernel.LAUNCHES))
    bounce_kernel._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        bounce_kernel._state.clear()
        bounce_kernel.LAUNCHES.update(saved[2])


def _covers(case, calls):
    """The case reaches what it names."""
    scatters = [a for k, a in calls if k == "scatter"]
    resolves = [a for k, a in calls if k == "resolve"]
    assert len(scatters) == len(resolves)
    lanes, cfg = scatters[0][0], scatters[0][4]
    alive = lanes.alive
    if case.startswith("edges"):
        assert scatters[0][5] == cfg.rr_start_depth and scatters[0][7] is not None
        glass = alive & (lanes.shade == SHADING_GLASS)
        outside = vec.dot(lanes.view, lanes.nrm) < 0.0
        n_use = torch.where(outside[:, None], lanes.nrm, -lanes.nrm)
        g_ior = torch.where(lanes.ior > 0, lanes.ior, 1.5)
        eta = torch.where(outside, 1.0 / g_ior, g_ior)
        cos_i = -vec.dot(lanes.view, n_use)
        tir = glass & (1.0 - eta * eta * (1.0 - cos_i * cos_i) < 0.0)
        assert tir.any() and (glass & (lanes.ior <= 0.0)).any()
        assert (glass & (lanes.alb == 0.0).all(dim=1)).any() and (~alive).any()
        sel, sun = scatters[0][3], scatters[0][8]
        on = sel["is_sun"] & sel["ok"] & alive
        same = (sel["wi"] == sun).all(dim=1)
        assert (on & same).any() and (on & ~same & (sel["wi"] - sun).abs().amax(1).lt(1e-6)).any()
        sc = integrator.scatter_plain(*scatters[0])
        assert (alive & (lanes.shade == SHADING_LAMBERT) & ~sc.trace_active).any()  # killed
        if case == "edges":
            assert (resolves[0][5].t == float(np.float32(T_HIT_MAX))).any()
        return
    assert len(scatters) == cfg.max_depth
    # with the sun's trace not deduplicated, bounce 0 hands the sun's
    # direction without its occlusion, and nothing is substituted
    assert (scatters[0][7] is None) == (case == "cornell_no_dedup") == (not cfg.dedup_sun_shadow)
    assert scatters[0][8] is not None
    assert all(a[7] is None for a in scatters[1:])
    final_scatter, final_resolve = scatters[-1], resolves[-1]
    if case == "alpha":
        assert not final_scatter[6] and final_resolve[5] is not None
    else:
        assert final_scatter[6] and final_resolve[5] is None
    if case == "deferred":
        assert all(a[3] is None for a in resolves) and final_resolve[4] is None
    else:
        assert all(a[3] is not None for a in resolves)
    if case.startswith("spheres"):
        assert (cfg.shadow_rr_lum == 0.0) == (case == "spheres_no_shadow_rr")
        shades = set(lanes.shade[alive].tolist())
        assert {SHADING_LAMBERT, SHADING_MIRROR, SHADING_GLASS} <= shades


@pytest.mark.parametrize("case", host_check.BOUNCE_CASES)
def test_host_built_bounce_equals_the_plain_body(host, case):
    calls = host.bounce_case(case, 9)
    before = dict(bounce_kernel.LAUNCHES)
    diff = [host.compare_bounce(kind, args) for kind, args in calls]
    assert not any(any(d.values()) for d in diff), diff
    half = len(calls) // 2
    assert bounce_kernel.LAUNCHES == {"scatter": before["scatter"] + half,
                                      "resolve": before["resolve"] + half}
    _covers(case, calls)


def test_bounce_on_the_cpu_is_the_plain_body(host):
    """On CPU tensors `scatter` and `resolve` run the plain bodies: no
    launch, the same lanes."""
    (_, s_args), (_, r_args) = host.bounce_case("edges", 3)
    before = dict(bounce_kernel.LAUNCHES)
    for fn, plain, args in ((integrator.scatter, integrator.scatter_plain, s_args),
                            (integrator.resolve, integrator.resolve_plain, r_args)):
        got, want = host.lane_fields(fn(*args)), host.lane_fields(plain(*args))
        assert got.keys() == want.keys()
        for k in want:
            assert torch.equal(got[k].view(torch.int8), want[k].view(torch.int8)), k
    assert bounce_kernel.LAUNCHES == before


@pytest.mark.parametrize("deferred", [False, True], ids=["inline", "deferred"])
def test_frame_through_the_host_build_launches_each_half_once_a_bounce(host, monkeypatch,
                                                                       deferred):
    """A Cornell frame with the kernels in the plain bodies' place: one
    `scatter` and one `resolve` launch a bounce, and the frame the plain
    bodies give, to the few-ulp drift of the CPU's sqrt, cos and sin."""
    scene = build_cornell_scene(tess=4, sphere_tess=(8, 12), device="cpu")[1]
    cfg = RenderConfig(spp=2, max_depth=3, deferred_shadows=deferred)

    def frame():
        r = Renderer(48, 32, cfg, scene, cornell_camera(48, 32), device="cpu")
        r.sun_azimuth, r.sun_elevation = 0.3, 0.6
        r.render()
        return r._last_aux["color"], float(r._last_aux["eff_rays"])

    want = frame()
    monkeypatch.setattr(integrator, "scatter", integrator.scatter_kernel)
    monkeypatch.setattr(integrator, "resolve", integrator.resolve_kernel)
    before = dict(bounce_kernel.LAUNCHES)
    got = frame()
    assert bounce_kernel.LAUNCHES == {"scatter": before["scatter"] + cfg.max_depth,
                                      "resolve": before["resolve"] + cfg.max_depth}
    near = torch.isclose(got[0], want[0], rtol=1e-3, atol=1e-3).all(dim=1)
    assert float(near.float().mean()) > 0.98
    assert abs(got[1] - want[1]) <= 0.01 * want[1]


def _scatter_launch(host, seed=5):
    """The wrapper's inputs and switches of the `edges` case's scatter call."""
    (_, args), _ = host.bounce_case("edges", seed)
    return integrator.scatter_launch_args(*args)


def _bad_dtype(t):
    t["pos"] = t["pos"].double()


def _bad_device(t):
    t["thr"] = t["thr"].to("meta")


def _bad_lanes(t):
    t["out_m"] = t["out_m"][:-1]


def _bad_state(t):
    t["state_rs"] = t["state_rs"].to(torch.int32)


def _missing(t):
    del t["contrib"]


def _sun_alone(t):
    t["sun_dir"] = None


@pytest.mark.parametrize("fault", [_bad_dtype, _bad_device, _bad_lanes, _bad_state,
                                   _missing, _sun_alone], ids=lambda f: f.__name__[1:])
def test_scatter_wrapper_refuses_before_launching(host, fault):
    """A float64 position, throughput on another device, ReSTIR's m one lane
    short, an int32 RNG state, no selection contribution, a sun occlusion
    without the sun's direction: each raises, and nothing is launched."""
    t, kw = _scatter_launch(host)
    fault(t)
    before = dict(bounce_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="bounce kernel"):
        bounce_kernel.scatter(t, **kw)
    assert bounce_kernel.LAUNCHES == before


def test_resolve_wrapper_refuses_a_closest_hit_without_its_surface(host):
    """`resolve` of a closest-hit bounce needs the hit and its surface; the
    sky test's lanes alone raise, and nothing is launched."""
    _, (_, r_args) = host.bounce_case("edges_final", 5)
    t, kw = integrator.resolve_launch_args(*r_args)
    before = dict(bounce_kernel.LAUNCHES)
    with pytest.raises(ValueError, match="bounce kernel: trace_active"):
        bounce_kernel.resolve(t, **{**kw, "sky": False})
    assert bounce_kernel.LAUNCHES == before
    assert bounce_kernel.resolve(t, **kw).keys() == {"li", "alive", "state"}


def test_bounce_wrappers_launch_nothing_on_no_lanes(host):
    """No lanes: empty outputs of the plain bodies' dtypes and shapes, and no
    launch counted."""
    (_, s_args), (_, r_args) = host.bounce_case("edges", 5)

    def empty(x):
        if isinstance(x, torch.Tensor):
            return x[:0] if x.dim() and x.shape[0] == 3000 else x
        if isinstance(x, dict):
            return {k: empty(v) for k, v in x.items()}
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{f.name: empty(getattr(x, f.name))
                                             for f in dataclasses.fields(x)})
        return x

    s_args, r_args = [empty(a) for a in s_args], [empty(a) for a in r_args]
    before = dict(bounce_kernel.LAUNCHES)
    for kind, args in (("scatter", s_args), ("resolve", r_args)):
        got = host.lane_fields(getattr(integrator, kind + "_kernel")(*args))
        want = host.lane_fields(getattr(integrator, kind + "_plain")(*args))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    assert bounce_kernel.LAUNCHES == before


@pytest.mark.parametrize("case", ["edges", "edges_final"])
def test_needed_bytes_is_a_lower_bound_on_every_byte(host, case):
    """`needed_bytes` lies between the outputs alone and every input and
    output once a lane, and a queued visibility ray's weight and mask are
    not charged."""
    for kind, args in host.bounce_case(case, 4):
        t, kw = getattr(integrator, kind + "_launch_args")(*args)
        _, out, keep = getattr(bounce_kernel, "pack_" + kind)(t, **kw)
        written = sum(x.numel() * x.element_size() for x in out.values())
        every = written + sum(x.numel() * x.element_size() for x in keep)
        nb = bounce_kernel.needed_bytes(kind, t, out)
        assert written < nb < every
        if kind == "resolve":
            n = args[0].pos.shape[0]
            queued = bounce_kernel.needed_bytes(kind, {**t, "shadow_occ": None}, out)
            assert nb - queued == n * (1 + 12)  # q_act and contrib_w
