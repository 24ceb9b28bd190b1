"""The hit-shading kernel's own source (csrc/shade.cu), run on the CPU.

ops/cuda/host_check.py compiles it for the host with g++ (`-ffp-contract=off`,
a stub `cuda_runtime.h`); here that build is bound in place of the nvcc one
and driven through `ops/traverse.shade_hits_kernel` and the wrapper
(`ops/cuda/shade.launch`: ctypes argument layout, table checks, output
allocation) against the plain `ops/traverse.shade_hits_plain`, on the hit
records of the plain walk: the leaf-8 SAH Cornell box (primary and bounce
lanes, two-sided walls seen from both sides), a small terrain with its
mirror and lambert spheres, a SceneBuilder scene of textured, glass and
zero-kd spheres and textured two-sided grids in transformed instances, the
courtyard's OBJ textures, and that scene's records edited to what the
gathers clamp (prim and inst -1 or past their tables, kind 0 on a hit, t at
the hit limit, inf, NaN). Every output is equal bit for bit but the albedo
of a textured sphere, held to host_check.SHADE_RTOL / SHADE_ATOL because
PyTorch's CPU atan2 and acos are not the C library's to the last bit. On
the card chip_smoke.py holds the nvcc build to the plain body bit for bit."""

import dataclasses

import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.models.materials import SHADING_GLASS
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.cuda import host_check
from ilgpu_raytracing_tpu_torch.ops.cuda import shade as shade_kernel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build bound as the kernel library for this module only; the
    wrapper's library cache and launch count are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries((host_check.SHADE,),
                                     str(tmp_path_factory.mktemp("shade_host")))
    saved = (cu.load_kernel_library, cu.stream_ptr, dict(shade_kernel.LAUNCHES))
    shade_kernel._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        shade_kernel._state.clear()
        shade_kernel.LAUNCHES.update(saved[2])


def _covers(case, args, lanes):
    """The case reaches what it names."""
    hit = args["hit"]
    if case == "cornell":
        assert lanes["flipped"].any() and (lanes["tri"] & ~lanes["flipped"]).any()
        assert lanes["miss"].any()
    elif case == "terrain":
        assert set(hit.prim[lanes["sphere"]].tolist()) == {0, 1}  # mirror and lambert
    elif case == "builder":
        assert lanes["textured_sphere"].any() and (lanes["textured"] & lanes["tri"]).any()
        assert lanes["flipped"].any()
        assert (traverse.shade_hits_plain(**args).shading == SHADING_GLASS).any()
        moved = (args["scene"].inst_o2w != torch.eye(3, 4)).flatten(1).any(dim=1)
        assert (moved[hit.inst.clamp(min=0).long()] & ~lanes["miss"]).any()
    elif case == "courtyard":
        assert (lanes["textured"] & lanes["tri"]).any()
    else:
        on = ~lanes["miss"]
        for edited in (hit.prim == -1, hit.prim == 10 ** 6, hit.inst == -1, hit.inst == 99,
                       hit.kind == 0):
            assert (edited & on).any()
        assert torch.isnan(hit.t).any() and torch.isinf(hit.t).any()


@pytest.mark.parametrize("case", host_check.SHADE_CASES)
def test_host_built_shade_equals_the_plain_version(host, case):
    args = host.shade_case(case, 8)
    before = shade_kernel.LAUNCHES["shade"]
    diff = host.compare_shade(args)
    assert not any(diff.values()), diff
    assert shade_kernel.LAUNCHES["shade"] == before + 1
    _covers(case, args, host.shade_lanes(args))


def test_shade_hits_on_the_cpu_is_the_plain_body(host):
    """On CPU tensors `shade_hits` runs the plain body: no launch, the same
    surface."""
    args = host.shade_case("builder", 3)
    before = shade_kernel.LAUNCHES["shade"]
    got, want = traverse.shade_hits(**args), traverse.shade_hits_plain(**args)
    assert shade_kernel.LAUNCHES["shade"] == before
    for k in vars(want):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def _bad_dtype(a):
    a["o"] = a["o"].double()


def _bad_device(a):
    a["hit"] = dataclasses.replace(a["hit"], t=a["hit"].t.to("meta"))


def _bad_lanes(a):
    a["hit"] = dataclasses.replace(a["hit"], bu=a["hit"].bu[:-1])


def _bad_table(a):
    a["scene"] = dataclasses.replace(a["scene"], tri_mat=a["scene"].tri_mat.long())


def _strided_table(a):
    e1 = a["scene"].tri_e1
    a["scene"] = dataclasses.replace(a["scene"], tri_e1=torch.cat([e1, e1], 1)[:, :3])


@pytest.mark.parametrize("fault", [_bad_dtype, _bad_device, _bad_lanes, _bad_table,
                                   _strided_table], ids=lambda f: f.__name__[1:])
def test_shade_wrapper_refuses_before_launching(host, fault):
    """A float64 ray, a hit field on another device, lanes of another
    length, an int64 material table, a strided edge table: each raises, and
    nothing is launched."""
    args = host.shade_case("builder", 5)
    fault(args)
    before = shade_kernel.LAUNCHES["shade"]
    with pytest.raises(ValueError, match="shade kernel"):
        traverse.shade_hits_kernel(**args)
    assert shade_kernel.LAUNCHES["shade"] == before


def test_shade_wrapper_launches_nothing_on_no_lanes(host):
    """No lanes: empty outputs of the surface's dtypes, and no launch counted."""
    args = host.shade_case("builder", 5)
    args["o"], args["d"] = args["o"][:0], args["d"][:0]
    args["hit"] = dataclasses.replace(
        args["hit"], **{k: v[:0] for k, v in vars(args["hit"]).items()})
    before = shade_kernel.LAUNCHES["shade"]
    got, want = traverse.shade_hits_kernel(**args), traverse.shade_hits_plain(**args)
    assert shade_kernel.LAUNCHES["shade"] == before
    for k in vars(want):
        x, y = getattr(got, k), getattr(want, k)
        assert x.shape == y.shape and x.dtype == y.dtype, k
