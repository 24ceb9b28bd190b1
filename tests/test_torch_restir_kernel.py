"""The ReSTIR kernel's own source (csrc/restir.cu), run on the CPU.

ops/cuda/host_check.py compiles it for the host with g++ (`-ffp-contract=off`,
a stub `cuda_runtime.h`); here that build is bound in place of the nvcc one
and driven through `ops/restir.restir_direct_kernel` and the wrapper
(`ops/cuda/restir.launch`: ctypes argument layout, output allocation) on
seeded inputs at 64x64 and 40x24, against the
plain `ops/restir.restir_direct`: both weighting modes, static reuse on and
off, one and two sample views in both lane layouts, a tenth of the lanes
inactive, every pixel of the image (so neighbours and reprojections fall
off its edges). Integer outputs are equal; floats are held to
host_check.RESTIR_RTOL / RESTIR_ATOL, because PyTorch's CPU sqrt, cos and
sin are not the C library's to the last bit. On the card chip_smoke.py
holds the nvcc build to the plain body bit for bit."""

import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import restir
from ilgpu_raytracing_tpu_torch.ops.cuda import host_check
from ilgpu_raytracing_tpu_torch.ops.cuda import restir as restir_kernel

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build bound as the kernel library for this module only; the
    wrapper's library cache and launch count are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries((host_check.RESTIR,),
                                     str(tmp_path_factory.mktemp("restir_host")))
    saved = (cu.load_kernel_library, cu.stream_ptr, dict(restir_kernel.LAUNCHES))
    restir_kernel._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        restir_kernel._state.clear()
        restir_kernel.LAUNCHES.update(saved[2])


@pytest.mark.parametrize("case", list(host_check.RESTIR_CASES))
def test_host_built_restir_equals_the_plain_version(host, case):
    args = host.restir_args(case, 11)
    before = restir_kernel.LAUNCHES["restir"]
    diff = host.compare_restir(args)
    assert not any(diff.values()), diff
    assert restir_kernel.LAUNCHES["restir"] == before + 1
    # the case exercises what it names: imports accepted with reuse, the
    # candidates alone without
    m = restir.restir_direct(**args)[1].m
    if args.get("static_reuse", True):
        assert int(m.max()) > 9
    else:
        assert int(m.max()) == 9


def _bad_reps(a):
    a["reps"] = 3


def _bad_rows(a):
    a["res_prev"] = a["res_prev"].map(lambda x: x[:-1])


def _bad_dtype(a):
    a["pos"] = a["pos"].double()


def _bad_mask(a):
    a["enable_spatial"] = a["enable_spatial"].to(torch.uint8)


@pytest.mark.parametrize("fault", [_bad_reps, _bad_rows, _bad_dtype, _bad_mask],
                         ids=lambda f: f.__name__[5:])
def test_restir_wrapper_refuses_before_launching(host, fault):
    """Lanes that are not whole sample views, previous reservoirs of another
    size than the image, a float64 input, a mask that is not bool: each
    raises, and nothing is launched."""
    args = host.restir_args("reps2_tiles", 3)
    fault(args)
    before = restir_kernel.LAUNCHES["restir"]
    with pytest.raises(ValueError, match="restir kernel"):
        restir.restir_direct_kernel(**args)
    assert restir_kernel.LAUNCHES["restir"] == before
