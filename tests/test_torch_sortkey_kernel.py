"""The sort-key kernel's own source (csrc/sortkey.cu), run on the CPU.

ops/cuda/host_check.py compiles it for the host with g++ (`-ffp-contract=off`,
a stub `cuda_runtime.h`); here that build is bound in place of the nvcc one
and driven through the wrapper (`ops/cuda/sortkey.ray_key`: argument checks,
ctypes call, key allocation, the launch count) against the plain
`ops/sort.ray_key_plain`, bit for bit: the treelet key on the boxes of the
small terrain (32) and of the six-instance sphere scene (6) and on a
hand-made table (two boxes entered at the same t, origins inside a box,
rays that miss every box), the Morton and the octant key on the Cornell
box; a tenth of the lanes inactive, zero, subnormal, NaN and inf
components. `_ray_perm` through the kernel gives the plain key's (perm,
pos). On the card chip_smoke.py holds the nvcc build to the plain key on a
terrain and a Cornell frame's sorted calls."""

import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops import sort
from ilgpu_raytracing_tpu_torch.ops.cuda import host_check, sortkey

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The host build bound as the kernel library for this module only; the
    wrapper's library cache and launch counts are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries((host_check.SORTKEY,),
                                     str(tmp_path_factory.mktemp("sortkey_host")))
    saved = (cu.load_kernel_library, cu.stream_ptr, dict(sortkey.LAUNCHES))
    sortkey._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        sortkey._state.clear()
        sortkey.LAUNCHES.update(saved[2])


def _exercised(case, args, key):
    """The case reaches what it names: dead lanes in their bin; for the
    treelet key, live rays in a box's bin and in the miss bin; on the
    hand-made table an exact tie (won by box 1) and an entry at the 1e-4
    floor."""
    act = args["active"]
    bins = sort._bins(args["morton_bounds"], args["treelet_bounds"])
    assert bool((key[~act] == (8 if bins == sort._BINS else bins - 1)).all())
    assert bool((key >= 0).all()) and bool((key < bins).all())
    if args["treelet_bounds"] is None:
        return
    t = args["treelet_bounds"].shape[0]
    live = key[act]
    assert bool((live < 8 * t).any()) and bool((live == 8 * t).any())
    entry = sort._slab_entry(args["treelet_bounds"], args["o"], args["d"])
    if case == "hand_treelet":
        assert bool((entry[:, 1] == entry[:, 3]).logical_and(entry[:, 1].isfinite()).any())
        assert float(entry[:, 0].min()) == float(torch.tensor(1e-4))
        e = args["o"].shape[0] - 2 * host_check._edge_rays()[0].shape[0]  # live edge rays
        assert bool((key[e:e + 2] == sort._octant3(args["d"][e:e + 2]) * t + 1).all())


@pytest.mark.parametrize("case", list(host_check.SORTKEY_CASES))
def test_host_built_sortkey_equals_the_plain_key(host, case):
    args = host.sortkey_case(case, 2 ** 31 + 17)
    variant = host.SORTKEY_CASES[case][1]
    before = dict(sortkey.LAUNCHES)
    key_k = sortkey.ray_key(**args)
    key_p = sort.ray_key_plain(**args)
    assert key_k.dtype == key_p.dtype == torch.int32
    assert torch.equal(key_k, key_p)
    assert sortkey.LAUNCHES == {**before, variant: before[variant] + 1}
    _exercised(case, args, key_k)
    # _ray_perm through the kernel gives the plain key's permutation
    plain = sort._ray_perm(**args)
    real = sort.ray_key_plain
    sort.ray_key_plain = sortkey.ray_key
    try:
        via_kernel = sort._ray_perm(**args)
    finally:
        sort.ray_key_plain = real
    assert all(torch.equal(a, b) for a, b in zip(via_kernel, plain))
    assert sortkey.LAUNCHES[variant] == before[variant] + 2


def _five_columns(a):
    a["treelet_bounds"] = a["treelet_bounds"][:, :5]


def _no_boxes(a):
    a["treelet_bounds"] = torch.zeros((0, 6))


def _float64_rays(a):
    a["d"] = a["d"].double()


def _byte_mask(a):
    a["active"] = a["active"].to(torch.uint8)


def _short_bounds(a):
    a["morton_bounds"] = (torch.zeros(2), torch.ones(3))


@pytest.mark.parametrize("fault", [_five_columns, _no_boxes, _float64_rays, _byte_mask,
                                   _short_bounds], ids=lambda f: f.__name__[1:])
def test_sortkey_wrapper_refuses_before_launching(host, fault):
    """Boxes of five columns, none, float64 rays, a mask that is not bool,
    Morton bounds of another size than 3: each raises, and nothing is
    launched."""
    args = host.sortkey_case("hand_treelet", 5, n=64)
    if fault is _short_bounds:
        args["treelet_bounds"] = None
    fault(args)
    before = dict(sortkey.LAUNCHES)
    with pytest.raises(ValueError, match="sortkey kernel"):
        sortkey.ray_key(**args)
    assert sortkey.LAUNCHES == before
