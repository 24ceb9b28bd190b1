"""The CUDA trace kernels' own source, run on the CPU.

ops/cuda/host_check.py compiles csrc/wide_trace.cu, stream_trace.cu,
binary_trace.cu, treelet_trace.cu and streamtreelet_trace.cu (with the
csrc/*.cuh headers) for the host with g++; here they are bound in place of
the nvcc builds and run through the wrappers' launch path (ctypes argument
order, stack-overflow flag, the counting variant) on CPU tensors. K1/K2 and
K4/K5 are held to the plain walks on primary and bounce rays: hit masks and
occlusion equal, |dt| <= 1e-3, prim agreement > 99.5% (the bar chip_smoke.py
holds them to on the card). K5, with a tenth of the lanes inactive, also
equals the plain walk and K4's hit mask at t_max 5 and 1e29 on the small
terrain and the leaf-64 Cornell box. K6, K7 and K8 are held to their own plain
versions bit for bit: every output of K6, and t / pp of one treelet round on
random want masks. This checks the kernels' logic; what nvcc accepts, and
speed, show only on the card."""

import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.models import cornell, terrain
from ilgpu_raytracing_tpu_torch.models.camera import Camera
from ilgpu_raytracing_tpu_torch.models.scene import build_default_scene
from ilgpu_raytracing_tpu_torch.ops import cuda as cu
from ilgpu_raytracing_tpu_torch.ops.cuda import (
    binary,
    host_check,
    stream,
    streamtreelet,
    treelet,
    wide,
)

KERNEL_MODULES = (wide, stream, binary, treelet, streamtreelet)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def host():
    """The host builds bound as the kernel libraries for this module only;
    the wrappers' library caches and launch counts are restored after."""
    if not tnative.available():
        pytest.skip("no C++ compiler")
    libs = host_check.host_libraries()
    saved = (cu.load_kernel_library, cu.stream_ptr,
             [dict(m.LAUNCHES) for m in KERNEL_MODULES])
    for m in KERNEL_MODULES:
        m._state.clear()
    cu.load_kernel_library = lambda name: (libs[name], 0.0)
    cu.stream_ptr = lambda t: None
    try:
        yield host_check
    finally:
        cu.load_kernel_library, cu.stream_ptr = saved[0], saved[1]
        for m, counts in zip(KERNEL_MODULES, saved[2]):
            m._state.clear()
            m.LAUNCHES.update(counts)


CASES = {
    "terrain_stream": (
        stream, lambda: terrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1],
        terrain.terrain_camera),
    "cornell_wide": (
        wide, lambda: cornell.build_cornell_scene(tess=4, sphere_tess=(8, 12),
                                                  blas_leaf_size=8, bvh_method="sah",
                                                  device="cpu")[1],
        cornell.cornell_camera),
}


@pytest.mark.parametrize("case", list(CASES))
def test_host_built_kernels_meet_the_plain_walk(host, case):
    mod, build, camera = CASES[case]
    scene = build()
    ks = stream.prepare_stream(scene) if mod is stream else wide.prepare_scene(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    assert host.check_walks(f"{case} primary", mod, ks, o, d)
    bo, bd = host.bounce_rays(scene, host.primary_hits(mod, ks, o, d), o, d, 2)
    assert bo.shape[0] > 100
    assert host.check_walks(f"{case} bounce", mod, ks, bo, bd)
    # the kernel launches counted (3 per check_walks) and the counting
    # variant did not count
    assert sum(mod.LAUNCHES.values()) >= 6
    work = torch.zeros((2,), dtype=torch.int64)
    mod._launch(ks, bo, bd, torch.full((bo.shape[0],), 1e30), any_hit=True, work=work)
    assert int(work[0]) > 0 and int(work[1]) > 0


ROUND_CASES = {
    "cornell_binary_treelet": (
        wide, CASES["cornell_wide"][1], cornell.cornell_camera),
    "default_binary_treelet": (
        wide, lambda: build_default_scene(single_instance=False, device="cpu")[1],
        Camera.create),
    "terrain_streamtreelet": (stream, CASES["terrain_stream"][1], terrain.terrain_camera),
}


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_host_built_k6_k7_k8_equal_their_plain_versions(host, case):
    """K6 on primary and bounce rays (wide-table scenes) and one K7 / K8
    round on bounce rays with random and full want masks, each equal to
    its plain version in every output."""
    mod, build, camera = ROUND_CASES[case]
    scene = build()
    ks = stream.prepare_stream(scene) if mod is stream else wide.prepare_scene(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    bo, bd = host.bounce_rays(scene, host.primary_hits(mod, ks, o, d), o, d, 2)
    if mod is wide:
        bs = binary.prepare_binary(scene)
        assert host.check_binary(f"{case} primary", bs, o, d)
        assert host.check_binary(f"{case} bounce", bs, bo, bd)
        ts = treelet.prepare_treelets(ks, 8)
        assert host.check_round(f"{case} K7", treelet, ts, bo, bd, 1, 3)
        assert binary.LAUNCHES["binary_closest"] >= 2 and treelet.LAUNCHES["treelet"] >= 2
    else:
        sts = streamtreelet.prepare_treelets_stream(ks, 8)
        assert host.check_round(f"{case} K8", streamtreelet, sts, bo, bd, 1, 3)
        assert streamtreelet.LAUNCHES["streamtreelet"] >= 2


ANYHIT_CASES = {
    "terrain": (CASES["terrain_stream"][1], terrain.terrain_camera),
    "cornell_leaf64": (
        lambda: cornell.build_cornell_scene(tess=6, sphere_tess=(10, 14), blas_leaf_size=64,
                                            bvh_method="sah", device="cpu")[1],
        cornell.cornell_camera),
}


@pytest.mark.parametrize("case", list(ANYHIT_CASES))
def test_host_built_k5_equals_the_plain_walk_and_k4(host, case):
    """K5's own walk (csrc/stream_anyhit.cuh) with inactive lanes: occlusion
    equal to the plain walk and to K4's hit mask at t_max 5 and 1e29, on
    primary and bounce rays."""
    build, camera = ANYHIT_CASES[case]
    scene = build()
    ss = stream.prepare_stream(scene)
    o, d = host.jittered_rays(camera(48, 32), 48, 32, 1)
    launches = stream.LAUNCHES["stream_shadow"]
    assert host.check_anyhit(f"{case} primary", ss, o, d, 4)
    bo, bd = host.bounce_rays(scene, host.primary_hits(stream, ss, o, d), o, d, 2)
    assert bo.shape[0] > 100
    assert host.check_anyhit(f"{case} bounce", ss, bo, bd, 5)
    # the host build ran, not the plain walk: 2 K5 launches per check
    assert stream.LAUNCHES["stream_shadow"] - launches == 4
