"""K5's packed node table (ops/cuda/stream.pack_anyhit_nodes): one
128-byte record per wide node, equal row for row and bit for bit to the
StreamScene's `wide_frame`, `wide_qbounds` and `wide_child` on the small
terrain (grid 64 x 32, leaf 64, SAH), and rebuilt with the extended tables
of a treelet cut. The kernel that reads it runs on the card (chip_smoke.py)
and, built for the host, in tests/test_torch_host_kernels.py."""

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch import native as tnative
from ilgpu_raytracing_tpu_torch.models import terrain
from ilgpu_raytracing_tpu_torch.ops.cuda import stream, streamtreelet

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def small_terrain():
    if not tnative.available():
        pytest.skip("no C++ compiler")
    return stream.prepare_stream(
        terrain.build_terrain_scene(grid_x=64, grid_z=32, device="cpu")[1])


def _check_records(ss):
    nodes = ss.anyhit_nodes
    w = ss.wide_child.numel() // 8
    assert nodes.dtype == torch.int32 and tuple(nodes.shape) == (w, 32)
    assert nodes.is_contiguous() and nodes.data_ptr() % 16 == 0
    rec = nodes.numpy()
    frame = ss.wide_frame.numpy().reshape(w, 6)
    np.testing.assert_array_equal(rec[:, 0:6].view(np.float32), frame)
    np.testing.assert_array_equal(rec[:, 0:6], frame.view(np.int32))  # bit for bit
    np.testing.assert_array_equal(rec[:, 6:8], 0)
    np.testing.assert_array_equal(rec[:, 8:24], ss.wide_qbounds.numpy().reshape(w, 16))
    np.testing.assert_array_equal(rec[:, 24:32], ss.wide_child.numpy().reshape(w, 8))


def test_anyhit_records_equal_the_wide_tables(small_terrain):
    _check_records(small_terrain)
    # K5's node-group stack holds the wide depth (<= MAX_DEPTH), and K4's
    # per-thread bound derives from the same depth
    assert 1 <= small_terrain.wide_depth <= 36
    assert small_terrain.thread_stack == 7 * small_terrain.wide_depth + 1


def test_anyhit_records_follow_a_treelet_cut(small_terrain):
    sts = streamtreelet.prepare_treelets_stream(small_terrain, 8)
    grown = sts.sscene
    assert grown.wide_child.numel() > small_terrain.wide_child.numel()
    _check_records(grown)
    assert grown.wide_depth >= small_terrain.wide_depth
    w = small_terrain.anyhit_nodes.shape[0]
    assert torch.equal(grown.anyhit_nodes[:w], small_terrain.anyhit_nodes)
