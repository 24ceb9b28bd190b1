"""The wide tables of a refit scene rebuilt on its device (`wide.refit_tables`),
on the CPU, held to a full prep (`wide.prepare_scene`) of the same scene bit
for bit:

- the per-octant child orders (`wide.octant_orders`) against the host
  prep's `_octant_perms` on every node of the 1080p bench Cornell table,
  and on boxes where ties or the order of the key's three additions decide;
- three or more compounding `refit_mesh_instance` calls on a triangle soup
  beside a sphere instance, on the small Cornell box and on geometry
  collapsed to coincident and degenerate boxes, every field of the refit
  tables equal to a full prep's, and the previous tables' tensors unwritten;
- the scenes that take the full prep: a new `commit()` with another
  topology, a scene of another builder with equal shapes, another alpha
  flag, tables without maps, a caller's BinaryScene; a mesh Renderer's
  refit replicates the refit tables and renders the single-device frame;
- the Renderer's `scene_tables` counter (one full prep, then one refit a
  frame) and its frames, equal to those of the full-prep route.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch.config import RenderConfig
from ilgpu_raytracing_tpu_torch.models import camera as tcamera
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene
from ilgpu_raytracing_tpu_torch.models.materials import Material
from ilgpu_raytracing_tpu_torch.ops import route
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, wide
from ilgpu_raytracing_tpu_torch.parallel import sharding as shrd
from ilgpu_raytracing_tpu_torch.runtime import renderer as trenderer

TABLES = ("wide_bounds", "wide_child", "wide_perm", "nodes", "tri_rows", "sph_rows",
          "tri_v0e", "inst_w2o", "inst_i", "inst_f")
STATIC = ("meta", "stack_cap", "wide_depth", "leaf_width", "needs_bary")


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _assert_same_tables(got: wide.WideScene, want: wide.WideScene):
    for k in TABLES:
        g, w = getattr(got, k), getattr(want, k)
        assert (g.dtype, g.shape, g.device) == (w.dtype, w.shape, w.device), k
        assert torch.equal(_bits(g), _bits(w)), k
    for k in STATIC:  # repr: float for float, and NaN equal to NaN
        assert repr(getattr(got, k)) == repr(getattr(want, k)), k


# ------------------------------------------------------------ octant orders


def _perms_by_node(wb: np.ndarray, wc: np.ndarray) -> np.ndarray:
    return np.stack([wide._octant_perms(wb[i], wc[i]) for i in range(wc.shape[0])])


def test_octant_orders_equal_the_host_prep_on_the_cornell_table():
    _, s = build_cornell_scene(tess=24, sphere_tess=(48, 72), blas_leaf_size=8,
                               bvh_method="sah", device="cpu")
    ws = wide.prepare_scene(s)
    wc = ws.wide_child.view(-1, 8)
    assert wc.shape[0] > 500
    got = wide.octant_orders(ws.wide_bounds.view(-1, 8, 6), wc)
    assert got.dtype == torch.int32 and torch.equal(got, ws.wide_perm.view(-1, 8))


def _tie_boxes(case: str, rs) -> tuple[np.ndarray, np.ndarray]:
    """(n, 8, 6) boxes and (n, 8) children of `n` nodes."""
    n = 400
    wc = np.where(rs.random((n, 8)) < 0.25, wide._EMPTY,
                  rs.choice([3, -18, -35], size=(n, 8))).astype(np.int32)
    if case == "coincident":  # every slot of a node the same box
        lo = rs.integers(-2, 3, size=(n, 1, 3)).astype(np.float32)
        lo = np.repeat(lo, 8, axis=1)
        hi = lo + np.float32(0.5)
    elif case == "degenerate":  # points and flat boxes on a coarse grid
        lo = (rs.integers(-2, 3, size=(n, 8, 3)) * 0.25).astype(np.float32)
        hi = lo + (rs.integers(0, 2, size=(n, 8, 3)) * 0.25).astype(np.float32)
    elif case == "signed_zero":  # centroids 0.0 and -0.0: equal keys
        lo = rs.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), size=(n, 8, 3))
        hi = np.where(rs.random((n, 8, 3)) < 0.5, -lo, lo).astype(np.float32)
    elif case == "addition_order":  # keys that only (x + y) + z rounds so
        big = np.float32(2.0 ** 25)
        c = rs.choice(np.array([1.0, 0.5, -1.0, 0.0], np.float32), size=(n, 8, 3))
        axis = rs.integers(0, 3, size=(n, 8))
        for a in range(3):
            c[..., a] = np.where(axis == a, c[..., a], big * rs.choice([1, -1], size=(n, 8)))
        lo = hi = c
    else:  # "nonfinite": inf and NaN boxes beside finite ones
        lo = rs.normal(size=(n, 8, 3)).astype(np.float32)
        hi = lo + np.float32(1.0)
        lo = np.where(rs.random((n, 8, 3)) < 0.1, np.float32(np.inf), lo)
        hi = np.where(rs.random((n, 8, 3)) < 0.1, np.float32(np.nan), hi)
        hi = np.where(rs.random((n, 8, 3)) < 0.05, np.float32(-np.inf), hi)
    return np.concatenate([lo, hi], axis=-1).astype(np.float32), wc


@pytest.mark.parametrize("case", ["coincident", "degenerate", "signed_zero",
                                  "addition_order", "nonfinite"])
def test_octant_orders_keep_the_stable_order_on_ties(case):
    wb, wc = _tie_boxes(case, np.random.default_rng(17))
    with np.errstate(invalid="ignore"):
        want = _perms_by_node(wb, wc)
    got = wide.octant_orders(torch.as_tensor(wb), torch.as_tensor(wc)).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ refit tables


def _soup(seed: int = 3):
    rs = np.random.RandomState(seed)
    v = rs.randn(80, 3).astype(np.float32)
    t = rs.randint(0, 80, size=(120, 3)).astype(np.int32)
    return v, t[(t[:, 0] != t[:, 1]) & (t[:, 1] != t[:, 2]) & (t[:, 0] != t[:, 2])]


def _soup_scene(seed: int = 3):
    """Two spheres in a sphere instance beside a random triangle soup."""
    b = tscene.SceneBuilder()
    b.add_material(Material())
    b.add_sphere((5, 0, 0), 1.0)
    b.add_sphere((-4, 1, 0), 0.5)
    b.add_sphere_instance([0, 1])
    b.add_mesh_instance(*_soup(seed))
    return b, 1, b.commit("cpu")


def _cornell_scene():
    b, s = build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                               bvh_method="sah", device="cpu")
    return b, 0, s


def _positions(b, inst_index):
    inst = b.instances[inst_index]
    return b.positions[inst.vertex_first: inst.vertex_first + inst.vertex_count].copy()


def _moves(case: str, base: np.ndarray):
    """Four positions of the mesh's vertices, each a refit of the last."""
    rs = np.random.RandomState(4)
    if case == "collapsed":  # coincident points, a line, a plane, a NaN, then apart again
        yield np.zeros_like(base)
        yield np.where(np.arange(3) == 0, base, 0).astype(np.float32)
        flat = base.copy()
        flat[:, 1] = 0.0
        yield flat
        lost = base.copy()
        lost[::2] = np.nan  # triangle 0 among those lost: its epilogue row stays zero
        yield lost
        yield base
        return
    for k in range(4):
        yield (base + rs.randn(*base.shape).astype(np.float32) * 0.05 * (k + 1)).astype(
            np.float32)


def _snapshot(ws: wide.WideScene) -> dict:
    return {k: getattr(ws, k).clone() for k in TABLES}


@pytest.mark.parametrize("case", ["soup", "cornell", "collapsed"])
def test_refit_tables_equal_a_full_prep(case):
    b, inst, s = _cornell_scene() if case == "cornell" else _soup_scene()
    prev = first = wide.prepare_scene(s)
    orders_moved = False
    for moved in _moves(case, _positions(b, inst)):
        s = tscene.refit_mesh_instance(b, s, inst, moved)
        before = _snapshot(prev)
        got = wide.refit_tables(prev, s)
        assert got is not None
        _assert_same_tables(got, wide.prepare_scene(s))
        assert got.scene.tri_v0 is s.tri_v0 and got.scene.has_alpha is False
        for k, v in before.items():
            assert torch.equal(_bits(getattr(prev, k)), _bits(v)), f"refit wrote {k}"
        orders_moved |= not torch.equal(got.wide_perm, first.wide_perm)
        prev = got  # the next refit starts from the refit tables and their maps
    assert orders_moved


def _other_topology(b, inst, s):
    b.add_sphere((0, 6, 0), 0.25)
    b.add_sphere_instance([len(b.spheres) - 1])
    return b.commit("cpu")


FALLBACKS = {
    "new_commit": _other_topology,
    "other_builder": lambda b, inst, s: _soup_scene()[2],
    "alpha_flag": lambda b, inst, s: dataclasses.replace(s, has_alpha=True),
    "moved_shape": lambda b, inst, s: dataclasses.replace(s, tri_v0=s.tri_v0[:-1]),
}


@pytest.mark.parametrize("case", list(FALLBACKS) + ["no_maps", "binary", "none"])
def test_refit_tables_falls_back_to_the_full_prep(case):
    b, inst, s = _soup_scene()
    prev = wide.prepare_scene(s)
    moved = tscene.refit_mesh_instance(b, s, inst, _positions(b, inst) + np.float32(0.1))
    assert wide.refit_tables(prev, moved) is not None
    if case in FALLBACKS:
        assert wide.refit_tables(prev, FALLBACKS[case](b, inst, moved)) is None
    elif case == "no_maps":  # tables loaded without maps (the JAX package's prep)
        tables = wide.wide_tables(wide.prepare(s))
        del tables["slot_node"], tables["tri_prims"]
        assert wide.refit_tables(wide.wide_from_numpy(tables, s), moved) is None
    elif case == "binary":
        assert wide.refit_tables(binary.prepare_binary(s), moved) is None
    else:
        assert wide.refit_tables(None, moved) is None


def test_meshed_tables_refit_from_their_plain_tables():
    """A mesh Renderer's refit `set_scene` refits (no full prep), holds the
    refit tables replicated onto the mesh's device, and renders the
    single-device Renderer's refit frame bit for bit."""
    b, inst, s = _soup_scene()
    mesh = shrd.make_mesh(devices=[torch.device("cpu")] * 2)
    cfg = RenderConfig(spp=1, max_depth=1, render_scale=1.0)
    # read once: a refit writes the builder's positions
    moved = _positions(b, inst) * np.float32(1.5)
    frames = []
    for m in (None, mesh):
        r = trenderer.Renderer(16, 16, cfg, s, mesh=m, device="cpu")
        start = dict(route.SCENE_TABLES)
        r.set_scene(tscene.refit_mesh_instance(b, r.scene, inst, moved))
        counts = {k: v - start[k] for k, v in route.SCENE_TABLES.items()}
        assert counts == {"prepared": 0, "refitted": 1}
        _assert_same_tables(r.wscene, wide.prepare_scene(r.scene))
        if m is not None:
            reps = r._kscene_replicas()
            assert r._kscenes[0] is r.wscene
            assert reps.copies[0] is reps.copies[1]  # one device, one replica
            _assert_same_tables(reps.copies[0], r.wscene)
            got, want = reps.copies[0]._refit_maps, r.wscene._refit_maps
            assert torch.equal(got.slot_node, want.slot_node)
            assert torch.equal(got.tri_prims, want.tri_prims)
        with torch.inference_mode():
            frames.append(r.render().clone())
    assert torch.equal(frames[0], frames[1])


# ------------------------------------------------------------ the Renderer

W = H = 32
FRAMES = 3


def _animate(full_prep: bool, monkeypatch):
    """examples/animate.py's loop at 32x32: bob the sphere, refit,
    set_scene, orbit the camera, render; with `full_prep` every set_scene
    takes the full prep. Returns the renderer, its packed frames and the
    scene_tables counts of the loop."""
    if full_prep:
        monkeypatch.setattr(wide, "refit_tables", lambda prev, scene: None)
    builder, scene = build_cornell_scene(tess=4, sphere_tess=(8, 12), blas_leaf_size=8,
                                         device="cpu")
    start = dict(route.SCENE_TABLES)
    cfg = RenderConfig(spp=1, max_depth=2, progressive_accumulation=True)
    r = trenderer.Renderer(out_w=W, out_h=H, cfg=cfg, scene=scene, device="cpu")
    base = _positions(builder, 0)
    frames = []
    with torch.inference_mode():
        for f in range(FRAMES):
            phase = 2.0 * math.pi * f / FRAMES
            moved = base.copy()
            moved[-9 * 12:, 1] += np.float32(0.15 * math.sin(phase))
            r.set_scene(tscene.refit_mesh_instance(builder, r.scene, 0, moved))
            r.set_camera(tcamera.Camera.look_at(
                (3.2 * math.sin(phase * 0.25), 0.2, 3.2 * math.cos(phase * 0.25)),
                (0, 0, 0), (0, 1, 0), 40.0, W / H))
            frames.append(r.render().clone())
    counts = {k: v - start[k] for k, v in route.SCENE_TABLES.items()}
    return r, frames, counts


def test_renderer_refits_each_frame_and_renders_the_full_prep_frames(monkeypatch):
    r, frames, counts = _animate(False, monkeypatch)
    assert counts == {"prepared": 1, "refitted": FRAMES}
    with monkeypatch.context() as m:
        r_full, frames_full, counts_full = _animate(True, m)
    assert counts_full == {"prepared": 1 + FRAMES, "refitted": 0}
    _assert_same_tables(r.wscene, r_full.wscene)
    for got, want in zip(frames, frames_full):
        assert torch.equal(got, want)
    assert not torch.equal(frames[0], frames[-1])


def test_renderer_takes_the_full_prep_off_the_refit_path():
    """A scene of another topology, and a caller's BinaryScene, each take
    the full prep; the next refit refits the tables that prep made."""
    b, inst, s = _soup_scene()
    r = trenderer.Renderer(16, 16, RenderConfig(spp=1, max_depth=1), s, device="cpu")
    start = dict(route.SCENE_TABLES)
    steps = [
        lambda: tscene.refit_mesh_instance(b, r.scene, inst, _positions(b, inst) * 1.1),
        lambda: _other_topology(b, inst, r.scene),
        lambda: tscene.refit_mesh_instance(b, r.scene, inst, _positions(b, inst) * 0.9),
    ]
    want = [(0, 1), (1, 1), (1, 2)]
    for step, (prepared, refitted) in zip(steps, want):
        r.set_scene(step())
        assert route.SCENE_TABLES["prepared"] - start["prepared"] == prepared
        assert route.SCENE_TABLES["refitted"] - start["refitted"] == refitted
        _assert_same_tables(r.wscene, wide.prepare_scene(r.scene))
    r.wscene = binary.prepare_binary(r.scene)
    r.set_scene(tscene.refit_mesh_instance(b, r.scene, inst, _positions(b, inst) * 1.2))
    assert isinstance(r.wscene, wide.WideScene)
    assert route.SCENE_TABLES["prepared"] - start["prepared"] == 2
    _assert_same_tables(r.wscene, wide.prepare_scene(r.scene))
