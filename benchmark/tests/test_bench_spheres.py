"""CPU tests of the sphere door of the benchmark: the reference's sphere
tree answers every query with the same bits as a test of every sphere at
once (the oracle below), a scene of spheres with no triangles goes through
the program's door and the reference and comes out correct, and a scene
with neither triangles nor spheres is refused.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from benchmark.harness import cell, judge, program, spec
from benchmark.harness import traffic as traffic_mod
from benchmark.reference import accel, ops
from benchmark.reference import frame as ref
from benchmark.scenes import oneweekend
from benchmark.tests.test_bench_correctness import _faulty

SEED = 2**31 + 113


def _oracle_spheres(acc: accel.Accel, o, d):
    """(t, sphere id) of the nearest accepted sphere per ray, every ray
    against every sphere in one block (T_INF where none)."""
    if acc.sph_center.shape[0] == 0:
        n = o.shape[0]
        return torch.full((n,), ops.T_INF), torch.full((n,), -1, dtype=torch.int64)
    ok, t = ops.intersect_sphere(o[:, None, :], d[:, None, :], acc.sph_center[None],
                                 acc.sph_radius[None])
    t = torch.where(ok & (t > ops.T_EPS), t, ops.T_INF)
    return t.amin(dim=1), torch.argmin(t, dim=1)


def _oracle_closest(acc, o, d, active):
    t_s, sid = _oracle_spheres(acc, o, d)
    on_s = active & (t_s < ops.T_HIT_MAX)
    t = torch.where(on_s, t_s, ops.T_INF)
    kind = torch.where(on_s, accel.KIND_SPHERE, 0)
    prim = torch.where(on_s, sid, -1)
    lim = torch.where(active, t, torch.zeros_like(t))
    t_t, tri, _, _ = accel._triangles(acc, o, d, lim, any_hit=False)
    on_t = active & (tri >= 0) & (t_t < t)
    return (torch.where(on_t, t_t, t), torch.where(on_t, accel.KIND_TRI, kind),
            torch.where(on_t, tri, prim))


def _oracle_occluded(acc, o, d, t_max, active):
    t_s, _ = _oracle_spheres(acc, o, d)
    occ = active & (t_s < t_max)
    lim = torch.where(active & ~occ, torch.full_like(t_s, t_max), torch.zeros_like(t_s))
    return occ | accel._triangles(acc, o, d, lim, any_hit=True)[0]


def _sphere_set(n: int, rng: np.random.Generator) -> list[dict]:
    """n spheres: a ground sphere of radius 1000 (n > 1), random small ones
    in a 12-unit cube, nested pairs (one inside the other), overlapping
    pairs, and copies of one sphere (exactly equal t), some far apart in id."""
    out = []
    add = lambda c, r: out.append(dict(center=tuple(float(x) for x in c), radius=float(r)))
    if n > 1:
        add((0.0, -1000.0, 0.0), 1000.0)
    while len(out) < n:
        c = rng.uniform(-6.0, 6.0, 3)
        r = rng.uniform(0.05, 1.5)
        kind = rng.integers(0, 4)
        add(c, r)
        if kind == 1 and len(out) < n:  # nested
            add(c + rng.uniform(-0.2, 0.2, 3) * r, 0.5 * r)
        elif kind == 2 and len(out) < n:  # overlapping
            add(c + rng.normal(size=3) * r * 0.8, r * rng.uniform(0.5, 1.2))
        elif kind == 3:  # copies: the same sphere again, next in id and later on
            for _ in range(min(int(rng.integers(1, 12)), n - len(out))):
                add(c, r)
    if n >= 7:  # a copy of an early sphere at the last id
        out[-1] = dict(out[1])
    return out[:n]


def _rays(spheres: list[dict], m: int, rng: np.random.Generator):
    """m rays of each kind: random origins and directions; origins inside a
    sphere; rays aimed at a sphere's centre; grazing rays, tangent to a
    sphere at a random point and at a point where it touches its box; and
    a seeded active mask."""
    c = np.array([s["center"] for s in spheres], np.float32)
    r = np.array([s["radius"] for s in spheres], np.float32)
    unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
    pick = rng.integers(0, len(spheres), (4, m))
    o_rand = rng.uniform(-9.0, 9.0, (m, 3))
    d_rand = unit(rng.normal(size=(m, 3)))
    o_in = c[pick[0]] + unit(rng.normal(size=(m, 3))) * r[pick[0], None] * rng.uniform(
        0.0, 0.9, (m, 1))
    d_in = unit(rng.normal(size=(m, 3)))
    o_at = rng.uniform(-9.0, 9.0, (m, 3))
    d_at = unit(c[pick[1]] - o_at)
    # tangent at p = c + r n: a direction perpendicular to n, from a point back
    # along it; n random, or an axis, where the sphere touches its box
    axis = np.eye(3)[rng.integers(0, 3, m)] * rng.choice([-1.0, 1.0], (m, 1))
    o_g, d_g = [], []
    for n_g, k in ((unit(rng.normal(size=(m, 3))), pick[2]), (axis, pick[3])):
        p_g = c[k] + n_g * r[k, None]
        d_g.append(unit(np.cross(n_g, rng.normal(size=(m, 3)))))
        o_g.append(p_g - d_g[-1] * rng.uniform(0.5, 8.0, (m, 1)))
    o = np.concatenate([o_rand, o_in, o_at, *o_g]).astype(np.float32)
    d = np.concatenate([d_rand, d_in, d_at, *d_g]).astype(np.float32)
    active = rng.random(o.shape[0]) < 0.9
    return torch.as_tensor(o), torch.as_tensor(d), torch.as_tensor(active)


@pytest.mark.parametrize("n", [1, 7, 64, 500])
def test_sphere_tree_queries_equal_a_test_of_every_sphere(n):
    rng = np.random.default_rng(1000 + n)
    spheres = _sphere_set(n, rng)
    acc = accel.build(np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64), spheres,
                      "cpu")
    o, d, active = _rays(spheres, 500, rng)
    got = accel.trace_closest(acc, o, d, active)
    want = _oracle_closest(acc, o, d, active)
    assert torch.equal(got.t, want[0])
    assert torch.equal(got.kind, want[1].to(torch.int32))
    assert torch.equal(got.prim, want[2].to(torch.int32))
    assert bool(got.hit.any()) and bool((got.kind[~active] == 0).all())
    for t_max in (1e29, 4.0):
        occ = accel.occluded(acc, o, d, t_max, active)
        assert torch.equal(occ, _oracle_occluded(acc, o, d, t_max, active)), t_max


def test_sphere_tree_breaks_equal_t_to_the_lowest_id():
    """Nine copies of one sphere, more than a leaf; the last copy shares
    its leaf with a small sphere nearer the rays' origin, so that leaf is
    entered first: every hit is on copy 0, as `argmin` over all spheres
    gives."""
    spheres = [dict(center=(0.0, 0.0, 0.0), radius=1.0) for _ in range(9)]
    spheres.append(dict(center=(0.5, 0.5, 4.0), radius=0.1))  # off every ray's path
    acc = accel.build(np.zeros((0, 3)), np.zeros((0, 3)), spheres, "cpu")
    rng = np.random.default_rng(3)
    o = torch.as_tensor(np.tile([[0.0, 0.0, 5.0]], (200, 1)).astype(np.float32))
    d = ops.normalize(torch.as_tensor(np.concatenate(
        [rng.uniform(-0.15, 0.15, (200, 2)), -np.ones((200, 1))], 1).astype(np.float32)))
    got = accel.trace_closest(acc, o, d)
    want = _oracle_closest(acc, o, d, torch.ones(200, dtype=torch.bool))
    assert torch.equal(got.t, want[0]) and torch.equal(got.prim, want[2].to(torch.int32))
    assert set(got.prim[got.kind == accel.KIND_SPHERE].tolist()) == {0}


def test_spheres_with_triangles_keep_their_order():
    """Spheres inside the Cornell box: a triangle is kept only where it is
    strictly nearer, as before the sphere tree."""
    s = spec.scene_generator("cornell").build({"tess": 4, "sphere_tess": [6, 8]})
    rng = np.random.default_rng(5)
    spheres = _sphere_set(64, rng)[1:]  # no ground: the box's floor is the ground
    for sp in spheres:
        sp["center"] = tuple(0.15 * np.asarray(sp["center"]))
        sp["radius"] = 0.15 * sp["radius"]
    acc = accel.build(s["mesh"]["positions"], s["mesh"]["tris"], spheres, "cpu")
    o, d, active = _rays(spheres, 400, rng)
    got = accel.trace_closest(acc, o, d, active)
    want = _oracle_closest(acc, o, d, active)
    assert torch.equal(got.t, want[0]) and torch.equal(got.prim, want[2].to(torch.int32))
    assert torch.equal(got.kind, want[1].to(torch.int32))
    assert {1, 2} <= set(got.kind.tolist())
    assert torch.equal(accel.occluded(acc, o, d, 1e29, active),
                       _oracle_occluded(acc, o, d, 1e29, active))


def test_sphere_tree_query_memory_grows_with_depth_not_spheres(monkeypatch):
    """The walk never holds a (lanes, spheres) block: its largest tensor
    is lanes x LEAF or lanes x stack depth, whatever the sphere count."""
    rng = np.random.default_rng(9)
    spheres = [dict(center=tuple(rng.uniform(-50, 50, 3)), radius=0.3) for _ in range(4096)]
    acc = accel.build(np.zeros((0, 3)), np.zeros((0, 3)), spheres, "cpu")
    o = torch.as_tensor(rng.uniform(-60, 60, (256, 3)).astype(np.float32))
    d = ops.normalize(torch.as_tensor(rng.normal(size=(256, 3)).astype(np.float32)))
    largest = [0]
    intersect = ops.intersect_sphere

    def spy(o_, d_, center, radius):
        largest[0] = max(largest[0], center.numel() // 3)
        return intersect(o_, d_, center, radius)

    monkeypatch.setattr(ops, "intersect_sphere", spy)
    accel.trace_closest(acc, o, d)
    assert 0 < largest[0] <= 256 * accel.LEAF


def test_oneweekend_scene_is_the_books_final_render():
    s = oneweekend.build({"seed": 0, "grid": 11})
    sp = s["spheres"]
    assert len(s["mesh"]["tris"]) == 0 and 470 <= len(sp) <= 488
    assert sp[0]["center"] == (0.0, -1000.0, 0.0) and sp[0]["radius"] == 1000.0
    assert [x["center"] for x in sp[-3:]] == [(0.0, 1.0, 0.0), (-4.0, 1.0, 0.0),
                                              (4.0, 1.0, 0.0)]
    small = sp[1:-3]
    assert all(x["radius"] == 0.2 and x["center"][1] == 0.2 for x in small)
    assert all(math.dist(x["center"], (4.0, 0.2, 0.0)) > 0.9 for x in small)
    kinds = [x["shading"] for x in small]
    glass = [x for x in sp if x["shading"] == oneweekend.GLASS]
    assert all(x["ior"] == 1.5 for x in glass)
    assert 0.7 < kinds.count(oneweekend.LAMBERT) / len(small) < 0.9
    assert 0 < kinds.count(oneweekend.GLASS) < kinds.count(oneweekend.MIRROR)
    assert oneweekend.build({"seed": 0, "grid": 11})["spheres"] == sp
    assert oneweekend.build({"seed": 1, "grid": 11})["spheres"] != sp


def _sphere_cell(out_w: int = 64, out_h: int = 36) -> dict:
    """A reduced book scene (grid 3: about 40 spheres) as a cell of the
    harness, at the Cornell configuration's render settings with spp 2 and
    4 bounces, the camera orbiting the book's eye point by +-15 degrees."""
    bench = spec.load_benchmark()
    render = dict(spec.cell(bench, "cornell-bench.orbit")["config"]["render"],
                  out_w=out_w, out_h=out_h, spp=2, max_depth=4)
    config = {"name": "oneweekend-small", "render": render,
              "scene": {"kind": "oneweekend", "params": {"seed": 7, "grid": 3},
                        "build": {"blas_leaf_size": 8, "bvh_method": "sah"}}}
    traffic = {"config": "oneweekend-small",
               "camera": {"center": [0.0, 0.0, 0.0], "radius": math.hypot(13.0, 3.0),
                          "height": 2.0, "fov_deg": 20.0, "phase0_rad": math.atan2(13.0, 3.0),
                          "step_rad": 2 * math.pi / 240, "arc_rad": math.pi / 6},
               "dt": 1 / 60, "warmup_frames": 2, "profile_frames": 2, "judge_frames": 1,
               "checks": {"frame_bad_pct": 0.5, "state_bad_pct": 0.5,
                          "chain_frame_bad_pct": 0.5, "chain_state_bad_pct": 0.5}}
    return dict(name="oneweekend-small.orbit", entry={"config": "oneweekend-small", "chips": 1},
                config=config, traffic=traffic)


def test_program_door_builds_spheres_as_one_instance():
    s = oneweekend.build({"seed": 7, "grid": 3})
    _, sc = program.build_scene(s, {"blas_leaf_size": 8, "bvh_method": "sah"}, "cpu")
    assert sc.n_spheres == len(s["spheres"]) and 35 <= len(s["spheres"]) <= 40
    assert sc.inst_o2w.shape[0] == 1 and sc.tri_instances.numel() == 0


def _run_sphere_cell():
    bench = spec.load_benchmark()
    return cell.run(_sphere_cell(), bench, SEED, 6.0, False, "cpu", time.perf_counter(),
                    log=lambda s: None)["line"]


def test_sphere_scene_at_a_small_size_is_correct():
    line = _run_sphere_cell()
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1
    for v in line["checks"].values():
        assert v["value"] is not None and v["value"] <= 0.5


def test_sphere_scene_with_an_altered_answer_is_not_correct(monkeypatch):
    renderer, broken = _faulty("answer_altered")
    monkeypatch.setattr(renderer, "render_frame", broken)
    line = _run_sphere_cell()
    assert not line["correct"], line["checks"]


def test_bfloat16_control_fails_on_the_sphere_scene():
    """The reference in bfloat16 in the program's place, first frame of
    the reduced book scene at 192x108: it fails a limit of the cell."""
    c = _sphere_cell(192, 108)
    render = dict(c["config"]["render"])
    scene = oneweekend.build(c["config"]["scene"]["params"])
    tr = traffic_mod.Traffic(c["traffic"], scene, 192, 108, SEED)
    render["rng_salt"] = tr.rng_salt
    j = judge.Judge(scene, tr, render, 192, 108, c["traffic"]["dt"], "cpu")
    jc = judge.Judge(scene, tr, render, 192, 108, c["traffic"]["dt"], "cpu",
                     round_to=torch.bfloat16)
    want = j.frame(0, 0, j.empty_state())
    got = jc.frame(0, 0, jc.empty_state())
    numbers = judge.compare(got[0], judge.ref_state_tensors(got[1]), *want)
    limits = c["traffic"]["checks"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


def test_a_spec_with_no_triangles_and_no_spheres_is_refused():
    s = oneweekend.build({"seed": 7, "grid": 3})
    empty = dict(s, spheres=[])
    build = {"blas_leaf_size": 8, "bvh_method": "sah"}
    with pytest.raises(ValueError, match="neither"):
        program.build_scene(empty, build, "cpu")
    with pytest.raises(ValueError, match="neither"):
        ref.make_scene(empty, "cpu")
    with pytest.raises(ValueError, match="neither"):
        accel.build(np.zeros((0, 3)), np.zeros((0, 3)), [], "cpu")
