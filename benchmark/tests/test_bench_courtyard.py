"""CPU tests of the textured, alpha-cutout door of the benchmark, on the
courtyard fixture (`courtyard_scene.py`, no configuration of the
benchmark): the fixture writes the repository's asset byte for byte, the
program loads the spec's scene through its OBJ loader, the reference's
in-walk alpha test agrees with a test of every triangle, a small courtyard
cell run through the harness is correct, and the program with its cutouts
or its diffuse textures taken away, or with a faulty frame step, is not,
nor is the bfloat16 control; and the kernel-call count a frame.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import copy
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import cell, judge, program, program_spans, spec
from benchmark.harness import traffic as traffic_mod
from benchmark.metrics import kernel_calls_per_frame
from benchmark.reference import accel, ops
from benchmark.reference import frame as ref
from benchmark.tests import courtyard_scene as courtyard
from benchmark.tests.test_bench_correctness import _faulty

SEED = 2**31 + 91
BUILD = {"blas_leaf_size": 8, "bvh_method": "median"}
# a viewer panning along the banners, +-30 degrees round the asset's camera
# pose, at the Cornell configuration's render settings with the asset's sun
TRAFFIC = {"config": "courtyard",
           "camera": {"center": [0.0, 1.3, -3.0], "radius": 6.6, "height": 1.7,
                      "fov_deg": 62.0, "phase0_rad": 0.0, "step_rad": 2 * np.pi / 240,
                      "arc_rad": np.pi / 3},
           "dt": 1 / 60, "warmup_frames": 2, "profile_frames": 3, "judge_frames": 3,
           "checks": {"frame_bad_pct": 0.5, "state_bad_pct": 0.5,
                      "chain_frame_bad_pct": 0.5, "chain_state_bad_pct": 0.5}}


def courtyard_cell(out_w: int, out_h: int) -> dict:
    """The fixture as a cell of the harness (spec.cell's shape)."""
    bench = spec.load_benchmark()
    cornell = spec.cell(bench, "cornell-bench.orbit")["config"]
    render = dict(cornell["render"], out_w=out_w, out_h=out_h, sun_azimuth=0.4,
                  sun_elevation=0.9)
    config = {"name": "courtyard", "render": render,
              "scene": {"kind": "courtyard", "params": {}, "build": BUILD}}
    return dict(name="courtyard.orbit", entry={"config": "courtyard", "chips": 1},
                config=config, traffic=copy.deepcopy(TRAFFIC))


@pytest.fixture(autouse=True)
def _courtyard_kind(monkeypatch):
    """The harness finds the fixture as scene kind `courtyard`."""
    find = spec.scene_generator
    monkeypatch.setattr(spec, "scene_generator",
                        lambda kind: courtyard if kind == "courtyard" else find(kind))


def test_generator_files_equal_the_repository_asset(tmp_path):
    from ilgpu_raytracing_tpu_torch.models.sponza_like import write_sponza_like_asset

    write_sponza_like_asset(str(tmp_path))
    files = courtyard.build({})["obj_files"]
    assert sorted(files) == sorted(p.name for p in tmp_path.iterdir())
    for name, data in files.items():
        assert (tmp_path / name).read_bytes() == data, name


def test_program_door_loads_the_spec_scene():
    s = courtyard.build({})
    _, sc = program.build_scene(s, BUILD, "cpu")
    mesh = s["mesh"]
    p, t = mesh["positions"], mesh["tris"]
    assert sc.n_tris == t.shape[0] == 94
    # vertex for vertex, in the spec's triangle order
    np.testing.assert_array_equal(sc.tri_v0.numpy(), p[t[:, 0]])
    np.testing.assert_array_equal(sc.tri_e1.numpy(), p[t[:, 1]] - p[t[:, 0]])
    np.testing.assert_array_equal(sc.tri_e2.numpy(), p[t[:, 2]] - p[t[:, 0]])
    for k in range(3):
        np.testing.assert_array_equal(getattr(sc, f"tri_uv{k}").numpy(), mesh["tri_uv"][:, k])
    # each triangle's material, field by field
    tm = sc.tri_mat.long()
    for key, field in (("kd", "mat_kd"), ("diffuse_tex", "mat_diffuse_tex"),
                       ("alpha_tex", "mat_alpha_tex"), ("alpha_cutoff", "mat_alpha_cutoff"),
                       ("two_sided", "mat_two_sided"), ("shading", "mat_shading"),
                       ("ior", "mat_ior")):
        want = np.array([s["materials"][m][key] for m in mesh["tri_mat"]], np.float32)
        np.testing.assert_array_equal(getattr(sc, field)[tm].numpy().astype(np.float32), want,
                                      err_msg=key)
    assert sc.has_alpha
    # the texture pool: sizes, offsets and 0xAARRGGBB texels in the spec's order
    tex = s["textures"]
    assert sc.tex_width.tolist() == [a.shape[1] for a in tex]
    assert sc.tex_height.tolist() == [a.shape[0] for a in tex]
    assert sc.tex_offset.tolist() == list(np.cumsum([0] + [a.shape[0] * a.shape[1]
                                                           for a in tex])[:-1])
    argb = [a.astype(np.int64) for a in tex]
    packed = np.concatenate([(a[..., 3] << 24 | a[..., 0] << 16 | a[..., 1] << 8 | a[..., 2])
                             .reshape(-1) for a in argb])
    np.testing.assert_array_equal(sc.texels.numpy(), packed)


# ---- the reference's alpha test against every triangle ----


def _ramp_spec():
    """The courtyard with its banner mask replaced by seeded grey levels,
    so point samples fall inside and outside the +-0.10 band."""
    s = courtyard.build({})
    rng = np.random.default_rng(7)
    g = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    s["textures"][2] = np.stack([g, g, g, np.full_like(g, 255)], axis=-1)
    return s


def _luma(a, x, y):
    c = a[y, x, :3].astype(np.float32) * np.float32(1.0 / 255.0)
    return (np.float32(0.2126) * c[0] + np.float32(0.7152) * c[1]
            + np.float32(0.0722) * c[2])


def _mask_by_hand(a, u, v, cutoff, closest):
    """One candidate's cutout, texel by texel in numpy float32."""
    h, w = a.shape[:2]
    fu = np.float32(u) - np.float32(np.floor(u))
    fv = np.float32(1.0) - (np.float32(v) - np.float32(np.floor(v)))
    x, y = fu * np.float32(w - 1), fv * np.float32(h - 1)
    x0, y0 = int(np.floor(x)), int(np.floor(y))
    x1, y1 = min(w - 1, x0 + 1), min(h - 1, y0 + 1)
    tx, ty = x - np.float32(x0), y - np.float32(y0)
    one = np.float32(1.0)
    lin = ((_luma(a, x0, y0) * (one - tx) + _luma(a, x1, y0) * tx) * (one - ty)
           + (_luma(a, x0, y1) * (one - tx) + _luma(a, x1, y1) * tx) * ty)
    if closest:
        return bool(lin >= cutoff), None
    pt = _luma(a, int(np.round(x)), int(np.round(y)))
    lo, hi = np.float32(cutoff) - np.float32(0.1), np.float32(cutoff) + np.float32(0.1)
    inside = not (pt < lo or pt >= hi)
    return bool(pt >= hi or (inside and lin >= cutoff)), inside


def test_reference_alpha_walk_equals_every_triangle_tested():
    s = _ramp_spec()
    sc = ref.make_scene(s, "cpu")
    mesh, mats = s["mesh"], s["materials"]
    # rays from the sweep's eye points towards random points of the banners
    rng = np.random.default_rng(11)
    n = 600
    eye = np.stack([rng.uniform(-3.3, 3.3, n), rng.uniform(1.0, 2.4, n),
                    rng.uniform(2.7, 3.6, n)], -1).astype(np.float32)
    goal = np.stack([rng.choice([-3.0, 0.0, 3.0], n) + rng.uniform(-0.85, 0.85, n),
                     rng.uniform(0.95, 2.45, n), np.full(n, -3.0)], -1).astype(np.float32)
    o = torch.as_tensor(eye)
    d = ops.normalize(torch.as_tensor(goal - eye))
    got = accel.trace_closest(sc.acc, o, d)
    occ = accel.occluded(sc.acc, o, d, 1e29)

    p, t = mesh["positions"], mesh["tris"]
    v0, v1, v2 = (torch.as_tensor(p[t[:, k]])[None] for k in range(3))
    ok, tt, bu, bv = ops.intersect_triangle(o[:, None, :], d[:, None, :], v0, v1 - v0, v2 - v0)
    ok = ok & (tt > ops.T_EPS)
    in_band, peeled = set(), 0
    for i in range(n):
        best, best_t, blocked = -1, np.inf, False
        for j in np.nonzero(ok[i].numpy())[0]:
            m = mats[mesh["tri_mat"][j]]
            w = np.float32(1.0) - bu[i, j].numpy() - bv[i, j].numpy()
            uv = mesh["tri_uv"][j]
            u = uv[0, 0] * w + uv[1, 0] * bu[i, j].numpy() + uv[2, 0] * bv[i, j].numpy()
            v = uv[0, 1] * w + uv[1, 1] * bu[i, j].numpy() + uv[2, 1] * bv[i, j].numpy()
            if m["alpha_tex"] >= 0:
                a = s["textures"][m["alpha_tex"]]
                closest_ok, _ = _mask_by_hand(a, u, v, m["alpha_cutoff"], True)
                any_ok, inside = _mask_by_hand(a, u, v, m["alpha_cutoff"], False)
                in_band.add(inside)
            else:
                closest_ok = any_ok = True
            blocked |= any_ok
            if closest_ok and float(tt[i, j]) < best_t:
                best, best_t = int(j), float(tt[i, j])
        assert int(got.prim[i]) == best, i
        if best >= 0:
            assert float(got.t[i]) == best_t, i
        assert bool(occ[i]) == blocked, i
        near = torch.where(ok[i], tt[i], torch.inf)
        peeled += bool(ok[i].any()) and int(near.argmin()) != best
    # both sides of the band were met, and the cutouts moved closest hits
    assert in_band == {True, False}
    assert peeled > 0


# ---- the cell at a small size, and faults under the timed path ----


def run_small(seconds: float = 16.0):
    return cell.run(courtyard_cell(96, 64), spec.load_benchmark(), SEED, seconds, False, "cpu",
                    time.perf_counter(),
                    log=lambda s: None)["line"]


def test_courtyard_at_a_small_size_is_correct():
    line = run_small()
    assert line["correct"], line["checks"]
    for v in line["checks"].values():
        assert v["value"] == 0.0


def _without_cutouts(sc):
    return dataclasses.replace(sc, has_alpha=False)


def _without_diffuse_textures(sc):
    return dataclasses.replace(sc, mat_diffuse_tex=torch.full_like(sc.mat_diffuse_tex, -1))


@pytest.mark.parametrize("fault", [_without_cutouts, _without_diffuse_textures,
                                   "state_unchanged", "half_left_out", "answer_altered"])
def test_faults_under_the_timed_path_are_not_correct(fault, monkeypatch):
    """The loaded scene with its cutouts or diffuse textures taken away,
    and the three faults of a frame step (test_bench_correctness._faulty)."""
    if isinstance(fault, str):
        renderer, broken_frame = _faulty(fault)
        monkeypatch.setattr(renderer, "render_frame", broken_frame)
    else:
        build = program.build_scene

        def broken(spec_, build_, device):
            b, sc = build(spec_, build_, device)
            return b, fault(sc)

        monkeypatch.setattr(program, "build_scene", broken)
    line = run_small(seconds=8.0)
    assert not line["correct"]
    over = [k for k, v in line["checks"].items()
            if v["value"] is not None and v["value"] > v["limit"]]
    assert over, line["checks"]


def test_bfloat16_control_is_not_correct():
    """The reference computed in bfloat16 (geometry, rays, textures,
    colour) in the program's place, on the courtyard's first frame at
    192x128: it fails a limit of the cell."""
    c = courtyard_cell(192, 128)
    render = dict(c["config"]["render"])
    scene = courtyard.build({})
    tr = traffic_mod.Traffic(c["traffic"], scene, 192, 128, SEED)
    render["rng_salt"] = tr.rng_salt
    j = judge.Judge(scene, tr, render, 192, 128, c["traffic"]["dt"], "cpu")
    jc = judge.Judge(scene, tr, render, 192, 128, c["traffic"]["dt"], "cpu",
                     round_to=torch.bfloat16)
    want = j.frame(0, 0, j.empty_state())
    got = jc.frame(0, 0, jc.empty_state())
    numbers = judge.compare(got[0], judge.ref_state_tensors(got[1]), *want)
    limits = c["traffic"]["checks"]
    assert any(numbers[k] > limits[k] for k in limits), (numbers, limits)


# ---- kernel_calls_per_frame ----


def test_kernel_calls_per_frame_by_hand(monkeypatch):
    """Frames 0-2 issued in a window that counts 2 copies: 2, 3 and 4
    outermost kernel calls (a kernel span inside another is not a call of
    its own); frame 3 comes after the window."""
    recs, ids = [], iter(range(100))
    for f, calls in enumerate((2, 3, 4, 9)):
        fid = next(ids)
        t0 = (100 + 20 * f) * 1_000_000
        for c in range(calls):
            kid = next(ids)
            recs.append((kid, fid, "kernel", f, t0 + c, t0 + c + 1, {"name": "wide_closest"}))
            if c == 0:
                recs.append((next(ids), kid, "kernel", f, t0, t0 + 1, {"name": "sortpos"}))
        recs.append((fid, -1, "frame", f, t0, t0 + 10_000_000, None))
    snap = {"records": recs, "written": len(recs), "capacity": 1 << 16, "counters": {}}
    monkeypatch.setattr(program_spans, "snapshot", lambda: snap)
    window = types.SimpleNamespace(t0=0.095, done=[(0, 0.1, 0.125), (1, 0.12, 0.145)])
    assert kernel_calls_per_frame.read(types.SimpleNamespace(window=window)) == 3.0
    monkeypatch.setattr(program_spans, "snapshot", lambda: None)
    assert kernel_calls_per_frame.read(types.SimpleNamespace(window=window)) is None
