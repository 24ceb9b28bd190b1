"""The port's alpha-cutout and OBJ path vs the JAX reference on the CPU.

- Loader and scene tables: `load_obj` (OBJ, MTL, PNG through PIL, TGA at
  8/24/32 bits, uncompressed and RLE, both origins) and the Sponza-like
  courtyard's committed tables equal the JAX package's exactly, under the
  median build and SAH leaf 8; the asset's bytes are the JAX package's.
- Mask samplers and `traverse._tri_alpha_pass`: equal to JAX's eager ops
  exactly, on random uv (outside [0, 1] and negative too), exact .5 texel
  centres (round half to even) and tex ids -1 and past the end.
- The plain walk's in-loop alpha test against JAX's `traverse` on the
  512-ray fan of tests/test_pallas_integration.py and the courtyard's
  primary rays: hit masks agree (>= 99.5%: XLA contracts FMAs on the CPU,
  ROADMAP Queue 3), t to rtol/atol 1e-4 where both hit.
- The peel (ops/alpha.py) around the opaque plain walk of K1 and of K6
  against the in-loop walk and the brute oracle, and on the fan against
  JAX's peel around its opaque XLA tracer (the same rounds and exhausted
  masks); the MAX_PEELS + 6 layer stack for exhaustion.
- The 64x64 courtyard frame (tests/test_sponza_like.py protocol) against
  goldens/sponza_like_64.npy at its bar, on the in-loop and the peel route;
  chunked `path_trace` and `primary_visibility` equal to unchunked bit for
  bit on the courtyard and Cornell.
"""

import dataclasses
import os
import re
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu.models import obj_loader as jobj
from ilgpu_raytracing_tpu.models import scene as jscene
from ilgpu_raytracing_tpu.models import sponza_like as jsponza
from ilgpu_raytracing_tpu.ops import alpha as jalpha
from ilgpu_raytracing_tpu.ops import texture as jtex
from ilgpu_raytracing_tpu.ops import traverse as jtrav
from ilgpu_raytracing_tpu_torch.config import PARITY_KNOBS, RenderConfig
from ilgpu_raytracing_tpu_torch.models import obj_loader as tobj
from ilgpu_raytracing_tpu_torch.models import scene as tscene
from ilgpu_raytracing_tpu_torch.models import sponza_like as tsponza
from ilgpu_raytracing_tpu_torch.models.cornell import build_cornell_scene, cornell_camera
from ilgpu_raytracing_tpu_torch.models.scene import _FIELDS
from ilgpu_raytracing_tpu_torch.ops import alpha as talpha
from ilgpu_raytracing_tpu_torch.ops import brute, integrator, rays, sky
from ilgpu_raytracing_tpu_torch.ops import texture as ttex
from ilgpu_raytracing_tpu_torch.ops import traverse as ttrav
from ilgpu_raytracing_tpu_torch.ops.cuda import binary, stream, wide
from ilgpu_raytracing_tpu_torch.ops.restir import Reservoirs
from ilgpu_raytracing_tpu_torch.runtime.renderer import Renderer
from torch_ref_native import ensure_reference_native

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GOLDEN = os.path.join(ROOT, "tests", "goldens", "sponza_like_64.npy")
W = H = 64


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    ensure_reference_native()


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _write_png(path, rgba):
    from PIL import Image

    Image.fromarray(rgba, "RGBA").save(path)


def _tga_header(w, h, image_type, depth, desc):
    hdr = bytearray(18)
    hdr[2] = image_type
    hdr[12], hdr[13], hdr[14], hdr[15] = w & 255, w >> 8, h & 255, h >> 8
    hdr[16], hdr[17] = depth, desc
    return bytes(hdr)


def _write_tga(path, rgba, bpp, top_origin):
    """Uncompressed TGA at 32 (BGRA), 24 (BGR) or 8 (gray = red) bits."""
    h, w = rgba.shape[:2]
    img = rgba if top_origin else rgba[::-1]
    px = {4: img[..., [2, 1, 0, 3]], 3: img[..., [2, 1, 0]], 1: img[..., :1]}[bpp]
    with open(path, "wb") as f:
        f.write(_tga_header(w, h, 3 if bpp == 1 else 2, 8 * bpp,
                            0x20 if top_origin else 0))
        f.write(np.ascontiguousarray(px, np.uint8).tobytes())


def _write_tga_rle(path, rgba):
    """Top-origin 32-bit RLE: a run packet for each run of equal pixels (up
    to 128) and a raw packet for each single pixel."""
    h, w = rgba.shape[:2]
    flat = rgba.reshape(-1, 4)
    body = bytearray()
    i = 0
    while i < flat.shape[0]:
        j = i + 1
        while j < flat.shape[0] and j - i < 128 and (flat[j] == flat[i]).all():
            j += 1
        if j - i > 1:
            body.append(0x80 | (j - i - 1))
            body += bytes(flat[i, [2, 1, 0, 3]])
        else:
            body.append(0)
            body += bytes(flat[i, [2, 1, 0, 3]])
        i = j
    with open(path, "wb") as f:
        f.write(_tga_header(w, h, 10, 32, 0x20))
        f.write(bytes(body))


def _tables(scene):
    """Committed tables as numpy (JAX SceneData or the port's)."""
    out = {k: np.asarray(getattr(scene, k)) if not torch.is_tensor(getattr(scene, k))
           else getattr(scene, k).numpy() for k in _FIELDS}
    out["texels"] = out["texels"].astype(np.int64)
    return out


def _assert_same_tables(js, ts):
    jt, tt = _tables(js), _tables(ts)
    for k in _FIELDS:
        assert jt[k].shape == tt[k].shape, k
        np.testing.assert_array_equal(jt[k], tt[k], err_msg=k)
    assert (js.has_alpha, js.blas_leaf_max, js.tlas_leaf_max) == (
        ts.has_alpha, ts.blas_leaf_max, ts.tlas_leaf_max)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _j(x):
    return jnp.asarray(x.numpy() if torch.is_tensor(x) else x)


# ------------------------------------------------------------- scenes

@pytest.fixture(scope="module")
def obj_dir(tmp_path_factory):
    """tests/test_obj_loader.py's asset: a leaf quad with PNG diffuse and
    mask, glass, mirror, a missing texture, a `d 0.5` material, negative
    indices."""
    d = str(tmp_path_factory.mktemp("obj"))
    tex = np.zeros((8, 8, 4), np.uint8)
    tex[..., 0], tex[..., 3] = 200, 255
    _write_png(os.path.join(d, "diffuse.png"), tex)
    mask = np.zeros((8, 8, 4), np.uint8)
    mask[:, 4:, :3] = 255  # left half transparent, right half opaque
    mask[..., 3] = 255
    _write_png(os.path.join(d, "mask.png"), mask)
    _write(os.path.join(d, "scene.mtl"),
           "newmtl leaf\nKd 0.2 0.7 0.2\nmap_Kd diffuse.png\nmap_d mask.png\n"
           "newmtl glassy\nKd 0.9 0.9 0.9\nNi 1.52\nillum 7\n"
           "newmtl chrome\nillum 3\n"
           "newmtl missingtex\nKd 0.5 0.5 0.5\nmap_Kd not_there.png\n"
           "newmtl fade\nKd 1 0 0\nd 0.5\n"
           "newmtl wall\nKd 0.8 0.8 0.8\n")
    _write(os.path.join(d, "scene.obj"),
           "mtllib scene.mtl\n"
           "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
           "v 0 0 -1\nv 1 0 -1\nv 1 1 -1\nv 0 1 -1\n"
           "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\n"
           "usemtl leaf\nf 1/1 2/2 3/3 4/4\n"
           "usemtl wall\nf 5/1 6/2 7/3 8/4\n"
           "usemtl glassy\nf -4/-4 -3/-3 -2/-2\n")
    return d


@pytest.fixture(scope="module")
def fan_scenes(obj_dir):
    """(JAX scene, port scene) of the leaf quad in front of the wall."""
    path = os.path.join(obj_dir, "scene.obj")
    jb = jscene.SceneBuilder()
    jobj.add_obj_instance(jb, path)
    tb = tscene.SceneBuilder()
    tobj.add_obj_instance(tb, path)
    return jb.commit(), tb.commit("cpu")


def _fan_rays():
    """The 512-ray fan of tests/test_pallas_integration.py:87-101."""
    rs = np.random.RandomState(7)
    n = 512
    o = np.stack([rs.uniform(-0.2, 1.2, n), rs.uniform(-0.2, 1.2, n),
                  np.full(n, 2.0)], axis=1).astype(np.float32)
    d = np.stack([rs.uniform(-0.2, 0.2, n), rs.uniform(-0.2, 0.2, n),
                  np.full(n, -1.0)], axis=1).astype(np.float32)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


@pytest.fixture(scope="module")
def courtyard(tmp_path_factory):
    """(JAX scene, port scene, port WideScene) of the courtyard, median BVH
    with leaf 8 as tests/test_sponza_like.py builds it."""
    _, js = jsponza.build_sponza_like_scene(str(tmp_path_factory.mktemp("jc")))
    _, ts = tsponza.build_sponza_like_scene(str(tmp_path_factory.mktemp("tc")),
                                            device="cpu")
    return js, ts, wide.prepare_scene(ts)


def _courtyard_rays():
    o, d = rays.generate_primary_rays(tsponza.sponza_camera(W, H), W, H)
    return o.contiguous().numpy(), d.numpy()


# ------------------------------------------------- loader and tables

def test_load_obj_equals_reference(obj_dir):
    path = os.path.join(obj_dir, "scene.obj")
    jm = jobj.load_obj(path, scale=2.0)
    tm = tobj.load_obj(path, scale=2.0)
    for f in ("positions", "triangles", "tri_uvs", "tri_material"):
        a, b = getattr(jm, f), getattr(tm, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert [dataclasses.asdict(m) for m in jm.materials] == [
        dataclasses.asdict(m) for m in tm.materials]
    assert len(jm.textures) == len(tm.textures) == 2
    for a, b in zip(jm.textures, tm.textures):
        np.testing.assert_array_equal(a, b)
    # tests/test_obj_loader.py's semantics on the port's mesh
    assert tm.triangles.shape == (5, 3)
    np.testing.assert_allclose(tm.positions.max(), 2.0)
    np.testing.assert_array_equal(tm.triangles[4], [4, 5, 6])  # negative indices
    leaf = tm.materials[tm.tri_material[0]]
    assert leaf.kd == (0.2, 0.7, 0.2) and leaf.diffuse_tex >= 0
    assert leaf.alpha_tex >= 0 and leaf.two_sided
    glassy = tm.materials[tm.tri_material[4]]
    assert glassy.shading == tscene.SHADING_GLASS and glassy.ior == pytest.approx(1.52)
    assert sum(m.shading == tscene.SHADING_MIRROR for m in tm.materials) == 1
    assert [m.diffuse_tex for m in tm.materials if m.kd == (0.5, 0.5, 0.5)] == [-1]
    assert [m.two_sided for m in tm.materials if m.kd == (1.0, 0.0, 0.0)] == [True]
    np.testing.assert_allclose(tm.tri_uvs[0, 2], [1, 1])


@pytest.mark.parametrize("fmt", ["32_bottom", "32_top", "24_bottom", "8_top", "rle"])
def test_tga_readers(tmp_path, fmt):
    rgba = np.zeros((4, 6, 4), np.uint8)
    rgba[..., 0] = np.arange(6, dtype=np.uint8)[None, :] * 40
    rgba[..., 1] = np.arange(4, dtype=np.uint8)[:, None] * 60
    rgba[..., 2] = 9
    rgba[..., 3] = 200
    rgba[1, 2:5] = (7, 8, 9, 255)  # a run for the RLE case
    path = str(tmp_path / "t.tga")
    if fmt == "rle":
        _write_tga_rle(path, rgba)
        want = rgba
    else:
        bits, origin = fmt.split("_")
        bpp = int(bits) // 8
        _write_tga(path, rgba, bpp, origin == "top")
        want = rgba.copy()
        if bpp < 4:
            want[..., 3] = 255
        if bpp == 1:
            want[..., 1] = want[..., 2] = want[..., 0]
    got = tobj._load_tga_rgba(path)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jobj._load_tga_rgba(path))


def test_png_needs_pil_and_tga_does_not(obj_dir, tmp_path, monkeypatch):
    """With PIL missing a PNG raises ImportError (nothing falls back) and
    the TGA-only courtyard still loads."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        tobj._load_texture_rgba(os.path.join(obj_dir, "mask.png"))
    _, scene = tsponza.build_sponza_like_scene(str(tmp_path), device="cpu")
    assert scene.has_alpha and scene.tex_offset.shape[0] == 3


def test_courtyard_asset_bytes_equal_reference(tmp_path):
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jsponza.write_sponza_like_asset(jdir)
    tsponza.write_sponza_like_asset(tdir)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) == [
        "banner.tga", "banner_mask.tga", "courtyard.mtl", "courtyard.obj", "tiles.tga"]
    for name in names:
        with open(os.path.join(jdir, name), "rb") as a, open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("method", ["median", "sah"])
def test_courtyard_tables_equal_reference(tmp_path, method):
    _, js = jsponza.build_sponza_like_scene(str(tmp_path / "j"), 8, method)
    _, ts = tsponza.build_sponza_like_scene(str(tmp_path / "t"), 8, method, device="cpu")
    _assert_same_tables(js, ts)
    # tests/test_sponza_like.py's feature checks on the port's scene
    assert ts.mat_kd.shape[0] == 5 and ts.has_alpha and ts.n_tris == 94
    assert int((ts.mat_diffuse_tex >= 0).sum()) == 2
    assert int((ts.mat_alpha_tex >= 0).sum()) == 1
    assert max(float(ts.tri_uv1.max()), float(ts.tri_uv2.max())) > 1.5
    # both kernel routes keep the barycentrics the mask test needs
    assert wide.prepare_scene(ts).needs_bary and stream.prepare_stream(ts).needs_bary


def test_port_sources_import_no_jax():
    """No source of the port, and not chip_smoke.py, imports jax or the
    JAX package (a grep over every import line)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|ilgpu_raytracing_tpu)(\W|$)")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "ilgpu_raytracing_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = []
    for path in files:
        with open(path) as f:
            for i, line in enumerate(f, 1):
                if pat.match(line) or re.search(r"import_module\(['\"](jax|ilgpu_raytracing_tpu)['\".]", line):
                    bad.append(f"{path}:{i}: {line.strip()}")
    assert not bad, bad


# ---------------------------------------- mask samplers, alpha pass

def test_mask_samplers_equal_reference(courtyard):
    js, ts, _ = courtyard
    rs = np.random.RandomState(3)
    n = 4096
    tex = rs.randint(-1, 4, n).astype(np.int32)  # -1, the 3 textures, 3 = past the end
    u = rs.uniform(-3.0, 3.0, n).astype(np.float32)
    v = rs.uniform(-3.0, 3.0, n).astype(np.float32)
    u[:64] = np.arange(64, dtype=np.float32) / 63.0  # texel centres and edges
    v[64:128] = -np.arange(64, dtype=np.float32) / 63.0
    # exact .5 texel centres on the 64-wide textures: u = (k + .5) / 63 puts
    # x = k + .5 exactly (float32), and v = 1 - (k + .5) / 63 mostly puts y there
    half = slice(128, 128 + 62)
    k = np.arange(62, dtype=np.float32)
    u[half] = (k + 0.5) / np.float32(63.0)
    v[half] = np.float32(1.0) - (k[::-1] + 0.5) / np.float32(63.0)
    tex[half] = np.arange(62) % 3
    got = {}
    for name in ("sample_mask_bilinear", "sample_mask_point"):
        want = np.asarray(getattr(jtex, name)(js, _j(tex), _j(u), _j(v)))
        got[name] = getattr(ttex, name)(ts, _t(tex), _t(u), _t(v)).numpy()
        np.testing.assert_array_equal(got[name], want, err_msg=name)
    assert (tex == -1).any() and (tex == 3).any()

    # at the .5 centres the point sample rounds half to even: the texel
    # np.round picks, where rounding half away from zero picks another one
    x = u[half] * np.float32(63.0)
    y = (np.float32(1.0) - v[half]) * np.float32(63.0)
    assert (x - np.floor(x) == 0.5).all() and (y - np.floor(y) == 0.5).sum() > 40
    texels = ts.texels.numpy()
    off = ts.tex_offset.numpy()[tex[half]]

    def luma(xi, yi):
        p = texels[off + yi * 64 + xi]
        c = [((p >> b) & 255).astype(np.float32) * np.float32(1.0 / 255.0) for b in (16, 8, 0)]
        return np.float32(0.2126) * c[0] + np.float32(0.7152) * c[1] + np.float32(0.0722) * c[2]

    even = luma(np.round(x).astype(np.int64), np.round(y).astype(np.int64))
    away = luma(np.floor(x + 0.5).astype(np.int64), np.floor(y + 0.5).astype(np.int64))
    np.testing.assert_allclose(got["sample_mask_point"][half], even, rtol=1e-6)
    assert (np.abs(even - away) > 0.05).any()


def test_tri_alpha_pass_equals_reference(courtyard):
    js, ts, _ = courtyard
    rs = np.random.RandomState(5)
    n = 4096  # the sampler test's shapes: JAX reuses its compiled ops
    prim = rs.randint(-1, ts.n_tris + 1, n).astype(np.int32)
    bu = rs.uniform(-0.2, 1.2, n).astype(np.float32)
    bv = rs.uniform(-0.2, 1.2, n).astype(np.float32)
    banner = np.nonzero(np.asarray(js.mat_alpha_tex)[np.asarray(js.tri_mat)] >= 0)[0]
    prim[: n // 2] = rs.choice(banner, n // 2)  # half on the cut-out banners
    for closest in (True, False):
        want = np.asarray(jtrav._tri_alpha_pass(js, _j(prim), _j(bu), _j(bv), closest))
        got = ttrav._tri_alpha_pass(ts, _t(prim), _t(bu), _t(bv), closest).numpy()
        np.testing.assert_array_equal(got, want)
        frac = got[: n // 2].mean()
        assert 0.2 < frac < 0.9, f"banner pass share {frac}"


# ------------------------------------ in-loop walk, peel, brute oracle

def _hit_bar(label, jhit, thit, floor=0.995):
    """Hit masks agree on >= floor of the rays (FMA flips are counted), t
    to 1e-4 where both hit. Returns the number of flipped rays."""
    jh, th = np.asarray(jhit.hit), thit.hit.numpy()
    flips = int((jh != th).sum())
    print(f"{label}: hit masks differ on {flips} of {jh.size} rays")
    assert (jh == th).mean() >= floor, label
    both = jh & th
    np.testing.assert_allclose(thit.t.numpy()[both], np.asarray(jhit.t)[both],
                               rtol=1e-4, atol=1e-4, err_msg=label)
    return flips


@pytest.mark.parametrize("case", ["fan", "courtyard"])
def test_in_loop_walk_matches_reference(case, fan_scenes, courtyard):
    js, ts = fan_scenes if case == "fan" else courtyard[:2]
    o, d = _fan_rays() if case == "fan" else _courtyard_rays()
    jhit = jtrav.trace_closest(js, _j(o), _j(d))
    thit = ttrav.trace_closest(ts, _t(o), _t(d))
    _hit_bar(f"{case} closest", jhit, thit)
    assert 0.2 < thit.hit.numpy().mean()
    # any-hit at t_max 1e29 and at one between the cut-out layer and the
    # surface behind it, in one call (a per-lane t_max)
    n = o.shape[0]
    o2, d2 = np.concatenate([o, o]), np.concatenate([d, d])
    t_max = np.repeat(np.array([1e29, 2.5 if case == "fan" else 7.0], np.float32), n)
    jocc = np.asarray(jtrav.shadow_occlusion(js, _j(o2), _j(d2), _j(t_max)))
    tocc = ttrav.shadow_occlusion(ts, _t(o2), _t(d2), _t(t_max)).numpy()
    print(f"{case} any-hit: differs on {int((jocc != tocc).sum())} of {2 * n} rays")
    assert (jocc == tocc).mean() >= 0.995
    assert 0 < tocc[n:].sum() < tocc[:n].sum()
    # the in-loop walk against the port's own brute oracle
    bhit = brute.trace_closest_brute(ts, _t(o), _t(d))
    np.testing.assert_array_equal(bhit.hit.numpy(), thit.hit.numpy())
    np.testing.assert_array_equal(bhit.prim.numpy(), thit.prim.numpy())
    np.testing.assert_allclose(bhit.t.numpy(), thit.t.numpy(), rtol=1e-6)


def _peel_routes(ts):
    """The opaque closest-hit tracers of the port that the peel wraps: the
    plain K1 walk (a WideScene on CPU tensors) and the plain K6 walk."""
    ws, bs = wide.prepare_scene(ts), binary.prepare_binary(ts)
    return {
        "K1 plain": lambda o, d, a: wide.trace_closest_wide(ws, o, d, active=a),
        "K6 plain": lambda o, d, a: binary.trace_closest_binary(bs, o, d, active=a),
    }


@pytest.mark.parametrize("case", ["fan", "courtyard"])
def test_peel_matches_in_loop_and_brute(case, fan_scenes, courtyard):
    """The peel around the plain K1 and K6 walks equals the in-loop walk and
    the brute oracle (hits, prims, t) and the in-loop any-hit, in the same
    rounds on both routes."""
    ts = fan_scenes[1] if case == "fan" else courtyard[1]
    o, d = _fan_rays() if case == "fan" else _courtyard_rays()
    to, td = _t(o), _t(d)
    ref = ttrav.trace_closest(ts, to, td)
    bru = brute.trace_closest_brute(ts, to, td)
    occ_ref = ttrav.shadow_occlusion(ts, to, td, 1e29)
    rounds = {}
    for name, fn in _peel_routes(ts).items():
        hit, exh, i = talpha.trace_closest_peel(fn, ts, to, td, with_exhausted=True,
                                                with_iters=True)
        assert not bool(exh.any())
        for label, want in (("in-loop", ref), ("brute", bru)):
            assert _hit_bar(f"{case} peel around {name} vs {label}", want, hit, 1.0) == 0
            np.testing.assert_array_equal(hit.prim.numpy(), want.prim.numpy())
        occ, s_exh, si = talpha.shadow_occlusion_peel(fn, ts, to, td, 1e29,
                                                      with_exhausted=True, with_iters=True)
        np.testing.assert_array_equal(occ.numpy(), occ_ref.numpy())
        assert not bool(s_exh.any())
        rounds[name] = (i, si)
    assert len(set(rounds.values())) == 1 and rounds["K1 plain"][0] >= 2, rounds


def test_peel_matches_reference_peel(fan_scenes):
    """The port's peel around the plain K1 walk against JAX's peel around
    its opaque XLA tracer on the fan: the same rounds and exhausted masks,
    hits at the walk's bar."""
    js, ts = fan_scenes
    o, d = _fan_rays()
    jop = js.replace(has_alpha=False)
    jfn = lambda oo, dd, a: jtrav.trace_closest(jop, oo, dd, active=a)
    tfn = _peel_routes(ts)["K1 plain"]
    jhit, jexh, ji = jalpha.trace_closest_peel(jfn, js, _j(o), _j(d),
                                               with_exhausted=True, with_iters=True)
    thit, texh, ti = talpha.trace_closest_peel(tfn, ts, _t(o), _t(d), with_exhausted=True,
                                               with_iters=True)
    assert int(ji) == ti >= 2
    np.testing.assert_array_equal(np.asarray(jexh), texh.numpy())
    _hit_bar("fan peel vs JAX peel", jhit, thit)
    jocc, jsexh, jsi = jalpha.shadow_occlusion_peel(jfn, js, _j(o), _j(d), 1e29,
                                                    with_exhausted=True, with_iters=True)
    tocc, tsexh, tsi = talpha.shadow_occlusion_peel(tfn, ts, _t(o), _t(d), 1e29,
                                                    with_exhausted=True, with_iters=True)
    assert int(jsi) == tsi
    np.testing.assert_array_equal(np.asarray(jsexh), tsexh.numpy())
    assert (np.asarray(jocc) == tocc.numpy()).mean() >= 0.995


def test_peel_exhaustion_defined(tmp_path):
    """tests/test_pallas_integration.py:162-227: MAX_PEELS + 6 cut-out
    layers. Lane 0 crosses them all in the transparent half (exhausted: a
    miss and unoccluded); lane 1 stops on the first layer."""
    d_dir = str(tmp_path)
    mask = np.zeros((8, 8, 4), np.uint8)
    mask[:, 4:, :3] = 255
    mask[..., 3] = 255
    _write_png(os.path.join(d_dir, "mask.png"), mask)
    _write(os.path.join(d_dir, "stack.mtl"), "newmtl leaf\nKd 0.2 0.7 0.2\nmap_d mask.png\n")
    verts, faces = [], []
    for i in range(talpha.MAX_PEELS + 6):
        z = -0.01 * i
        verts += [f"v 0 0 {z}", f"v 1 0 {z}", f"v 1 1 {z}", f"v 0 1 {z}"]
        faces.append(f"f {4 * i + 1}/1 {4 * i + 2}/2 {4 * i + 3}/3 {4 * i + 4}/4")
    _write(os.path.join(d_dir, "stack.obj"),
           "mtllib stack.mtl\n" + "\n".join(verts)
           + "\nvt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nusemtl leaf\n" + "\n".join(faces) + "\n")
    b = tscene.SceneBuilder()
    tobj.add_obj_instance(b, os.path.join(d_dir, "stack.obj"))
    scene = b.commit("cpu")
    assert scene.has_alpha
    opaque = dataclasses.replace(scene, has_alpha=False)
    closest = lambda oo, dd, act: ttrav.trace_closest(opaque, oo, dd, active=act)
    o = torch.tensor([[0.25, 0.5, 1.0], [0.75, 0.5, 1.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    hit, exh, i = talpha.trace_closest_peel(closest, scene, o, d, with_exhausted=True,
                                            with_iters=True)
    assert exh.tolist() == [True, False] and hit.hit.tolist() == [False, True]
    assert i == talpha.MAX_PEELS
    occ, s_exh = talpha.shadow_occlusion_peel(closest, scene, o, d, 1e29,
                                              with_exhausted=True)
    assert s_exh.tolist() == [True, False] and occ.tolist() == [False, True]
    # no lane active: no round runs
    _, _, i0 = talpha.trace_closest_peel(closest, scene, o, d, torch.zeros(2, dtype=torch.bool),
                                         with_exhausted=True, with_iters=True)
    assert i0 == 0


# ------------------------------------------------ frames, chunking

def _frames(scene, ks, cam, key, w=W, h=H, max_depth=3):
    """Two locked-noise frames (tests/test_sponza_like.py protocol): spp 2,
    depth 3, parity knobs; per frame (gb, res_prev, res_cur_init, color,
    depth, obj_id, res_cur, eff)."""
    cfg = RenderConfig(spp=2, max_depth=max_depth, **PARITY_KNOBS)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    ra, rb = Reservoirs.empty(w * h, "cpu"), Reservoirs.empty(w * h, "cpu")
    out = []
    for f in range(2):
        gb = integrator.primary_visibility(scene, cam, w, h, 0, ks)
        rp, rc = (ra, rb) if f % 2 == 0 else (rb, ra)
        res = integrator.path_trace(scene, gb, cam, cam, rp, rc, f, key, sun, cfg, w, h, ks)
        if f % 2 == 0:
            rb = res[3]
        else:
            ra = res[3]
        out.append((gb, rp, rc) + tuple(res))
    return out


@pytest.mark.parametrize("route", ["in-loop", "peel"])
def test_courtyard_frame_golden(route, courtyard):
    _, ts, ws = courtyard
    frames = _frames(ts, None if route == "in-loop" else ws,
                     tsponza.sponza_camera(W, H), 77)
    got = frames[-1][3].numpy()
    assert np.isfinite(got).all()
    diff = np.abs(got - np.load(_GOLDEN).astype(np.float32))
    frac = (diff.max(axis=-1) > 0.1).mean()
    print(f"courtyard {route}: mean |diff| {diff.mean():.5f}, pixels > 0.1 {frac:.4%}")
    assert diff.mean() < 0.02, f"mean drift {diff.mean():.4f}"
    assert frac < 0.01


def _same_frame(a, b):
    for x, y in zip(a[:3] + a[4:], b[:3] + b[4:]):
        assert torch.equal(x, y)
    for k in vars(a[3]):
        assert torch.equal(getattr(a[3], k), getattr(b[3], k)), k


@pytest.mark.parametrize("case", ["courtyard", "cornell"])
def test_chunked_equals_unchunked(case, courtyard, monkeypatch):
    """chunk_pixels=512 runs a 32x32 frame's 1,024 pixels in 4 chunks on
    the courtyard (the peel chunks trace lanes: 256 pixels x 2 spp) and in
    2 on Cornell (wide route): colour, depth, obj_id, reservoirs and eff
    equal the one-chunk call bit for bit, on the second frame (reuse from
    full-image neighbours); the chunked G-buffer equals the unchunked.
    Depth 2: a scatter bounce and the final one."""
    w = h = 32
    if case == "courtyard":
        _, scene, ks = courtyard
        cam = tsponza.sponza_camera(w, h)
    else:
        _, scene = build_cornell_scene(tess=2, sphere_tess=(6, 8), device="cpu")
        ks, cam = wide.prepare_scene(scene), cornell_camera(w, h)
    blocks = []
    real = integrator._path_trace_block
    monkeypatch.setattr(integrator, "_path_trace_block",
                        lambda *a: blocks.append(a[3].shape[0]) or real(*a))
    base = _frames(scene, ks, cam, 1234, w, h, max_depth=2)
    gb, rp, rc = base[1][:3]
    want = base[1][3:]
    assert blocks == [w * h] * 2
    cfg = RenderConfig(spp=2, max_depth=2, chunk_pixels=512, **PARITY_KNOBS)
    sun = sky.sun_direction(cfg.sun_azimuth, cfg.sun_elevation)
    got = integrator.path_trace(scene, gb, cam, cam, rp, rc, 1, 1234, sun, cfg, w, h, ks)
    n_chunks = 4 if case == "courtyard" else 2
    assert blocks[2:] == [w * h // n_chunks] * n_chunks
    _same_frame(want, got)
    gb_c = integrator.primary_visibility(scene, cam, w, h, 256, ks)  # 4 chunks
    for k in vars(gb):
        assert torch.equal(getattr(gb, k), getattr(gb_c, k)), k


def test_renderer_renders_courtyard_on_cpu(courtyard):
    _, ts, _ = courtyard
    r = Renderer(96, 96, RenderConfig(spp=1, max_depth=1), ts,
                 tsponza.sponza_camera(96, 96), device="cpu")
    assert isinstance(r.wscene, wide.WideScene) and r.wscene.needs_bary
    assert not r.wscene.scene.has_alpha  # the plain K1/K2 are opaque, as the kernels
    r.render()
    img = r.frame_rgb()
    assert img.shape == (96, 96, 3) and len(np.unique(img.reshape(-1, 3), axis=0)) > 50
