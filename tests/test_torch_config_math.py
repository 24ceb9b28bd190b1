"""Port vs JAX reference on the CPU: config, RNG, layout, packing (exact),
vector math, intersection, sampling, sky and tone mapping (rtol/atol 1e-6),
and the port's import hygiene (no jax)."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu import config as jconfig
from ilgpu_raytracing_tpu.ops import intersect as jint
from ilgpu_raytracing_tpu.ops import layout as jlayout
from ilgpu_raytracing_tpu.ops import sampling as jsamp
from ilgpu_raytracing_tpu.ops import sky as jsky
from ilgpu_raytracing_tpu.ops import tonemap as jtone
from ilgpu_raytracing_tpu.utils import image as jimage
from ilgpu_raytracing_tpu.utils import packing as jpack
from ilgpu_raytracing_tpu.utils import rng as jrng
from ilgpu_raytracing_tpu.utils import vec as jvec
from ilgpu_raytracing_tpu_torch import config as tconfig
from ilgpu_raytracing_tpu_torch.ops import intersect as tint
from ilgpu_raytracing_tpu_torch.ops import layout as tlayout
from ilgpu_raytracing_tpu_torch.ops import sampling as tsamp
from ilgpu_raytracing_tpu_torch.ops import sky as tsky
from ilgpu_raytracing_tpu_torch.ops import tonemap as ttone
from ilgpu_raytracing_tpu_torch.utils import image as timage
from ilgpu_raytracing_tpu_torch.utils import packing as tpack
from ilgpu_raytracing_tpu_torch.utils import rng as trng
from ilgpu_raytracing_tpu_torch.utils import vec as tvec

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
RNG = np.random.default_rng(20240601)


def _u32(n):
    return RNG.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)


def _vec3(n, scale=1.0):
    return (RNG.normal(size=(n, 3)) * scale).astype(np.float32)


@pytest.fixture(autouse=True)
def _seeded():
    """Every test draws its inputs from the same fixed seed."""
    global RNG
    RNG = np.random.default_rng(20240601)


def _j(x):
    return np.array(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _eq_u32(jx, tx):
    np.testing.assert_array_equal(_j(jx).astype(np.int64), tx.numpy())


def test_render_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.RenderConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.RenderConfig)}
    assert jf == tf
    jc, tc = jconfig.RenderConfig(), tconfig.RenderConfig()
    assert tc.shadow_rr_lum == 0.3 and tc.rr_start_depth == 2
    assert tc.restir_reference_weighting is False
    for ow, oh in ((1920, 1080), (1280, 720), (64, 64), (100, 50), (3840, 2160), (33, 17)):
        assert jc.internal_resolution(ow, oh) == tc.internal_resolution(ow, oh)
    assert tc.internal_resolution(1920, 1080) == (1280, 704)


@pytest.mark.parametrize("fn", ["hash32", "pcg_permute", "next_uint", "side_float",
                                "next_float2"])
def test_rng_primitives_bit_exact(fn):
    x = _u32(20000)
    x[:4] = [0, 1, 0xFFFFFFFF, 0x80000000]
    jx, tx = jnp.asarray(x), torch.as_tensor(x.astype(np.int64))
    if fn == "next_uint":
        js, jv = jrng.next_uint(jx)
        ts, tv = trng.next_uint(tx)
        _eq_u32(js, ts)
        jf, tf = jrng.next_float(jx)[1], trng.next_float(tx)[1]
        np.testing.assert_array_equal(_j(jf), tf.numpy())
    elif fn == "next_float2":
        for j, t in zip(jrng.next_float2(jx), trng.next_float2(tx)):
            if j.dtype == jnp.uint32:
                _eq_u32(j, t)
            else:
                np.testing.assert_array_equal(_j(j), t.numpy())
    elif fn == "side_float":
        np.testing.assert_array_equal(
            _j(jrng.side_float(jx, 0x53484457)), trng.side_float(tx, 0x53484457).numpy()
        )
    else:
        _eq_u32(getattr(jrng, fn)(jx), getattr(trng, fn)(tx))


@pytest.mark.parametrize("noise_key", [0, 1234, 0xDEADBEEF])
def test_seed_streams_bit_exact(noise_key):
    w, h = 97, 61
    idx = np.arange(w * h, dtype=np.int32)
    sample = np.repeat(np.arange(2, dtype=np.uint32), w * h)
    for frame in (0, 7):
        js = jrng.seed_from_index(
            jnp.asarray(np.tile(idx, 2)), w, frame, jnp.asarray(sample), 0xC0FFEE,
            np.uint32(noise_key),
        )
        ts = trng.seed_from_index(
            torch.as_tensor(np.tile(idx, 2)), w, frame,
            torch.as_tensor(sample.astype(np.int64)), 0xC0FFEE, noise_key,
        )
        _eq_u32(js, ts)
        # a few draws down the stream
        for _ in range(3):
            js, jf = jrng.next_float(js)
            ts, tf = trng.next_float(ts)
            np.testing.assert_array_equal(_j(jf), tf.numpy())
        _eq_u32(js, ts)


@pytest.mark.parametrize("wh", [(128, 64), (64, 64), (100, 37)])
def test_layout_exact(wh):
    w, h = wh
    pos = np.arange(w * h, dtype=np.int32)
    jx, jy = jlayout.xy_from_position(jnp.asarray(pos), w, h)
    tx, ty = tlayout.xy_from_position(torch.as_tensor(pos), w, h)
    np.testing.assert_array_equal(_j(jx), tx.numpy())
    np.testing.assert_array_equal(_j(jy), ty.numpy())
    xs = RNG.integers(-3, w + 3, size=5000).astype(np.int32)
    ys = RNG.integers(-3, h + 3, size=5000).astype(np.int32)
    np.testing.assert_array_equal(
        _j(jlayout.position_from_xy(jnp.asarray(xs), jnp.asarray(ys), w, h)),
        tlayout.position_from_xy(_t(xs), _t(ys), w, h).numpy(),
    )
    flat = RNG.normal(size=(w * h, 3)).astype(np.float32)
    img = _j(jlayout.to_image(jnp.asarray(flat), w, h))
    np.testing.assert_array_equal(img, tlayout.to_image(_t(flat), w, h).numpy())
    np.testing.assert_array_equal(
        _j(jlayout.from_image(jnp.asarray(img))), tlayout.from_image(_t(img)).numpy()
    )


@pytest.mark.parametrize("srgb", [False, True])
def test_image_helpers_exact(srgb, tmp_path):
    """linear_to_uint8 (with the edges 0, 1 and out of range), the packed
    PNG writer, and vec3, against the JAX package's."""
    c = RNG.uniform(-0.2, 1.2, size=(37, 53, 3)).astype(np.float32)
    c[0, :3] = [[0.0, 1.0, 0.5], [-1.0, 2.0, 0.0031308], [1e-8, 0.999, 0.04045]]
    np.testing.assert_array_equal(timage.linear_to_uint8(torch.as_tensor(c), srgb),
                                  jimage.linear_to_uint8(jnp.asarray(c), srgb))
    packed = _u32(37 * 53) | np.uint32(0xFF000000)
    from PIL import Image

    jimage.save_packed_png(str(tmp_path / "j.png"), jnp.asarray(packed), 53, 37)
    timage.save_packed_png(str(tmp_path / "t.png"),
                           torch.as_tensor(packed.astype(np.int64)), 53, 37)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
    np.testing.assert_array_equal(tvec.vec3(0.5, -1.0, 3.25, device="cpu").numpy(),
                                  _j(jvec.vec3(0.5, -1.0, 3.25)))
    assert tvec.vec3(1, 2, 3, torch.int32, device="cpu").dtype == torch.int32


def test_packing_exact():
    c = RNG.uniform(-0.2, 1.2, size=(20000, 3)).astype(np.float32)
    _eq_u32(jpack.pack_rgba8(jnp.asarray(c)), tpack.pack_rgba8(_t(c)))
    _eq_u32(jpack.pack_srgb(jnp.asarray(c)), tpack.pack_srgb(_t(c)))
    p = _u32(20000)
    np.testing.assert_array_equal(
        _j(jpack.unpack_rgb8(jnp.asarray(p))),
        tpack.unpack_rgb8(torch.as_tensor(p.astype(np.int64))).numpy(),
    )
    shade = RNG.integers(0, 3, size=1000).astype(np.int32)
    ior = RNG.uniform(0.0, 3.0, size=1000).astype(np.float32)
    jp = jpack.pack_mat_id(jnp.asarray(shade), jnp.asarray(ior))
    tp = tpack.pack_mat_id(_t(shade), _t(ior))
    np.testing.assert_array_equal(_j(jp), tp.numpy())
    for a, b in zip(jpack.unpack_mat_id(jp), tpack.unpack_mat_id(tp)):
        np.testing.assert_array_equal(_j(a), b.numpy())


@pytest.mark.parametrize(
    "name", ["dot", "cross", "normalize", "reflect", "refract", "fresnel",
             "basis", "luminance", "safe_color", "inv_dir", "transform"],
)
def test_vec_math_close(name):
    a, b = _vec3(5000), _vec3(5000)
    b[:7] = 0.0
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), _t(a), _t(b)
    if name == "dot":
        pairs = [(jvec.dot(ja, jb), tvec.dot(ta, tb))]
    elif name == "cross":
        pairs = [(jvec.cross(ja, jb), tvec.cross(ta, tb))]
    elif name == "normalize":
        pairs = [(jvec.normalize(ja), tvec.normalize(ta)),
                 (jvec.length(ja), tvec.length(ta))]
    elif name == "reflect":
        n = _j(jvec.normalize(jb + 1e-3))
        pairs = [(jvec.reflect(ja, jnp.asarray(n)), tvec.reflect(ta, _t(n)))]
    elif name == "refract":
        n = _j(jvec.normalize(jnp.asarray(_vec3(5000))))
        i = _j(jvec.normalize(ja))
        eta_i = RNG.uniform(1.0, 1.6, 5000).astype(np.float32)
        eta_t = RNG.uniform(1.0, 1.6, 5000).astype(np.float32)
        jok, jd = jvec.refract(jnp.asarray(i), jnp.asarray(n), jnp.asarray(eta_i), jnp.asarray(eta_t))
        tok, td = tvec.refract(_t(i), _t(n), _t(eta_i), _t(eta_t))
        np.testing.assert_array_equal(_j(jok), tok.numpy())
        pairs = [(jd, td)]
    elif name == "fresnel":
        cos = RNG.uniform(0, 1, 5000).astype(np.float32)
        pairs = [(jvec.schlick_fresnel(jnp.asarray(cos), 1.0, 1.5),
                  tvec.schlick_fresnel(_t(cos), 1.0, 1.5))]
    elif name == "basis":
        n = _j(jvec.normalize(ja))
        n[:3] = [[0, 1, 0], [0, -1, 0], [1, 0, 0]]
        pairs = list(zip(jvec.orthonormal_basis(jnp.asarray(n)), tvec.orthonormal_basis(_t(n))))
    elif name == "luminance":
        pairs = [(jvec.luminance(ja), tvec.luminance(ta))]
    elif name == "safe_color":
        c = a * 1e6
        c[0] = [np.nan, np.inf, -np.inf]
        pairs = [(jvec.safe_color(jnp.asarray(c)), tvec.safe_color(_t(c)))]
    elif name == "inv_dir":
        pairs = [(jvec.inv_dir(jb), tvec.inv_dir(tb))]
    else:
        m = RNG.normal(size=(5000, 3, 4)).astype(np.float32)
        pairs = [(jvec.transform_point(jnp.asarray(m), ja), tvec.transform_point(_t(m), ta)),
                 (jvec.transform_vector(jnp.asarray(m), ja), tvec.transform_vector(_t(m), ta))]
    for jr, tr in pairs:
        np.testing.assert_allclose(_j(jr), tr.numpy(), rtol=1e-6, atol=1e-5 if name in ("transform", "inv_dir") else 1e-6)


def test_intersect_close():
    n = 20000
    o = _vec3(n, 2.0)
    d = _j(jvec.normalize(jnp.asarray(_vec3(n))))
    bmin = _vec3(n) - 1.0
    bmax = bmin + np.abs(_vec3(n)) + 0.1
    inv = _j(jvec.inv_dir(jnp.asarray(d)))
    jm = jint.intersect_aabb(jnp.asarray(o), jnp.asarray(inv), jnp.asarray(bmin), jnp.asarray(bmax), 1e-3, 1e30)
    tm = tint.intersect_aabb(_t(o), _t(inv), _t(bmin), _t(bmax), 1e-3, 1e30)
    assert (_j(jm) == tm.numpy()).mean() > 0.999
    c, r = _vec3(n), np.abs(RNG.normal(size=n)).astype(np.float32) + 0.2
    jok, jt, jn = jint.intersect_sphere(jnp.asarray(o), jnp.asarray(d), jnp.asarray(c), jnp.asarray(r))
    tok, tt, tn = tint.intersect_sphere(_t(o), _t(d), _t(c), _t(r))
    same = _j(jok) == tok.numpy()
    assert same.mean() > 0.999
    np.testing.assert_allclose(_j(jt)[same], tt.numpy()[same], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_j(jn)[same], tn.numpy()[same], rtol=1e-5, atol=1e-5)
    v0, e1, e2 = _vec3(n), _vec3(n), _vec3(n)
    jr = jint.intersect_triangle(*(jnp.asarray(x) for x in (o, d, v0, e1, e2)))
    tr = tint.intersect_triangle(*(_t(x) for x in (o, d, v0, e1, e2)))
    same = _j(jr[0]) == tr[0].numpy()
    assert same.mean() > 0.999 and _j(jr[0]).sum() > 100
    for a, b in zip(jr[1:], tr[1:]):
        np.testing.assert_allclose(_j(a)[same], b.numpy()[same], rtol=1e-5, atol=1e-5)


def test_sampling_sky_tonemap_close():
    n = 10000
    nrm = _j(jvec.normalize(jnp.asarray(_vec3(n))))
    state = _u32(n) | 1
    js, jw = jsamp.sample_hemisphere_cosine(jnp.asarray(nrm), jnp.asarray(state))
    ts, tw = tsamp.sample_hemisphere_cosine(_t(nrm), torch.as_tensor(state.astype(np.int64)))
    _eq_u32(js, ts)
    np.testing.assert_allclose(_j(jw), tw.numpy(), **TOL)
    np.testing.assert_allclose(
        _j(jsamp.cos_hemisphere_pdf(jnp.asarray(nrm), jw)),
        tsamp.cos_hemisphere_pdf(_t(nrm), tw).numpy(), **TOL,
    )
    top, bottom = (0.5, 0.7, 1.0), (1.0, 1.0, 1.0)
    np.testing.assert_allclose(
        _j(jsky.sky_radiance(jnp.asarray(nrm), top, bottom)),
        tsky.sky_radiance(_t(nrm), top, bottom).numpy(), **TOL,
    )
    for az, el in ((0.0, 0.9), (0.3, 0.6), (5.0, -0.2)):
        np.testing.assert_array_equal(jsky.sun_direction(az, el), tsky.sun_direction(az, el))
        assert jsky.advance_sun_azimuth(az, 2.0, 0.05) == tsky.advance_sun_azimuth(az, 2.0, 0.05)
    c = np.abs(_vec3(n, 2.0))
    for name in ("clamp", "reinhard", "aces"):
        np.testing.assert_allclose(
            _j(jtone.OPERATORS[name](jnp.asarray(c))),
            ttone.OPERATORS[name](_t(c)).numpy(), **TOL,
        )


def test_port_imports_no_jax():
    """Importing every module of the port leaves jax out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ilgpu_raytracing_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "       or k == 'ilgpu_raytracing_tpu' or k.startswith('ilgpu_raytracing_tpu.')]\n"
        "assert not bad, bad\n"
        "for m in ('models.terrain', 'ops.cuda.stream', 'ops.cuda.wide', 'ops.sort'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "print('ok', len([k for k in sys.modules if k.startswith(p.__name__)]))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[1]) >= 27
